from repro_torch.serve.engine import GenerationResult, ServeEngine
