"""The port's model stack (dense attention + dense FFN layers)."""
from repro_torch.models.params import (ParamDef, init_params, model_defs,
                                       params_from_jax)
from repro_torch.models.transformer import (Block, Transformer,
                                            cast_for_compute, decode_step,
                                            init_cache, prefill, train_logits)
