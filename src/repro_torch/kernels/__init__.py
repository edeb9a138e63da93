"""Hand-written CUDA kernels of the port, each beside its plain version.

| Kernel | Replaces (Pallas, TPU; or XLA's gradient) |
| --- | --- |
| ``flash_attention`` | ``repro/kernels/flash_attention.py`` ``flash_attention_tpu`` |
| ``flash_bwd_dq``, ``flash_bwd_dkdv`` | XLA's gradient of ``repro/models/attention.py`` ``flash_attention_xla`` |
| ``rmsnorm`` | ``repro/kernels/rmsnorm.py`` ``rmsnorm_tpu`` |
| ``rmsnorm_residual`` | ``repro/kernels/rmsnorm.py`` ``rmsnorm_residual_tpu`` |
| ``rmsnorm_bwd``, ``rmsnorm_residual_bwd`` (dx and dw in one launch each) | XLA's gradient of ``repro/kernels/ref.py`` ``rmsnorm_ref`` and of the unfused ``x + y; norm`` |
| ``bf16x3.split_bf16x3`` (the f32 cotangent as three bf16 terms) | none: part of the unembedding's backward on tensor cores (``models/layers.py`` ``UnembedProduct``), where XLA's gradient of ``repro/models/layers.py`` ``unembed`` multiplies in f32 |
| ``gqa_decode.gqa_decode`` (the scores, then weighted V with the chunks' merge) | none: the single-device decode attention over the bf16 KV cache, read only up to each row's length, where ``repro/models/attention.py`` ``decode_attention_ref`` leaves two einsums to XLA |
"""
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain,
                                                 flash_bwd_dkdv, flash_bwd_dq)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                         rmsnorm_bwd_plain, rmsnorm_plain,
                                         rmsnorm_residual,
                                         rmsnorm_residual_bwd,
                                         rmsnorm_residual_bwd_plain,
                                         rmsnorm_residual_plain)
