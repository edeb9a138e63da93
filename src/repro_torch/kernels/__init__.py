"""Hand-written CUDA kernels of the port, each beside its plain version.

| Kernel | Replaces (Pallas, TPU) |
| --- | --- |
| ``flash_attention`` | ``repro/kernels/flash_attention.py`` ``flash_attention_tpu`` |
| ``rmsnorm`` | ``repro/kernels/rmsnorm.py`` ``rmsnorm_tpu`` |
| ``rmsnorm_residual`` | ``repro/kernels/rmsnorm.py`` ``rmsnorm_residual_tpu`` |
"""
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_plain,
                                         rmsnorm_residual,
                                         rmsnorm_residual_plain)
