"""Architecture registry of the port: ``get_config(name)``.

All eleven of the JAX package's architectures, each module a copy of the
reference's with its imports rewritten.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.configs import (command_r_plus_104b, deepseek_v2_236b,
                                 internlm2_1_8b, internvl2_2b,
                                 jamba_1_5_large_398b, llama3_405b,
                                 musicgen_medium, qwen2_moe_a2_7b,
                                 starcoder2_15b, tacc_100m, xlstm_125m)

_MODULES = {
    "starcoder2-15b": starcoder2_15b,
    "internlm2-1.8b": internlm2_1_8b,
    "llama3-405b": llama3_405b,
    "command-r-plus-104b": command_r_plus_104b,
    "internvl2-2b": internvl2_2b,
    "xlstm-125m": xlstm_125m,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "musicgen-medium": musicgen_medium,
    "tacc-100m": tacc_100m,
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; the archs are "
                       f"{list(_MODULES)}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["LayerSpec", "ModelConfig", "get_config", "list_archs"]
