"""Architecture registry of the port: ``get_config(name)``.

Only the architectures the port runs are registered. The JAX package's
other ten wait for their mixers and FFNs (ROADMAP, Queue 1).
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.configs import tacc_100m

_MODULES = {
    "tacc-100m": tacc_100m,
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(
            f"arch '{name}' is not ported yet (ROADMAP Queue 1, items 12-14: "
            f"MoE, MLA, Mamba/xLSTM and the remaining config features); "
            f"ported: {list(_MODULES)}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["LayerSpec", "ModelConfig", "get_config", "list_archs"]
