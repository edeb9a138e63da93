"""The program under test, as the harness sees it: its model configuration
built from a configuration file's ``model`` section. The port is imported
here and in the kinds' modules only, inside functions, so that the
harness's other files (and its tests) load without it."""
from __future__ import annotations

from typing import Dict


def model_config(config: Dict):
    """The port's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig
    m = dict(config["model"])
    period = tuple(LayerSpec(**s) for s in m.pop("period"))
    moe = m.pop("moe", None)
    return ModelConfig(name=config["name"], period=period,
                       moe=None if moe is None else MoEConfig(**moe), **m)
