"""The program under test, as the harness sees it: its model configuration
built from a configuration file's ``model`` section. The port is imported
here and in the kinds' modules only, inside functions, so that the
harness's other files (and its tests) load without it."""
from __future__ import annotations

from typing import Dict


def model_config(config: Dict):
    """The port's ``ModelConfig`` for a configuration file: ``prelayers``
    and ``period`` as ``LayerSpec`` tuples, and each sub-config (``moe``,
    ``mla``, ``mamba``, ``xlstm``) as its dataclass."""
    from repro_torch.configs.base import (LayerSpec, MambaConfig,
                                          MLAConfig, ModelConfig, MoEConfig,
                                          XLSTMConfig)
    subs = {"moe": MoEConfig, "mla": MLAConfig, "mamba": MambaConfig,
            "xlstm": XLSTMConfig}
    m = dict(config["model"])
    for key in ("prelayers", "period"):
        if key in m:
            m[key] = tuple(LayerSpec(**s) for s in m[key])
    for key, cls in subs.items():
        if m.get(key) is not None:
            m[key] = cls(**m[key])
    return ModelConfig(name=config["name"], **m)
