"""A configuration's layers, as the port's ``ModelConfig.layer_specs`` lists
them: the ``model`` section's ``prelayers``, then its ``period`` repeated
to ``n_layers``. Each spec is a :class:`Spec`, with the port's
``LayerSpec`` defaults filled in; the harness draws, counts and reads
every layer by its spec."""
from __future__ import annotations

from typing import Dict, List, NamedTuple


class Spec(NamedTuple):
    mixer: str                   # attn | mla | mamba | mlstm | slstm
    ffn: str = "dense"           # dense | moe | none
    parallel: bool = False       # mixer and FFN on one norm, side by side


def specs(m: Dict) -> List[Spec]:
    """Every layer's spec in order. Raises ``ValueError`` where
    ``n_layers`` is not the prelayers and a whole number of periods."""
    pre = [Spec(**s) for s in m.get("prelayers", [])]
    period = [Spec(**s) for s in m.get("period", [{"mixer": "attn"}])]
    rest = m["n_layers"] - len(pre)
    if rest < 0 or rest % len(period):
        raise ValueError(f"n_layers {m['n_layers']} is not {len(pre)} "
                         f"prelayers and a whole number of "
                         f"{len(period)}-layer periods")
    return pre + period * (rest // len(period))
