"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the plain reference works out from the same inputs.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Mapping, Sequence

import torch


def token_gaps(ref_logits: torch.Tensor, served: Sequence[int]) -> List[float]:
    """By how much each served token's reference logit lies below the
    reference's best at its position: ``ref_logits`` (n, V), one row per
    served token."""
    idx = torch.as_tensor(list(served), device=ref_logits.device)
    best = ref_logits.max(-1).values
    return (best - ref_logits.gather(-1, idx[:, None])[:, 0]).tolist()


def leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
             leaves: Iterable[str] = None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger (some are all but zero)."""
    names = list(ref if leaves is None else leaves)
    floor = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in names)


def moved_leaves(first_grad: Mapping[str, float], share: float = 1e-3
                 ) -> List[str]:
    """The leaves whose first clipped gradient in the reference is at least
    ``share`` of the median leaf's: the rest move by round-off alone."""
    floor = share * statistics.median(first_grad.values())
    return [k for k, v in first_grad.items() if v >= floor]


def within(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number finite and at or under its limit."""
    return bool(checks) and all(
        c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values())
