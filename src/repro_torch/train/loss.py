"""Cross-entropy loss with ignore-index masking and z-loss. Port of
``repro/train/loss.py``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

IGNORE = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  z_loss: float = 1e-4
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits (B,S,V) f32; labels (B,S) integer with IGNORE masking.
    Returns (ce + z-loss, stats); the stats are detached 0-d f32 tensors,
    every mean taken over n = max(#unmasked, 1) tokens."""
    mask = labels != IGNORE
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - ll) * mask
    n = mask.sum().clamp(min=1)
    ce = nll.sum() / n
    zl = z_loss * (lse.square() * mask).sum() / n
    acc = ((logits.argmax(-1) == safe) & mask).sum() / n
    stats = {"ce": ce, "z_loss": zl, "accuracy": acc,
             "tokens": n.to(torch.float32)}
    return ce + zl, {k: v.detach().float() for k, v in stats.items()}
