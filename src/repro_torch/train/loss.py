"""Cross-entropy loss with ignore-index masking and z-loss. Port of
``repro/train/loss.py``, and its counterpart over a mesh: the logits split
over the vocab on ``model`` and the tokens over the batch axes."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.models.params import TP_AXIS
from repro_torch.parallel.collectives import pmax, psum

IGNORE = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  z_loss: float = 1e-4, mesh=None,
                  batch_axes: Sequence[str] = ("data",)
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits (B,S,V) f32; labels (B,S) integer with IGNORE masking.
    Returns (ce + z-loss, stats); the stats are detached 0-d f32 tensors,
    every mean taken over n = max(#unmasked, 1) tokens.

    With ``mesh``, ``logits`` are this rank's block of the vocab over
    ``TP_AXIS`` (B_loc, S, V / n) and its rows its block over
    ``batch_axes``: the logsumexp is a pmax and a psum of exp sums, each
    label's logit comes from the rank that holds it, the argmax takes the
    lowest global index among ties, as ``argmax`` does, and the sums and n
    are added over the batch axes, so the loss and stats are the global
    batch's on every rank."""
    if mesh is None:
        return _cross_entropy(logits, labels, z_loss)
    mask = labels != IGNORE
    safe = torch.where(mask, labels, 0).long()
    vocab = mesh.live((TP_AXIS,))
    V = logits.shape[-1]
    lo = mesh.axis_index(vocab) * V
    top, arg = logits.detach().max(-1)
    peak = pmax(top, vocab, mesh)
    lse = torch.log(psum(torch.exp(logits - peak[..., None]).sum(-1), vocab,
                         mesh)) + peak
    local = safe - lo
    inside = (local >= 0) & (local < V)
    ll = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    ll = psum(torch.where(inside, ll, torch.zeros((), device=ll.device)),
              vocab, mesh)
    first = torch.where(top == peak, lo + arg, torch.full_like(arg, 2 ** 62))
    pred = -pmax(-first, vocab, mesh)
    sums = psum(torch.stack([
        ((lse - ll) * mask).sum(), (lse.square() * mask).sum(),
        ((pred == safe) & mask).sum().float(), mask.sum().float()]),
        batch_axes, mesh)
    n = sums[3].clamp(min=1)
    ce = sums[0] / n
    zl = z_loss * sums[1] / n
    stats = {"ce": ce, "z_loss": zl, "accuracy": sums[2] / n, "tokens": n}
    return ce + zl, {k: v.detach().float() for k, v in stats.items()}


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                   z_loss: float):
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
