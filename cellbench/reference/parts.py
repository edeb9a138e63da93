"""The model-independent parts of the plain references: float32 products
(and the e4m3 control's), RMSNorm, a SwiGLU FFN, a mixture of experts,
the language-model loss, AdamW with its schedule, a training loop over a
module's own loss, and a configuration's layer specs. A reference module
(``decoder.py`` and any added beside it) takes them by a relative import;
they import nothing of the program or of the harness.

Weights are the tensors the benchmark drew (``harness/weights.py``), named
as the program names them (matrices stored ``(in, out)``, a SwiGLU
``w_in`` as ``[gate | up]``), read in float32 at each use. Call
:func:`exact` before running a reference on a GPU, so that float32
products are not computed in TF32.

``mm`` is the one place a product of activations and weights is taken;
:func:`fp8_mm` replaces it for the control, which computes those products
from float8 (e4m3) operands.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, NamedTuple

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def exact() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.float()


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the absolute maximum mapped to 448), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` from e4m3 operands: x scaled per row, w per output column,
    products summed in float32. The gradient passes through the rounding
    unchanged (straight-through), as fp8 training does."""
    w = w.float()
    xq = x + (_fp8(x.detach(), -1) - x).detach()
    wq = w + (_fp8(w.detach(), 0) - w).detach()
    return xq @ wq


class Spec(NamedTuple):
    mixer: str
    ffn: str = "dense"
    parallel: bool = False


def layer_specs(m: Dict) -> List[Spec]:
    """Every layer's spec: the ``model`` section's ``prelayers``, then its
    ``period`` repeated to ``n_layers``."""
    pre = [Spec(**s) for s in m.get("prelayers", [])]
    period = [Spec(**s) for s in m.get("period", [{"mixer": "attn"}])]
    rest = m["n_layers"] - len(pre)
    if rest < 0 or rest % len(period):
        raise ValueError(f"n_layers {m['n_layers']} is not the prelayers "
                         f"and a whole number of periods")
    return pre + period * (rest // len(period))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def swiglu(h: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
           mm: MatMul) -> torch.Tensor:
    g, u = mm(h, w_in).chunk(2, dim=-1)
    return mm(F.silu(g) * u, w_out)


def experts(m: Dict, p: Params, pre: str, h: torch.Tensor,
            mm: MatMul) -> torch.Tensor:
    """The mixture of experts on h (S, D): each token's top-k experts by the
    router's softmax (float32), their outputs summed with those weights
    (renormalised over the k with ``norm_topk``), and the shared block."""
    moe = m["moe"]
    E = moe["n_experts"]
    probs = torch.softmax(h @ p[pre + "router"].float()[:, :E], dim=-1)
    top_p, top_i = torch.topk(probs, moe["top_k"], dim=-1)
    if moe.get("norm_topk"):
        top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in top_i.unique().tolist():
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        out = swiglu(h[rows], p[pre + "w_in"][e], p[pre + "w_out"][e], mm)
        y = y.index_add(0, rows, out * top_p[rows, slot][:, None])
    if moe.get("n_shared"):
        y = y + swiglu(h, p[pre + "shared_w_in"], p[pre + "shared_w_out"], mm)
    return y


def lm_loss(z: torch.Tensor, labels: torch.Tensor, z_loss: float
            ) -> torch.Tensor:
    """Mean cross-entropy of one sequence's logits z (S, V) plus ``z_loss``
    times the mean squared log-partition (the PaLM z-loss)."""
    lse = torch.logsumexp(z, dim=-1)
    ce = (lse - z.gather(-1, labels[:, None])[:, 0]).mean()
    return ce + z_loss * lse.square().mean()


def lr_at(opt: Dict, step: int) -> float:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine to
    ``lr * min_lr_ratio`` at ``total_steps``."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["lr"] * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"])
                        * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(opt: Dict, p: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          m1: Dict[str, torch.Tensor], v1: Dict[str, torch.Tensor],
          step: int) -> Dict[str, float]:
    """One AdamW step in place: the gradient clipped to ``clip_norm`` by the
    global norm, bias-corrected moments, decoupled weight decay on matrices
    (two or more dims). Returns each leaf's clipped gradient's norm."""
    gnorm = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
    scale = opt["clip_norm"] / (gnorm + 1e-9) if gnorm > opt["clip_norm"] else 1.0
    lr = lr_at(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    norms = {}
    for k, w in p.items():
        g = grads[k] * scale
        norms[k] = float(g.norm())
        m1[k].mul_(b1).add_(g, alpha=1 - b1)
        v1[k].mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (m1[k] / (1 - b1 ** step)) / ((v1[k] / (1 - b2 ** step)).sqrt()
                                          + opt["eps"])
        decay = opt["weight_decay"] if w.dim() >= 2 else 0.0
        w.sub_(lr * (u + decay * w))
    return norms


def train(loss: Callable, m: Dict, p: Dict[str, torch.Tensor], batches,
          opt: Dict, z_loss: float, mm: MatMul = f32_mm):
    """AdamW steps on ``p`` (float32 leaves, updated in place), one for each
    (tokens, labels) batch of (B, S) rows, the loss the mean over rows of
    ``loss(m, p, tokens, labels, z_loss, mm)`` (one row). Gradients
    accumulate one row at a time. Returns each step's loss and the norm of
    each leaf's clipped gradient at the first step."""
    m1 = {k: torch.zeros_like(w) for k, w in p.items()}
    v1 = {k: torch.zeros_like(w) for k, w in p.items()}
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        leaves = {k: w.detach().requires_grad_() for k, w in p.items()}
        total = 0.0
        for r in range(tokens.shape[0]):
            l = loss(m, leaves, tokens[r], labels[r], z_loss, mm) / tokens.shape[0]
            l.backward()
            total += float(l.detach())
        grads = {k: (w.grad if w.grad is not None else torch.zeros_like(w))
                 for k, w in leaves.items()}
        for w in leaves.values():
            w.grad = None
        norms = adamw(opt, p, grads, m1, v1, step)
        first = norms if first is None else first
        del grads, leaves
        losses.append(total)
    return losses, first
