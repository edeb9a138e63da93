"""The weights of a cell, drawn from the seed on the device in a few large
calls, in the program's leaf names.

Each kind of leaf is drawn for every layer at once as one stacked tensor,
in the type it is used in (``serving`` draws matrices in the model's
compute dtype, the router and vectors in float32; training draws every leaf
in float32, as the master weights), and each layer's leaf is a view of it.
The same seed on the same device gives the same tensors, so a side can draw
them again instead of keeping a copy (:func:`groups`).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

# the largest slice drawn by one call (a qwen2-moe expert stack is 8.3e9)
SLICE = 1 << 30

Group = Tuple[str, Tuple[int, ...], List[str], str, float]


def layout(m: Dict) -> List[Group]:
    """(kind, stacked shape, leaf names, init, std) of every group of leaves
    of a configuration's ``model`` section. ``init`` is ``normal`` (std),
    ``norm`` (1 + std * normal) or ``bias`` (std * normal); matrices take std
    1/sqrt(fan_in), the embedding and unembedding 0.02."""
    D, H, KV, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    V, n = m["vocab_size"], m["n_layers"]
    names = lambda s: [f"layers.{i}.{s}" for i in range(n)]   # noqa: E731
    out: List[Group] = [
        ("embed.tok", (V, D), ["embed.tok"], "normal", 0.02),
        ("embed.unembed", (V, D), ["embed.unembed"], "normal", 0.02),
        ("out_norm.scale", (D,), ["out_norm.scale"], "norm", 0.05),
        ("mixer_norm.scale", (n, D), names("mixer_norm.scale"), "norm", 0.05),
        ("mixer.wq", (n, D, H * hd), names("mixer.wq"), "normal", D ** -0.5),
        ("mixer.wkv", (n, D, 2 * KV * hd), names("mixer.wkv"), "normal",
         D ** -0.5),
        ("mixer.wo", (n, H * hd, D), names("mixer.wo"), "normal",
         (H * hd) ** -0.5),
        ("ffn_norm.scale", (n, D), names("ffn_norm.scale"), "norm", 0.05)]
    if m.get("qkv_bias"):
        out += [("mixer.bq", (n, H * hd), names("mixer.bq"), "bias", 0.02),
                ("mixer.bkv", (n, 2 * KV * hd), names("mixer.bkv"), "bias",
                 0.02)]
    moe = m.get("moe")
    if moe is None:
        F = m["d_ff"]
        out += [("ffn.w_in", (n, D, 2 * F), names("ffn.w_in"), "normal",
                 D ** -0.5),
                ("ffn.w_out", (n, F, D), names("ffn.w_out"), "normal",
                 F ** -0.5)]
        return out
    E = max(moe["n_experts"], moe.get("pad_to", 0))
    Fe = moe["d_ff_expert"]
    out += [("ffn.router", (n, D, E), names("ffn.router"), "normal",
             D ** -0.5),
            ("ffn.w_in", (n, E, D, 2 * Fe), names("ffn.w_in"), "normal",
             D ** -0.5),
            ("ffn.w_out", (n, E, Fe, D), names("ffn.w_out"), "normal",
             Fe ** -0.5)]
    if moe.get("n_shared"):
        Fs = moe["d_ff_shared"]
        out += [("ffn.shared_w_in", (n, D, 2 * Fs), names("ffn.shared_w_in"),
                 "normal", D ** -0.5),
                ("ffn.shared_w_out", (n, Fs, D), names("ffn.shared_w_out"),
                 "normal", Fs ** -0.5)]
    return out


def dtype_of(m: Dict, kind: str, shape: Tuple[int, ...], serving: bool
             ) -> torch.dtype:
    """float32 for training, and for a vector or the router when serving;
    the compute dtype for a served matrix."""
    per_leaf = len(shape) - (0 if kind.startswith(("embed.", "out_norm."))
                             else 1)
    if not serving or per_leaf < 2 or kind.endswith("router"):
        return torch.float32
    return getattr(torch, m["dtype"])


def _fill(t: torch.Tensor, init: str, std: float, gen: torch.Generator
          ) -> None:
    flat = t.view(-1)
    for i in range(0, flat.numel(), SLICE):
        part = flat[i:i + SLICE]
        part.normal_(0.0, std, generator=gen)
        if init == "norm":
            part.add_(1.0)


def groups(m: Dict, seed: int, device, serving: bool
           ) -> Iterator[Tuple[List[str], torch.Tensor]]:
    """Each group's leaf names and stacked tensor, drawn in turn from one
    generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for kind, shape, leaves, init, std in layout(m):
        t = torch.empty(shape, dtype=dtype_of(m, kind, shape, serving),
                        device=device)
        _fill(t, init, std, gen)
        yield leaves, t


def draw(m: Dict, seed: int, device, serving: bool) -> Dict[str, torch.Tensor]:
    """Every leaf, each a view of its group's stacked tensor."""
    out: Dict[str, torch.Tensor] = {}
    for leaves, t in groups(m, seed, device, serving):
        if len(leaves) == 1:
            out[leaves[0]] = t
        else:
            out.update(zip(leaves, t.unbind(0)))
    return out

