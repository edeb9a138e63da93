"""The weights of a cell, drawn from the seed on the device in a few large
calls, in the program's leaf names.

Each kind of leaf is drawn for every layer that holds it at once, as one
stacked tensor, in the type it is used in (``serving`` draws matrices in
the model's compute dtype, the router and vectors in float32; training
draws every leaf in float32, as the master weights), and each layer's leaf
is a view of it. Layers whose leaf of one kind differs in shape (a dense
leading layer's ``ffn.w_in`` beside the expert layers') stack apart. The
same seed on the same device gives the same tensors, so a side can draw
them again instead of keeping a copy (:func:`groups`).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

from cellbench.harness.layers import Spec, specs

# the largest slice drawn by one call (a qwen2-moe expert stack is 8.3e9)
SLICE = 1 << 30

Group = Tuple[str, Tuple[int, ...], List[str], str, float]
Leaf = Tuple[str, Tuple[int, ...], str, float]      # kind, shape, init, std


def _mat(kind: str, shape: Tuple[int, ...], fan_in: int) -> Leaf:
    return (kind, shape, "normal", fan_in ** -0.5)


def _norm(kind: str, width: int) -> Leaf:
    return (kind, (width,), "norm", 0.05)


def _attn(m: Dict) -> Tuple[List[Leaf], List[Leaf]]:
    D, H, KV, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    mats = [_mat("mixer.wq", (D, H * hd), D),
            _mat("mixer.wkv", (D, 2 * KV * hd), D),
            _mat("mixer.wo", (H * hd, D), H * hd)]
    bias = []
    if m.get("qkv_bias"):
        bias = [("mixer.bq", (H * hd,), "bias", 0.02),
                ("mixer.bkv", (2 * KV * hd,), "bias", 0.02)]
    return mats, bias


def _mla(m: Dict) -> Tuple[List[Leaf], List[Leaf]]:
    D, H, a = m["d_model"], m["n_heads"], m["mla"]
    dn, dr, dv = a["qk_nope_head_dim"], a["qk_rope_head_dim"], a["v_head_dim"]
    R, QR = a["kv_lora_rank"], a.get("q_lora_rank", 0)
    out = [_mat("mixer.w_dkv", (D, R), D), _mat("mixer.w_kr", (D, dr), D),
           _mat("mixer.w_ukv", (R, H, dn + dv), R), _norm("mixer.kv_norm", R),
           _mat("mixer.w_o", (H, dv, D), H * dv)]
    if QR:
        out += [_mat("mixer.w_dq", (D, QR), D), _norm("mixer.q_norm", QR),
                _mat("mixer.w_uq", (QR, H, dn + dr), QR)]
    else:
        out += [_mat("mixer.w_q", (D, H, dn + dr), D)]
    return out, []


def _ffn(m: Dict, ffn: str) -> List[Leaf]:
    D = m["d_model"]
    if ffn == "none":
        return []
    if ffn == "dense":
        F = m["d_ff"]
        return [_mat("ffn.w_in", (D, 2 * F), D), _mat("ffn.w_out", (F, D), F)]
    moe = m["moe"]
    E = max(moe["n_experts"], moe.get("pad_to", 0))
    Fe = moe["d_ff_expert"]
    out = [_mat("ffn.router", (D, E), D),
           _mat("ffn.w_in", (E, D, 2 * Fe), D),
           _mat("ffn.w_out", (E, Fe, D), Fe)]
    if moe.get("n_shared"):
        Fs = moe["d_ff_shared"]
        out += [_mat("ffn.shared_w_in", (D, 2 * Fs), D),
                _mat("ffn.shared_w_out", (Fs, D), Fs)]
    return out


MIXERS = {"attn": _attn, "mla": _mla}


def layer_leaves(m: Dict, spec: Spec) -> List[Leaf]:
    """One layer's leaves in the order they are drawn: the mixer's norm and
    matrices, the FFN's norm, the mixer's biases, the FFN's leaves."""
    if spec.mixer not in MIXERS:
        raise ValueError(f"the harness draws no {spec.mixer!r} mixer; it "
                         f"draws {sorted(MIXERS)}")
    mats, bias = MIXERS[spec.mixer](m)
    norm = [] if spec.ffn == "none" or spec.parallel else [
        _norm("ffn_norm.scale", m["d_model"])]
    return ([_norm("mixer_norm.scale", m["d_model"])] + mats + norm + bias
            + _ffn(m, spec.ffn))


def layout(m: Dict) -> List[Group]:
    """(kind, stacked shape, leaf names, init, std) of every group of leaves
    of a configuration's ``model`` section: the embedding, unembedding and
    final norm, then each kind of layer leaf stacked over the layers that
    hold it at one shape, in the order the layers first hold it. ``init``
    is ``normal`` (std), ``norm`` (1 + std * normal) or ``bias`` (std *
    normal); a matrix takes std 1/sqrt(fan-in), its fan-in the widths a
    product with it sums over; the embedding and unembedding 0.02."""
    D, V = m["d_model"], m["vocab_size"]
    stacks: Dict[Leaf, List[str]] = {}
    for i, spec in enumerate(specs(m)):
        for leaf in layer_leaves(m, spec):
            stacks.setdefault(leaf, []).append(f"layers.{i}.{leaf[0]}")
    return [("embed.tok", (V, D), ["embed.tok"], "normal", 0.02),
            ("embed.unembed", (V, D), ["embed.unembed"], "normal", 0.02),
            ("out_norm.scale", (D,), ["out_norm.scale"], "norm", 0.05)] + [
        (kind, (len(names),) + shape, names, init, std)
        for (kind, shape, init, std), names in stacks.items()]


def stacked(kind: str) -> bool:
    """Whether a group's tensor stacks its leaves on a leading layer axis
    (every layer leaf, even one held by a single layer)."""
    return not kind.startswith(("embed.", "out_norm."))


def dtype_of(m: Dict, kind: str, shape: Tuple[int, ...], serving: bool
             ) -> torch.dtype:
    """float32 for training, and for a vector or the router when serving;
    the compute dtype for a served matrix."""
    per_leaf = len(shape) - stacked(kind)
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
           ) -> Iterator[List[Tuple[str, torch.Tensor]]]:
    """Each group's leaves as (name, tensor), the tensors views of the
    group's stacked one, drawn in turn from one generator seeded with
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for kind, shape, leaves, init, std in layout(m):
        t = torch.empty(shape, dtype=dtype_of(m, kind, shape, serving),
                        device=device)
        _fill(t, init, std, gen)
        yield list(zip(leaves, t.unbind(0))) if stacked(kind) else [
            (leaves[0], t)]


def draw(m: Dict, seed: int, device, serving: bool) -> Dict[str, torch.Tensor]:
    """Every leaf, each a view of its group's stacked tensor."""
    out: Dict[str, torch.Tensor] = {}
    for leaves in groups(m, seed, device, serving):
        out.update(leaves)
    return out
