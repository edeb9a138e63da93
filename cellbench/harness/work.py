"""The yardstick's arithmetic: the H100's peaks, each kernel's operations
and bytes, and a model's FLOPs.

Frozen copies, so that a later change to the program cannot move them: the
peaks and the kernels' ``*_work`` formulas of ``repro_torch/launch/count.py``,
``kernels/flash_attention.py`` and ``kernels/rmsnorm.py``, and the
parameter arithmetic of ``benchmarks_torch/roofline_torch.py``. A kernel's
work counts each input byte read once and each output byte written once,
at the shapes it is called with (a serving prefill's padded rows, its keys
masked at the prompt's length: :func:`flash_fwd_masked`). A model's FLOPs
count what the request needs: a prompt at its own length.
"""
from __future__ import annotations

from typing import Dict, Tuple

from cellbench.harness.layers import specs

# NVIDIA H100 SXM5 data sheet, dense, at 700 W: bf16 tensor-core FLOP/s,
# float32 FLOP/s outside the tensor cores, HBM3 bytes/s
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12

Work = Tuple[float, float, float]        # (bytes, FLOPs, peak FLOP/s)


def causal_pairs(S: int) -> int:
    """(query, key) pairs of a causal sequence of S tokens."""
    return S * (S + 1) // 2


def flash_fwd(B: int, S: int, H: int, KV: int, D: int, el: int = 2) -> Work:
    """K1: q and o at H heads, k and v at KV heads; QK^T and PV."""
    return (el * (2 * B * S * H * D + 2 * B * S * KV * D),
            4.0 * H * D * B * causal_pairs(S), PEAK_BF16)


def flash_fwd_masked(S: int, L: int, H: int, KV: int, D: int,
                     el: int = 2) -> Work:
    """K1 on one sequence padded to S rows with its keys at or past L
    masked (a prefill of L tokens): q and o at all S rows, k and v read at
    their L valid rows; each of the first L rows attends causally, each of
    the S - L padded rows to all L keys. ``flash_fwd(1, S, ...)`` at L = S."""
    pairs = causal_pairs(L) + (S - L) * L
    return (el * (2 * S * H * D + 2 * L * KV * D), 4.0 * H * D * pairs,
            PEAK_BF16)


def flash_bwd(B: int, S: int, H: int, KV: int, D: int, el: int = 2) -> Work:
    """K1b (dq and dkdv): q, o, dO, dq at H heads, k, v, dk, dv at KV heads,
    lse and delta; five products over the pairs."""
    qb, kb, rows = B * S * H * D * el, B * S * KV * D * el, B * H * S * 4
    return (4 * qb + 4 * kb + 2 * rows,
            10.0 * H * D * B * causal_pairs(S), PEAK_BF16)


def norm_fwd(N: int, D: int, residual: bool, el: int = 2) -> Work:
    """K2 (K3 with ``residual``): x (and r) in, y (and the sum) out, the
    float32 scale; the norm's float32 operations."""
    return (el * (4 if residual else 2) * N * D + 4 * D,
            (5.0 if residual else 4.0) * N * D, PEAK_F32)


def norm_bwd(N: int, D: int, residual: bool, el: int = 2) -> Work:
    """K2b (K3b): x (or the sum), dy (and ds) in, dx out, w in, dw out."""
    return (el * (4 if residual else 3) * N * D + 8 * D, 8.0 * N * D,
            PEAK_F32)


def bound_s(work: Work) -> Tuple[float, str]:
    """The least time the chip could take, and what bounds it."""
    nbytes, flops, peak = work
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _mixer_params(m: Dict, mixer: str) -> int:
    """A mixer's matrix parameters as its sequence pass multiplies a token
    by them: MLA's query (``w_q``, or ``w_dq`` then ``w_uq``), its latent
    and rope-key projections, the latent's up-projection and ``w_o``."""
    D, H = m["d_model"], m["n_heads"]
    if mixer == "attn":
        KV, hd = m["n_kv_heads"], m["head_dim"]
        return D * H * hd + D * 2 * KV * hd + H * hd * D
    if mixer == "mla":
        a = m["mla"]
        dn, dr, dv = (a["qk_nope_head_dim"], a["qk_rope_head_dim"],
                      a["v_head_dim"])
        R, QR = a["kv_lora_rank"], a.get("q_lora_rank", 0)
        q = D * QR + QR * H * (dn + dr) if QR else D * H * (dn + dr)
        return q + D * R + D * dr + R * H * (dn + dv) + H * dv * D
    raise ValueError(f"the harness counts no {mixer!r} mixer")


def _ffn_params(m: Dict, ffn: str) -> int:
    """An FFN's matrix parameters a token uses: a dense SwiGLU at ``d_ff``;
    a MoE layer's router, its top-k experts and the shared block."""
    D = m["d_model"]
    if ffn == "none":
        return 0
    if ffn == "dense":
        return 3 * D * m["d_ff"]
    moe = m["moe"]
    expert = 3 * D * moe["d_ff_expert"]
    shared = 3 * D * moe.get("d_ff_shared", 0)
    router = D * moe["n_experts"]
    return router + moe["top_k"] * expert + shared


def params(m: Dict) -> Dict[str, int]:
    """Parameters in matrix products as a token uses them: ``layers``, over
    every layer by its spec, and ``unembed``."""
    return {"layers": sum(_mixer_params(m, s.mixer) + _ffn_params(m, s.ffn)
                          for s in specs(m)),
            "unembed": m["vocab_size"] * m["d_model"]}


def _count(items) -> Dict:
    """How many layers give each item, in the order of first appearance."""
    out: Dict = {}
    for x in items:
        out[x] = out.get(x, 0) + 1
    return out


def attn_shapes(m: Dict) -> Dict[Tuple[int, int, int], int]:
    """The (query heads, key/value heads, head dim) K1 and K1b are called
    at in each attention layer, with the number of layers at each: a GQA
    layer's own; MLA's (H, H, dn + dr), its keys rebuilt for every head
    and V padded to dn + dr (``models/mla.py``), since a kernel's work
    counts what it is called with."""
    def shape(mixer):
        if mixer == "attn":
            return (m["n_heads"], m["n_kv_heads"], m["head_dim"])
        a = m["mla"]
        return (m["n_heads"], m["n_heads"],
                a["qk_nope_head_dim"] + a["qk_rope_head_dim"])
    return _count(shape(s.mixer) for s in specs(m)
                  if s.mixer in ("attn", "mla"))


def norm_calls(m: Dict) -> Dict[Tuple[int, bool], int]:
    """The RMSNorm calls of one pass over a row, as {(width, residual):
    calls}: each layer's mixer norm (K2) and, before a sequential FFN, the
    residual add and norm (K3) at ``d_model``; an MLA layer's ``q_norm``
    at ``q_lora_rank`` where it has one and ``kv_norm`` at
    ``kv_lora_rank``; the final norm."""
    D = m["d_model"]
    calls = []
    for s in specs(m):
        calls.append((D, False))
        if s.mixer == "mla":
            a = m["mla"]
            if a.get("q_lora_rank", 0):
                calls.append((a["q_lora_rank"], False))
            calls.append((a["kv_lora_rank"], False))
        if s.ffn != "none" and not s.parallel:
            calls.append((D, True))
    return _count(calls + [(D, False)])


def _attn_coef(m: Dict, mixer: str) -> float:
    """FLOPs of one layer's attention a (query, key) pair: QK^T and PV,
    MLA's at dn + dr and dv, as the model needs them."""
    if mixer == "attn":
        return 4.0 * m["n_heads"] * m["head_dim"]
    if mixer == "mla":
        a = m["mla"]
        return (2.0 * m["n_heads"] * (a["qk_nope_head_dim"]
                                      + a["qk_rope_head_dim"])
                + 2.0 * m["n_heads"] * a["v_head_dim"])
    return 0.0


def attn_flops(m: Dict, pairs: float) -> float:
    """QK^T and PV of every layer over ``pairs`` (query, key) pairs."""
    return sum(c * pairs * n for c, n in
               _count(_attn_coef(m, s.mixer) for s in specs(m)).items())


def train_flops(m: Dict, rows: int, S: int) -> float:
    """Model FLOPs of one training step on ``rows`` sequences of S tokens:
    6 x (matrix parameters a token uses, the unembedding included, the
    embedding lookup not) x tokens, plus causal attention forward and
    backward (3 x its forward); no recompute."""
    p = params(m)
    n = p["layers"] + p["unembed"]
    return 6.0 * n * rows * S + 3.0 * attn_flops(m, rows * causal_pairs(S))


def prefill_flops(m: Dict, L: int) -> float:
    """A prompt of L tokens: 2 x active parameters x L through the layers,
    attention over its causal pairs, and one row of logits."""
    p = params(m)
    return (2.0 * p["layers"] * L + attn_flops(m, causal_pairs(L))
            + 2.0 * p["unembed"])


def decode_flops(m: Dict, context: int) -> float:
    """One generated token that attends to ``context`` keys (itself
    included): 2 x active parameters, attention, one row of logits."""
    p = params(m)
    return (2.0 * (p["layers"] + p["unembed"])
            + attn_flops(m, context))
