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


def params(m: Dict) -> Dict[str, float]:
    """Parameters in matrix products: ``layer`` per layer as a token uses
    them (a MoE layer: the router, its top-k experts and the shared block),
    and ``unembed``."""
    D, H, KV, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn = D * H * hd + D * 2 * KV * hd + H * hd * D
    moe = m.get("moe")
    if moe is None:
        ffn = 3 * D * m["d_ff"]
    else:
        expert = 3 * D * moe["d_ff_expert"]
        shared = 3 * D * moe.get("d_ff_shared", 0)
        router = D * moe["n_experts"]
        ffn = router + moe["top_k"] * expert + shared
    return {"layer": attn + ffn, "unembed": m["vocab_size"] * D}


def attn_flops(m: Dict, pairs: float) -> float:
    """QK^T and PV of every layer over ``pairs`` (query, key) pairs."""
    return 4.0 * m["n_heads"] * m["head_dim"] * pairs * m["n_layers"]


def train_flops(m: Dict, rows: int, S: int) -> float:
    """Model FLOPs of one training step on ``rows`` sequences of S tokens:
    6 x (matrix parameters a token uses, the unembedding included, the
    embedding lookup not) x tokens, plus causal attention forward and
    backward (3 x its forward); no recompute."""
    p = params(m)
    n = p["layer"] * m["n_layers"] + p["unembed"]
    return 6.0 * n * rows * S + 3.0 * attn_flops(m, rows * causal_pairs(S))


def prefill_flops(m: Dict, L: int) -> float:
    """A prompt of L tokens: 2 x active parameters x L through the layers,
    attention over its causal pairs, and one row of logits."""
    p = params(m)
    return (2.0 * p["layer"] * m["n_layers"] * L + attn_flops(m, causal_pairs(L))
            + 2.0 * p["unembed"])


def decode_flops(m: Dict, context: int) -> float:
    """One generated token that attends to ``context`` keys (itself
    included): 2 x active parameters, attention, one row of logits."""
    p = params(m)
    return (2.0 * (p["layer"] * m["n_layers"] + p["unembed"])
            + attn_flops(m, context))
