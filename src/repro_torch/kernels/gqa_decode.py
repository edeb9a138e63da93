"""GQA decode attention over the KV cache: ``csrc/gqa_decode.cu`` on the
card, beside its plain version.

One decode step's attention: q (B, H, HD) against caches (B, S, KV, HD),
head h reading KV head h // (H // KV), ``lengths`` (B,) counting each row's
valid positions (a count past S counts S). The kernel reads the bf16 cache
where it lies (any 16-byte aligned strides with a contiguous head dim) and
only up to each row's length, in chunks of keys spread over blocks
(:func:`key_chunk`), in two launches: the scores, then the weighted sum of
V, each chunk's with the chunks' merge by the last of a row. Its numbers
are the plain version's: products of the operands in f32 (exact for bf16),
f32 sums, scale 1/sqrt(HD), a max-subtracted softmax in f32, the weights
rounded to the cache's dtype before the PV product, PV in f32, the output
rounded to q's dtype; only the order of the f32 sums differs. Positions
past a row's length weigh exact zeros in the plain version (scores of
-1e30), so skipping them changes nothing; a row of length 0 attends to all
S positions with equal weight, as there.

On CPU tensors :func:`gqa_decode` computes :func:`gqa_decode_plain`, for
any float dtype; on CUDA tensors it launches the kernels (bf16 caches, as
the model's are, an f32 or bf16 q, int32 or int64 lengths) or raises; on
``meta`` it allocates what the CUDA path allocates (the output and the f32
scratch, planned for the H100's SMs) and launches nothing.
Under an active counter (``launch/count.py``) a call records
:func:`gqa_decode_work` once, K and V counted at S (no lengths are known
to a dry run).
``gqa_decode.launches`` counts the calls that launched the kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import NEG_INF, _in_place
from repro_torch.launch import count

HEAD_DIMS = (16, 64, 128)
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256
# keys of K a block reads in one chunk at most: 128 KB, 512 keys at HD 128
# in bf16; halved down to MIN_CHUNK keys while the chunks of B x KV rows at
# their full S would give an SM fewer than ITEMS_PER_SM, since a row's
# live keys are a part of S
CHUNK_BYTES = 128 * 1024
MIN_CHUNK = 64
ITEMS_PER_SM = 24
# blocks of a pass over the cache an SM: the grid walks the live chunks
BLOCKS_PER_SM = 8
# chunk * G floats: a block's scores in shared memory (csrc kMaxScores)
MAX_SCORES = 8192
# rows whose lengths every block stages to list the live chunks (kMaxRows)
MAX_ROWS = 512

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k, v, lengths, out, scratch, strides, B, S, H, KV, HD, chunk,
    # blocks, len64, q dtype, stream
    "gqa_decode": [_P] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    + [_I] * 9 + [_P],
}


def gqa_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B,H,HD); caches: (B,S,KV,HD); lengths (B,) = #valid positions
    (including the token just written). Grouped GQA, full softmax."""
    B, H, HD = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, HD).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) / math.sqrt(HD)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    s = torch.where(kpos[None, None, None, :] < lengths[:, None, None, None],
                    s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, H, HD).to(q.dtype)


def gqa_decode_work(B: int, S: int, H: int, KV: int, HD: int,
                    q_dtype: torch.dtype, cache_dtype: torch.dtype
                    ) -> count.Work:
    """(bytes, FLOPs, dtype) of one call with K and V at all S positions:
    q read and o written at H heads, K and V read once at KV heads; QK and
    PV at every (head, position), f32 products."""
    qe, ce = (torch.finfo(d).bits // 8 for d in (q_dtype, cache_dtype))
    return (2 * B * H * HD * qe + 2 * B * S * KV * HD * ce,
            4.0 * B * H * S * HD, torch.float32)


def groups(HD: int) -> int:
    """Query heads a block can take at once: its (position, head) groups,
    one of HD * 2 / 16 threads each (16 bytes of the bf16 cache a
    thread)."""
    return THREADS * 8 // HD


def key_chunk(B: int, KV: int, G: int, S: int, HD: int, sms: int) -> int:
    """Keys a chunk holds, of S split into ceil(S / chunk) chunks: the
    largest power of two with at most :data:`CHUNK_BYTES` of bf16 K (and G
    heads' scores within :data:`MAX_SCORES`), halved down to
    :data:`MIN_CHUNK` while B x KV x chunks would give each of ``sms`` SMs
    fewer than :data:`ITEMS_PER_SM`; at most S."""
    chunk = min(CHUNK_BYTES // (HD * 2), MAX_SCORES // G)
    chunk = max(MIN_CHUNK, 1 << (chunk.bit_length() - 1))
    while (chunk > MIN_CHUNK
           and B * KV * -(-S // chunk) < ITEMS_PER_SM * sms):
        chunk //= 2
    return min(chunk, S)


def scratch_floats(B: int, S: int, H: int, HD: int, KV: int,
                   splits: int) -> int:
    """f32 scratch of one call: each head's chunk max and sum, its scores,
    each chunk's partial output, and a count of the chunks done for each
    (row, KV head)."""
    return B * H * (2 * splits + S + splits * HD) + B * KV


def _check(q, k, v, lengths) -> None:
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"gqa_decode runs on cpu, cuda or meta tensors, "
                         f"got {q.device}")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B,H,HD) and the caches (B,S,KV,HD), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, H, HD = q.shape
    S, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, S, KV, HD) or v.shape != k.shape or H % KV:
        raise ValueError(f"caches {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if HD not in HEAD_DIMS:
        raise ValueError(f"gqa_decode has no kernel for head dim {HD} "
                         f"(built for {HEAD_DIMS})")
    if (q.dtype not in _Q_DTYPES or k.dtype != torch.bfloat16
            or v.dtype != k.dtype):
        raise TypeError(f"gqa_decode takes a float32 or bfloat16 q and "
                        f"bfloat16 caches, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if H // KV > groups(HD):
        raise ValueError(f"{H // KV} query heads a KV head: a block takes at "
                         f"most {groups(HD)} at head dim {HD}")
    if lengths.dtype not in (torch.int32, torch.int64) or tuple(
            lengths.shape) != (B,):
        raise ValueError(f"lengths must be int32 or int64 of shape ({B},), "
                         f"got {lengths.dtype} {tuple(lengths.shape)}")
    for t in (k, v, lengths):
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
    if B > MAX_ROWS:
        raise ValueError(f"batch {B}: the kernels stage at most {MAX_ROWS} "
                         f"rows")


def _kernel(q, k, v, lengths) -> torch.Tensor:
    _check(q, k, v, lengths)
    B, H, HD = q.shape
    S, KV = k.shape[1], k.shape[2]
    if q.stride(-1) != 1:
        q = q.contiguous()
    (k, ks), (v, vs) = _in_place(k), _in_place(v)
    lengths = lengths.contiguous()
    meta = q.device.type == "meta"
    sms = (count.H100_SMS if meta else torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    chunk = key_chunk(B, KV, H // KV, S, HD, sms)
    out = torch.empty(B, H, HD, dtype=q.dtype, device=q.device)
    scratch = torch.empty(scratch_floats(B, S, H, HD, KV, -(-S // chunk)),
                          dtype=torch.float32, device=q.device)
    if meta:
        return out
    strides = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), *ks, *vs)
    lib = build.load("gqa_decode", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.gqa_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), strides, B, S, H, KV, HD,
            chunk, BLOCKS_PER_SM * sms, int(lengths.dtype == torch.int64),
            _Q_DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "gqa_decode")
    gqa_decode.launches += 1
    return out


def _decode(q, k_cache, v_cache, lengths) -> torch.Tensor:
    if q.device.type == "cpu":
        return gqa_decode_plain(q, k_cache, v_cache, lengths)
    return _kernel(q, k_cache, v_cache, lengths)


def gqa_decode(q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The decode attention of :func:`gqa_decode_plain`, with its contract:
    the kernels on the card, the plain version on the CPU."""
    c = count.ACTIVE
    if c is None:
        return _decode(q, k_cache, v_cache, lengths)
    B, H, HD = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    with c.kernel("gqa_decode", gqa_decode_work(B, S, H, KV, HD, q.dtype,
                                                k_cache.dtype)):
        return _decode(q, k_cache, v_cache, lengths)


gqa_decode.launches = 0
