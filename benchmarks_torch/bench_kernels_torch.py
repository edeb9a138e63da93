"""Kernel bench of the PyTorch port: snapshot, gate and tuning sweep.

The port's counterpart of ``benchmarks/bench_kernels.py``, in H100 terms:

  python benchmarks_torch/bench_kernels_torch.py
      Run every point through the port's public wrappers (so the committed
      tuning table, ``src/repro_torch/kernels/autotune_table.json``, is used
      end to end) and write the ``BENCH_kernels_torch.json`` snapshot.
  python benchmarks_torch/bench_kernels_torch.py --check
      Run a fresh snapshot and hold it to the committed one: exit 0 (ok),
      1 (a violation) or 2 (no committed snapshot). A violation is an error
      over its tolerance, an exact comparison that failed, a point's choice
      or ``from_table`` that differs from the committed snapshot's (the
      table and the snapshot must agree), a point missing on either side,
      or a cold time below the bound (``frac_of_bound`` over 1.05, which
      no card can read). Times are reported, not gated.
  python benchmarks_torch/bench_kernels_torch.py --tune
      Sweep each choice the wrappers make at run time (the f32 forward's
      key split, the norm variant, the paged cache's page) at the points
      and at every config's norm width at 8 and 512 rows, pick by cold
      device time, and rewrite the table. An entry is written only where
      the winner beats the default rule by more than the spread of three
      repeats and gives the default's outputs bit for bit on the sweep's
      inputs.

Each runs on the card; ``--device cpu`` runs the same plumbing on the CPU at
small shapes through the plain versions, with times fabricated as twice
each point's bound. A point records its error against the plain version in
the unit of its bar (``err_unit``), its device time by CUDA-graph replay on
the same inputs (``device_ms``, as ``chip_smoke.py``'s ``time_ms``), the
same with the inputs rotated over copies of at least 100 MB, twice the
H100's 50 MB L2 (``cold_ms``), the least time the card could take
(``bound_ms``: the bytes each call must move over the HBM rate, or its
operations over the peak rate for its type, whichever is larger) and
``frac_of_bound`` = bound / cold.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np                                              # noqa: E402
import torch                                                    # noqa: E402

from repro_torch.configs import get_config, list_archs          # noqa: E402
from repro_torch.device import card, resolve_device             # noqa: E402
from repro_torch.kernels import autotune                        # noqa: E402
from repro_torch.launch.count import (                          # noqa: E402
    H100_SMS, HBM_BYTES_PER_S, PEAK_FLOPS)
from repro_torch.models.attention import (                      # noqa: E402
    decode_attention_ref, write_kv_cache)
from repro_torch.parallel.decode_attn import (                  # noqa: E402
    PagedKVCache, paged_decode_attention, paged_write_kv)

# the wrappers' modules (the package exports functions of these names)
FA = importlib.import_module("repro_torch.kernels.flash_attention")
RMS = importlib.import_module("repro_torch.kernels.rmsnorm")
DEFAULT_OUT = os.path.join(ROOT, "BENCH_kernels_torch.json")
COLD_BYTES = 100e6         # twice the H100's 50 MB L2
FRAC_LIMIT = 1.05          # a cold time this far under the bound is wrong
WARM_ITERS = 50
REPEATS = 3
SEED = 0
BF16, F32 = torch.bfloat16, torch.float32
FLASH_TOL = {BF16: 3e-2, F32: 3e-5}
NORM_TOL = 1e-5            # f32; bf16 norms within one bf16 ulp
BWD_REL = {"dq": 2e-5, "dk": 2e-5, "dv": 1e-3}   # chip_smoke.py phase 7
DW_REL = 1e-5


class Point:
    """One bench point: ``kind`` names the function, ``dims`` its shape on
    the card and ``small`` the shape the CPU smoke takes instead."""

    def __init__(self, name: str, kind: str, dims: dict, small: dict):
        self.name, self.kind, self.dims, self.small = name, kind, dims, small

    def at(self, small: bool) -> dict:
        return dict(self.dims, **self.small) if small else self.dims


def _flash(name, kind, B, S, H, KV, D, dtype, small):
    return Point(name, kind, dict(B=B, S=S, H=H, KV=KV, D=D, dtype=dtype),
                 small)


def _norm(name, kind, N, D, dtype):
    return Point(name, kind, dict(N=N, D=D, dtype=dtype),
                 dict(N=min(N, 24), D=min(D, 256)))


POINTS: Tuple[Point, ...] = (
    # JAX's five (benchmarks/bench_kernels.py), at its shapes; its flash
    # takes k/v at the query heads
    _flash("flash_b1h2s512d128_bf16", "flash", 1, 512, 2, 2, 128, BF16,
           dict(S=64)),
    _flash("flash_b1h2s384d64_f32", "flash", 1, 384, 2, 2, 64, F32,
           dict(S=48)),
    _norm("rmsnorm_4096x1024_bf16", "rmsnorm", 4096, 1024, BF16),
    _norm("rmsnorm_1000x512_f32", "rmsnorm", 1000, 512, F32),
    Point("decode_b4h8s256d64", "decode",
          dict(B=4, H=8, S=256, HD=64, KV=4, dtype=F32,
               lengths=[37, 255, 128, 5]),
          dict(S=64, lengths=[9, 63, 32, 1])),
    # the main path's shapes (PERF.md section 6): tacc-100m serving and
    # training, deepseek-v2's prefill at head dim 192
    _flash("flash_serve_bf16", "flash", 1, 512, 12, 4, 64, BF16, dict(S=64)),
    _flash("flash_serve_f32", "flash", 1, 512, 12, 4, 64, F32, dict(S=64)),
    _flash("flash_train_bf16", "flash", 16, 128, 12, 4, 64, BF16,
           dict(B=2, S=32)),
    _flash("flash_train_f32", "flash", 16, 128, 12, 4, 64, F32,
           dict(B=2, S=32)),
    _flash("flash_d192_bf16", "flash", 1, 512, 128, 128, 192, BF16,
           dict(S=32, H=4, KV=4)),
    _norm("rmsnorm_512x768_bf16", "rmsnorm", 512, 768, BF16),
    _norm("rmsnorm_2048x768_bf16", "rmsnorm", 2048, 768, BF16),
    _norm("rmsnorm_residual_512x768_bf16", "rmsnorm_residual", 512, 768,
          BF16),
    _norm("rmsnorm_residual_2048x768_bf16", "rmsnorm_residual", 2048, 768,
          BF16),
    _flash("flash_bwd_train_bf16", "flash_bwd", 16, 128, 12, 4, 64, BF16,
           dict(B=2, S=32)),
    _norm("rmsnorm_bwd_2048x768_bf16", "rmsnorm_bwd", 2048, 768, BF16),
    _norm("rmsnorm_residual_bwd_2048x768_bf16", "rmsnorm_residual_bwd", 2048,
          768, BF16),
)
TUNE_ROWS = (8, 512)


def config_widths() -> List[int]:
    """Every width a registered config normalizes: d_model, and MLA's
    q and kv latent widths."""
    widths = set()
    for arch in list_archs():
        cfg = get_config(arch)
        widths.add(cfg.d_model)
        if cfg.mla is not None:
            widths.update((cfg.mla.q_lora_rank, cfg.mla.kv_lora_rank))
    return sorted(widths)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def _graph(calls: Sequence[Callable[[], object]]) -> torch.cuda.CUDAGraph:
    """The calls captured in order into one CUDA graph, after a warm-up of
    each outside the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    return graph


def _replay_ms(graph: torch.cuda.CUDAGraph, calls: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn: Callable[[], object], iters: int = WARM_ITERS) -> float:
    """Device time of one call: ``iters`` calls on the same inputs captured
    in one CUDA graph, replayed and timed by CUDA events."""
    return _replay_ms(_graph([fn] * iters), iters)


class Cold:
    """One call rotated over copies of its inputs that total at least
    COLD_BYTES, so that each call reads its inputs from HBM and not from
    L2: ``ms()`` replays the captured rotation once, timed."""

    def __init__(self, bases: List[torch.Tensor],
                 call: Callable[[List[torch.Tensor]], object]):
        per = sum(t.numel() * t.element_size() for t in bases)
        self.copies = max(2, math.ceil(COLD_BYTES / per))
        self.bytes = per * self.copies
        # the graph reads these: they live as long as it does
        self.sets = [bases] + [[t.clone() for t in bases]
                               for _ in range(self.copies - 1)]
        self.calls = self.copies * math.ceil(WARM_ITERS / self.copies)
        thunks = [lambda s=self.sets[i % self.copies]: call(s)
                  for i in range(self.calls)]
        self.graph = _graph(thunks)

    def ms(self) -> float:
        return _replay_ms(self.graph, self.calls)


# ---------------------------------------------------------------------------
# Kinds: inputs, call, check, bound, choice
# ---------------------------------------------------------------------------

def _randn(rng: np.random.RandomState, shape, dtype, device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(device=device, dtype=dtype)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(1e-30)))
    return torch.pow(2.0, e - 7)


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _norm_err(y: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float, str]:
    """(error, tolerance, unit) of a normed output: bf16 in ulps of the
    plain value (bar 1), f32 absolute (bar 1e-5)."""
    if y.dtype == BF16:
        return (float(((y.float() - ref.float()).abs() / _bf16_ulp(ref))
                      .max()), 1.0, "bf16 ulp")
    return _max_abs(y, ref), NORM_TOL, "abs"


def _bar_share(g: torch.Tensor, ref: torch.Tensor, rel: float) -> float:
    """A gradient's share of chip_smoke.py phase 7's bar (pass <= 1): past
    one bf16 ulp of each value (bf16) the least share of max(|ref|, 1) it
    needs, over the bar's ``rel``."""
    scale = max(float(ref.float().abs().max()), 1.0)
    d = (g.float() - ref.float()).abs()
    if g.dtype == BF16:
        d = (d - _bf16_ulp(ref)).clamp(min=0)
    return float(d.max()) / scale / rel


def _sms(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


class FlashKind:
    """K1 through ``flash_attention``: causal, k/v strided views of one
    (B, S, 2, KV, D) tensor as ``project_qkv`` gives them."""

    def bases(self, d, device, rng):
        B, S, H, KV, D = d["B"], d["S"], d["H"], d["KV"], d["D"]
        return [_randn(rng, (B, S, H, D), d["dtype"], device),
                _randn(rng, (B, S, 2, KV, D), d["dtype"], device)]

    @staticmethod
    def qkv(b):
        return b[0], b[1][:, :, 0], b[1][:, :, 1]

    def call(self, b):
        return FA.flash_attention(*self.qkv(b), causal=True)

    def check(self, b, out):
        ref = FA.flash_attention_plain(*self.qkv(b), causal=True)
        err = _max_abs(out, ref)
        return err, err, FLASH_TOL[out.dtype], "abs", {}

    def work(self, d):
        return FA.flash_work(d["B"], d["S"], d["H"], d["KV"], d["D"],
                             d["dtype"])

    def plan(self, d, device, table):
        n, hit = autotune.plan_key_splits(
            d["B"], d["S"], d["H"], FA._kernel_head_dim(d["D"]), d["dtype"],
            _sms(device), table)
        return f"splits={n}", hit

    def launched(self):
        return f"splits={FA.flash_attention.splits}"


class FlashBwdKind(FlashKind):
    """K1b-dq then K1b-dkdv through ``flash_attention_bwd`` on the kernel
    forward's o and lse (the plain forward's on the CPU)."""

    def bases(self, d, device, rng):
        q, kv = super().bases(d, device, rng)
        do = _randn(rng, q.shape, d["dtype"], device)
        fwd = FA._forward if device.type == "cuda" else \
            (lambda q, k, v, c, ln, _: FA._plain_forward(q, k, v, c, ln))
        o, lse = fwd(q, kv[:, :, 0], kv[:, :, 1], True, None, True)
        return [q, kv, o, lse, do]

    def call(self, b):
        return FA.flash_attention_bwd(*self.qkv(b), *b[2:], causal=True)

    def check(self, b, out):
        ref = FA.flash_attention_bwd_plain(*self.qkv(b), *b[2:], causal=True)
        share = max(_bar_share(g, r, BWD_REL[n])
                    for n, g, r in zip(("dq", "dk", "dv"), out, ref))
        err = max(_max_abs(g, r) for g, r in zip(out, ref))
        return share, err, 1.0, "share of phase 7's bar", {}

    def work(self, d):
        return FA.flash_bwd_work(d["B"], d["S"], d["H"], d["KV"], d["D"],
                                 d["dtype"])

    def plan(self, d, device, table):
        return "splits=1", False

    def launched(self):
        return "splits=1"


def _vector(d: dict) -> bool:
    """Whether rows of this point take the 16-byte norm variants (its
    tensors are fresh allocations, so every base is aligned)."""
    return d["D"] * (torch.finfo(d["dtype"]).bits // 8) % 16 == 0


class NormKind:
    """K2 (``rmsnorm``) or K3 (``rmsnorm_residual``) forward, eps 1e-5."""

    def __init__(self, residual: bool):
        self.residual = residual

    def bases(self, d, device, rng):
        N, D, dt = d["N"], d["D"], d["dtype"]
        xs = [_randn(rng, (N, D), dt, device)
              for _ in range(2 if self.residual else 1)]
        return xs + [_randn(rng, (D,), F32, device)]

    def call(self, b):
        if self.residual:
            return RMS.rmsnorm_residual(b[0], b[1], b[2])
        return RMS.rmsnorm(b[0], b[1])

    def check(self, b, out):
        if self.residual:
            (y, s), (ry, rs) = out, RMS.rmsnorm_residual_plain(*b)
            exact = {"sum_bit_equal": bool(torch.equal(s, rs))}
        else:
            y, ry, exact = out, RMS.rmsnorm_plain(*b), {}
        err, tol, unit = _norm_err(y, ry)
        return err, _max_abs(y, ry), tol, unit, exact

    def work(self, d):
        return RMS.norm_work(d["N"], d["D"], d["dtype"], self.residual)

    def plan(self, d, device, table):
        v, hit = autotune.plan_rmsnorm_rows(d["N"], d["D"], d["dtype"],
                                            _vector(d), table)
        return RMS.VARIANTS[v], hit

    def launched(self):
        fn = RMS.rmsnorm_residual if self.residual else RMS.rmsnorm
        return fn.variant


class NormBwdKind(NormKind):
    """K2b (``rmsnorm_bwd``) or K3b (``rmsnorm_residual_bwd``): dx (dt) and
    dw in one launch; the variant is always ``pick_variant``'s."""

    def bases(self, d, device, rng):
        N, D, dt = d["N"], d["D"], d["dtype"]
        x, w = _randn(rng, (N, D), dt, device), _randn(rng, (D,), F32, device)
        grads = [_randn(rng, (N, D), dt, device)
                 for _ in range(2 if self.residual else 1)]
        return [x, w] + grads

    def call(self, b):
        if self.residual:
            return RMS.rmsnorm_residual_bwd(*b)
        return RMS.rmsnorm_bwd(*b)

    def check(self, b, out):
        plain = (RMS.rmsnorm_residual_bwd_plain if self.residual
                 else RMS.rmsnorm_bwd_plain)
        (dx, dw), (rdx, rdw) = out, plain(*b)
        share = max(_bar_share(dx, rdx, BWD_REL["dq"]),
                    _max_abs(dw, rdw) / (DW_REL * float(rdw.abs().max())))
        return (share, max(_max_abs(dx, rdx), _max_abs(dw, rdw)), 1.0,
                "share of phase 7's bar", {})

    def work(self, d):
        return RMS.norm_bwd_work(d["N"], d["D"], d["dtype"], self.residual)

    def plan(self, d, device, table):
        return RMS.VARIANTS[RMS.variant_for(d["D"], _vector(d))], False

    def launched(self):
        fn = RMS.rmsnorm_residual_bwd if self.residual else RMS.rmsnorm_bwd
        return fn.variant


class DecodeKind:
    """The paged decode: a dense (B, S, KV, HD) cache scattered into pages
    through block tables, one new token written at each sequence's length
    (``paged_write_kv``), then ``paged_decode_attention``; held to the
    dense ``write_kv_cache`` + ``decode_attention_ref`` bit for bit, as
    JAX's bench holds its own."""

    def __init__(self, page: Optional[int] = None):
        self.page = page            # the tune sweep's; else the plan's

    def inputs(self, d, device, rng, page):
        """q, the dense cache, the new k/v and the lengths, drawn in JAX's
        bench's order, then the pools and block tables; returns the bases
        (q, k_pages, v_pages, block tables, lengths + 1) and the dense
        reference output."""
        B, H, S, HD, KV, dt = (d["B"], d["H"], d["S"], d["HD"], d["KV"],
                               d["dtype"])
        q = _randn(rng, (B, H, HD), dt, device)
        kc, vc = (_randn(rng, (B, S, KV, HD), dt, device) for _ in range(2))
        kn, vn = (_randn(rng, (B, KV, HD), dt, device) for _ in range(2))
        ln = torch.tensor(d["lengths"], dtype=torch.int32, device=device)
        cache = PagedKVCache(num_pages=2 * B * (S // page), page_size=page,
                             num_kv_heads=KV, head_dim=HD,
                             pages_per_seq=S // page, dtype=dt, device=device)
        for b in range(B):
            cache.reserve(b)
        bt = cache.block_tables(range(B))
        kp, vp = cache.k_pages, cache.v_pages
        kp[bt.reshape(-1).long()] = kc.reshape(B * (S // page), page, KV, HD)
        vp[bt.reshape(-1).long()] = vc.reshape(B * (S // page), page, KV, HD)
        paged_write_kv(kp, vp, kn, vn, bt, ln)
        kc2, vc2 = write_kv_cache(kc.clone(), vc.clone(), kn, vn, ln)
        ref = decode_attention_ref(q, kc2, vc2, ln + 1)
        return [q, kp, vp, bt, ln + 1], ref

    def bases(self, d, device, rng):
        page = self.page or autotune.plan_decode_page(
            (d["B"], d["H"], d["S"], d["HD"]), d["dtype"])[0]
        bases, self.ref = self.inputs(d, device, rng, page)
        return bases

    def call(self, b):
        return paged_decode_attention(*b)

    def check(self, b, out):
        err = _max_abs(out, self.ref)
        return err, err, 0.0, "abs", {"bit_equal_to_dense":
                                      bool(torch.equal(out, self.ref))}

    def work(self, d):
        el = torch.finfo(d["dtype"]).bits // 8
        used = sum(n + 1 for n in d["lengths"])   # this run's valid rows
        nbytes = el * (2 * d["KV"] * d["HD"] * used
                       + 2 * d["B"] * d["H"] * d["HD"])
        return nbytes, 4.0 * d["H"] * d["HD"] * used, d["dtype"]

    def plan(self, d, device, table):
        page, hit = autotune.plan_decode_page(
            (d["B"], d["H"], d["S"], d["HD"]), d["dtype"], table)
        return f"page={page}", hit

    def launched(self):
        return None


KINDS = {"flash": FlashKind, "flash_bwd": FlashBwdKind,
         "rmsnorm": lambda: NormKind(False),
         "rmsnorm_residual": lambda: NormKind(True),
         "rmsnorm_bwd": lambda: NormBwdKind(False),
         "rmsnorm_residual_bwd": lambda: NormBwdKind(True),
         "decode": DecodeKind}


def bound(nbytes: int, flops: float, dtype: torch.dtype) -> Tuple[float, str]:
    """The least time (ms) the card could take, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _jsonable(d: dict) -> dict:
    return {k: autotune.dtype_name(v) if isinstance(v, torch.dtype) else v
            for k, v in d.items()}


def run_point(point: Point, device: torch.device,
              table: autotune.AutotuneTable, timed: bool = True) -> Dict:
    """One point under ``table``: its choice, errors and, ``timed``, its
    times and bound. On the card, the choice the wrapper recorded as
    launched must be the plan's."""
    small = device.type != "cuda"
    d = point.at(small)
    kind = KINDS[point.kind]()
    rng = np.random.RandomState(SEED)
    with autotune.override(table):
        bases = kind.bases(d, device, rng)
        out = kind.call(bases)
        choice, hit = kind.plan(d, device, table)
        if device.type == "cuda":
            torch.cuda.synchronize()
            launched = kind.launched()
            if launched is not None and launched != choice:
                raise AssertionError(f"{point.name}: the wrapper launched "
                                     f"{launched}, its plan says {choice}")
        err, abs_err, tol, unit, exact = kind.check(bases, out)
        result = {"kind": point.kind, **_jsonable(d), "choice": choice,
                  "from_table": bool(hit), "max_err": err, "tol": tol,
                  "err_unit": unit, "max_abs_err": abs_err, "exact": exact}
        if not timed:
            return result
        nbytes, flops, peak = kind.work(d)
        b_ms, b_by = bound(nbytes, flops, peak)
        if device.type == "cuda":
            warm = device_ms(lambda: kind.call(bases))
            cold = Cold(bases, kind.call)
            cold_ms, copies, cold_bytes = cold.ms(), cold.copies, cold.bytes
            del cold
        else:                       # no device: fabricated, twice the bound
            warm = cold_ms = 2 * b_ms
            copies, cold_bytes = 0, 0
    return {**result, "device_ms": warm, "cold_ms": cold_ms,
            "cold_copies": copies, "cold_bytes": cold_bytes, "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "frac_of_bound": b_ms / cold_ms}


def snapshot(table_path: str = autotune.DEFAULT_TABLE_PATH,
             device="cuda", verbose: bool = True) -> Dict:
    """Every point through the wrappers under the table at ``table_path``."""
    dev = resolve_device(device)
    table = autotune.AutotuneTable.load(table_path)
    points = {}
    for p in POINTS:
        points[p.name] = r = run_point(p, dev, table)
        if verbose:
            print(f"{p.name}: {r['choice']} from_table={r['from_table']} "
                  f"max_err={r['max_err']:.3g} (tol {r['tol']:g} "
                  f"{r['err_unit']}) device_ms={r['device_ms']:.6g} "
                  f"cold_ms={r['cold_ms']:.6g} bound_ms={r['bound_ms']:.6g} "
                  f"({r['bound_by']}) frac_of_bound="
                  f"{r['frac_of_bound']:.4g}", flush=True)
    on_card = dev.type == "cuda"
    return {"bench": "bench_kernels_torch", "device": dev.type,
            "card": card(dev),
            "torch": torch.__version__, "sms": _sms(dev),
            "timing": ("CUDA graph replay; cold: inputs rotated over >= "
                       f"{COLD_BYTES / 1e6:g} MB of copies" if on_card else
                       "fabricated on the CPU: twice each point's bound"),
            "table_entries": len(table.entries), "points": points}


def violations(name: str, r: Dict) -> List[str]:
    """What is wrong with one point's result on its own: an error over its
    tolerance, a failed exact comparison, a cold time under the bound."""
    out = []
    if r["max_err"] > r["tol"]:
        out.append(f"{name}: max_err {r['max_err']:.3g} over tol "
                   f"{r['tol']:g} ({r['err_unit']})")
    out += [f"{name}: {k} failed" for k, ok in r["exact"].items() if not ok]
    if r.get("frac_of_bound", 0.0) > FRAC_LIMIT:
        out.append(f"{name}: frac_of_bound {r['frac_of_bound']:.4g} over "
                   f"{FRAC_LIMIT} (faster than the card can be)")
    return out


def check(fresh: Dict, committed: Dict) -> List[str]:
    """The gate's violations of a fresh snapshot against the committed one
    (empty: ok)."""
    out = []
    new, old = fresh["points"], committed["points"]
    for name in sorted(set(old) - set(new)):
        out.append(f"{name}: in the committed snapshot, not in the fresh one")
    for name, r in sorted(new.items()):
        out += violations(name, r)
        if name not in old:
            out.append(f"{name}: not in the committed snapshot")
            continue
        for k in ("choice", "from_table"):
            if r[k] != old[name][k]:
                out.append(f"{name}: {k} {r[k]!r}, committed {old[name][k]!r}"
                           f" (table and snapshot disagree)")
    return out


def entry_points(key: str, choice: Sequence[int]) -> List[Tuple[Point, str]]:
    """Points that run a table entry at its bucket's own shape, each with
    the choice its plan must name: K1 f32 with k/v at the query heads, K2
    and K3 (both take a norm entry), the paged decode."""
    kernel, dtype, dims = key.split("|")
    dt, dims = getattr(torch, dtype), [int(n) for n in dims.split("x")]
    if kernel == "flash_attention":
        B, H, S, D = dims
        return [(_flash(key, "flash", B, S, H, H, D, dt, {}),
                 f"splits={choice[0]}")]
    if kernel == "rmsnorm":
        N, D = dims
        return [(Point(key, kind, dict(N=N, D=D, dtype=dt), {}),
                 RMS.VARIANTS[choice[0]])
                for kind in ("rmsnorm", "rmsnorm_residual")]
    B, H, S, HD = dims
    lengths = [(S - 1) * (b + 1) // B for b in range(B)]
    return [(Point(key, "decode", dict(B=B, H=H, S=S, HD=HD, KV=H, dtype=dt,
                                       lengths=lengths), {}),
             f"page={choice[0]}")]


# ---------------------------------------------------------------------------
# Tune sweep
# ---------------------------------------------------------------------------

def _sweep(label: str, candidates: Sequence, default, build, say
           ) -> Tuple[object, bool]:
    """Cold device time of each candidate (and of ``default``, a candidate
    whether or not an entry could name it), REPEATS times, interleaved; the
    winner, and whether it makes an entry: it beats ``default`` by more
    than the spread and gives ``default``'s outputs bit for bit on the
    sweep's inputs. A choice that rounds otherwise makes a model round
    differently in two layouts whose rows fall in different buckets (a
    mesh rank's rows and the whole batch's): entries of the norm variant
    at 512 rows moved chip_smoke.py phase 18's least MoE gradient cosine
    against one process under its bar. ``build(c)`` gives a candidate's
    (timer, outputs) pairs."""
    candidates = sorted(set(candidates) | {default})
    arms = {c: build(c) for c in candidates}
    reps = {c: [] for c in candidates}
    for _ in range(REPEATS):
        for c in candidates:
            reps[c].append(sum(t.ms() for t, _ in arms[c]))
    med = {c: float(np.median(v)) for c, v in reps.items()}
    win = min(candidates, key=lambda c: med[c])
    spread = max(max(reps[c]) - min(reps[c]) for c in (win, default))
    same = all(torch.equal(a, b) for (_, x), (_, y) in
               zip(arms[win], arms[default]) for a, b in zip(x, y))
    del arms
    faster = win != default and med[default] - med[win] > spread
    say(f"{label}: " + ", ".join(f"{c}: {med[c]:.6g}" for c in candidates)
        + f" ms; default {default}, winner {win}, spread {spread:.3g}"
        + (" -> entry" if faster and same else
           " -> no entry (its outputs differ from the default's)" if faster
           else " -> no entry"))
    return win, faster and same


def tune(table_path: str = autotune.DEFAULT_TABLE_PATH, device="cuda",
         say=print) -> autotune.AutotuneTable:
    """Rewrite the table from a sweep on ``device`` (see the module doc)."""
    dev = resolve_device(device)
    small = dev.type != "cuda"
    table = autotune.AutotuneTable()

    def colds(kind, d, probe):
        """A cold rotation of ``kind`` at ``d`` under ``probe`` (on the CPU a
        fabricated constant time) and its outputs on the first inputs."""
        with autotune.override(probe):
            bases = kind.bases(d, dev, np.random.RandomState(SEED))
            out = kind.call(bases)
            out = out if isinstance(out, tuple) else (out,)
            if small:
                return [(_Fixed(bound(*kind.work(d))[0]), out)]
            return [(Cold(bases, kind.call), out)]

    for p in POINTS:
        d = p.at(small)
        if p.kind != "flash" or d["dtype"] != F32:
            continue
        B, S, H, D = d["B"], d["S"], d["H"], FA._kernel_head_dim(d["D"])
        default = FA.key_splits(B, S, H, F32, _sms(dev))

        def build(n, d=d, B=B, S=S, H=H, D=D):
            probe = autotune.AutotuneTable()
            probe.record("flash_attention", F32, (B, H, S, D), [n])
            return colds(FlashKind(), d, probe)
        win, keep = _sweep(p.name, autotune.key_split_candidates(S),
                              default, build, say)
        if keep:
            table.record("flash_attention", F32, (B, H, S, D), [win])
    shapes = {(p.at(small)["N"], p.at(small)["D"], p.at(small)["dtype"])
              for p in POINTS if p.kind in ("rmsnorm", "rmsnorm_residual")}
    widths = [min(w, 256) for w in config_widths()] if small else \
        config_widths()
    shapes |= {(n, w, BF16) for w in widths for n in TUNE_ROWS}
    for N, D, dt in sorted(shapes, key=lambda s: (str(s[2]), s[1], s[0])):
        d = dict(N=N, D=D, dtype=dt)
        vector = _vector(d)
        default = RMS.variant_for(D, vector)

        def build(v, d=d, N=N, D=D, dt=dt):
            probe = autotune.AutotuneTable()
            probe.record("rmsnorm", dt, (N, D), [v])
            # K2 and K3 both take the entry: time them together
            return colds(NormKind(False), d, probe) + \
                colds(NormKind(True), d, probe)
        win, keep = _sweep(
            f"rmsnorm {N}x{D} {autotune.dtype_name(dt)}",
            autotune.rmsnorm_variant_candidates(D, vector), default, build,
            say)
        if keep:
            table.record("rmsnorm", dt, (N, D), [win])
    p = next(p for p in POINTS if p.kind == "decode")
    d = p.at(small)
    shape = (d["B"], d["H"], d["S"], d["HD"])
    default = autotune.plan_decode_page(shape, d["dtype"],
                                        autotune.AutotuneTable())[0]
    win, keep = _sweep(
        p.name, autotune.decode_page_candidates(d["S"]), default,
        lambda page: colds(DecodeKind(page), d, autotune.AutotuneTable()),
        say)
    if keep:
        table.record("decode_attention", d["dtype"], shape, [win])
    table.save(table_path)
    say(f"wrote {table_path} ({len(table.entries)} entries)")
    return table


class _Fixed:
    """A fabricated cold time (the CPU smoke of the sweep)."""

    def __init__(self, ms: float):
        self._ms = ms

    def ms(self) -> float:
        return self._ms


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--tune", action="store_true",
                      help="sweep the run-time choices and rewrite the table")
    mode.add_argument("--check", action="store_true",
                      help="hold a fresh snapshot to the committed one")
    ap.add_argument("--table", default=autotune.DEFAULT_TABLE_PATH,
                    help="tuning table path")
    ap.add_argument("--out", default=None,
                    help="snapshot path (default BENCH_kernels_torch.json; "
                         "with --check, where to write the fresh one)")
    ap.add_argument("--baseline", default=DEFAULT_OUT,
                    help="the committed snapshot --check holds to")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plumbing at small "
                         "shapes, times fabricated")
    args = ap.parse_args(argv)
    if args.tune:
        tune(args.table, args.device)
        return 0
    if args.check and not os.path.exists(args.baseline):
        resolve_device(args.device)
        print(f"no committed snapshot at {args.baseline}")
        return 2
    snap = snapshot(args.table, args.device)
    out = args.out or (None if args.check else DEFAULT_OUT)
    if out:
        with open(out, "w", encoding="utf-8") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {out}")
    print(f"card: {snap['card']}")
    if not args.check:
        return 0
    with open(args.baseline, encoding="utf-8") as f:
        committed = json.load(f)
    bad = check(snap, committed)
    for line in bad:
        print(f"VIOLATION {line}")
    print(f"check: {len(snap['points'])} points, {len(bad)} violations")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
