#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: every kernel under src/repro_torch/kernels/csrc/ with nvcc;
   HGMMA (wgmma) in the SASS of both bf16 flash-attention kernels, and
   128-bit global loads and stores in every 16-byte rmsnorm kernel;
3. kernels: each kernel against its plain PyTorch version at the serving
   shapes of tacc-100m (k/v as strided views of one tensor, as the model
   gives them), with its time, the plain version's, one PyTorch library
   call's where there is one, and its bound on this card; flash attention
   also at its edges (a row with no valid key, a ragged tile at a batch
   boundary, head dim 128), the norms at theirs (one row, a ragged last
   block, a row or base off 16 bytes, rows of 1536, 2048, 8192 and 16384),
   each with the variant the wrapper launched; and the launch floor, an
   empty kernel's time;
4. consistency: full-width tacc-100m, prefill + 4 decode steps against the
   full forward, and a prefill against the plain path on the CPU;
5. serve: ServeEngine(max_batch=8, max_seq=512) serves 16 requests; every
   kernel's launch count must move;
6. profile: torch.profiler over 8 prefills and 16 decode steps, for the
   time the card is busy and idle.

Then one ``{"kernels": [...]}`` line with each kernel's launches in phase 5,
and the last line ``{"ok": true, "device": {...}}``. Exits non-zero, before
printing anything, when no CUDA card is present.
"""
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import (build, flash_attention, flash_attention_plain,
                                 rmsnorm, rmsnorm_plain, rmsnorm_residual,
                                 rmsnorm_residual_plain)
from repro_torch.kernels.rmsnorm import launch_empty
from repro_torch.models import (Transformer, cast_for_compute, decode_step,
                                init_params, prefill, train_logits)
from repro_torch.serve import ServeEngine

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s,
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

MAX_BATCH, MAX_SEQ = 8, 512
N_REQUESTS, MAX_NEW = 16, 32
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 50) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed and timed by CUDA events, so host dispatch is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int = 50) -> float:
    """Time of one call issued from Python, back to back, by CUDA events:
    what the serving loop pays, host dispatch included."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, flops: float, dtype: torch.dtype):
    """The least time (ms) the card could take, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 1 ---------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "it runs on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit({"phase": "device", **dev, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return dev


# -- phase 2 ---------------------------------------------------------------

def kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel: the flash kernels as
    ``flash_fwd_wgmma<bf16, 64>``, the norm kernels as
    ``rmsnorm_kernel<bf16, residual=1, V=8, NV=8, warp>``, others by their
    mangled name."""
    m = re.search(r"(flash_fwd_[a-z]+)I(f?)Li(\d+)E", mangled)
    if m:
        return (f"{m.group(1)}<{'float' if m.group(2) else 'bf16'}, "
                f"{m.group(3)}>")
    m = re.search(r"rmsnorm_kernelI(f|\d+__nv_bfloat16)Lb([01])ELi(\d+)E"
                  r"Li(\d+)ELb([01])E", mangled)
    if m:
        return (f"rmsnorm_kernel<{'float' if m.group(1) == 'f' else 'bf16'}, "
                f"residual={m.group(2)}, V={m.group(3)}, NV={m.group(4)}, "
                f"{'wide' if m.group(5) == '1' else 'warp'}>")
    return mangled


def sass(library: str) -> dict:
    """The SASS of each kernel of a built library, by readable name."""
    out = subprocess.run(
        [build.tool("cuobjdump"), "--dump-sass",
         str(build.library_path(library))],
        capture_output=True, text=True, check=True).stdout
    return {kernel_name(part.split("\n", 1)[0].strip()): part
            for part in out.split("Function : ")[1:]}


def hgmma_counts() -> dict:
    """HGMMA (wgmma) instructions in the SASS of each flash-attention kernel
    of the built library. Fails unless both bf16 instantiations have them,
    so a kernel that lost its tensor cores cannot pass."""
    counts = {n: text.count("HGMMA")
              for n, text in sass("flash_attention").items()}
    bf16 = {n: c for n, c in counts.items() if "<bf16," in n}
    if len(bf16) != 2 or not all(bf16.values()):
        raise AssertionError(f"the bf16 flash kernels lack HGMMA: {counts}")
    return counts


def wide_access_counts() -> dict:
    """128-bit global loads and stores (LDG/STG with .128) in the SASS of
    each rmsnorm kernel. Fails unless the bf16 warp-per-row kernels of K2
    and K3 are there and every kernel with 16-byte accesses (V > 1) has
    both, so a kernel that lost its vectors cannot pass."""
    counts = {n: {op: len(re.findall(rf"\b{op}(?:\.\w+)*?\.128\b", text))
                  for op in ("LDG", "STG")}
              for n, text in sass("rmsnorm").items()}
    vector = {n: c for n, c in counts.items()
              if n.startswith("rmsnorm_kernel<") and "V=1," not in n}
    warp = [n for n in vector if "<bf16," in n and n.endswith("warp>")]
    if (not any("residual=0" in n for n in warp)
            or not any("residual=1" in n for n in warp)
            or not all(c["LDG"] and c["STG"] for c in vector.values())):
        raise AssertionError(f"the 16-byte rmsnorm kernels lack 128-bit "
                             f"loads or stores: {counts}")
    return counts


def ptxas_report(report: str) -> dict:
    """ptxas's registers, spills and performance warnings, by kernel."""
    out, name = {}, "?"
    for ln in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "registers" in ln or "spill" in ln or "Performance" in ln:
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    reports = build.build_all()
    seconds = time.perf_counter() - t0
    emit({"phase": "build", "seconds": seconds,
          "ptxas": {name: ptxas_report(rep) for name, rep in reports.items()},
          "hgmma": hgmma_counts(), "ldst128": wide_access_counts()})


# -- phase 3 ---------------------------------------------------------------

def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(1e-30)))
    return torch.pow(2.0, e - 7)


def flash_case(dtype, lengths_list, *, causal=True, S=MAX_SEQ, D=None,
               timed=True):
    cfg = get_config("tacc-100m")
    B, H, KV = len(lengths_list), cfg.n_heads, cfg.n_kv_heads
    D = D or cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    # k/v as project_qkv gives them: strided views of one (B,S,2,KV,D) tensor
    kv = torch.randn(B, S, 2, KV, D, generator=g, device="cuda").to(dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    o = flash_attention(q, k, v, causal=causal, lengths=lengths)
    ref = flash_attention_plain(q, k, v, causal=causal, lengths=lengths)
    torch.cuda.synchronize()
    tol = 3e-2 if dtype == torch.bfloat16 else 3e-5
    err = max_err(o, ref)
    case = {"dtype": str(dtype).split(".")[-1], "q": list(q.shape),
            "kv": list(k.shape), "lengths": lengths_list, "causal": causal,
            "max_abs_err": err, "tol": tol}
    if not (torch.isfinite(o.float()).all() and err <= tol):
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: {case}")
    if not timed:
        return case
    # operations this data needs: QK^T and PV over the keys each row attends
    qpos = np.arange(S)
    keys = sum(int(np.minimum(qpos + 1, n).sum()) if causal and n > 0
               else S * (n if n > 0 else S) for n in lengths_list)
    flops = 4.0 * keys * H * D
    b_ms, b_by = bound(nbytes(q, k, v, o, lengths), flops, dtype)
    kpos = torch.arange(S, device="cuda")
    mask = kpos[None, None, None, :] < lengths[:, None, None, None]
    if causal:
        mask = mask & (kpos[:, None] >= kpos[None, :])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kernel = lambda: flash_attention(q, k, v, causal=causal,  # noqa: E731
                                     lengths=lengths)
    case.update(
        ms=time_ms(kernel), call_ms=call_ms(kernel),
        plain_ms=time_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, lengths=lengths), iters=10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        library="F.scaled_dot_product_attention(attn_mask, enable_gqa=True)",
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes(q, k, v, o, lengths),
        flops=flops)
    return case


def _norm_within_bar(y: torch.Tensor, ref: torch.Tensor):
    """Whether a normed output is within K2's and K3's bar of its plain
    version, and the bar: one bf16 ulp in bf16, 1e-5 in f32."""
    if y.dtype == torch.bfloat16:
        return (bool(((y.float() - ref.float()).abs() <= _bf16_ulp(ref)).all()),
                "1 bf16 ulp")
    return max_err(y, ref) <= 1e-5, 1e-5


def rms_case(dtype, rows, residual: bool, *, D=None, offset=0, timed=True):
    """One case of K2 (``residual`` False) or K3: rows of D (tacc-100m's
    d_model by default), x at ``offset`` elements into its storage. K3's
    sum must equal its plain version's bit for bit, and its normed output
    is held to K2's bar against the plain norm of that sum."""
    D = D or get_config("tacc-100m").d_model
    g = torch.Generator(device="cuda").manual_seed(SEED + rows + D)
    x = torch.randn(offset + rows * D, generator=g,
                    device="cuda").to(dtype)[offset:].view(rows, D)
    r = torch.randn(rows, D, generator=g, device="cuda").to(dtype)
    w = torch.randn(D, generator=g, device="cuda")
    eps = 1e-5
    case = {"dtype": str(dtype).split(".")[-1], "x": [rows, D],
            "x_offset_bytes": offset * x.element_size()}
    if residual:
        (y, s), (ry, rs) = (rmsnorm_residual(x, r, w, eps),
                            rmsnorm_residual_plain(x, r, w, eps))
        torch.cuda.synchronize()
        ok, tol = _norm_within_bar(y, ry)
        ok = ok and torch.equal(s, rs)
        case.update(variant=rmsnorm_residual.variant,
                    max_abs_err=max_err(y, ry), tol=tol,
                    sum_bit_equal=bool(torch.equal(s, rs)))
        kernel, plain, library, lib_name = (
            lambda: rmsnorm_residual(x, r, w, eps),
            lambda: rmsnorm_residual_plain(x, r, w, eps), None, None)
        moved, flops = nbytes(x, r, w, y, s), 5.0 * x.numel()
    else:
        y, ry = rmsnorm(x, w, eps), rmsnorm_plain(x, w, eps)
        torch.cuda.synchronize()
        ok, tol = _norm_within_bar(y, ry)
        case.update(variant=rmsnorm.variant, max_abs_err=max_err(y, ry),
                    tol=tol)
        wx = w.to(dtype)                # F.rms_norm fuses only for one dtype
        kernel, plain, library, lib_name = (
            lambda: rmsnorm(x, w, eps), lambda: rmsnorm_plain(x, w, eps),
            lambda: F.rms_norm(x, (D,), wx, eps),
            "F.rms_norm (weight in the input dtype)")
        moved, flops = nbytes(x, w, y), 4.0 * x.numel()
    ok = ok and bool(torch.isfinite(y.float()).all())
    if not ok:
        raise AssertionError(f"{'rmsnorm_residual' if residual else 'rmsnorm'}"
                             f" disagrees with its plain version: {case}")
    if not timed:
        return case
    b_ms, b_by = bound(moved, flops, torch.float32)
    case.update(ms=time_ms(kernel), call_ms=call_ms(kernel),
                plain_ms=time_ms(plain),
                library_ms=time_ms(library) if library else None,
                library=lib_name, bound_ms=b_ms, bound_by=b_by, bytes=moved,
                flops=flops,
                # one read and one write of x by PyTorch's copy kernel: what
                # any kernel that reads and writes rows this size costs here
                copy_ms=time_ms(lambda: torch.empty_like(x).copy_(x)))
    return case


def rms_cases(residual: bool, floor: float) -> list:
    """K2's or K3's cases: the timed serving shapes first, then the edges,
    each variant, and the JAX suite's shapes, in both dtypes."""
    bf16, f32 = torch.bfloat16, torch.float32
    timed = [rms_case(dt, n, residual) for dt in (bf16, f32)
             for n in (MAX_SEQ, MAX_BATCH)]
    for c in timed:
        c["floor_ms"] = floor
    edges = [(1, {}), (13, {}),                      # a ragged last block
             (MAX_BATCH, {"D": 770}),                 # row bytes off 16
             (MAX_BATCH, {"offset": 1}),              # base 2 or 4 bytes off
             # every warp-layout width kept (1536, 2048), then the wide one
             (MAX_BATCH, {"D": 1536}), (MAX_BATCH, {"D": 2048}),
             (MAX_BATCH, {"D": 8192}), (MAX_BATCH, {"D": 16384}),
             (100, {"D": 384}), (8, {"D": 128})]      # tests/test_kernels.py
    return timed + [rms_case(dt, rows, residual, timed=False, **kw)
                    for dt in (bf16, f32) for rows, kw in edges]


KERNELS = [
    # (wrapper, source, TPU kernel it replaces)
    (flash_attention, "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:82"),
    (rmsnorm, "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "src/repro/kernels/rmsnorm.py:32"),
    (rmsnorm_residual, "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "src/repro/kernels/rmsnorm.py:51"),
]


def phase_kernels() -> dict:
    bf16, f32 = torch.bfloat16, torch.float32
    floor = time_ms(launch_empty)
    cases = {
        "flash_attention": [
            flash_case(bf16, [MAX_SEQ]),          # a full 512-token prefill
            flash_case(bf16, [136]),              # serve prompts' expected length
            flash_case(f32, [MAX_SEQ]),
            flash_case(bf16, [MAX_SEQ], D=128),
            flash_case(bf16, [37, 0], timed=False),
            flash_case(f32, [300, 1], timed=False),
            flash_case(bf16, [MAX_SEQ], causal=False, timed=False),
            flash_case(f32, [100], S=200, timed=False),   # ragged tile edge
            # a ragged tile edge at a batch boundary: a store past S would
            # land in the next batch's rows
            flash_case(bf16, [200, 150], S=200, timed=False),
            # eight rows with lengths at and around tile edges
            flash_case(bf16, [1, 64, 65, 512, 0, 300, 511, 128], timed=False),
            flash_case(bf16, [1], S=1, timed=False),
            flash_case(bf16, [200, 512], D=128, timed=False),
            flash_case(f32, [77], S=300, D=128, timed=False),
            flash_case(bf16, [77], S=300, D=128, timed=False),
        ],
        "rmsnorm": rms_cases(False, floor),
        "rmsnorm_residual": rms_cases(True, floor),
    }
    emit({"phase": "kernels", "floor_ms": floor, "cases": cases})
    return cases


# -- phase 4 ---------------------------------------------------------------

def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-6)


def phase_consistency(cfg, params) -> dict:
    B, S, NDEC = 2, 128, 4
    model = Transformer(cfg, cast_for_compute(cfg, params, "cuda"),
                        device="cuda")
    rng = np.random.RandomState(SEED)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    out = {"phase": "consistency", "batch": B, "seq": S}
    with torch.inference_mode():
        full = train_logits(model, {"tokens": toks})
        if not (torch.isfinite(full).all()
                and full.shape == (B, S, cfg.vocab_size)):
            raise AssertionError(f"full forward: shape {tuple(full.shape)}, "
                                 f"finite {bool(torch.isfinite(full).all())}")
        Sp = S - NDEC
        pt = F.pad(toks[:, :Sp], (0, NDEC))
        lengths = torch.full((B,), Sp, dtype=torch.int32, device="cuda")
        lg, cache = prefill(model, {"tokens": pt}, lengths)
        out["prefill_vs_full"] = rel_err(lg, full[:, Sp - 1])
        out["decode_vs_full"] = []
        for i in range(NDEC):
            lg, cache = decode_step(model, cache, toks[:, Sp + i])
            out["decode_vs_full"].append(rel_err(lg, full[:, Sp + i]))
        # the same weights through the plain path on the CPU
        lens1 = torch.tensor([Sp - 21], dtype=torch.int32)
        lg_gpu, _ = prefill(model, {"tokens": toks[:1]}, lens1.cuda())
        cpu_model = Transformer(cfg, cast_for_compute(cfg, params, "cpu"),
                                device="cpu")
        lg_cpu, _ = prefill(cpu_model, {"tokens": toks[:1].cpu()}, lens1)
        out["prefill_vs_cpu_plain"] = rel_err(lg_gpu, lg_cpu)
    out["bars"] = {"prefill_vs_full": 0.05, "decode_vs_full": 0.08,
                   "prefill_vs_cpu_plain": 0.03}
    emit(out)
    if not (out["prefill_vs_full"] < 0.05
            and max(out["decode_vs_full"]) < 0.08
            and out["prefill_vs_cpu_plain"] < 0.03):
        raise AssertionError(f"full-width consistency failed: {out}")
    return out


# -- phase 5 ---------------------------------------------------------------

def phase_serve(cfg, params) -> dict:
    engine = ServeEngine(cfg, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                         seed=SEED, device="cuda")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab_size, rng.randint(16, 257)).tolist()
               for _ in range(N_REQUESTS)]
    for fn, _, _ in KERNELS:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run(prompts, max_new=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn, _, _ in KERNELS}
    tokens = sum(len(r.tokens) for r in results)
    pf, dc = engine.timings["prefill"], engine.timings["decode"]
    out = {"phase": "serve", "requests": len(results), "tokens": tokens,
           "prompt_tokens": sum(len(p) for p in prompts),
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "prefills": len(pf), "prefill_ms_mean": 1e3 * float(np.mean(pf)),
           "prefill_ms_p50": 1e3 * float(np.median(pf)),
           "decode_steps": len(dc), "decode_step_ms_mean": 1e3 * float(np.mean(dc)),
           "decode_step_ms_p50": 1e3 * float(np.median(dc)),
           "launches": launches}
    emit(out)
    ok = (len(results) == N_REQUESTS and all(r.done for r in results)
          and all(len(r.tokens) == MAX_NEW for r in results)
          and all(0 <= t < cfg.vocab_size for r in results for t in r.tokens))
    if not ok:
        raise AssertionError("serve returned an unexpected result")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched while serving: {idle}")
    return out


# -- phase 6 ---------------------------------------------------------------

def _trace(fn) -> dict:
    """Run ``fn`` (returns a call count) under torch.profiler: per call, the
    host clock, the time the card was busy, and where it was busy."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {"calls": n, "traced_wall_ms": 1e3 * wall / n,
            "device_busy_ms": sum(per.values()) / 1e3 / n if per else None,
            "top_device_us": [[k[:80], v / n] for k, v in top],
            "top_host_us": [[a.key[:60], a.self_cpu_time_total / n]
                            for a in host[:8]]}


def phase_profile(cfg, params, served: dict) -> dict:
    """Where a prefill and a decode step spend their time. The device's idle
    share is taken against the untraced means of phase 5."""
    engine = ServeEngine(cfg, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                         seed=SEED, device="cuda")
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(1, cfg.vocab_size, 136).tolist()
               for _ in range(MAX_BATCH)]
    out = {"phase": "profile",
           "prefill": _trace(lambda: len([engine.add_request(p, max_new=64)
                                          for p in prompts])),
           "decode": _trace(lambda: len([engine.step() for _ in range(16)]))}
    for name, untraced in (("prefill", served["prefill_ms_mean"]),
                           ("decode", served["decode_step_ms_mean"])):
        busy = out[name]["device_busy_ms"]
        out[name]["device_idle_share"] = (
            None if busy is None else max(0.0, 1.0 - busy / untraced))
    emit(out)
    return out


def main() -> None:
    dev = phase_device()
    phase_build()
    cases = phase_kernels()
    cfg = get_config("tacc-100m")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         "cuda")
    phase_consistency(cfg, params)
    served = phase_serve(cfg, params)
    phase_profile(cfg, params, served)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "floor_ms")
    emit({"kernels": [
        {"name": fn.__name__, "route": "cuda", "source": src, "replaces": tpu,
         "launches": served["launches"][fn.__name__],
         **{k: cases[fn.__name__][0][k] for k in keys
            if k in cases[fn.__name__][0]},
         "shape": cases[fn.__name__][0].get("q") or cases[fn.__name__][0]["x"],
         "dtype": cases[fn.__name__][0]["dtype"]}
        for fn, src, tpu in KERNELS]})
    emit({"ok": True, "device": dev})


if __name__ == "__main__":
    main()
