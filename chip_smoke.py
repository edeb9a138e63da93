#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: every kernel under src/repro_torch/kernels/csrc/ with nvcc,
   built anew so that ptxas reports on each; HGMMA (wgmma) in the SASS of
   every bf16 flash-attention kernel (forward, K1b-dq and K1b-dkdv, at
   D = 64 and 128), and 128-bit global loads and stores in every 16-byte
   rmsnorm kernel;
3. kernels: each kernel against its plain PyTorch version at the serving
   shapes of tacc-100m (k/v as strided views of one tensor, as the model
   gives them), with its time, the plain version's, one PyTorch library
   call's where there is one, and its bound on this card; flash attention
   also at its edges (a row with no valid key, a ragged tile at a batch
   boundary, head dim 128; in f32 S = 33, 65 and 129 with lengths around
   the tile edges, with and without its key split, and a base 4 bytes off,
   which must be copied), its o bit-equal over two calls and its strided
   k/v read without a copy, and ptxas's spills of the D = 64 f32 forward
   kernels 0; the norms at theirs (one row, a ragged last
   block, a row or base off 16 bytes, rows of 1536, 2048, 8192 and 16384),
   each with the variant the wrapper launched; and the launch floor, an
   empty kernel's time; K1, K2 and K3 also at the training shapes
   (q (16, 128, 12, 64), rows (2048, 768));
4. consistency: full-width tacc-100m, prefill + 4 decode steps against the
   full forward, and a prefill against the plain path on the CPU;
5. serve: ServeEngine(max_batch=8, max_seq=512) serves 16 requests; every
   kernel's launch count must move;
6. profile: torch.profiler over 8 prefills and 16 decode steps, for the
   time the card is busy and idle;
7. kernels_bwd: each backward kernel (K1b-dq, K1b-dkdv, and K2b and K3b,
   each giving dx and dw in one launch) against its plain backward, at the
   training shapes of tacc-100m and at their edges (flash also with q and
   dO as transposed views and k/v as views of one fused tensor, read in
   place), with its time, the plain version's, the backward of one PyTorch
   call where there is one, and its bound; K1b's and dw's outputs must be
   bit-equal over two calls, dw also under a CUDA graph's replay; ptxas's
   spills of the D = 64 K1b kernels (bf16 and f32) must be 0;
8. train_consistency: full-width tacc-100m, one forward and backward of
   train_logits + cross_entropy on the card through the kernels and on the
   CPU through the plain path, from the same weights and tokens;
9. train: 20 steps of build_train_step on SyntheticLM batches (global
   batch 16, seq 128, lr 3e-4, remat="full"): the loss on batch 0 and on
   a batch never trained on, taken without a gradient before the first
   step and after the last, must fall by stated margins, and every
   forward and backward kernel must launch as often as the code says; a
   torch.profiler window over 3 steps.

Then one ``{"kernels": [...]}`` line with each kernel's launches in phase 5
(forward kernels) or phase 9 (backward kernels), K1's row with its f32
numbers at both timed shapes (no path launches it), and the last line
``{"ok": true, "device": {...}}``. Exits non-zero, before printing
anything, when no CUDA card is present.
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
from repro_torch.data import SyntheticLM
from repro_torch.kernels import (build, flash_attention, flash_attention_bwd,
                                 flash_attention_bwd_plain,
                                 flash_attention_plain, flash_bwd_dkdv,
                                 flash_bwd_dq, rmsnorm, rmsnorm_bwd,
                                 rmsnorm_bwd_plain, rmsnorm_plain,
                                 rmsnorm_residual,
                                 rmsnorm_residual_bwd,
                                 rmsnorm_residual_bwd_plain,
                                 rmsnorm_residual_plain)
from repro_torch.kernels.flash_attention import _plain_forward
from repro_torch.kernels.flash_attention import _bwd_inputs as bwd_inputs
from repro_torch.kernels.flash_attention import _forward as flash_forward
from repro_torch.kernels.flash_attention import _in_place as flash_in_place
from repro_torch.kernels.rmsnorm import (REDUCE_LANES, REDUCERS, bwd_blocks,
                                         launch_empty, pick_variant)
from repro_torch.models import (Transformer, cast_for_compute, decode_step,
                                init_params, prefill, train_logits)
from repro_torch.serve import ServeEngine
from repro_torch.train import (OptConfig, TrainConfig, build_train_step,
                               cross_entropy, init_train_state)

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s,
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

MAX_BATCH, MAX_SEQ = 8, 512
N_REQUESTS, MAX_NEW = 16, 32
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 20, 16, 128
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
    ``flash_fwd_wgmma<bf16, 64>``, ``flash_fwd_f32<float, 64>`` (with its
    keys split over blocks: ``flash_fwd_f32<float, 64, split>``),
    ``flash_fwd_f32_merge<float, 64>`` or ``flash_bwd_dq_f32<float, 64>``,
    the norm kernels as
    ``rmsnorm_kernel<bf16, residual=1, V=8, NV=8, warp>``, others by their
    mangled name."""
    m = re.search(r"(flash_(?:fwd|bwd_[a-z]+)_(?:wgmma|f32)(?:_merge)?)"
                  r"I(f?|\d+__nv_bfloat16)Li(\d+)E(?:Lb([01])E)?", mangled)
    if m:
        f32 = m.group(2) == "f" or "_f32" in m.group(1)
        split = ", split" if m.group(4) == "1" else ""
        return (f"{m.group(1)}<{'float' if f32 else 'bf16'}, {m.group(3)}"
                f"{split}>")
    m = re.search(r"(rmsnorm(?:_bwd)?_kernel)I(f|\d+__nv_bfloat16)Lb([01])E"
                  r"Li(\d+)ELi(\d+)ELb([01])E", mangled)
    if m:
        return (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}, "
                f"residual={m.group(3)}, V={m.group(4)}, NV={m.group(5)}, "
                f"{'wide' if m.group(6) == '1' else 'warp'}>")
    m = re.search(r"(empty_kernel)", mangled)
    return m.group(1) if m else mangled


def sass(library: str) -> dict:
    """The SASS of each kernel of a built library, by readable name."""
    out = subprocess.run(
        [build.tool("cuobjdump"), "--dump-sass",
         str(build.library_path(library))],
        capture_output=True, text=True, check=True).stdout
    return {kernel_name(part.split("\n", 1)[0].strip()): part
            for part in out.split("Function : ")[1:]}


WGMMA_KERNELS = [f"{k}<bf16, {d}>" for k in (
    "flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")
    for d in (64, 128)]


def hgmma_counts() -> dict:
    """HGMMA (wgmma) instructions in the SASS of each flash-attention kernel
    of the built library. Fails unless every bf16 instantiation, forward
    and backward, has them, so a kernel that lost its tensor cores cannot
    pass."""
    counts = {n: text.count("HGMMA")
              for n, text in sass("flash_attention").items()}
    if not all(counts.get(n) for n in WGMMA_KERNELS):
        raise AssertionError(f"a bf16 flash kernel lacks HGMMA: {counts}")
    return counts


def wide_access_counts() -> dict:
    """128-bit global loads and stores (LDG/STG with .128) in the SASS of
    each rmsnorm kernel, forward and backward. Fails unless the bf16
    warp-per-row kernels of K2, K3, K2b and K3b are there and every kernel
    with 16-byte accesses (V > 1) has both, so a kernel that lost its
    vectors cannot pass."""
    counts = {n: {op: len(re.findall(rf"\b{op}(?:\.\w+)*?\.128\b", text))
                  for op in ("LDG", "STG")}
              for n, text in sass("rmsnorm").items()}
    vector = {n: c for n, c in counts.items()
              if n.startswith(("rmsnorm_kernel<", "rmsnorm_bwd_kernel<"))
              and "V=1," not in n}
    warp = [n for n in vector if "<bf16," in n and n.endswith("warp>")]
    if (not all(any(n.startswith(kind) and f"residual={res}" in n
                    for n in warp)
                for kind in ("rmsnorm_kernel<", "rmsnorm_bwd_kernel<")
                for res in (0, 1))
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


def phase_build() -> dict:
    """Returns ptxas's report by kernel name."""
    t0 = time.perf_counter()
    reports = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_report(rep) for name, rep in reports.items()}
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas,
          "hgmma": hgmma_counts(), "ldst128": wide_access_counts()})
    return {k: v for rep in ptxas.values() for k, v in rep.items()}


# -- phase 3 ---------------------------------------------------------------

def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(1e-30)))
    return torch.pow(2.0, e - 7)


def flash_case(dtype, lengths_list, *, causal=True, S=MAX_SEQ, D=None,
               timed=True, offset=0):
    """K1 against its plain version; o must be bit-equal over two calls.
    k/v are strided views of one fused tensor, which the wrapper must pass
    to the kernel uncopied; ``offset`` (elements) puts the bases of q and
    of the fused k/v tensor off 16 bytes, so the wrapper must copy them."""
    cfg = get_config("tacc-100m")
    B, H, KV = len(lengths_list), cfg.n_heads, cfg.n_kv_heads
    D = D or cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(offset + B * S * H * D, generator=g,
                    device="cuda").to(dtype)[offset:].view(B, S, H, D)
    # k/v as project_qkv gives them: strided views of one (B,S,2,KV,D) tensor
    kv = torch.randn(offset + B * S * 2 * KV * D, generator=g,
                     device="cuda").to(dtype)[offset:].view(B, S, 2, KV, D)
    k, v = kv[:, :, 0], kv[:, :, 1]
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    o = flash_attention(q, k, v, causal=causal, lengths=lengths)
    again = flash_attention(q, k, v, causal=causal, lengths=lengths)
    ref = flash_attention_plain(q, k, v, causal=causal, lengths=lengths)
    torch.cuda.synchronize()
    tol = 3e-2 if dtype == torch.bfloat16 else 3e-5
    err = max_err(o, ref)
    taken = {n: flash_in_place(t)[0] is t for n, t in (("q", q), ("k", k),
                                                       ("v", v))}
    case = {"dtype": str(dtype).split(".")[-1], "q": list(q.shape),
            "kv": list(k.shape), "lengths": lengths_list, "causal": causal,
            "max_abs_err": err, "tol": tol,
            "bit_equal_over_two_calls": bool(torch.equal(o, again)),
            "read_in_place": taken, "offset_bytes": offset * q.element_size()}
    if not (torch.isfinite(o.float()).all() and err <= tol
            and case["bit_equal_over_two_calls"]):
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version or itself: {case}")
    if any(taken.values()) if offset else not all(taken.values()):
        raise AssertionError(f"flash_attention copied a view it can read in "
                             f"place, or read one it cannot: {case}")
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
    """K2's or K3's cases: the timed serving shapes first, then the
    training shape, then the edges, each variant, and the JAX suite's
    shapes, in both dtypes."""
    bf16, f32 = torch.bfloat16, torch.float32
    timed = [rms_case(dt, n, residual) for dt in (bf16, f32)
             for n in (MAX_SEQ, MAX_BATCH)]
    timed.append(rms_case(bf16, TRAIN_BATCH * TRAIN_SEQ, residual))
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


def spill_bytes(lines) -> "int | None":
    """Spill stores plus loads in ptxas's report of one kernel (None when
    there is no report)."""
    found = [int(n) for ln in lines or ()
             for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)]
    return sum(found) if found else None


def require_no_spills(ptxas: dict, names, phase: str) -> dict:
    """ptxas's spill bytes of each named kernel, emitted; fails unless each
    is reported and 0."""
    spills = {n: spill_bytes(ptxas.get(n)) for n in names}
    emit({"phase": phase, "spill_bytes": spills})
    if any(v != 0 for v in spills.values()):
        raise AssertionError(f"kernels spill (or ptxas did not report "
                             f"them): {spills}")
    return spills


def phase_kernels(ptxas: dict) -> dict:
    """Phase 3. The D = 64 f32 forward kernels (the model's head dim),
    whole or split, must not spill."""
    require_no_spills(ptxas, ("flash_fwd_f32<float, 64>",
                              "flash_fwd_f32<float, 64, split>"),
                      "kernels_spills")
    bf16, f32 = torch.bfloat16, torch.float32
    floor = time_ms(launch_empty)
    cases = {
        "flash_attention": [
            flash_case(bf16, [MAX_SEQ]),          # a full 512-token prefill
            flash_case(bf16, [136]),              # serve prompts' expected length
            flash_case(f32, [MAX_SEQ]),
            flash_case(bf16, [MAX_SEQ], D=128),
            # the training shape: q (16, 128, 12, 64)
            flash_case(bf16, [TRAIN_SEQ] * TRAIN_BATCH, S=TRAIN_SEQ),
            flash_case(f32, [TRAIN_SEQ] * TRAIN_BATCH, S=TRAIN_SEQ),
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
            # f32 at the edges of its tiles and of its strides; a case with
            # fewer (batch, head, q tile) blocks than SMs (132 on the H100)
            # splits its keys over two blocks: 36, 96, 108, 120 below
            # split, 192 do not
            flash_case(f32, [33, 32, 31], S=33, timed=False),
            flash_case(f32, [65, 64, 63, 1], S=65, timed=False),
            flash_case(f32, [129, 128, 0], S=129, timed=False),
            flash_case(f32, [0, 77], timed=False),
            flash_case(f32, [0, 77], causal=False, timed=False),
            flash_case(f32, [200, 512], D=128, timed=False),
            flash_case(f32, [300, 77], S=300, offset=1, timed=False),
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


# -- phase 7 ---------------------------------------------------------------

def grad_within_bar(g: torch.Tensor, ref: torch.Tensor, *,
                    rounds_p: bool = False):
    """Whether a gradient is within the backward kernels' bar of its plain
    version, the bar, and the reading: the least share of max(|ref|, 1)
    that the bar's second term needs for this case to pass. Both compute
    the same f32 formula with sums in another order, then round once: f32
    within 2e-5 of max(|ref|, 1); bf16 within one bf16 ulp of each value
    plus 2e-5 of max |ref| (the f32 sums' difference can cross a rounding
    boundary of a value near 0). ``rounds_p`` (dV of attention in bf16
    only): plus 1e-3 of max |ref|, since both round p to bf16 before the
    PV product, and p's last f32 bit, which the two compute in another
    order, can flip that rounding and move a dV sum by a bf16 ulp of p
    times dO (seen: 2^-8 at D = 128). dQ and dK take p in f32."""
    scale = max(float(ref.float().abs().max()), 1.0)
    d = (g.float() - ref.float()).abs()
    if g.dtype == torch.bfloat16:
        rel = 1e-3 if rounds_p else 2e-5
        need = float((d - _bf16_ulp(ref)).clamp(min=0).max()) / scale
        return need <= rel, f"1 bf16 ulp + {rel:g} max|ref|", need
    need = float(d.max()) / scale
    return need <= 2e-5, "2e-5 max(|ref|, 1)", need


def library_bwd_ms(fn, inputs, grads_out) -> float:
    """Device time of the backward of one PyTorch call: its forward and
    backward (``torch.autograd.grad``) captured together in a CUDA graph,
    less the forward alone. Autograd runs a backward op on its forward's
    stream, so the two are captured together."""
    inputs = [t.detach().requires_grad_(True) for t in inputs]
    both = time_ms(lambda: torch.autograd.grad(fn(*inputs), inputs,
                                               grads_out), iters=20)
    with torch.no_grad():
        fwd = time_ms(lambda: fn(*inputs), iters=20)
    return both - fwd


def flash_bwd_case(dtype, B, S, H, KV, D, *, causal=True, lengths=None,
                   timed=False, strided=False):
    """K1b-dq and K1b-dkdv against the plain backward on the same q, k, v,
    dO and the kernel forward's o and lse; the lse against the plain
    forward's. ``strided`` (bf16): q and dO are transposed views of
    (B, H, S, D) tensors, k and v views of one fused (B, S, 2, KV, D)
    tensor, and the backward must read all four in place."""
    g = torch.Generator(device="cuda").manual_seed(SEED + S + H + D)
    if strided:
        q, do = (torch.randn(B, H, S, D, generator=g, device="cuda")
                 .to(dtype).transpose(1, 2) for _ in range(2))
        kv = torch.randn(B, S, 2, KV, D, generator=g, device="cuda").to(dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
    else:
        q, do = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(B, S, KV, D, generator=g, device="cuda").to(dtype)
                for _ in range(2))
    ln = (None if lengths is None else
          torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    o, lse = flash_forward(q, k, v, causal, ln, True)
    _, lse_ref = _plain_forward(q, k, v, causal, ln)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     lengths=ln)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                lengths=ln)
    rq, rk, rv = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                           causal=causal, lengths=ln)
    torch.cuda.synchronize()
    case = {"dtype": str(dtype).split(".")[-1], "q": [B, S, H, D],
            "kv": [B, S, KV, D], "causal": causal, "lengths": lengths,
            "lse_err": max_err(lse, lse_ref),
            "bit_equal_over_two_calls": all(
                torch.equal(a, b) for a, b in zip((dq, dk, dv), again))}
    if strided:
        case["strides"] = {n: list(t.stride())
                           for n, t in (("q", q), ("k", k), ("dO", do))}
        taken = bwd_inputs(q, k, v, o, do, lse)
        if not all(t is u for t, u in zip(taken, (q, k, v, o, do))):
            raise AssertionError(f"the bf16 backward copied a strided input "
                                 f"that TMA can read: {case}")
    failed = ([] if case["lse_err"] <= 1e-4 * max(float(lse_ref.abs().max()),
                                                   1.0) else ["lse"])
    if not case["bit_equal_over_two_calls"]:
        failed.append("repeat")
    for name, a, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        good, tol, need = grad_within_bar(a, r, rounds_p=name == "dv")
        if not (good and bool(torch.isfinite(a.float()).all())):
            failed.append(name)
        case[f"{name}_err"] = max_err(a, r)
        case[f"{name}_tol"] = tol
        case[f"{name}_need"] = need
    case["max_abs_err"] = max(case["dq_err"], case["dk_err"], case["dv_err"])
    if failed:
        raise AssertionError(f"flash backward disagrees with its plain "
                             f"version in {failed}: {case}")
    if not timed:
        return case
    # what this data needs: each product over the (q, key) pairs attended
    qpos = np.arange(S)
    pairs = B * H * (int(np.minimum(qpos + 1, S).sum()) if causal else S * S)
    el = q.element_size()
    qb, kb, rows = B * S * H * D * el, B * S * KV * D * el, B * H * S * 4
    dq_bytes = 4 * qb + 2 * kb + 2 * rows       # q o dO dq, k v, lse delta
    dkdv_bytes = 2 * qb + 4 * kb + 2 * rows     # q dO, k v dk dv, lse delta
    both = 4 * qb + 4 * kb + 2 * rows
    _, delta = flash_bwd_dq(q, k, v, o, lse, do, causal=causal, lengths=ln)
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=causal, lengths=ln), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = library_bwd_ms(
        lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=causal, enable_gqa=True),
        (qt, kt, vt), do.transpose(1, 2))
    for name, fn, nbytes_, products in (
            ("dq", lambda: flash_bwd_dq(q, k, v, o, lse, do,
                                        causal=causal, lengths=ln),
             dq_bytes, 3),
            ("dkdv", lambda: flash_bwd_dkdv(q, k, v, do, lse, delta,
                                            causal=causal, lengths=ln),
             dkdv_bytes, 4)):
        flops = 2.0 * D * pairs * products
        b_ms, b_by = bound(nbytes_, flops, dtype)
        case[name] = {"ms": time_ms(fn), "bound_ms": b_ms, "bound_by": b_by,
                      "bytes": nbytes_, "flops": flops}
    flops = 2.0 * D * pairs * 5
    b_ms, b_by = bound(both, flops, dtype)
    case.update(ms=time_ms(lambda: flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal, lengths=ln)),
        plain_ms=plain_ms, library_ms=lib,
        library="backward of F.scaled_dot_product_attention(is_causal, "
                "enable_gqa=True)", bound_ms=b_ms, bound_by=b_by,
        bytes=both, flops=flops)
    return case


def rms_bwd_case(dtype, rows, residual: bool, *, D=None, offset=0,
                 timed=False):
    """K2b or K3b, dx and dw in one launch, against the plain backward; dw
    must be bit-equal over two calls and, for a timed case, when the same
    launch is captured in a CUDA graph and replayed twice."""
    D = D or get_config("tacc-100m").d_model
    g = torch.Generator(device="cuda").manual_seed(SEED + rows + D + 7)
    x = torch.randn(offset + rows * D, generator=g,
                    device="cuda").to(dtype)[offset:].view(rows, D)
    dy, ds = (torch.randn(rows, D, generator=g, device="cuda").to(dtype)
              for _ in range(2))
    w = torch.randn(D, generator=g, device="cuda")
    eps = 1e-5
    if residual:
        kernel = lambda: rmsnorm_residual_bwd(x, w, dy, ds, eps)  # noqa: E731
        plain = lambda: rmsnorm_residual_bwd_plain(x, w, dy, ds, eps)  # noqa: E731
        wrapper = rmsnorm_residual_bwd
    else:
        kernel = lambda: rmsnorm_bwd(x, w, dy, eps)  # noqa: E731
        plain = lambda: rmsnorm_bwd_plain(x, w, dy, eps)  # noqa: E731
        wrapper = rmsnorm_bwd
    dx, dw = kernel()
    variant = wrapper.variant
    dx2, dw2 = kernel()
    rdx, rdw = plain()
    torch.cuda.synchronize()
    ok, tol, need = grad_within_bar(dx, rdx)
    dw_tol = 1e-5 * float(rdw.abs().max())   # f32 sums over rows, reordered
    repeat = bool(torch.equal(dw, dw2) and torch.equal(dx, dx2))
    ok = (ok and max_err(dw, rdw) <= dw_tol and repeat
          and bool(torch.isfinite(dx.float()).all()))
    case = {"dtype": str(dtype).split(".")[-1], "x": [rows, D],
            "x_offset_bytes": offset * x.element_size(), "variant": variant,
            "max_abs_err": max_err(dx, rdx), "tol": tol, "need": need,
            "dw_err": max_err(dw, rdw), "dw_tol": dw_tol,
            "bit_equal_over_two_calls": repeat}
    if timed:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gdx, gdw = kernel()
        replays = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            replays.append(bool(torch.equal(gdw, dw) and torch.equal(gdx, dx)))
        case["bit_equal_under_graph_replay"] = all(replays)
        ok = ok and all(replays)
    if not ok:
        raise AssertionError(f"{'K3b' if residual else 'K2b'} disagrees with "
                             f"its plain version or itself: {case}")
    if not timed:
        return case
    others = (dy, ds) if residual else (dy,)
    # each input read once, dx and dw written once: the partial and group
    # rows of dw stay in L2 and are not counted
    moved = nbytes(x, *others, w, dx, dw)
    b_ms, b_by = bound(moved, 8.0 * x.numel(), torch.float32)
    if residual:
        lib, lib_name = None, None
    else:
        wx = w.to(dtype)
        lib = library_bwd_ms(lambda a, b: F.rms_norm(a, (D,), b, eps),
                             (x, wx), dy)
        lib_name = "backward of F.rms_norm (weight in the input dtype)"
    case.update(
        ms=time_ms(kernel), plain_ms=time_ms(plain), library_ms=lib,
        library=lib_name, bound_ms=b_ms, bound_by=b_by, bytes=moved,
        flops=8.0 * x.numel(), blocks=bwd_blocks(rows, pick_variant(x, w)),
        dw=f"summed in this launch: each block writes its partial row, the "
           f"last {REDUCERS} blocks each add a slice of the columns over all "
           f"partial rows ({REDUCE_LANES} lanes of every {REDUCE_LANES}th "
           f"row, then the lanes, in order); no separate launch")
    return case


def phase_kernels_bwd(ptxas: dict) -> dict:
    """Phase 7: every backward kernel against its plain backward, and
    ptxas's registers and spills for each backward kernel; the D = 64 K1b
    kernels (the training shape's head dim), bf16 and f32, must not
    spill."""
    require_no_spills(ptxas, ("flash_bwd_dq_wgmma<bf16, 64>",
                              "flash_bwd_dkdv_wgmma<bf16, 64>",
                              "flash_bwd_dq_f32<float, 64>",
                              "flash_bwd_dkdv_f32<float, 64>"),
                      "kernels_bwd_spills")
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config("tacc-100m")
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    TB, TS = TRAIN_BATCH, TRAIN_SEQ
    flash = [flash_bwd_case(bf16, TB, TS, H, KV, HD, timed=True),
             flash_bwd_case(f32, TB, TS, H, KV, HD, timed=True)]
    for dt in (bf16, f32):
        flash += [
            flash_bwd_case(dt, 2, 1, H, KV, HD, lengths=[1, 0]),
            flash_bwd_case(dt, 2, 65, H, KV, HD, lengths=[65, 30]),
            flash_bwd_case(dt, 2, 200, H, KV, HD, lengths=[200, 0]),
            flash_bwd_case(dt, 1, 512, H, KV, HD),
            flash_bwd_case(dt, 2, 200, H, KV, 128, lengths=[137, 200]),
            flash_bwd_case(dt, 2, 130, 4, 4, HD, lengths=[130, 64]),   # G = 1
            flash_bwd_case(dt, 2, 200, H, KV, HD, causal=False,
                           lengths=[0, 151]),
            flash_bwd_case(dt, 1, 128, 4, 4, 128, causal=False),
        ]
    flash.append(flash_bwd_case(bf16, 2, 200, H, KV, HD, lengths=[200, 137],
                                strided=True))
    N = TB * TS
    norms = {}
    for residual, key in ((False, "K2b"), (True, "K3b")):
        cases = [rms_bwd_case(bf16, N, residual, timed=True),
                 rms_bwd_case(f32, N, residual, timed=True)]
        for dt in (bf16, f32):
            cases += [rms_bwd_case(dt, 1, residual),
                      rms_bwd_case(dt, 13, residual),
                      rms_bwd_case(dt, 13, residual, D=2048),
                      rms_bwd_case(dt, 5, residual, D=770),
                      rms_bwd_case(dt, 7, residual, offset=1),
                      rms_bwd_case(dt, 3, residual, D=8192)]
        norms[key] = cases
    out = {"phase": "kernels_bwd", "flash": flash, **norms,
           "ptxas": {k: v for k, v in ptxas.items() if "_bwd_" in k}}
    emit(out)
    return out


# -- phase 8 ---------------------------------------------------------------

TRAIN_CONSISTENCY_BARS = {"loss_rel": 1e-3, "grad_norm_rel": 1e-3,
                          "min_cosine": 0.999}


def _loss_and_grads(model: Transformer, batch: dict):
    logits = train_logits(model, batch, remat="full")
    loss, _ = cross_entropy(logits, batch["labels"])
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), dict(zip(names, grads))


def phase_train_consistency(cfg, params) -> dict:
    """Phase 8: one forward and backward at full width on the card and on
    the CPU's plain path, from the same f32 weights and tokens. bf16
    activations round differently in the two paths, so the bars sit a few
    times above what the H100 read (loss rel 2.7e-5, grad norm rel 1.5e-5,
    least cosine 0.99957): loss and grad norm within rel 1e-3, every
    parameter's gradient at cosine >= 0.999. A kernel that is wrong by a
    few percent in one leaf's gradient leaves these bars."""
    b = SyntheticLM(cfg, 1, 128, seed=SEED).batch(0)
    batches = {dev: {k: torch.from_numpy(v).long().to(dev) for k, v in b.items()}
               for dev in ("cuda", "cpu")}
    loss_g, g_gpu = _loss_and_grads(
        Transformer(cfg, params, device="cuda", trainable=True),
        batches["cuda"])
    loss_c, g_cpu = _loss_and_grads(
        Transformer(cfg, {k: v.cpu() for k, v in params.items()},
                    device="cpu", trainable=True), batches["cpu"])
    norm = lambda gs: float(torch.sqrt(sum((g.double() ** 2).sum()  # noqa: E731
                                           for g in gs.values())))
    cos = {}
    for name, gc in g_cpu.items():
        a, c = g_gpu[name].double().cpu().flatten(), gc.double().flatten()
        den = float(a.norm() * c.norm())
        cos[name] = 1.0 if den == 0 and float(a.norm() + c.norm()) == 0 \
            else float(a @ c) / max(den, 1e-300)
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
    out = {"phase": "train_consistency", "batch": 1, "seq": 128,
           "loss_gpu": loss_g, "loss_cpu": loss_c,
           "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
           "grad_norm_gpu": norm(g_gpu), "grad_norm_cpu": norm(g_cpu),
           "min_cosine": worst[0][1], "worst_cosines": worst,
           "bars": TRAIN_CONSISTENCY_BARS}
    out["grad_norm_rel"] = (abs(out["grad_norm_gpu"] - out["grad_norm_cpu"])
                            / out["grad_norm_cpu"])
    emit(out)
    bars = TRAIN_CONSISTENCY_BARS
    if not (np.isfinite(loss_g) and out["loss_rel"] < bars["loss_rel"]
            and out["grad_norm_rel"] < bars["grad_norm_rel"]
            and out["min_cosine"] >= bars["min_cosine"]):
        raise AssertionError(f"training consistency failed: {out}")
    return out


# -- phase 9 ---------------------------------------------------------------

# The least fall of the loss over the 20 steps on batch 0 (trained on at
# the first step) and on batch 23 (never trained on), each loss taken
# without a gradient from the same tokens before and after. The evaluation
# is deterministic, so parameters that never moved read a fall of exactly
# 0. The bars sit at about half and a third of what the H100 read: 1.039
# on batch 0, which the model has partly memorised, and 0.0158 held out.
EVAL_FALL = {"batch_0": 0.5, "held_out": 0.005}

BWD_KERNELS = [
    # (name, wrapper whose count is the kernel's, source, what it replaces)
    ("flash_bwd_dq", flash_bwd_dq,
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "XLA's gradient of src/repro/models/attention.py:91"),
    ("flash_bwd_dkdv", flash_bwd_dkdv,
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "XLA's gradient of src/repro/models/attention.py:91"),
    ("rmsnorm_bwd", rmsnorm_bwd, "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "XLA's gradient of src/repro/kernels/ref.py:24"),
    ("rmsnorm_residual_bwd", rmsnorm_residual_bwd,
     "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "XLA's gradient of src/repro/models/transformer.py:187-189"),
]


def expected_train_launches(cfg, steps: int) -> dict:
    """Launches of each kernel in ``steps`` train steps, from the code:
    every layer is an attention + dense FFN block under remat="full", so
    its forward runs twice (forward, then recomputed in the backward) and
    its backward once; out_norm (K2) lies outside the blocks; K2b and K3b
    each give dx and dw in one launch, with no separate dw reduction."""
    n = cfg.n_layers
    per_step = {"flash_attention": 2 * n, "rmsnorm": 2 * n + 1,
                "rmsnorm_residual": 2 * n, "flash_bwd_dq": n,
                "flash_bwd_dkdv": n, "rmsnorm_bwd": n + 1,
                "rmsnorm_residual_bwd": n}
    return {k: steps * v for k, v in per_step.items()}


def _eval_loss(cfg, params, batch: dict) -> float:
    """The training loss (cross-entropy + z-loss) of ``params`` on
    ``batch``, without a gradient."""
    model = Transformer(cfg, params, device="cuda", trainable=True)
    with torch.no_grad():
        logits = train_logits(model, batch, remat="none")
        loss, _ = cross_entropy(logits, batch["labels"],
                                z_loss=TrainConfig().z_loss)
    return float(loss)


def phase_train(cfg) -> dict:
    """Phase 9: the main training path, 20 steps at full width. Batch 0
    (trained on at the first step) and batch 23 (never trained on) are
    evaluated before the first step and after the last."""
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [{k: torch.from_numpy(v).long().cuda()
                for k, v in data.batch(i).items()}
               for i in range(TRAIN_STEPS + 4)]
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    step_fn = build_train_step(cfg, ocfg, TrainConfig(), remat="full")
    state = init_train_state(
        cfg, ocfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    evals = {"batch_0": [_eval_loss(cfg, state["params"], batches[0])],
             "held_out": [_eval_loss(cfg, state["params"], batches[-1])]}
    wrappers = [fn for fn, _, _ in KERNELS] + [fn for _, fn, _, _ in
                                               BWD_KERNELS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases left allocated: the peak below includes it
    allocated_at_start = torch.cuda.memory_allocated()
    for fn in wrappers:
        fn.launches = 0
    losses, gnorms, lrs, step_ms = [], [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
    launches = {fn.__name__: fn.launches for fn in wrappers}
    expected = expected_train_launches(cfg, TRAIN_STEPS)
    evals["batch_0"].append(_eval_loss(cfg, state["params"], batches[0]))
    evals["held_out"].append(_eval_loss(cfg, state["params"], batches[-1]))
    fall = {k: a - b for k, (a, b) in evals.items()}
    steady = step_ms[1:]
    out = {"phase": "train", "steps": TRAIN_STEPS, "global_batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "lr": 3e-4, "remat": "full",
           "loss": losses, "grad_norm": gnorms, "lr_per_step": lrs,
           "step_ms": step_ms,
           "step_ms_mean": float(np.mean(steady)),
           "step_ms_p50": float(np.median(steady)),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3 / float(np.mean(steady)),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "memory_allocated_at_start_gb": allocated_at_start / 1e9,
           "launches": launches, "expected_launches": expected,
           "eval_loss_before_after": evals, "eval_fall": fall,
           "eval_fall_bar": EVAL_FALL}

    # a profiled window of three more steps
    def three():
        for i in range(3):
            step_fn(state, batches[TRAIN_STEPS + i])
        return 3
    prof = _trace(three)
    busy = prof["device_busy_ms"]
    prof["device_idle_share"] = (None if busy is None else
                                 max(0.0, 1.0 - busy / prof["traced_wall_ms"]))
    prof["idle_share_vs_untraced"] = (None if busy is None else max(
        0.0, 1.0 - busy / out["step_ms_mean"]))
    out["profile"] = prof
    emit(out)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"the loss did not fall: {losses}")
    if not all(fall[k] >= EVAL_FALL[k] for k in EVAL_FALL):
        raise AssertionError(f"the evaluated loss fell by {fall}, less than "
                             f"{EVAL_FALL}: {evals}")
    if launches != expected:
        raise AssertionError(f"kernel launches in {TRAIN_STEPS} steps: "
                             f"{launches}, expected {expected}")
    return out


def kernel_line(served: dict, cases: dict, bwd: dict, trained: dict) -> dict:
    """The ``{"kernels": [...]}`` line: forward kernels with their serve
    launches and phase 3 numbers, backward kernels with their train
    launches and phase 7 numbers (bf16 at the training shapes)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "floor_ms")
    rows = [{"name": fn.__name__, "route": "cuda", "source": src,
             "replaces": tpu, "launches": served["launches"][fn.__name__],
             "launches_in": "serve (phase 5)",
             "train_launches": trained["launches"][fn.__name__],
             **{k: cases[fn.__name__][0][k] for k in keys
                if k in cases[fn.__name__][0]},
             "shape": (cases[fn.__name__][0].get("q")
                       or cases[fn.__name__][0]["x"]),
             "dtype": cases[fn.__name__][0]["dtype"]}
            for fn, src, tpu in KERNELS]
    # K1 f32 launches on neither path: its phase 3 numbers at both shapes
    fwd = cases["flash_attention"]
    rows[0].update({f"f32_{n}": {k: fwd[i][k] for k in keys
                                 if k in fwd[i] and k != "floor_ms"}
                    for n, i in (("serve", 2), ("train", 5))})
    fl, f32, k2, k3 = (bwd["flash"][0], bwd["flash"][1], bwd["K2b"][0],
                       bwd["K3b"][0])

    def flash_row(c, part, err):
        return {**c[part], "plain_ms": c["plain_ms"],
                "library_ms": c["library_ms"], "max_abs_err": err}
    per = {"flash_bwd_dq": {**flash_row(fl, "dq", fl["dq_err"]),
                            "shape": fl["q"],
                            "f32": flash_row(f32, "dq", f32["dq_err"])},
           "flash_bwd_dkdv": {**flash_row(fl, "dkdv",
                                          max(fl["dk_err"], fl["dv_err"])),
                              "shape": fl["kv"],
                              "f32": flash_row(f32, "dkdv", max(
                                  f32["dk_err"], f32["dv_err"]))},
           "rmsnorm_bwd": {**k2, "shape": k2["x"]},
           "rmsnorm_residual_bwd": {**k3, "shape": k3["x"]}}
    for name, fn, src, what in BWD_KERNELS:
        c = per[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": what, "launches": trained["launches"][name],
                     "launches_in": "train (phase 9)",
                     **{k: c.get(k) for k in keys if k != "floor_ms"},
                     "shape": c["shape"], "dtype": fl["dtype"],
                     **{k: c[k] for k in ("f32", "dw") if k in c}})
    return {"kernels": rows}


def main() -> None:
    dev = phase_device()
    ptxas = phase_build()
    cases = phase_kernels(ptxas)
    cfg = get_config("tacc-100m")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         "cuda")
    phase_consistency(cfg, params)
    served = phase_serve(cfg, params)
    phase_profile(cfg, params, served)
    bwd = phase_kernels_bwd(ptxas)
    phase_train_consistency(cfg, params)
    trained = phase_train(cfg)
    emit(kernel_line(served, cases, bwd, trained))
    emit({"ok": True, "device": dev})


if __name__ == "__main__":
    main()
