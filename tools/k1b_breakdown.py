#!/usr/bin/env python3
"""Where K1b's time goes on a CUDA card: the backward kernels timed whole
and with parts taken out, bf16 (wgmma) and f32 (FMA).

    python3 tools/k1b_breakdown.py

Each variant is ``csrc/flash_attention.cu`` with one part of a kernel
disabled by a text patch, built with ``nvcc`` into
``build/k1b_breakdown/`` and loaded in place of the library; K1b-dq and
K1b-dkdv are then timed as ``chip_smoke.py`` times them (CUDA graph
replay), at the training shape of tacc-100m (q (16, 128, 12, 64), k/v
(16, 128, 4, 64), causal; bf16 k/v as strided views, f32 contiguous), two
rounds in turn. A variant's results are wrong by design; only its time is
read. It prints the card's name and power limit, then one JSON line of
microseconds per variant: [dq, dkdv] for each round. A patch that no
longer matches the source fails, naming its variant.
"""
import ctypes
import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")

_DQ_LOOP = ("    const uint32_t tK = sK + s * L::kTileBytes, "
            "tV = sV + s * L::kTileBytes;\n")
_WG0 = "    if (wg == 0) {\n      wg_fence();\n      fence_regs(st);\n"
_WG1 = "    } else {\n      float dpt[32];\n"
VARIANTS = {
    "whole": [],
    # K1b-dq without Delta's loads of o and dO
    "dq_no_delta": [("    if (row < S) {\n      const uint4* po",
                     "    if (false) {\n      const uint4* po")],
    # K1b-dq's loop waits for its tiles and computes nothing
    "dq_loads_only": [(_DQ_LOOP, _DQ_LOOP +
                       "    if (t == 0) mbar_wait(barQ, 0);\n"
                       "    mbar_wait(barK + 8 * s, (t >> 1) & 1);\n"
                       "    mbar_wait(barV + 8 * s, (t >> 1) & 1);\n"
                       "    if (t >= 0) continue;\n")],
    # K1b-dkdv with one warpgroup's products (dV's or dK's), or neither
    "dkdv_dv_only": [(_WG1, _WG1.replace("} else {", "} else if (false) {"))],
    "dkdv_dk_only": [(_WG0, _WG0.replace("(wg == 0)", "(wg == 0 && false)")),
                     (_WG1, _WG1.replace("} else {", "} else if (wg == 1) {"))],
    "dkdv_loads_only": [(_WG0, _WG0.replace("(wg == 0)", "(wg == 0 && false)")),
                        (_WG1, _WG1.replace("} else {", "} else if (false) {"))],
}

_F32_DQ = "    float sc[8][4], dp[8][4];\n"
_F32_DQ_END = "    __syncthreads();                    // dS is written over V\n"
_F32_DQ_PM = "    pm_f32<8, D>(acc, dSs, DP, Ks, DP, tx, ty);"
_F32_DKDV = "    float sc[4][4], dpt[4][4];\n"
_F32_DKDV_END = ("    __syncthreads();                    "
                 "// stage st, P~^T and dS^T are free\n")
_F32_DKDV_PM = ("    pm_f32<4, D>(dva, Pt, kSP, dOt, DP, tx, ty);   // dV += P~^T dO\n"
                "    pm_f32<4, D>(dka, dSt, kSP, Q, DP, tx, ty);")
F32_VARIANTS = {
    "f32_whole": [],
    # K1b-dq f32 without dQ += dS K; with its loop's loads and waits only
    "f32_dq_no_dsk": [(_F32_DQ_PM, "")],
    "f32_dq_loads_only": [(_F32_DQ, "    if (j < 0) {\n" + _F32_DQ),
                          (_F32_DQ_END, "    }\n" + _F32_DQ_END),
                          (_F32_DQ_PM, "")],
    # K1b-dkdv f32 without dV's and dK's products; with loads and waits only
    "f32_dkdv_no_pm": [(_F32_DKDV_PM, "")],
    "f32_dkdv_loads_only": [(_F32_DKDV, "    if (i < 0) {\n" + _F32_DKDV),
                            (_F32_DKDV_END, "    }\n" + _F32_DKDV_END)],
}


def build_variants(out_dir: str, variants: dict, source: str = "flash_attention",
                   signatures: dict = None) -> dict:
    """Each variant of csrc/<source>.cu built into out_dir (all nvcc runs
    at once) and loaded, its entries given ``signatures``."""
    src = (build.CSRC / f"{source}.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, patches in variants.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: its patch no longer "
                                 f"matches the source once: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        procs[name] = subprocess.Popen(
            [build.tool("nvcc"), *flags, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{err}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn, argtypes in (signatures or fa._SIGNATURES).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    chip_smoke.phase_device()
    libs = build_variants(os.path.join(ROOT, "build", "k1b_breakdown"),
                          {**VARIANTS, **F32_VARIANTS})
    B, S, H, KV, D = 16, 128, 12, 4, 64
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    inputs = {}
    for dt in (torch.bfloat16, torch.float32):
        q, do = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dt)
                 for _ in range(2))
        kv = torch.randn(B, S, 2, KV, D, generator=g, device="cuda").to(dt)
        k, v = kv[:, :, 0], kv[:, :, 1]
        if dt == torch.float32:
            k, v = k.contiguous(), v.contiguous()
        o, lse = fa._forward(q, k, v, True, None, True)
        inputs[dt] = (q, k, v, o, lse, do)
    us = {}
    try:
        for _ in range(2):
            for name, lib in libs.items():
                q, k, v, o, lse, do = inputs[torch.float32 if name in
                                             F32_VARIANTS else torch.bfloat16]
                build._loaded["flash_attention"] = lib
                _, delta = fa.flash_bwd_dq(q, k, v, o, lse, do)
                us.setdefault(name, []).append([
                    1e3 * chip_smoke.time_ms(
                        lambda: fa.flash_bwd_dq(q, k, v, o, lse, do)),
                    1e3 * chip_smoke.time_ms(
                        lambda: fa.flash_bwd_dkdv(q, k, v, do, lse, delta))])
    finally:
        build._loaded.pop("flash_attention", None)
    print(json.dumps({"k1b_breakdown_us": us, "shape": [B, S, H, KV, D]}))


if __name__ == "__main__":
    main()
