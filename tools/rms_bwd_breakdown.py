#!/usr/bin/env python3
"""Where K2b's and K3b's time goes on a CUDA card: the backward norm
kernels (dx and dw in one launch) timed whole and with parts of the dw sum
taken out.

    python3 tools/rms_bwd_breakdown.py

Each variant is ``csrc/rmsnorm.cu`` with one part disabled by a text
patch, built with ``nvcc`` into ``build/rms_bwd_breakdown/`` and loaded in
place of the library; K2b and K3b are then timed as ``chip_smoke.py``
times them (CUDA graph replay), bf16 at the training shape of tacc-100m
(2048 rows of 768), two rounds in turn. Variants: ``whole``;
``no_dw_sum`` (each block writes its partial row and stops: no block
arrives, waits or sums); ``half_reducers`` (kReducers halved). A variant's
dw may be wrong by design; only its time is read. It prints the card's
name and power limit, then one JSON line of microseconds per variant:
[K2b, K3b] for each round.
"""
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from k1b_breakdown import build_variants  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

rms = importlib.import_module("repro_torch.kernels.rmsnorm")

_TAIL = "  dw_tail<WIDE>(partial, arrivals, dw_out, D, reducers, &red[0][0]);\n"
VARIANTS = {
    "whole": [],
    "no_dw_sum": [(_TAIL, "")],
    "half_reducers": [("constexpr int kReducers = 48;",
                       "constexpr int kReducers = 24;")],
}


def main() -> None:
    chip_smoke.phase_device()
    libs = build_variants(os.path.join(ROOT, "build", "rms_bwd_breakdown"),
                          VARIANTS, "rmsnorm", rms._SIGNATURES)
    N, D = chip_smoke.TRAIN_BATCH * chip_smoke.TRAIN_SEQ, 768
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    x, dy, ds = (torch.randn(N, D, generator=g, device="cuda").bfloat16()
                 for _ in range(3))
    w = torch.randn(D, generator=g, device="cuda")
    us = {}
    try:
        for _ in range(2):
            for name, lib in libs.items():
                build._loaded["rmsnorm"] = lib
                us.setdefault(name, []).append([
                    1e3 * chip_smoke.time_ms(lambda: rms.rmsnorm_bwd(x, w, dy)),
                    1e3 * chip_smoke.time_ms(
                        lambda: rms.rmsnorm_residual_bwd(x, w, dy, ds))])
    finally:
        build._loaded.pop("rmsnorm", None)
    print(json.dumps({"rms_bwd_breakdown_us": us, "shape": [N, D]}))


if __name__ == "__main__":
    main()
