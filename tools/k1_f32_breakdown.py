#!/usr/bin/env python3
"""Where K1 f32's time goes on a CUDA card: the float32 forward kernel
(``flash_fwd_f32``) timed whole and with parts taken out.

    python3 tools/k1_f32_breakdown.py

Each variant is ``csrc/flash_attention.cu`` with one part of the kernel
disabled by a text patch, built with ``nvcc`` into
``build/k1_f32_breakdown/`` (``tools/k1b_breakdown.py`` ``build_variants``)
and loaded in place of the library; the forward is then timed as
``chip_smoke.py`` phase 3 times it (CUDA graph replay) at its two timed
f32 shapes, the serving one (q (1, 512, 12, 64)) and the training one (q
(16, 128, 12, 64)), both causal with k/v as strided views of one fused
tensor, two rounds in turn. A variant's results are wrong by design; only
its time is read. Then the whole kernel at both shapes with each q tile's
keys split over 1 to 4 blocks, whatever ``key_splits`` would choose (it
splits the serving shape's keys over ``KEY_SPLITS`` blocks and never the
training shape's). It prints the card's name and power limit, then one
JSON line of microseconds: [serve, train] for each variant and round,
and [round 1, round 2] for each shape and split count. A patch that no
longer matches the source fails, naming its variant.
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

fa = importlib.import_module("repro_torch.kernels.flash_attention")

_QK = "    abt_f32<NR, D, 8, 16, 8>(sc, Qs, DP, Ks, DP, tx, ty);     // S = Q K^T\n"
_PV = "    pm_f32<NR, D, 16, 8>(acc, Ps, kSP, Vs, DP, tx, ty);       // O += P V\n"
_SOFTMAX = ("    for (int i = 0; i < NR; ++i) {\n"
            "      const int r = ty + 16 * i, qpos = q0 + r;\n")
_ZERO = "    for (auto& row : sc) for (float& x : row) x = 0.f;\n"
VARIANTS = {
    "whole": [],
    # without O += P V; without S = Q K^T (the scores are 0)
    "no_pv": [(_PV, "")],
    "no_qk": [(_QK, _ZERO)],
    # the loop's loads, waits and barriers only: no product, no softmax
    "loads_only": [(_QK, _ZERO), (_PV, ""),
                   (_SOFTMAX, _SOFTMAX.replace("i < NR;",
                                               "i < (j < 0 ? NR : 0);"))],
}
SHAPES = {"serve": (1, 512), "train": (16, 128)}      # (B, S)


def inputs(B: int, S: int) -> tuple:
    cfg = chip_smoke.get_config("tacc-100m")
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    q = torch.randn(B, S, H, D, generator=g, device="cuda")
    kv = torch.randn(B, S, 2, KV, D, generator=g, device="cuda")
    return q, kv[:, :, 0], kv[:, :, 1]


def main() -> None:
    chip_smoke.phase_device()
    libs = build_variants(os.path.join(ROOT, "build", "k1_f32_breakdown"),
                          VARIANTS)
    data = {n: inputs(*bs) for n, bs in SHAPES.items()}
    us, splits = {}, {}
    keep = fa.key_splits
    try:
        for _ in range(2):
            for name, lib in libs.items():
                build._loaded["flash_attention"] = lib
                us.setdefault(name, []).append([
                    1e3 * chip_smoke.time_ms(
                        lambda: fa._forward(q, k, v, True, None, False))
                    for q, k, v in data.values()])
        build._loaded["flash_attention"] = libs["whole"]
        for _ in range(2):
            for shape, (q, k, v) in data.items():
                for n in (1, 2, 3, 4):
                    fa.key_splits = lambda *_, n=n: n
                    splits.setdefault(shape, {}).setdefault(n, []).append(
                        1e3 * chip_smoke.time_ms(
                            lambda: fa._forward(q, k, v, True, None, False)))
    finally:
        fa.key_splits = keep
        build._loaded.pop("flash_attention", None)
    print(json.dumps({"k1_f32_breakdown_us": us, "key_splits_us": splits,
                      "shapes": {n: list(data[n][0].shape) for n in data}}))


if __name__ == "__main__":
    main()
