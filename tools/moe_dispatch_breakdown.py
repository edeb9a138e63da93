#!/usr/bin/env python3
"""The MoE FFN's two paths on a CUDA card, by row count: the dense oracle
(every expert on every row) against the dropless dispatch (a host read of
the per-expert counts, then each non-empty expert on its own rows).

    python3 tools/moe_dispatch_breakdown.py [--arch qwen2-moe-a2.7b]

One MoE layer of ``--arch`` at full width (bf16 experts and shared block,
the router in f32, drawn from seed 0 as the serving weights are), fed
bf16 rows drawn from a normal distribution. For each row count it times
``moe_dense_oracle`` and ``moe_dispatch`` by ``chip_smoke.call_ms`` (back
to back from Python, host dispatch included), counts the experts the
route uses, and compares the two paths' routed f32 sums (max |dispatch -
oracle| over max |oracle|). It prints the card's name and power limit
(``chip_smoke.phase_device``), then one JSON line. ``moe_apply`` runs
the dispatch from ``DISPATCH_MIN_ROWS`` rows on; these numbers are what
that choice rests on.
"""
import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_serving_params  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402

ROWS = (8, 64, 256, 512, 1024, 2048, 4096, 8192)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    args = ap.parse_args()
    chip_smoke.phase_device()
    cfg = dataclasses.replace(get_config(args.arch), n_layers=1)
    params = init_serving_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    p = {k[len("layers.0.ffn."):]: v for k, v in params.items()
         if k.startswith("layers.0.ffn.")}
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {"arch": args.arch, "dispatch_min_rows": MOE.DISPATCH_MIN_ROWS,
           "rows": {}}
    with torch.inference_mode():
        for n in ROWS:
            x = torch.randn(1, n, cfg.d_model, generator=g,
                            device="cuda").bfloat16()
            flat = x.reshape(n, -1)
            idx, w, _ = MOE.route(cfg, flat, p["router"])
            dense = MOE.dense_routed(cfg, p, flat, idx, w)
            disp = MOE.dispatch_routed(cfg, p, flat, idx, w)
            iters = max(3, min(20, 20 * 512 // n))
            out["rows"][n] = {
                "experts_used": int(torch.unique(idx).numel()),
                "routed_rel_err": float((disp - dense).abs().max()
                                        / dense.abs().max()),
                "oracle_ms": chip_smoke.call_ms(
                    lambda: MOE.moe_dense_oracle(cfg, p, x), iters=iters),
                "dispatch_ms": chip_smoke.call_ms(
                    lambda: MOE.moe_dispatch(cfg, p, x), iters=iters)}
            del dense, disp
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
