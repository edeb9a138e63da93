"""Roofline of the port from its dry-run artifacts, in H100 terms.

The port's counterpart of ``benchmarks/roofline.py``. For each cell of
``launch/dryrun.py`` (``artifacts/dryrun_torch/*__<mesh>.json``), one
rank's three terms:

  compute term    = sum over dtypes of that dtype's FLOPs / its peak
                    (989e12 bf16 on the tensor cores, 67e12 f32 outside
                    them), so the f32 unembedding shows where it lands
  memory term     = bytes accessed / 3.35e12 B/s (HBM3)
  collective term = collective bytes / 450e9 B/s (NVLink 4, one way)

The peaks are NVIDIA's data sheet for the H100 SXM5, dense, at 700 W
(``repro_torch.launch.count``, the copy the kernel bench and
``chip_smoke.py`` read). The collective term takes one link rate for every
group, as the reference's one ICI rate did: links between hosts (and
pods) are not modelled. The dry run counts every layer and microbatch, so
nothing is extrapolated (the reference's ``extrapolate`` corrects XLA's
once-counted scan bodies).

Also reported: MODEL_FLOPS (6 N_active D for training, 2 N_active D for
inference, the unembedding once), the share of the counted FLOPs that is
useful, the roofline fraction, a rank's peak memory (``peak_bytes_est``)
and whether it fits the card.

  PYTHONPATH=src python benchmarks_torch/roofline_torch.py \\
      [--art-dir artifacts/dryrun_torch] [--mesh single multi]
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from typing import Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.configs.base import SHAPES                     # noqa: E402
from repro_torch.launch.count import (                          # noqa: E402
    H100_MEMORY_BYTES, HBM_BYTES_PER_S, NVLINK_BYTES_PER_S, PEAK_FLOPS,
    dtype_name)
from repro_torch.models.params import (                         # noqa: E402
    model_defs, padded_experts, param_count)

PEAKS = {dtype_name(k): v for k, v in PEAK_FLOPS.items()}
BF16_PEAK = PEAKS["bfloat16"]
DEFAULT_ART = "artifacts/dryrun_torch"
DEFAULT_OUT = "artifacts/roofline_torch"


# ---------------------------------------------------------------------------
# Analytic model FLOPs
# ---------------------------------------------------------------------------

def active_params(cfg) -> int:
    """Parameters touched per token (MoE: only routed top-k experts)."""
    total = param_count(model_defs(cfg))
    if cfg.moe is None:
        return total
    moe = cfg.moe
    n_moe_layers = sum(1 for s in cfg.period if s.ffn == "moe") * cfg.n_periods
    n_moe_layers += sum(1 for s in cfg.prelayers if s.ffn == "moe")
    per_expert = 3 * cfg.d_model * moe.d_ff_expert
    routed = n_moe_layers * padded_experts(moe) * per_expert
    active_routed = n_moe_layers * moe.top_k * per_expert
    return total - routed + active_routed


def nonembedding_params(cfg) -> int:
    total = param_count(model_defs(cfg))
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return total - emb


def model_flops(cfg, shape) -> float:
    """6*N_active*tokens (train) / 2*N_active*tokens (prefill) /
    2*N_active*batch per decode step. Unembedding counted once."""
    n_act = active_params(cfg) - cfg.vocab_size * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    unemb = 2 * cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        return (6 * n_act + 3 * unemb) * shape.tokens
    if shape.kind == "prefill":
        return 2 * n_act * shape.tokens + unemb * shape.global_batch
    return (2 * n_act + unemb) * shape.global_batch


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------

def coll_bytes(rec: Dict, key: str = "bytes") -> float:
    return sum(v.get(key, 0) for v in rec.get("collectives", {}).values())


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """Each dtype's FLOPs over its peak; a dtype with no peak of its own
    (integer index arithmetic) at the f32 rate."""
    return sum(n / PEAKS.get(dt, PEAKS["float32"])
               for dt, n in flops_by_dtype.items())


def analyse_cell(cell: Dict) -> Optional[Dict]:
    if cell.get("status") != "ok":
        return None
    cfg = get_config(cell["arch"])
    shape = SHAPES[cell["shape"]]
    full = cell["full"]
    chips = math.prod(cell["mesh_shape"].values())
    flops, hbytes = full["flops"], full["bytes_accessed"]
    cbytes = coll_bytes(full)
    t_compute = compute_seconds(full["flops_by_dtype"])
    t_memory = hbytes / HBM_BYTES_PER_S
    t_coll = cbytes / NVLINK_BYTES_PER_S
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(cfg, shape)                  # global useful FLOPs
    mf_chip = mf / chips
    ideal = mf_chip / BF16_PEAK
    suggestions = {
        "compute": "cut non-useful FLOPs (remat recompute, causal-masked "
                   "tiles, padded experts, the f32 unembedding) or raise "
                   "arithmetic intensity",
        "memory": "reduce HBM traffic: fuse elementwise chains into the "
                  "kernels, bf16 optimizer moments, fewer f32 casts",
        "collective": "re-shard to cut all-gather/all-to-all volume or "
                      "overlap collectives with compute",
    }
    peak = full["memory"]["peak_bytes_est"]
    return {
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "chips": chips,
        "flops_per_chip": flops,
        "flops_by_dtype": full["flops_by_dtype"],
        "bytes_per_chip": hbytes,
        "collective_bytes_per_chip": cbytes,
        "interpod_bytes_per_chip": coll_bytes(full, "interpod_bytes"),
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": mf_chip / flops if flops else 0.0,
        "roofline_fraction": ideal / bound if bound > 0 else 0.0,
        "hbm_per_chip_gib": peak / 2**30,
        "fits": peak <= H100_MEMORY_BYTES,
        "note": suggestions[dominant],
    }


def load(art_dir: str, meshes: Sequence[str] = ("single",)) -> List[Dict]:
    """Every analysed cell of ``meshes`` under ``art_dir``."""
    rows = []
    for mesh in meshes:
        for path in sorted(glob.glob(os.path.join(art_dir,
                                                  f"*__{mesh}.json"))):
            with open(path) as f:
                r = analyse_cell(json.load(f))
            if r:
                rows.append(r)
    rows.sort(key=lambda r: (r["mesh"], r["shape"], r["arch"]))
    return rows


def run(art_dir: str = DEFAULT_ART, out_dir: str = DEFAULT_OUT,
        meshes: Sequence[str] = ("single",)) -> List[Dict]:
    os.makedirs(out_dir, exist_ok=True)
    rows = load(art_dir, meshes)
    if rows:
        keys = [k for k in rows[0] if k != "flops_by_dtype"]
        with open(os.path.join(out_dir, "roofline.csv"), "w") as f:
            f.write(",".join(keys) + "\n")
            for r in rows:
                f.write(",".join(str(r[k]) for k in keys) + "\n")
        with open(os.path.join(out_dir, "roofline.md"), "w") as f:
            f.write("| arch | shape | mesh | compute s | memory s | "
                    "collective s | dominant | MODEL/counted | roofline "
                    "frac | GiB a rank | fits |\n")
            f.write("|---|---|---|---|---|---|---|---|---|---|---|\n")
            for r in rows:
                f.write(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                        f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
                        f"| {r['t_collective_s']:.3e} | {r['dominant']} "
                        f"| {r['useful_ratio']:.2f} "
                        f"| {r['roofline_fraction']:.2f} "
                        f"| {r['hbm_per_chip_gib']:.1f} "
                        f"| {'yes' if r['fits'] else 'no'} |\n")
    with open(os.path.join(out_dir, "roofline.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--art-dir", default=DEFAULT_ART)
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    ap.add_argument("--mesh", nargs="+", default=["single"],
                    choices=["single", "multi", "tiny"])
    args = ap.parse_args(argv)
    rows = run(args.art_dir, args.out_dir, args.mesh)
    print("H100 SXM5 peaks (data sheet, dense, 700 W): bf16 989e12, f32 "
          "67e12 FLOP/s, HBM 3.35e12 B/s, NVLink 450e9 B/s")
    for r in rows:
        print(f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:7s} "
              f"dom={r['dominant']:10s} comp={r['t_compute_s']:.2e}s "
              f"mem={r['t_memory_s']:.2e}s coll={r['t_collective_s']:.2e}s "
              f"useful={r['useful_ratio']:.2f} "
              f"roofline={r['roofline_fraction']:.2f} "
              f"GiB={r['hbm_per_chip_gib']:.1f} fits={r['fits']}")
    return rows


if __name__ == "__main__":
    main()
