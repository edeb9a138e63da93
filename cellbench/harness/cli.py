"""``python cellbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell on the card, ending in one JSON line.

The line holds ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared with its limit. The same numbers are the
last lines on standard error. A run that finds no card, fewer cards than
the cell asks for, or JAX or the JAX package loaded, prints no result and
exits with another code than 0.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

from cellbench.harness import guard, manifest
from cellbench.harness.compare import within

# the program's and libraries' caches, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "cuda_cache"}


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_caches(root: Path) -> None:
    """The caches' directories, set before torch is imported."""
    for var, sub in CACHES.items():
        os.environ[var] = str(root / "build" / "cellbench" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def device_info(chips: int, peak: int, trace) -> Dict:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(peak)}
    if trace is not None:
        out["busy_s"] = trace.busy_s()
        out["window_s"] = trace.window_s
    return out


def line(cell, out: Dict, trace: bool, setup_s: float, chips: int) -> Dict:
    if trace:
        metrics = {}
        for mt in cell.per_layer:
            v = manifest.reader(mt["name"])(out["ctx"])
            if v is not None:
                metrics[mt["name"]] = {"value": v, "unit": mt["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        metrics = {mt["name"]: {"value": values[mt["name"]],
                                "unit": mt["unit"]} for mt in cell.end_to_end}
    res = {"correct": within(out["checks"]), "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics,
           "device": device_info(chips, out["memory_peak_bytes"],
                                 out.get("trace"))}
    if trace:
        res["breakdown"] = {"device_ops": out["trace"].top_ops(),
                            "idle_gaps": out["trace"].idle_gaps()}
    res["checks"] = out["checks"]
    return res


def main(t_start: float, root: Path, argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    set_caches(root)
    import torch
    cell = manifest.load_cell(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"cellbench: the cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    kind = manifest.kind(cell.traffic["kind"])
    out = kind.run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    setup_s = out["window_start"] - t_start
    bad = guard.forbidden()
    if bad:
        print(f"cellbench: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 3
    res = line(cell, out, bool(args.trace), setup_s, cell.chips)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
