"""Benchmark harness of the port: its kernel, serving and checkpoint /
preemption benches, then the H100 roofline from the dry-run artifacts.
The port's counterpart of ``benchmarks/run.py`` (the scheduler, cache and
elastic benches are the JAX package's and are not ported, ROADMAP's "Not
to port").

  PYTHONPATH=src python benchmarks_torch/run_torch.py                # card
  PYTHONPATH=src python benchmarks_torch/run_torch.py --device cpu

The kernel bench writes its snapshot under ``--out`` (not the committed
``BENCH_kernels_torch.json``: ``bench_kernels_torch.py`` alone rewrites
that). The roofline runs when ``artifacts/dryrun_torch`` exists
(``python -m repro_torch.launch.dryrun --all``). Exit 1 when a section
failed.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

from repro_torch.device import resolve_device                   # noqa: E402


def section(title: str) -> None:
    print(f"\n{'=' * 72}\n== {title}\n{'=' * 72}", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="artifacts/bench_torch")
    ap.add_argument("--art-dir", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    resolve_device(args.device)         # the card, unless asked for the CPU
    os.makedirs(args.out, exist_ok=True)
    dev = ["--device", args.device]
    t0 = time.time()
    failures = []

    def run(name, title, fn):
        section(title)
        try:
            rc = fn()
            if isinstance(rc, int) and rc:
                failures.append(name)
        except Exception:
            failures.append(name)
            traceback.print_exc()

    import bench_kernels_torch
    import bench_preemption_torch
    import bench_serving_torch
    import roofline_torch
    run("kernels", "Hand kernels against their plain versions",
        lambda: bench_kernels_torch.main(
            dev + ["--out", os.path.join(args.out, "kernels.json")]))
    run("serving", "Serving engine (continuous batching)",
        lambda: bench_serving_torch.main(dev) and 0)
    run("preemption", "Checkpoint-then-preempt overhead",
        lambda: bench_preemption_torch.main(
            dev + (["--no-full"] if args.device == "cpu" else [])) and 0)
    section("Roofline (from the dry-run artifacts)")
    if os.path.isdir(args.art_dir):
        try:
            roofline_torch.main(["--art-dir", args.art_dir])
        except Exception:
            failures.append("roofline")
            traceback.print_exc()
    else:
        print(f"no {args.art_dir}: run `python -m repro_torch.launch.dryrun "
              f"--all` first")
    print(f"\nbenchmarks done in {time.time() - t0:.0f}s; "
          f"failures: {failures or 'none'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
