"""The control and the planted faults that the limits in ``limits/`` were
set against, read at a cell's own size on the card. The benchmark's own
runs never run this.

    python cellbench/control.py --workload <name> --seeds 1 2 3 \
        [--seconds 10]

For each seed it prints one JSON line of readings, each a number that
``correct`` compares:

- training: ``program`` (the program's checked steps, as a run makes
  them), ``control`` (the configuration's plain reference computing its
  products from float8 e4m3 operands, put in the program's place) and
  ``half_batch`` (the program training on half of each batch, the mean
  taken over it), each against the float32 reference. A state left
  unchanged reads 1 by construction (no gradient and no change).
- serving: ``program`` (a run's mean served-token gap over a sample of
  the requests a short window finished) and ``control`` (the mean gap of
  the tokens the e4m3 reference puts first at the same positions), and
  both sides' widest gaps.
"""
import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from cellbench.harness import manifest                       # noqa: E402
from cellbench.harness.cli import set_caches                 # noqa: E402


def train_readings(cell, seed: int, device) -> dict:
    from cellbench.kinds import train as k
    prog = k.Session(cell, seed, device, False).checked()
    k.free()
    half = k.Session(cell, seed, device, False, "half_batch").checked()
    k.free()
    ref = k.reference_readings(cell, seed, device)
    k.free()
    low = k.reference_readings(cell, seed, device, control=True)
    k.free()
    return {"program": k.numbers(prog, ref), "control": k.numbers(low, ref),
            "half_batch": k.numbers(half, ref)}


def serve_readings(cell, seed: int, device, seconds: float) -> dict:
    from cellbench.kinds import serve_closed as k
    keep = {}
    out = k.run(cell, seed, seconds, False, device, keep=keep)
    low = k.reference_gaps(cell.config, keep["params"], keep["picked"],
                           control=True)
    return {"program": {"served_gap_mean":
                        out["checks"]["served_gap_mean"]["value"]},
            "control": {"served_gap_mean": sum(low) / len(low)},
            "widest": {"program": out["widest_gap"], "control": max(low)},
            "sampled_tokens": len(low)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    set_caches(ROOT)
    cell = manifest.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        if cell.traffic["kind"] == "train":
            r = train_readings(cell, seed, args.device)
        else:
            r = serve_readings(cell, seed, args.device, args.seconds)
        print(json.dumps(dict(seed=seed, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
