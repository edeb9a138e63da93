"""Baseline against optimized dry-run profiles of the port, in H100 terms.

The port's counterpart of ``benchmarks/compare_profiles.py``: reads two
artifact directories of ``launch/dryrun.py`` (``--profile baseline`` and
``--profile optimized``), runs ``roofline_torch`` on both, and writes a
per-cell before/after table of the three roofline terms, a rank's memory,
the dominant term and the roofline fraction.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out artifacts/dryrun_torch_opt --profile optimized
  PYTHONPATH=src python benchmarks_torch/compare_profiles_torch.py \\
      --baseline artifacts/dryrun_torch --optimized artifacts/dryrun_torch_opt
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from roofline_torch import DEFAULT_ART, load                    # noqa: E402


def by_cell(art_dir: str, meshes: Sequence[str]) -> Dict:
    return {(r["arch"], r["shape"], r["mesh"]): r
            for r in load(art_dir, meshes)}


def delta(b: Optional[Dict], o: Optional[Dict], key: str) -> str:
    if b is None or o is None:
        return "—"
    vb, vo = b[key], o[key]
    if vb <= 0:
        return "—"
    return f"{vb:.2e}→{vo:.2e} ({(1 - vo / vb) * +100:+.0f}%)"


def table(base: Dict, opt: Dict) -> List[str]:
    lines = ["| arch | shape | mesh | compute s (b→o) | memory s (b→o) | "
             "collective s (b→o) | GiB a rank (b→o) | dominant (b→o) | "
             "roofline frac (b→o) |",
             "|---|---|---|---|---|---|---|---|---|"]
    for k in sorted(set(base) | set(opt)):
        b, o = base.get(k), opt.get(k)
        dom = f"{b['dominant'] if b else '—'}→{o['dominant'] if o else '—'}"
        rf = (f"{b['roofline_fraction']:.2f}→{o['roofline_fraction']:.2f}"
              if b and o else "—")
        hbm = (f"{b['hbm_per_chip_gib']:.1f}→{o['hbm_per_chip_gib']:.1f}"
               if b and o else "—")
        lines.append(
            f"| {k[0]} | {k[1]} | {k[2]} "
            f"| {delta(b, o, 't_compute_s')} "
            f"| {delta(b, o, 't_memory_s')} "
            f"| {delta(b, o, 't_collective_s')} "
            f"| {hbm} | {dom} | {rf} |")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=DEFAULT_ART)
    ap.add_argument("--optimized", default=DEFAULT_ART + "_opt")
    ap.add_argument("--mesh", nargs="+", default=["single"],
                    choices=["single", "multi", "tiny"])
    ap.add_argument("--out",
                    default="artifacts/roofline_torch/perf_compare.md")
    args = ap.parse_args(argv)
    lines = table(by_cell(args.baseline, args.mesh),
                  by_cell(args.optimized, args.mesh))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
