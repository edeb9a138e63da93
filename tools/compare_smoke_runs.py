#!/usr/bin/env python3
"""Compare the phase lines of two ``chip_smoke.py`` outputs, value by value.

    python3 tools/compare_smoke_runs.py A.txt B.txt [--phases 3-18]

Reads every JSON line with a ``"phase"`` key (and the ``{"kernels": ...}``
line) from each output, walks both objects together and compares every
leaf. A leaf whose path names a time, a rate, a memory or disk size, or a
host reading (``TIMING``) is counted and not compared: those move from run
to run. Every other leaf (errors, bars, cosines, losses, launch counts,
token ids, job states, byte counts) must be equal; the differing ones are
printed with their paths. Exits 0 when none differs, 1 otherwise.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, List, Tuple

# a path element naming something measured on a clock or of the machine
TIMING = re.compile(
    r"(^|_)(ms|s|seconds|wall|time|times|timings|tokens_per_s|gb|gib|"
    r"memory|peak|idle|busy|free|disk|reserved|allocated|step_ms|"
    r"call_ms|mean|p50|nvidia_smi|card|kind|torch|cuda|ptxas|profile|"
    r"snapshot_s|write_s|restore_s|stats|quanta|host|logs?|trace|"
    r"top_kernels|top_host_ops|pid|port|path|dir|tmp|started|ended)"
    r"($|_)", re.IGNORECASE)


def phase_lines(path: str) -> Dict[str, dict]:
    """Each phase line by its phase name (a repeated name gets a suffix),
    and the kernels line as ``kernels``."""
    out: Dict[str, dict] = {}
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            name = obj.get("phase") or ("kernels" if "kernels" in obj
                                         else None)
            if name is None:
                continue
            key, n = name, 1
            while key in out:
                n += 1
                key = f"{name}#{n}"
            out[key] = obj
    return out


def walk(a, b, path: Tuple[str, ...], same: List, differ: List,
         skipped: List) -> None:
    if any(TIMING.search(p) for p in path):
        skipped.append(path)
        return
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            if k not in a or k not in b:
                differ.append((path + (k,), a.get(k, "<absent>"),
                               b.get(k, "<absent>")))
            else:
                walk(a[k], b[k], path + (k,), same, differ, skipped)
    elif isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            walk(x, y, path + (str(i),), same, differ, skipped)
    elif a == b or (isinstance(a, float) and isinstance(b, float)
                    and a != a and b != b):
        same.append(path)
    else:
        differ.append((path, a, b))


def compare(a: Dict[str, dict], b: Dict[str, dict], phases=None) -> dict:
    same, differ, skipped = [], [], []
    names = [n for n in a if phases is None or n.split("#")[0] in phases]
    for name in names:
        if name not in b:
            differ.append(((name,), "<phase>", "<absent>"))
            continue
        walk(a[name], b[name], (name,), same, differ, skipped)
    return {"phases": names, "compared": len(same) + len(differ),
            "equal": len(same), "differ": differ, "not_compared":
            len(skipped)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--phases", default=None,
                    help="phase names to compare, comma-separated "
                         "(default: every phase line of A)")
    args = ap.parse_args(argv)
    phases = None if args.phases is None else set(args.phases.split(","))
    res = compare(phase_lines(args.a), phase_lines(args.b), phases)
    for path, x, y in res["differ"]:
        print(f"DIFFER {'.'.join(path)}: {x!r} != {y!r}")
    print(json.dumps({"phases": res["phases"], "compared": res["compared"],
                      "equal": res["equal"], "differ": len(res["differ"]),
                      "not_compared": res["not_compared"]}))
    return 1 if res["differ"] else 0


if __name__ == "__main__":
    sys.exit(main())
