"""Run one cell of the benchmark once: see ``harness/cli.py``.

    python cellbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.
"""
import time

T_START = time.perf_counter()

import sys                                                   # noqa: E402
from pathlib import Path                                     # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from cellbench.harness.cli import main                       # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T_START, ROOT))
