"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix. The configuration's file is
the one its ``configs`` entry gives; the traffic mix is
``<bench>/traffic/<traffic>.json``; the limits that decide ``correct`` are
``<bench>/limits/<workload>.json``; a per-layer metric's reader is
``<bench>/metrics/<metric>.py``; the plain reference a configuration's
``reference`` names is ``<bench>/reference/<name>.py``. ``<bench>`` is the
first of ``paths``. A later cell, configuration or metric is added as new
files and entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

# the harness's own directory: the code (kinds, metric readers, references)
# lives here
CODE = Path(__file__).resolve().parents[1]

# what the kinds and the control call on a reference module
REFERENCE_FUNCTIONS = ("exact", "f32_mm", "fp8_mm", "logits", "train")


@dataclass
class Cell:
    workload: Dict              # the entry of ``workloads``
    config: Dict                # the configuration's file
    traffic: Dict               # the traffic mix's file
    limits: Dict                # {check name: limit}
    end_to_end: List[Dict]      # the end-to-end metrics this cell reports
    per_layer: List[Dict]       # the per-layer metrics this cell reports

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files.
    Raises ``KeyError`` for a name the manifest does not hold and
    ``FileNotFoundError`` for a missing file."""
    root = Path(root)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; the "
                       f"workloads are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = root / manifest["paths"][0]
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    layer = [m for m in manifest["per_layer"] if _applies(m, workload)]
    return Cell(w, config, traffic, limits["limits"], e2e, layer)


def reader(name: str) -> Callable[[Dict], Optional[float]]:
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = CODE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cellbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind(name: str):
    """The module ``kinds/<name>.py`` that runs a traffic mix's kind."""
    return importlib.import_module(f"cellbench.kinds.{name}")


def reference(config: Dict):
    """The module ``reference/<name>.py`` that a configuration's
    ``reference`` names. Raises ``LookupError`` naming the module where it
    is not there or lacks one of ``REFERENCE_FUNCTIONS``."""
    name = config.get("reference")
    where = f"configuration {config.get('name')!r}: reference {name!r}"
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z_]\w*", name):
        raise LookupError(f"{where} names no module of reference/")
    path = CODE / "reference" / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"{where}: there is no {path}")
    mod = importlib.import_module(f"cellbench.reference.{name}")
    missing = [f for f in REFERENCE_FUNCTIONS if not callable(
        getattr(mod, f, None))]
    if missing:
        raise LookupError(f"{where}: {path} has no {', '.join(missing)}")
    return mod
