"""Checkpoint restore for the format ``repro/ckpt/checkpoint.py`` writes:
per-leaf ``.npy`` files plus a ``manifest.json`` skeleton of dicts, tuples
and lists. Leaves come back as CPU tensors; bfloat16 leaves, stored as a
``uint16`` view, are decoded without ``ml_dtypes``.

Saving comes with the training slice (ROADMAP Queue 1, item 7).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# dtype names the reference stores as same-width unsigned views
_BITCAST = {"bfloat16": (np.int16, torch.bfloat16)}


def _from_skeleton(skel: Any, leaves: List[Any]) -> Any:
    kind = skel["__kind__"]
    if kind == "dict":
        return {k: _from_skeleton(v, leaves) for k, v in skel["items"].items()}
    if kind == "tuple":
        return tuple(_from_skeleton(v, leaves) for v in skel["items"])
    if kind == "list":
        return [_from_skeleton(v, leaves) for v in skel["items"]]
    return leaves[skel["index"]]


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:010d}")


def _decode(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    if name in _BITCAST:
        np_view, torch_dtype = _BITCAST[name]
        return torch.from_numpy(arr.view(np_view)).view(torch_dtype)
    if name is not None and name != arr.dtype.name:
        raise ValueError(f"leaf stored as {arr.dtype.name}, manifest says "
                         f"{name}: not a format this port reads")
    return torch.from_numpy(arr)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(root: str, step: Optional[int] = None
                       ) -> Tuple[Any, Dict]:
    """Returns (state, manifest); the latest step when ``step`` is None."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes") or [None] * manifest["n_leaves"]
    leaves = [_decode(np.load(os.path.join(d, f"leaf_{i:06d}.npy")), dt)
              for i, dt in enumerate(dtypes)]
    return _from_skeleton(manifest["skeleton"], leaves), manifest
