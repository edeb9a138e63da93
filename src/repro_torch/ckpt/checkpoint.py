"""Checkpointing in the format of ``repro/ckpt/checkpoint.py``: per-leaf
``.npy`` files plus a ``manifest.json`` skeleton of dicts, tuples and lists,
staged in ``.tmp`` and renamed into place, with an async keep-N
``Checkpointer``.

Leaves are torch tensors (or numpy arrays) on save and come back as CPU
tensors on restore. ``.npy`` has no bfloat16 or float8: those leaves are
stored as same-width unsigned views and the manifest records the true
dtype, as the reference does, without ``ml_dtypes``. A state saved in JAX's
tree layout (``models/params.py`` ``state_to_jax``) restores into JAX.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_LEAF = "__leaf__"

# dtype name (numpy's and ``ml_dtypes``', as the manifest records it) ->
# (the unsigned view stored, the same-width integer view torch reads it
# through, the torch dtype)
_BITCAST = {
    "bfloat16": (np.uint16, np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, np.uint8, torch.float8_e5m2),
}
_TORCH_INT = {np.int16: torch.int16, np.uint8: torch.uint8}


def _to_skeleton(tree: Any, leaves: List[Any]) -> Any:
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _to_skeleton(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, (tuple, list)):
        return {"__kind__": "tuple" if isinstance(tree, tuple) else "list",
                "items": [_to_skeleton(v, leaves) for v in tree]}
    leaves.append(tree)
    return {"__kind__": _LEAF, "index": len(leaves) - 1}


def _from_skeleton(skel: Any, leaves: List[Any]) -> Any:
    kind = skel["__kind__"]
    if kind == "dict":
        return {k: _from_skeleton(v, leaves) for k, v in skel["items"].items()}
    if kind == "tuple":
        return tuple(_from_skeleton(v, leaves) for v in skel["items"])
    if kind == "list":
        return [_from_skeleton(v, leaves) for v in skel["items"]]
    return leaves[skel["index"]]


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:010d}")


def _encode(leaf: Any) -> Tuple[np.ndarray, str]:
    """A CPU tensor or numpy array -> (array ``np.save`` can write, the
    true dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type != "cpu":
            raise ValueError(f"leaf on {leaf.device}: snapshot to the CPU "
                             f"first")
        name = str(leaf.dtype).removeprefix("torch.")
        if name in _BITCAST:
            stored, via, _ = _BITCAST[name]
            return (leaf.contiguous().view(_TORCH_INT[via]).numpy()
                    .view(stored), name)
        return leaf.contiguous().numpy(), name
    arr = np.asarray(leaf)
    name = arr.dtype.name
    if name in _BITCAST:
        return arr.view(_BITCAST[name][0]), name
    return arr, name


def _decode(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    if name in _BITCAST:
        _, via, torch_dtype = _BITCAST[name]
        return torch.from_numpy(arr.view(via)).view(torch_dtype)
    if name is not None and name != arr.dtype.name:
        raise ValueError(f"leaf stored as {arr.dtype.name}, manifest says "
                         f"{name}: not a format this port reads")
    return torch.from_numpy(arr)


def save_checkpoint(root: str, step: int, state: Any, *,
                    extra: Optional[Dict] = None) -> str:
    """Writes ``state`` (CPU tensors or numpy arrays in dicts, tuples and
    lists) under ``root/step_<step>``; returns that directory. Its
    ``manifest.json`` holds the step, skeleton, dtypes and bytes."""
    os.makedirs(root, exist_ok=True)
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    # everything before the rename happens in the .tmp staging dir, which
    # any failure tears down: no reader ever sees a half-written step dir
    try:
        leaves: List[Any] = []
        skel = _to_skeleton(state, leaves)
        dtypes: List[str] = []
        nbytes = 0
        for i, leaf in enumerate(leaves):
            arr, name = _encode(leaf)
            dtypes.append(name)
            nbytes += arr.nbytes
            np.save(os.path.join(tmp, f"leaf_{i:06d}.npy"), arr)
        manifest = {"step": step, "skeleton": skel, "extra": extra or {},
                    "n_leaves": len(leaves), "dtypes": dtypes,
                    "nbytes": nbytes, "time": time.time()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


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


def _snapshot(leaf: Any) -> Any:
    # a copy even for a CPU tensor, whose .cpu() is the same storage: the
    # optimizer overwrites params and moments in place
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class Checkpointer:
    """Async checkpoint manager with keep-N retention.

    ``save`` copies the state to host memory, then writes it on a thread;
    an error there is raised by the next ``wait`` (or ``save``). ``saves``
    records each finished save: step, bytes, the seconds ``save`` took to
    copy (``snapshot_s``) and the thread's seconds to write (``write_s``).
    """

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves: List[Dict[str, float]] = []

    def save(self, step: int, state: Any, *, block: bool = False,
             extra: Optional[Dict] = None) -> None:
        self.wait()
        t0 = time.perf_counter()
        host_state = _map(_snapshot, state)
        snapshot_s = time.perf_counter() - t0

        def work():
            try:
                t1 = time.perf_counter()
                path = save_checkpoint(self.root, step, host_state,
                                       extra=extra)
                write_s = time.perf_counter() - t1
                with open(os.path.join(path, "manifest.json")) as f:
                    nbytes = json.load(f)["nbytes"]
                self._gc()
                self.saves.append({"step": step, "bytes": nbytes,
                                   "snapshot_s": snapshot_s,
                                   "write_s": write_s})
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.root)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)

    def restore(self, step: Optional[int] = None) -> Tuple[Any, Dict]:
        self.wait()
        return restore_checkpoint(self.root, step)
