"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface, ``build/repro_torch/<name>-<hash>.so`` at the root of the
checkout, keyed by a hash of every source under ``csrc/`` and the flags.
A library is built at its first use, and a build failure raises with
nvcc's stderr. :func:`build_all` rebuilds every source, one ``nvcc`` per
source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCE_SUFFIXES = (".cu", ".cuh", ".h")

_loaded: Dict[str, ctypes.CDLL] = {}


def tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which(name) or os.path.join(home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found (looked on PATH and at {path}); "
                           f"the port's CUDA kernels need the CUDA toolkit")
    return path


def source_key() -> str:
    """Hash of every source under ``csrc/`` (``.cu``, ``.cuh``, ``.h``, by
    relative path and content) and the flags: a change to any file a
    library may include rebuilds it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*")
                       if p.suffix in SOURCE_SUFFIXES):
        h.update(b"\0" + path.relative_to(CSRC).as_posix().encode() + b"\0")
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_key()}.so"


def _start(name: str) -> "subprocess.Popen | None":
    out = library_path(name)
    if out.exists():
        return None
    nvcc = tool("nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(name: str, proc: "subprocess.Popen | None") -> str:
    """Wait for one build; returns ptxas's report (empty if it was cached)."""
    if proc is None:
        return ""
    stdout, stderr = proc.communicate()
    out = library_path(name)
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{stderr}{stdout}")
    os.replace(tmp, out)
    return stderr + stdout


def build_all() -> Dict[str, str]:
    """Build every ``csrc/*.cu`` anew, in parallel, even where a library of
    the same key exists, so that ptxas reports on every kernel. Returns
    ptxas's report per source."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    for n in names:
        library_path(n).unlink(missing_ok=True)
    procs = {n: _start(n) for n in names}
    try:
        return {n: _finish(n, p) for n, p in procs.items()}
    finally:                    # a failed build leaves no nvcc running
        for p in procs.values():
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate()


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed. At the
    first load each entry in ``signatures`` gets its ctypes argtypes and an
    int restype."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
