"""Compiler Layer (TACC §3.1, layer 2).

Parses a :class:`TaskSpec`, prepares the runtime environment, and emits a
self-contained, execution-ready :class:`ExecutionPlan`. Artifacts (code,
dependencies, datasets) are staged through a content-addressed store with
*delta caching*: resubmitting a task re-ships only changed content — the
paper's mechanism for large task instructions with duplicate files across
submissions.

For torch_* backends the plan also resolves the model config and the mesh
request, so the Execution Layer receives everything needed to run without
consulting the schema again (reproducible execution).

The port's copy of ``repro/core/compiler.py``: the same code, with the
model resolved through ``repro_torch.configs``.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.core.schema import TaskSpec, SpecError


class ArtifactStore:
    """Content-addressed artifact store (CAS). Keys are sha256 digests."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.stats = {"put_bytes": 0, "dedup_bytes": 0, "puts": 0, "hits": 0}

    def _path(self, digest: str) -> str:
        return os.path.join(self.root, digest[:2], digest)

    def put(self, content: bytes) -> str:
        digest = hashlib.sha256(content).hexdigest()
        p = self._path(digest)
        self.stats["puts"] += 1
        if os.path.exists(p):
            self.stats["hits"] += 1
            self.stats["dedup_bytes"] += len(content)
            return digest
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(content)
        os.rename(tmp, p)
        self.stats["put_bytes"] += len(content)
        return digest

    def get(self, digest: str) -> bytes:
        with open(self._path(digest), "rb") as f:
            return f.read()

    def has(self, digest: str) -> bool:
        return os.path.exists(self._path(digest))


@dataclass
class ExecutionPlan:
    """Execution-ready task instruction (self-contained)."""
    plan_id: str
    spec: TaskSpec
    backend: str
    staged: Dict[str, str]            # artifact name -> cas digest
    model: Optional[Dict[str, Any]]   # resolved arch/config summary
    mesh_request: Dict[str, Any]
    workdir: str
    created: float = field(default_factory=time.time)
    cache_report: Dict[str, int] = field(default_factory=dict)


class TaskCompiler:
    def __init__(self, store: ArtifactStore, workroot: str):
        self.store = store
        self.workroot = workroot
        os.makedirs(workroot, exist_ok=True)

    def compile(self, spec: TaskSpec) -> ExecutionPlan:
        spec.validate()
        before = dict(self.store.stats)
        staged: Dict[str, str] = {}
        for name, content in sorted(spec.artifacts.items()):
            if content.startswith("cas:"):
                digest = content[4:]
                if not self.store.has(digest):
                    raise SpecError(f"artifact {name}: unknown digest {digest}")
                staged[name] = digest
            else:
                staged[name] = self.store.put(content.encode())
        model = self._resolve_model(spec)
        mesh_request = {
            "chips": spec.resources.chips,
            "min_chips": spec.resources.min_chips or spec.resources.chips,
            "prefer_single_pod": spec.resources.prefer_single_pod,
            "isolation": spec.resources.isolation,
            "quanta": spec.resources.quanta,
            "spot": spec.resources.spot,
        }
        plan_id = hashlib.sha256(
            (spec.spec_hash() + json.dumps(staged, sort_keys=True)).encode()
        ).hexdigest()[:16]
        workdir = os.path.join(self.workroot, plan_id)
        os.makedirs(workdir, exist_ok=True)
        after = self.store.stats
        report = {
            "new_bytes": after["put_bytes"] - before["put_bytes"],
            "cached_bytes": after["dedup_bytes"] - before["dedup_bytes"],
            "artifacts": len(staged),
        }
        return ExecutionPlan(plan_id=plan_id, spec=spec,
                             backend=spec.runtime.backend, staged=staged,
                             model=model, mesh_request=mesh_request,
                             workdir=workdir, cache_report=report)

    def _resolve_model(self, spec: TaskSpec) -> Optional[Dict[str, Any]]:
        if spec.runtime.backend == "shell":
            return None
        from repro_torch.configs import get_config
        entry = spec.entry
        cfg = get_config(entry["arch"], smoke=entry.get("smoke", False))
        return {"arch": cfg.name, "family": cfg.family,
                "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                "vocab": cfg.vocab_size}
