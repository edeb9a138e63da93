"""Task Schema Layer (TACC §3.1, layer 1).

Every task submitted to the cluster is a self-contained, unified
:class:`TaskSpec`: compute/network/QoS requirements, application payload
(code, dependencies, dataset references), and runtime/provisioning
configuration. The canonical JSON serialization is hashed, which gives the
paper's reproducibility guarantee: the same spec hash executes identically on
any TACC instance (deterministic data stream + seeded init + recorded plan).

Isolation tiers: ``chips`` may be fractional for the sub-chip tiers — a
``mig`` partition at 1/``MIG_SLICES`` granularity or a ``shared``
(time-sliced) slot at 1/``SHARED_SLOTS`` — carried as an exact
:class:`fractions.Fraction` (serialized ``"p/q"``), never a float, so all
capacity bookkeeping downstream stays integer-quantized.  ``spot`` marks a
job preemptible-for-capacity: it runs on spare chips and any non-spot demand
may reclaim them (priced by preemption risk in the scheduling layer).

The port's copy of ``repro/core/schema.py``. Its backends are the port's
runtimes, ``torch_train`` and ``torch_serve``, beside ``shell``: a torch
run is not bit-identical to a JAX run, so its spec must not share a JAX
spec's hash, and ``validate`` refuses the reference's ``jax_*`` backends.
A ``shell`` spec serializes, and hashes, exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, Dict, Optional, Union

QOS_CLASSES = ("realtime", "batch", "besteffort")
BACKENDS = ("torch_train", "torch_serve", "shell")

# isolation tiers and their sub-chip quantization (quanta per chip).  The
# cluster's multi-resource allocator and the trace layer import these so the
# whole stack agrees on one exact granularity per tier.
ISOLATION_TIERS = ("exclusive", "mig", "shared")
MIG_SLICES = 7          # MIG-style partitions per chip (1/7-chip granularity)
SHARED_SLOTS = 4        # time-sliced slots per shared chip (oversubscription)

TIER_QUANTA = {"exclusive": 1, "mig": MIG_SLICES, "shared": SHARED_SLOTS}


class SpecError(ValueError):
    pass


def parse_chips(value: Union[int, str, Fraction]) -> Union[int, Fraction]:
    """Normalize a chips demand to an exact int or Fraction (never float).

    Accepts ints, :class:`Fraction` and ``"p/q"`` / ``"n"`` strings (the JSON
    carrier).  Integral fractions collapse to int so whole-chip demands
    compare and serialize exactly as before.
    """
    if isinstance(value, bool):
        raise SpecError(f"chips must be a number, got {value!r}")
    if isinstance(value, float):
        raise SpecError("fractional chips must be exact (Fraction or 'p/q' "
                        f"string), not float {value!r}")
    if isinstance(value, str):
        value = Fraction(value)
    if isinstance(value, Fraction) and value.denominator == 1:
        return int(value)
    if not isinstance(value, (int, Fraction)):
        raise SpecError(f"chips must be int/Fraction/'p/q', got {value!r}")
    return value


def chips_repr(value: Union[int, Fraction]) -> Union[int, str]:
    """JSON-stable carrier: int stays int, a Fraction becomes ``"p/q"``."""
    if isinstance(value, Fraction):
        return f"{value.numerator}/{value.denominator}"
    return value


@dataclass(frozen=True)
class ResourceSpec:
    """Computing / network resource and QoS requirements."""
    chips: Union[int, Fraction, str] = 1
    min_chips: int = 0              # >0 => elastic: may run shrunk
    prefer_single_pod: bool = True  # gang placement hint (ICI locality)
    hbm_gb_per_chip: float = 16.0
    qos: str = "batch"
    priority: int = 0               # higher preempts lower (if preemptible)
    preemptible: bool = True
    max_runtime_s: float = 86400.0
    isolation: str = "exclusive"    # exclusive | mig | shared
    spot: bool = False              # preemptible-for-capacity spare tier

    def __post_init__(self):
        object.__setattr__(self, "chips", parse_chips(self.chips))

    def checkpoint_gb_per_chip(self, state_frac: float = 0.3) -> float:
        """Per-chip checkpoint shard size implied by the HBM budget: model
        + optimizer state occupy a roughly fixed fraction of the memory the
        gang was sized for.  A derived method (not a stored field) so spec
        hashes — and every committed trace artifact keyed on them — are
        unchanged."""
        return state_frac * self.hbm_gb_per_chip

    @property
    def quanta(self) -> int:
        """The demand in the tier's exact integer quanta: whole chips for
        exclusive, 1/MIG_SLICES slices for mig, 1/SHARED_SLOTS slots for
        shared."""
        q = self.chips * TIER_QUANTA.get(self.isolation, 1)
        if isinstance(q, Fraction):
            if q.denominator != 1:
                raise SpecError(
                    f"chips {self.chips} is not quantized for tier "
                    f"{self.isolation!r} (granularity "
                    f"1/{TIER_QUANTA[self.isolation]})")
            return int(q)
        return int(q)

    def validate(self) -> None:
        if self.isolation not in ISOLATION_TIERS:
            raise SpecError(f"isolation must be one of {ISOLATION_TIERS}")
        if self.isolation == "exclusive":
            if not isinstance(self.chips, int) or self.chips < 1:
                raise SpecError("exclusive jobs need integer chips >= 1")
        else:
            if not 0 < self.chips <= 1:
                raise SpecError(f"{self.isolation} jobs take a sub-chip "
                                "demand in (0, 1]")
            if self.min_chips:
                raise SpecError(f"{self.isolation} jobs are not elastic")
            self.quanta                      # raises if not quantized
        if self.min_chips > self.chips:
            raise SpecError("min_chips > chips")
        if self.qos not in QOS_CLASSES:
            raise SpecError(f"qos must be one of {QOS_CLASSES}")


@dataclass(frozen=True)
class RuntimeEnv:
    """Runtime environment / provisioning configuration."""
    backend: str = "torch_train"
    env_vars: Dict[str, str] = field(default_factory=dict)
    mesh_hint: Optional[str] = None      # e.g. "data*model"
    checkpoint_interval_steps: int = 50

    def validate(self) -> None:
        if self.backend not in BACKENDS:
            raise SpecError(f"backend must be one of {BACKENDS}")


@dataclass(frozen=True)
class TaskSpec:
    """The self-contained task description (layer-1 schema)."""
    name: str
    user: str = "anonymous"
    tenant: str = "default"
    resources: ResourceSpec = field(default_factory=ResourceSpec)
    runtime: RuntimeEnv = field(default_factory=RuntimeEnv)
    # backend-specific payload: for torch_train e.g.
    #   {arch, smoke, steps, global_batch, seq_len, lr, seed}
    entry: Dict[str, Any] = field(default_factory=dict)
    # application artifacts: name -> inline content (str) or "cas:<digest>"
    artifacts: Dict[str, str] = field(default_factory=dict)
    # scheduling hints
    estimated_duration_s: float = 600.0
    total_steps: int = 100
    max_retries: int = 3

    def validate(self) -> None:
        if not self.name:
            raise SpecError("task needs a name")
        self.resources.validate()
        self.runtime.validate()
        if self.runtime.backend == "torch_train" and "arch" not in self.entry:
            raise SpecError("torch_train tasks need entry.arch")
        if self.total_steps < 1:
            raise SpecError("total_steps must be >= 1")

    # -- canonical serialization / reproducibility hash ---------------------

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        # Fractions travel as exact "p/q" strings (JSON has no rationals and
        # floats would break the exact-bookkeeping guarantee)
        d["resources"]["chips"] = chips_repr(self.resources.chips)
        return d

    def canonical_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def spec_hash(self) -> str:
        return hashlib.sha256(self.canonical_json().encode()).hexdigest()[:16]

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TaskSpec":
        d = dict(d)
        if "resources" in d and isinstance(d["resources"], dict):
            d["resources"] = ResourceSpec(**d["resources"])
        if "runtime" in d and isinstance(d["runtime"], dict):
            d["runtime"] = RuntimeEnv(**d["runtime"])
        return TaskSpec(**d)
