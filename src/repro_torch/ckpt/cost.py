"""Checkpoint save/restore cost model.

Pure arithmetic — no torch, no filesystem — so the schedulers can import
it without touching the accelerator stack.

The model prices the two halves of checkpoint-aware restarts:

* **save cost**: each chip writes its own state shard in parallel (the
  real ``save_checkpoint`` is host-sharded the same way), so the transfer
  term depends on per-chip state size, not gang size — but the barrier /
  metadata-commit term grows with the gang, which is what makes wide
  gangs pay a real checkpoint tax.
* **restore cost**: same shape with read bandwidth; paid on every
  restart that resumes from a checkpoint (preemption, failure, or a
  predictive drain).

Per-chip state size is derived from the HBM budget on ``ResourceSpec``
(``checkpoint_gb_per_chip``): model + optimizer state occupy a roughly
fixed fraction of the memory a gang was sized for.

The port's copy of ``repro/ckpt/cost.py``; the code is verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["CheckpointCostModel"]


@dataclass(frozen=True)
class CheckpointCostModel:
    """Size- and interval-dependent checkpoint cost.

    ``state_frac_of_hbm`` is the fraction of per-chip HBM holding state
    worth persisting; bandwidths are per-chip (sharded I/O); the
    ``barrier_*`` terms are the per-participant serial cost of quiescing
    the gang and committing the manifest.
    """

    state_frac_of_hbm: float = 0.3
    write_gb_per_s: float = 8.0
    read_gb_per_s: float = 16.0
    fixed_save_s: float = 1.0
    fixed_restore_s: float = 2.0
    barrier_save_s_per_chip: float = 0.010
    barrier_restore_s_per_chip: float = 0.015

    def job_size_gb(self, resources) -> float:
        """Per-chip checkpoint shard size for a gang's ``ResourceSpec``
        (duck-typed so this module stays import-free: any object with
        ``checkpoint_gb_per_chip`` works)."""
        return resources.checkpoint_gb_per_chip(self.state_frac_of_hbm)

    def save_cost_s(self, size_gb_per_chip: float,
                    chips: float = 1.0) -> float:
        """Wall seconds a gang pauses to take one checkpoint."""
        return (self.fixed_save_s
                + self.barrier_save_s_per_chip * chips
                + size_gb_per_chip / self.write_gb_per_s)

    def restore_cost_s(self, size_gb_per_chip: float,
                       chips: float = 1.0) -> float:
        """Wall seconds a restarted gang pauses to load its last checkpoint
        (on top of scheduler/provisioning restart cost)."""
        return (self.fixed_restore_s
                + self.barrier_restore_s_per_chip * chips
                + size_gb_per_chip / self.read_gb_per_s)

    def overhead_fraction(self, size_gb_per_chip: float, chips: float,
                          interval_s: float) -> float:
        """Fraction of wall time a gang spends saving instead of stepping
        at a given checkpoint interval — the steady-state checkpoint tax
        policies trade against survival probability."""
        c = self.save_cost_s(size_gb_per_chip, chips)
        return c / max(c + interval_s, 1e-9)

    def expected_lost_s(self, interval_s: float) -> float:
        """Expected uncheckpointed work lost to an un-warned failure
        (failure time uniform within the checkpoint interval)."""
        return 0.5 * interval_s
