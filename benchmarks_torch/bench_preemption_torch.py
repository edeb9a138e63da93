"""Checkpoint-then-preempt overhead on the port (Execution Layer): the port's
counterpart of ``benchmarks/bench_preemption.py``.

Measured: a synchronous save, an asynchronous ``Checkpointer.save`` (its
submit, then its ``wait``) and a restore, of a train state made on the
device at growing d_model, then of tacc-100m at full width (the state
``chip_smoke.py`` phase 10 saves). The state lives on the card, so each
save pays the copy to the host. Simulated: the end-to-end JCT penalty of
one preemption at several checkpoint intervals, through the port's copy of
the control plane (``repro_torch.core``) on JAX's two-job trace.

  PYTHONPATH=src python benchmarks_torch/bench_preemption_torch.py          # card
  PYTHONPATH=src python benchmarks_torch/bench_preemption_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch                                                    # noqa: E402

from repro_torch.ckpt import (Checkpointer, restore_checkpoint,  # noqa: E402
                              save_checkpoint)
from repro_torch.ckpt.checkpoint import _map, _snapshot         # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.device import card, resolve_device             # noqa: E402
from repro_torch.models import state_to_jax                     # noqa: E402
from repro_torch.train import OptConfig, init_train_state       # noqa: E402


def ckpt_config(d_model: int):
    """JAX's bench's config: tacc-100m's smoke config at ``d_model``."""
    return get_config("tacc-100m", smoke=True).smoke(
        d_model=d_model, n_heads=4, n_kv_heads=2, head_dim=d_model // 4,
        d_ff=d_model * 4, vocab_size=4096)


def measure_ckpt(d_model: Optional[int] = None, device="cuda", *, cfg=None):
    """(state bytes, sync save s, async submit s, async wait s, restore s)
    of a train state of ``ckpt_config(d_model)`` (or ``cfg``) drawn on the
    CPU from seed 0 and moved to ``device``. The sync save copies the state
    to the host in JAX's layout, then writes it; ``Checkpointer.save``
    copies it in its submit and writes it on a thread."""
    dev = resolve_device(device)
    cfg = cfg or ckpt_config(d_model)
    state = init_train_state(cfg, OptConfig(),
                             torch.Generator().manual_seed(0), dev)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in _leaves(state))
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    with tempfile.TemporaryDirectory() as td:
        sync()
        t0 = time.perf_counter()
        save_checkpoint(td, 1, _map(_snapshot, state_to_jax(cfg, state)))
        t_sync = time.perf_counter() - t0
        ck = Checkpointer(td, keep=2)
        t0 = time.perf_counter()
        ck.save(2, state_to_jax(cfg, state))    # returns after the copy
        t_submit = time.perf_counter() - t0
        ck.wait()
        t_wait = time.perf_counter() - t0 - t_submit
        t0 = time.perf_counter()
        restore_checkpoint(td, 2)
        t_restore = time.perf_counter() - t0
    return n_bytes, t_sync, t_submit, t_wait, t_restore


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def sim_preemption_penalty(engine: str = "event", verbose: bool = True):
    """JCT overhead of one preemption vs checkpoint interval (virtual time):
    rows of (interval, victim end time, preemptions, sim wall s)."""
    from repro_torch.core import Cluster, ClusterSim, SimConfig, make_policy
    from repro_torch.core.compiler import ArtifactStore, TaskCompiler
    from repro_torch.data.trace import Trace, TraceJob
    trace = Trace(jobs=[
        TraceJob(id="low", submit_time=0.0, chips=32, total_steps=300,
                 work_per_step=28.0, estimated_duration_s=300),
        TraceJob(id="hi", submit_time=100.0, chips=16, priority=10,
                 total_steps=60, work_per_step=14.0,
                 estimated_duration_s=60),
    ], meta={"scenario": "one-preemption"})
    rows = []
    for interval in (10, 30, 60, 120):
        with tempfile.TemporaryDirectory() as td:
            comp = TaskCompiler(ArtifactStore(td + "/cas"), td + "/work")
            cluster = Cluster(n_pods=1, hosts_per_pod=8, chips_per_host=4)
            sim = ClusterSim(cluster, make_policy("priority"), SimConfig(
                checkpoint_interval_s=interval, checkpoint_cost_s=2,
                restart_cost_s=10, engine=engine))
            trace.install(sim, comp)
            t0 = time.perf_counter()
            sim.run()
            wall = time.perf_counter() - t0
            j = sim.jobs["low"]
            rows.append((interval, j.end_time, j.preemptions, wall))
    if verbose:
        base = min(r[1] for r in rows)
        print(f"\n{'ckpt_interval_s':>15s} {'victim_jct':>10s} "
              f"{'overhead%':>10s} {'sim_wall_s':>10s}")
        for interval, end, pre, wall in rows:
            print(f"{interval:15d} {end:10.0f} "
                  f"{100 * (end - base) / base:10.1f} {wall:10.4f}")
    return rows


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legacy-tick", action="store_true",
                    help="use the fixed-tick sim engine (parity oracle)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-full", action="store_true",
                    help="leave out tacc-100m at full width")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"on {card(dev)}")
    print(f"{'state':>16s} {'state_MiB':>10s} {'save_s':>8s} "
          f"{'async_submit_s':>14s} {'async_wait_s':>12s} "
          f"{'restore_s':>10s}")
    runs = [(f"d_model {d}", ckpt_config(d)) for d in (64, 128, 256, 512)]
    if not args.no_full:
        runs.append(("tacc-100m", get_config("tacc-100m")))
    measured = {}
    for name, cfg in runs:
        measured[name] = n, ts, ta, tw, tr = measure_ckpt(device=dev, cfg=cfg)
        print(f"{name:>16s} {n / 2**20:10.1f} {ts:8.3f} {ta:14.4f} "
              f"{tw:12.3f} {tr:10.3f}", flush=True)
    rows = sim_preemption_penalty("tick" if args.legacy_tick else "event")
    return {"ckpt": measured, "sim": rows}


if __name__ == "__main__":
    main()
