"""Training entry point: SyntheticLM batches through ``build_train_step``
on one device, the card by default, or over a mesh of ranks, with
checkpoints and resume.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 100 --ckpt-dir /tmp/run1 --ckpt-every 50
  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 8 -m repro_torch.launch.train --smoke --device cpu \
      --mesh tiny --steps 4

Prints loss, grad norm, lr, step time and tokens/s every 10 steps and at
the last. With ``--ckpt-dir`` it resumes from the latest checkpoint there
(``restored step N``; batches are indexed by step, so the stream goes on
where it stopped), saves every ``--ckpt-every`` steps, keeping 3, and at
the end. Checkpoints are written in JAX's tree layout, so the JAX package
restores them.

``--mesh`` is the reference's: ``local`` (one rank), ``tiny`` (data 2 x
model 4), ``pod`` (16 x 16) or ``multipod`` (pod 2 x 16 x 16). Over more
than one rank the job runs under ``torch.distributed.run``, which sets
each process's rank and world; the world must equal the mesh's size. Each
rank draws the whole state from the seed and keeps its blocks, takes its
rows of each global batch, and runs the FSDP + TP step with the MoE FFNs
expert-parallel (``RunFlags(distributed=True)``, tokens over the batch
axes). The process group is NCCL when each rank has a card of its own
(``cuda:<local rank>``), gloo when the ranks share one card (all on
``cuda:0``) or run on the CPU. Rank 0 prints and writes the checkpoints,
gathered whole; every rank restores its blocks.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.ckpt import Checkpointer, latest_step
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, to_torch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     make_tiny_mesh)
from repro_torch.models import state_from_jax, state_to_jax
from repro_torch.models.transformer import RunFlags
from repro_torch.parallel.sharding import batch_rows, train_batch_axes
from repro_torch.train import (OptConfig, TrainConfig, build_train_step,
                               init_train_state)

MESHES = {"local": make_local_mesh, "tiny": make_tiny_mesh,
          "pod": make_production_mesh,
          "multipod": lambda: make_production_mesh(multi_pod=True)}


def _join(device: str) -> str:
    """Joins the job ``torch.distributed.run`` started, if any; returns
    this rank's device."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return device
    dev = torch.device(device)
    backend = "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if torch.cuda.device_count() >= int(os.environ.get(
                "LOCAL_WORLD_SIZE", str(world))):
            device, backend = f"cuda:{local}", "nccl"
        else:
            device = "cuda:0"
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method="env://")
    return device


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Runs the loop; returns the last step's metrics as floats (empty when
    the checkpoint is already at ``--steps``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tacc-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", choices=sorted(MESHES), default="local")
    args = ap.parse_args(argv)

    joined = not dist.is_initialized()
    device = resolve_device(_join(args.device))
    joined = joined and dist.is_initialized()
    mesh = MESHES[args.mesh]()
    if math.prod(mesh.axis_sizes) == 1:
        mesh = None                         # one rank: the single-device step
    rank = 0 if mesh is None else mesh.rank
    cfg = get_config(args.arch, smoke=args.smoke)
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps)
    tcfg = TrainConfig(n_microbatches=args.microbatches)
    axes = () if mesh is None else train_batch_axes(mesh)
    step_fn = build_train_step(
        cfg, ocfg, tcfg, mesh=mesh,
        flags=RunFlags(distributed=mesh is not None, token_axes=axes))
    data = SyntheticLM(cfg, args.global_batch, args.seq_len, seed=args.seed)
    ck = (Checkpointer(args.ckpt_dir, keep=3, writer=rank == 0)
          if args.ckpt_dir else None)

    def rows(batch):
        batch = to_torch(batch, device)
        if mesh is None:
            return batch
        return {k: batch_rows(v, mesh, axes, args.microbatches)
                for k, v in batch.items()}

    start = 0
    if ck and latest_step(args.ckpt_dir) is not None:
        tree, man = ck.restore()
        state = state_from_jax(cfg, tree, device, mesh=mesh)
        start = man["step"]
        if rank == 0:
            print(f"restored step {start}", flush=True)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = init_train_state(cfg, ocfg, gen, device, mesh=mesh)

    last: Dict[str, float] = {}
    t0 = time.perf_counter()
    since = 0
    for i in range(start, args.steps):
        state, m = step_fn(state, rows(data.batch(i)))
        since += 1
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            last = {k: float(v) for k, v in m.items()}   # waits for the step
            dt = time.perf_counter() - t0
            tok = since * args.global_batch * args.seq_len
            if rank == 0:
                print(f"step {int(last['step']):5d} loss {last['loss']:.4f} "
                      f"gnorm {last['grad_norm']:.3f} lr {last['lr']:.2e} "
                      f"step {1e3 * dt / since:.1f} ms tok/s "
                      f"{tok / max(dt, 1e-9):,.0f} on {device}", flush=True)
            t0, since = time.perf_counter(), 0
        if ck and (i + 1) % args.ckpt_every == 0:
            ck.save(i + 1, state_to_jax(cfg, state, mesh=mesh))
    if ck:
        ck.save(args.steps, state_to_jax(cfg, state, mesh=mesh), block=True)
    if rank == 0:
        print("done")
    if joined:
        dist.destroy_process_group()
    return last


if __name__ == "__main__":
    main()
