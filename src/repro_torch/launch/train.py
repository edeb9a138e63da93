"""Training entry point: SyntheticLM batches through ``build_train_step``
on one device, the card by default, with checkpoints and resume.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 100 --ckpt-dir /tmp/run1 --ckpt-every 50

Prints loss, grad norm, lr, step time and tokens/s every 10 steps and at
the last. With ``--ckpt-dir`` it resumes from the latest checkpoint there
(``restored step N``; batches are indexed by step, so the stream goes on
where it stopped), saves every ``--ckpt-every`` steps, keeping 3, and at
the end. Checkpoints are written in JAX's tree layout, so the JAX package
restores them. Not ported yet: ``--mesh``, which waits for distribution
(ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch.ckpt import Checkpointer, latest_step
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, to_torch
from repro_torch.device import resolve_device
from repro_torch.models import state_from_jax, state_to_jax
from repro_torch.train import (OptConfig, TrainConfig, build_train_step,
                               init_train_state)


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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps)
    tcfg = TrainConfig(n_microbatches=args.microbatches)
    step_fn = build_train_step(cfg, ocfg, tcfg)
    data = SyntheticLM(cfg, args.global_batch, args.seq_len, seed=args.seed)
    ck = Checkpointer(args.ckpt_dir, keep=3) if args.ckpt_dir else None

    start = 0
    if ck and latest_step(args.ckpt_dir) is not None:
        tree, man = ck.restore()
        state = state_from_jax(cfg, tree, device)
        start = man["step"]
        print(f"restored step {start}", flush=True)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = init_train_state(cfg, ocfg, gen, device)

    last: Dict[str, float] = {}
    t0 = time.perf_counter()
    since = 0
    for i in range(start, args.steps):
        state, m = step_fn(state, to_torch(data.batch(i), device))
        since += 1
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            last = {k: float(v) for k, v in m.items()}   # waits for the step
            dt = time.perf_counter() - t0
            tok = since * args.global_batch * args.seq_len
            print(f"step {int(last['step']):5d} loss {last['loss']:.4f} "
                  f"gnorm {last['grad_norm']:.3f} lr {last['lr']:.2e} "
                  f"step {1e3 * dt / since:.1f} ms tok/s "
                  f"{tok / max(dt, 1e-9):,.0f} on {device}", flush=True)
            t0, since = time.perf_counter(), 0
        if ck and (i + 1) % args.ckpt_every == 0:
            ck.save(i + 1, state_to_jax(cfg, state))
    if ck:
        ck.save(args.steps, state_to_jax(cfg, state), block=True)
    print("done")
    return last


if __name__ == "__main__":
    main()
