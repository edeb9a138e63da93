"""Serving driver: load (or init) params and serve a synthetic request
stream through the continuous-batching engine, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.ckpt import restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params, params_from_jax
from repro_torch.serve import ServeEngine


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tacc-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params saved by repro.ckpt.save_checkpoint")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.ckpt_dir:
        state, _ = restore_checkpoint(args.ckpt_dir)
        params = params_from_jax(cfg, state["params"])
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(cfg, gen, device)
    engine = ServeEngine(cfg, params, max_batch=args.max_batch,
                         max_seq=args.max_seq, device=device)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(1, cfg.vocab_size, rng.randint(2, 10)).tolist()
               for _ in range(args.requests)]
    t0 = time.time()
    results = engine.run(prompts, max_new=args.max_new)
    dt = time.time() - t0
    for r in results:
        print(f"req {r.request_id}: {r.prompt} -> {r.tokens}")
    tok = sum(len(r.tokens) for r in results)
    print(f"{len(results)} requests, {tok} tokens in {dt:.1f}s "
          f"({engine._steps} decode steps) on {device}")


if __name__ == "__main__":
    main()
