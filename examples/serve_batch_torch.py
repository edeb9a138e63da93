"""Batched serving example on the PyTorch port: a trained small model served
with continuous batching. Requests arrive while others are mid-generation;
slots refill without stalling the batch. The port's counterpart of
``examples/serve_batch.py``; it imports only ``repro_torch``.

  PYTHONPATH=src python examples/serve_batch_torch.py                     # card
  PYTHONPATH=src python examples/serve_batch_torch.py --device cpu
"""
import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, to_torch
from repro_torch.device import resolve_device
from repro_torch.serve import ServeEngine
from repro_torch.train import (OptConfig, TrainConfig, build_train_step,
                               init_train_state)

NEW_TOKENS = 6


def pattern(x: int, v: int, n: int) -> List[int]:
    """The n tokens after x under the learned pattern x -> (5x+17) % V."""
    out = []
    for _ in range(n):
        x = (5 * x + 17) % v
        out.append(x)
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("tacc-100m", smoke=True)
    # quick train so generations follow the synthetic pattern
    ocfg = OptConfig(lr=2e-3, warmup_steps=10, total_steps=80)
    state = init_train_state(cfg, ocfg, torch.Generator().manual_seed(0), dev)
    step = build_train_step(cfg, ocfg, TrainConfig())
    data = SyntheticLM(cfg, 8, 64, seed=0)
    losses = []
    for i in range(args.steps):
        state, m = step(state, to_torch(data.batch(i), dev))
        losses.append(float(m["loss"]))
    print(f"trained to loss {losses[-1]:.3f}")

    engine = ServeEngine(cfg, state["params"], max_batch=4, max_seq=64,
                         device=dev)
    rng = np.random.RandomState(0)
    v = cfg.vocab_size
    prompts = []
    for _ in range(10):
        x = int(rng.randint(0, v))
        prompts.append([x] + pattern(x, v, 5))

    t0 = time.time()
    results = engine.run(prompts, max_new=NEW_TOKENS)
    dt = time.time() - t0
    correct = total = 0
    for r in results:
        expect = pattern(r.prompt[-1], v, NEW_TOKENS)
        hit = sum(a == b for a, b in zip(r.tokens, expect))
        correct += hit
        total += len(expect)
        print(f"  prompt tail {r.prompt[-2:]} -> {r.tokens} "
              f"(expected {expect}, {hit}/{NEW_TOKENS} match)")
    print(f"\npattern accuracy {correct / total:.0%}; "
          f"{len(results)} requests in {dt:.1f}s with continuous batching "
          f"({engine._steps} decode steps)")
    return {"losses": losses, "accuracy": correct / total,
            "results": results, "decode_steps": engine._steps}


if __name__ == "__main__":
    main()
