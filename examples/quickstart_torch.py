"""Quickstart on the PyTorch port: the public API in about 60 lines.

Builds a small dense LM, trains it on the synthetic stream in two
microbatches a step, checkpoints, restores, and generates tokens through
the serving engine. The port's counterpart of ``examples/quickstart.py``;
it imports only ``repro_torch``.

  PYTHONPATH=src python examples/quickstart_torch.py                      # card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --steps 10

``train`` is the training half, which ``chip_smoke.py`` runs on the card
and on the CPU from the same seed.
"""
import argparse
import tempfile
from typing import List, Optional

import torch

from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.ckpt.checkpoint import _map, _snapshot
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, to_torch
from repro_torch.device import resolve_device
from repro_torch.models import state_from_jax, state_to_jax
from repro_torch.serve import ServeEngine
from repro_torch.train import (OptConfig, TrainConfig, build_train_step,
                               init_train_state)

PROMPTS = [[1, 2, 3], [10, 20], [7, 7, 7, 7]]


def train(device="cuda", steps: int = 50, verbose: bool = True):
    """(cfg, state, per-step metrics as floats): the smoke model trained
    ``steps`` steps, 2 microbatches each, from a state drawn on the CPU
    from seed 0 (the same state on every device)."""
    dev = resolve_device(device)
    cfg = get_config("tacc-100m", smoke=True)          # tiny same-family model
    ocfg = OptConfig(lr=2e-3, warmup_steps=10, total_steps=100)
    state = init_train_state(cfg, ocfg, torch.Generator().manual_seed(0), dev)
    step = build_train_step(cfg, ocfg, TrainConfig(n_microbatches=2))
    data = SyntheticLM(cfg, global_batch=8, seq_len=64, seed=0)
    metrics = []
    for i in range(steps):
        state, m = step(state, to_torch(data.batch(i), dev))
        metrics.append({k: float(v) for k, v in m.items()})
        if verbose and i % 10 == 0:
            print(f"  step {int(metrics[-1]['step']):3d} loss "
                  f"{metrics[-1]['loss']:.3f} acc "
                  f"{metrics[-1]['accuracy']:.3f}")
    return cfg, state, metrics


def equal(a, b) -> bool:
    """Whether two trees of tensors are equal leaf for leaf, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(equal, a, b))
    return torch.equal(a, b)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)

    print("training...")
    cfg, state, metrics = train(args.device, args.steps)

    with tempfile.TemporaryDirectory() as td:
        saved = _map(_snapshot, state_to_jax(cfg, state))
        save_checkpoint(td, args.steps, saved)
        tree, _ = restore_checkpoint(td)
    same = equal(tree, saved) and equal(
        state_from_jax(cfg, tree, args.device), state)
    print(f"checkpoint roundtrip {'ok' if same else 'CHANGED THE STATE'}")

    print("serving...")
    engine = ServeEngine(cfg, state["params"], max_batch=4, max_seq=64,
                         device=args.device)
    results = engine.run(PROMPTS, max_new=8)
    for r in results:
        print(f"  prompt {r.prompt} -> {r.tokens}")
    return {"metrics": metrics, "restored_equal": same, "results": results}


if __name__ == "__main__":
    main()
