"""Serving engine benchmark on the port: continuous batching against
sequential service, the port's counterpart of ``benchmarks/bench_serving.py``.

The same prompts (``RandomState(0)``, as the JAX bench draws them) served by
``ServeEngine`` at ``max_batch=4`` and at ``max_batch=1``, after one
untimed request: decode steps, time per token, and the host-clock prefill
and decode times the engine keeps (``engine.timings``).

  PYTHONPATH=src python benchmarks_torch/bench_serving_torch.py          # card
  PYTHONPATH=src python benchmarks_torch/bench_serving_torch.py --device cpu
  PYTHONPATH=src python benchmarks_torch/bench_serving_torch.py \\
      --arch tacc-100m --max-seq 512                          # full width

tacc-100m's smoke config by default; ``--arch`` takes an architecture at
full width. On the card the card's name and power limit are printed beside
the numbers.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np                                              # noqa: E402
import torch                                                    # noqa: E402

from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.device import card, resolve_device             # noqa: E402
from repro_torch.models import init_params                      # noqa: E402
from repro_torch.serve import ServeEngine                       # noqa: E402


def run_bench(n_requests: int = 12, max_new: int = 8, *, max_seq: int = 48,
              cfg=None, params=None, device="cuda"):
    """One bench pass (importable so the tests can smoke it): serve the same
    prompt set with continuous batching and sequentially, returning both
    engines, their result lists and host-clock walls."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_config("tacc-100m", smoke=True)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, cfg.vocab_size, rng.randint(2, 10)))
               for _ in range(n_requests)]
    # one untimed request first: neither timed engine pays the process's
    # first calls on the device (library loads, allocator growth)
    ServeEngine(cfg, params, max_batch=1, max_seq=max_seq,
                device=dev).run(prompts[:1], max_new=2)
    out = {}
    for name, batch in (("batched", 4), ("sequential", 1)):
        eng = ServeEngine(cfg, params, max_batch=batch, max_seq=max_seq,
                          device=dev)
        t0 = time.perf_counter()
        res = eng.run(prompts, max_new=max_new)
        out[name] = (eng, res, time.perf_counter() - t0)
    return out


def rows(out: dict, n_requests: int, max_new: int) -> List[str]:
    """JAX's three rows, then each engine's mean host-clock prefill and
    decode step times."""
    (eng, _, t_cb), (eng1, _, t_seq) = out["batched"], out["sequential"]
    tok = n_requests * max_new
    lines = ["name,us_per_call,derived",
             f"serve_continuous_batch4,{t_cb / tok * 1e6:.0f},"
             f"decode_steps={eng._steps};tokens={tok}",
             f"serve_sequential_batch1,{t_seq / tok * 1e6:.0f},"
             f"decode_steps={eng1._steps};tokens={tok}",
             "serve_speedup,%.2f,steps_ratio=%.2f" % (
                 t_seq / max(t_cb, 1e-9), eng1._steps / max(eng._steps, 1))]
    for name, (e, _, _) in out.items():
        pre, dec = e.timings["prefill"], e.timings["decode"]
        lines.append(f"{name}_host_ms,prefill_mean={1e3 * np.mean(pre):.3f},"
                     f"decode_step_mean={1e3 * np.mean(dec):.3f};"
                     f"prefills={len(pre)};decode_steps={len(dec)}")
    return lines


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=48)
    ap.add_argument("--arch", default=None,
                    help="an architecture at full width (default: "
                         "tacc-100m's smoke config)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch or "tacc-100m", smoke=args.arch is None)
    out = run_bench(args.requests, args.max_new, max_seq=args.max_seq,
                    cfg=cfg, device=dev)
    print(f"{args.arch or 'tacc-100m smoke'}, max_seq {args.max_seq}, "
          f"on {card(dev)}")
    for line in rows(out, args.requests, args.max_new):
        print(line)
    return out


if __name__ == "__main__":
    main()
