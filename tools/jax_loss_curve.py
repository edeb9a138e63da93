#!/usr/bin/env python3
"""JAX's loss curve for the port's cluster training job, from the port's
own initial state, and the port's CPU curve beside it.

    PYTHONPATH=src python tools/jax_loss_curve.py [--steps 60] [--port-steps 60]

The job is ``examples/train_cluster_torch.py``'s training job at full size
(``train_spec``); its model, optimizer, train config, data stream and seed
come from ``TorchTrainRuntime.configs`` and ``.stream`` of that spec. The
tool draws the job's initial state as the runtime does (a CPU generator
from the seed), hands it to JAX through ``state_to_jax``, runs JAX's jitted
``build_train_step`` on ``repro.data.SyntheticLM`` batches, then the port's
train step on the CPU from the same state and batches, and writes
``tools/jax_loss_curve.json``: the spec's fields, every leaf's float64 sum
and sum of squares (``chip_smoke.leaf_sums``), JAX's per-step loss and
grad norm, the port's CPU losses and grad norms, and the bar phase 10 of
``chip_smoke.py`` holds the card's curve to (``chip_smoke.jax_curve_bars``).
On an 8-core host a full-size step takes seconds in each framework.

Rerun it after any change to the train step, the initialisation or the
job's spec; phase 10 fails when the initial state's sums differ from the
file's, and ``tests/test_torch_loss_curve.py`` when the spec does. This
tool and the tests are the only code that imports both frameworks.
"""
import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.core.executor import TorchTrainRuntime  # noqa: E402
from repro_torch.data import SyntheticLM, to_torch  # noqa: E402
from repro_torch.models import state_to_jax  # noqa: E402
from repro_torch.train import build_train_step, init_train_state  # noqa: E402


def job_spec(steps: int, smoke: bool = False):
    """The example's training job (its checkpoint interval, which does not
    touch the curve, as phase 10 runs it)."""
    path = os.path.join(ROOT, "examples", "train_cluster_torch.py")
    spec = importlib.util.spec_from_file_location("train_cluster_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.train_spec(smoke=smoke, steps=steps,
                          ckpt_every=chip_smoke.CLUSTER_CKPT_EVERY)


def initial_state(spec) -> dict:
    """The job's initial train state on the CPU, drawn as its runtime
    draws it."""
    cfg, ocfg, _ = TorchTrainRuntime.configs(spec)
    seed = TorchTrainRuntime.stream(spec)[2]
    return init_train_state(cfg, ocfg, torch.Generator().manual_seed(seed),
                            "cpu")


def _clone(state: dict) -> dict:
    return {"params": {k: v.clone() for k, v in state["params"].items()},
            "opt": {"m": {k: v.clone() for k, v in state["opt"]["m"].items()},
                    "v": {k: v.clone() for k, v in state["opt"]["v"].items()},
                    "step": state["opt"]["step"].clone()}}


def jax_config(cfg):
    """The JAX package's config equal to ``cfg`` on every field it has (its
    registered one, full or smoke, with ``cfg``'s dtype); the port's own
    fields (its RoPE scaling) must hold their defaults."""
    from repro.configs import get_config
    base, smoke = (cfg.name[:-len("-smoke")], True) \
        if cfg.name.endswith("-smoke") else (cfg.name, False)
    jcfg = dataclasses.replace(get_config(base, smoke=smoke), dtype=cfg.dtype)
    names = {f.name for f in dataclasses.fields(jcfg)}
    ours = {k: v for k, v in dataclasses.asdict(cfg).items() if k in names}
    own = [f for f in dataclasses.fields(cfg) if f.name not in names]
    if dataclasses.asdict(jcfg) != ours or any(
            getattr(cfg, f.name) != f.default for f in own):
        raise ValueError(f"no JAX config equals {cfg.name}")
    return jcfg


def jax_curve(spec, state: dict, steps: int, cfg=None):
    """JAX's jitted train step from ``state`` (the port's layout, left as
    it is) on ``repro.data.SyntheticLM`` batches: (losses, grad norms).
    ``cfg`` overrides the spec's model config (a test runs f32)."""
    import jax
    import jax.numpy as jnp

    from repro.data import SyntheticLM as JaxSyntheticLM
    from repro.train import OptConfig, TrainConfig
    from repro.train import build_train_step as jax_build_train_step

    pcfg, ocfg, tcfg = TorchTrainRuntime.configs(spec)
    cfg = cfg or pcfg
    batch, seq, seed = TorchTrainRuntime.stream(spec)
    jcfg = jax_config(cfg)
    jocfg = OptConfig(**{
        f.name: (getattr(jnp, str(v).split(".")[-1])
                 if isinstance(v, torch.dtype) else v)
        for f in dataclasses.fields(ocfg) for v in [getattr(ocfg, f.name)]})
    jtcfg = TrainConfig(n_microbatches=tcfg.n_microbatches,
                        z_loss=tcfg.z_loss, aux_scale=tcfg.aux_scale)
    tree = jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), state_to_jax(cfg, state),
        is_leaf=lambda t: isinstance(t, torch.Tensor))
    step = jax.jit(jax_build_train_step(jcfg, jocfg, jtcfg))
    data = JaxSyntheticLM(jcfg, batch, seq, seed=seed)
    losses, norms = [], []
    for i in range(steps):
        tree, m = step(tree, {k: jnp.asarray(v)
                              for k, v in data.batch(i).items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def port_curve(spec, state: dict, steps: int, cfg=None):
    """The port's train step on the CPU from a copy of ``state`` on the
    port's ``SyntheticLM`` batches: (losses, grad norms)."""
    pcfg, ocfg, tcfg = TorchTrainRuntime.configs(spec)
    cfg = cfg or pcfg
    batch, seq, seed = TorchTrainRuntime.stream(spec)
    step = build_train_step(cfg, ocfg, tcfg)
    data = SyntheticLM(cfg, batch, seq, seed=seed)
    state = _clone(state)
    losses, norms = [], []
    for i in range(steps):
        state, m = step(state, to_torch(data.batch(i), "cpu"))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=chip_smoke.CLUSTER_STEPS)
    ap.add_argument("--port-steps", type=int, default=None,
                    help="the port's CPU steps (default: --steps)")
    ap.add_argument("--out", default=chip_smoke.JAX_CURVE)
    args = ap.parse_args(argv)
    port_steps = args.steps if args.port_steps is None else args.port_steps
    torch.set_num_threads(os.cpu_count() or 1)
    spec = job_spec(args.steps)
    state = initial_state(spec)
    out = {"spec": chip_smoke.curve_spec(spec),
           "leaf_sums": chip_smoke.leaf_sums(state), "seconds": {}}
    t0 = time.perf_counter()
    jl, jn = jax_curve(spec, state, args.steps)
    out["seconds"]["jax"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pl, pn = port_curve(spec, state, port_steps)
    out["seconds"]["port_cpu"] = time.perf_counter() - t0
    import jax
    out["jax"] = {"loss": jl, "grad_norm": jn, "version": jax.__version__,
                  "backend": jax.default_backend()}
    out["port_cpu"] = {"loss": pl, "grad_norm": pn,
                       "torch": torch.__version__}
    out["bar"] = chip_smoke.jax_curve_bars(jl, pl)
    out["bar_rule"] = chip_smoke.jax_curve_bars.__doc__.split("\n\n")[0] \
        .replace("\n    ", " ").replace("\n", " ")
    out["max_rel_gap_port_cpu"] = max(
        abs(p - j) / abs(j) for j, p in zip(jl, pl))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: out[k] for k in ("seconds", "max_rel_gap_port_cpu")}))


if __name__ == "__main__":
    main()
