"""Dry run of the port: every (architecture x input shape x mesh) cell traced
once on the ``meta`` device, with no card. Port of
``repro/launch/dryrun.py``.

For each cell one rank's step runs through the port's own entry points
(``build_train_step``'s step, ``prefill`` or ``decode_step``) on a
``Mesh.view(..., dry=True)`` of the production mesh, on tensors that hold
no data: the rank's parameter, AdamW and cache blocks in the shapes its
plan gives, its rows of the cell's inputs (``data.input_specs``). A
counter (``launch/count.py``) records what the step does:

- ``flops`` (by dtype) and ``bytes_accessed``, from each aten op and from
  each hand kernel's own work;
- ``memory``: ``argument_bytes`` (params, AdamW moments, batch or cache),
  ``output_bytes``, ``alias_bytes`` (outputs written into the arguments:
  the state a step updates in place, the cache a decode writes),
  ``temp_bytes`` (the peak of the storages the step made, above the
  arguments, less the new outputs) and ``peak_bytes_est`` (XLA's formula,
  argument + temp + output - alias);
- ``collectives``: ``parallel/collectives.py``'s tally by kind, each with
  ``count``, ``bytes`` a rank and ``interpod_bytes``.

XLA counts a ``lax.scan`` body once, so the reference lowers reduced
variants and extrapolates (``--variants``, ``benchmarks/roofline.py``
``extrapolate``). The port runs every layer and microbatch as Python, so
the counter sees each one: neither is ported. Neither are the reference's
``seq_parallel_carry`` (an activation sharding constraint) and
``cast_params_early`` (an XLA cast placement): the plan records them as
the reference sets them, and each record lists them under
``no_counterpart``. The port serves with its serving layout
(``params.serving_plan``: experts split over ``model``, every other leaf
whole) where the reference shards serving params as it trains them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
      --shape train_4k --mesh multi

Artifacts go to ``artifacts/dryrun_torch/`` (one JSON a cell and
``summary.json``); the exit code is 1 when any cell failed. ``--jobs N``
traces N cells at a time, each in a process of its own: a cell's trace is
one Python thread, and xlstm-125m's time-step loop makes its train and
prefill cells the longest by far.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import copy
import multiprocessing
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.data.synthetic import input_specs
from repro_torch.launch.count import Counter
from repro_torch.launch.mesh import PRODUCTION_MESHES, TINY_MESHES, Mesh
from repro_torch.models import moe as MOE
from repro_torch.models.params import (DEFAULT_RULES, POD_FSDP_RULES,
                                       abstract_params, compute_dtype,
                                       model_defs, param_count, serving_plan,
                                       train_plan)
from repro_torch.models.transformer import (RunFlags, Transformer,
                                            decode_step, init_cache, prefill)
from repro_torch.parallel import collectives as COLL
from repro_torch.parallel.sharding import (cache_specs, decode_plan,
                                           local_shard, train_batch_axes)
from repro_torch.train import OptConfig, TrainConfig, build_train_step
from repro_torch.train.optimizer import init_opt

BIG_PARAMS = 50e9      # above this: bf16 optimizer moments + pod-FSDP rules
# plan keys the reference's XLA lowering reads and the port has no use for
NO_COUNTERPART = ("seq_parallel_carry", "cast_params_early")
MESHES = {"single": PRODUCTION_MESHES[False],
          "multi": PRODUCTION_MESHES[True],
          "tiny": TINY_MESHES[True]}
DEFAULT_OUT = "artifacts/dryrun_torch"


def dry_mesh(kind: str, rank: int = 0) -> Mesh:
    """Rank ``rank``'s dry view of mesh ``kind`` (``MESHES``)."""
    return Mesh.view(*MESHES[kind], rank, dry=True)


# ---------------------------------------------------------------------------
# Per-cell plans
# ---------------------------------------------------------------------------

def make_plan(cfg: ModelConfig, shape: ShapeConfig, mesh,
              profile: str = "baseline") -> Dict:
    """Per-cell execution plan, key by key the reference's.

    ``baseline`` is the paper-faithful starting point; ``optimized``
    applies the reference's hillclimb: bf16 gradient accumulation and 2
    microbatches for models over ``BIG_PARAMS`` (FSDP re-gathers scale with
    the microbatches), the all-gather MoE combine, and no sequence-parallel
    constraint on prefill."""
    n_params = param_count(model_defs(cfg))
    big = n_params > BIG_PARAMS
    multi = "pod" in mesh.axis_names
    opt = profile == "optimized"
    n_micro = 8
    if opt and big:
        n_micro = 2
    plan = {
        "profile": profile,
        "n_params": int(n_params),
        "opt_moment_dtype": "bfloat16" if big else "float32",
        "rules": "pod_fsdp" if (big and multi) else "default",
        "n_microbatches": n_micro if shape.kind == "train" else 1,
        "seq_parallel_carry": shape.kind == "train" or
        (shape.kind == "prefill" and not opt),
        "accum_dtype": "bfloat16" if (opt and big) else "float32",
        "moe_combine": "allgather" if opt else "psum",
        "cast_params_early": opt,
    }
    if shape.kind == "decode":
        b_axes, s_axes = decode_plan(cfg, shape, mesh)
        plan["decode_batch_axes"] = list(b_axes)
        plan["decode_seq_axes"] = list(s_axes)
    return plan


def _opt_cfg(plan) -> OptConfig:
    dt = (torch.bfloat16 if plan["opt_moment_dtype"] == "bfloat16"
          else torch.float32)
    return OptConfig(m_dtype=dt, v_dtype=dt)


def _rules(plan):
    return POD_FSDP_RULES if plan["rules"] == "pod_fsdp" else DEFAULT_RULES


# ---------------------------------------------------------------------------
# Counting one call
# ---------------------------------------------------------------------------

def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def storage_bytes(tree: Any) -> Dict[int, int]:
    """{storage id: bytes} of every tensor in ``tree``, each storage once."""
    out: Dict[int, int] = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def measure(fn: Callable, *args, track: Optional[str] = "meta"
            ) -> Tuple[Dict, Any]:
    """``fn(*args)`` under a counter that follows ``track``'s storages:
    (the record :func:`report` gives, ``fn``'s outputs). The collectives'
    tally is this call's alone."""
    counter = Counter(track)
    COLL.reset_stats()
    t0 = time.perf_counter()
    with counter:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    return report(counter, args, out, trace_s), out


def report(counter: Counter, args: Any, out: Any, trace_s: float) -> Dict:
    """The record of one counted call (the reference's
    ``compile_and_report``): ``trace_s`` for its ``compile_s``, and no
    ``hlo_chars``."""
    arg_st, out_st = storage_bytes(args), storage_bytes(out)
    argument = sum(arg_st.values())
    output = sum(out_st.values())
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    temp = max(counter.peak - (output - alias), 0)
    rec = counter.report()
    return {"label": "full", "trace_s": round(trace_s, 2),
            "flops": rec["flops"], "flops_by_dtype": rec["flops_by_dtype"],
            "flops_by_op": rec["flops_by_op"],
            "bytes_accessed": rec["bytes_accessed"], "ops": rec["ops"],
            "kernels": rec["kernels"],
            "memory": {"argument_bytes": argument, "output_bytes": output,
                       "temp_bytes": temp, "alias_bytes": alias,
                       "peak_bytes_est": argument + temp + output - alias},
            "collectives": copy.deepcopy(COLL.STATS["by_kind"])}


# ---------------------------------------------------------------------------
# A rank's arguments
# ---------------------------------------------------------------------------

def local_rows(rows: int, mesh, axes: Sequence[str]) -> Tuple[int, bool]:
    """(the most rows a rank holds of ``rows`` split over ``axes``,
    whether the split is uneven): rank 0's ceil share, the rank a dry run
    traces."""
    n = 1 if mesh is None else mesh.size(mesh.live(axes))
    return -(-rows // n), rows % n != 0


def as_batch(specs: Dict[str, torch.Tensor], rows: int, device
             ) -> Dict[str, torch.Tensor]:
    """The leaves of ``input_specs`` at ``rows`` rows on ``device``,
    token ids and labels as the int64 the model indexes with
    (``data.to_torch``)."""
    out = {}
    for k, v in specs.items():
        dt = v.dtype if v.is_floating_point() else torch.int64
        out[k] = torch.zeros((rows,) + tuple(v.shape[1:]), dtype=dt,
                             device=device)
    return out


def train_args(cfg: ModelConfig, ocfg: OptConfig, shape: ShapeConfig,
               mesh=None, rules=None, n_micro: int = 1
               ) -> Tuple[Dict, Dict, Dict]:
    """(state, batch, facts) of one rank's train step: its blocks of the
    params under ``train_plan`` with both AdamW moments, and its rows of
    every microbatch (rank 0's, the most, where the split is uneven)."""
    plan = None if mesh is None else train_plan(cfg, mesh, rules)
    params = abstract_params(model_defs(cfg), mesh=mesh, plan=plan)
    state = {"params": params, "opt": init_opt(params, ocfg)}
    axes = () if mesh is None else train_batch_axes(mesh)
    per, uneven = local_rows(shape.global_batch // n_micro, mesh, axes)
    batch = as_batch(input_specs(cfg, shape), per * n_micro, "meta")
    return state, batch, {"rows": per * n_micro, "uneven": uneven}


def serving_params(cfg: ModelConfig, mesh=None) -> Dict[str, torch.Tensor]:
    """A rank's serving params on meta, in their compute dtypes
    (``init_serving_params``): under ``serving_plan`` on a mesh (its
    experts; every other leaf whole)."""
    plan = None if mesh is None else serving_plan(cfg, mesh)
    out = {}
    for k, t in abstract_params(model_defs(cfg), mesh=mesh,
                                plan=plan).items():
        out[k] = t.to(compute_dtype(cfg, k, t))
    return out


def decode_args(cfg: ModelConfig, shape: ShapeConfig, mesh, b_axes,
                s_axes) -> Tuple[Dict, torch.Tensor, Dict]:
    """(cache, tokens, facts) of one rank's decode step: its block of
    ``init_cache`` under ``cache_specs`` and its tokens."""
    B = shape.global_batch
    cache = init_cache(cfg, B, shape.seq_len, "meta")
    rows, uneven = local_rows(B, mesh, b_axes)
    if mesh is not None:
        specs = cache_specs(cfg, b_axes, s_axes)
        layers = []
        for c, spec in zip(cache["layers"], specs["layers"]):
            layer = {}
            for k, t in c.items():
                sp = spec[k]
                if uneven:               # rank 0's rows, the most
                    t = t[:rows]
                    sp = (None,) + tuple(sp[1:])
                layer[k] = local_shard(t, sp, mesh)
            layers.append(layer)
        cache = {"layers": layers,
                 "lengths": torch.zeros(rows, dtype=torch.int32,
                                        device="meta")}
    tok = input_specs(cfg, shape)["tokens"]
    dt = tok.dtype if tok.is_floating_point() else torch.int64
    tokens = torch.zeros((rows,) + tuple(tok.shape[1:]), dtype=dt,
                         device="meta")
    return cache, tokens, {"rows": rows, "uneven": uneven}


# ---------------------------------------------------------------------------
# Trace one cell
# ---------------------------------------------------------------------------

def quiet_moe(fn: Callable) -> Callable:
    """``fn`` run from ``moe_ep.dropped`` = 0, the module-level count put
    back as it was after (a dry step leaves a meta tensor there, and a
    count on the card cannot take a meta one)."""
    def run(*args):
        held = MOE.moe_ep.dropped
        MOE.moe_ep.dropped = 0
        try:
            return fn(*args)
        finally:
            MOE.moe_ep.dropped = held
    return run


def trace_train(cfg: ModelConfig, shape: ShapeConfig, mesh, plan,
                n_micro: Optional[int] = None,
                global_batch: Optional[int] = None) -> Dict:
    """One rank's train step (the reference's ``lower_train``): its
    moments in ``plan``'s dtype, its microbatches and accumulation dtype,
    ``RunFlags(distributed=True)`` with the tokens over the batch axes."""
    n_micro = plan["n_microbatches"] if n_micro is None else n_micro
    ocfg = _opt_cfg(plan)
    accum = (torch.bfloat16 if plan.get("accum_dtype") == "bfloat16"
             else torch.float32)
    tcfg = TrainConfig(n_microbatches=n_micro, accum_dtype=accum)
    b_axes = train_batch_axes(mesh)
    flags = RunFlags(distributed=True, token_axes=b_axes,
                     moe_combine=plan.get("moe_combine", "psum"))
    rules = _rules(plan)
    sh = shape if global_batch is None else dataclasses.replace(
        shape, global_batch=global_batch)
    state, batch, facts = train_args(cfg, ocfg, sh, mesh, rules, n_micro)
    step = build_train_step(cfg, ocfg, tcfg, remat="full", flags=flags,
                            mesh=mesh, rules=rules)
    rec, _ = measure(quiet_moe(step), state, batch)
    rec.update(facts)
    return rec


def trace_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh, plan,
                  global_batch: Optional[int] = None) -> Dict:
    """One rank's prefill (the reference's ``lower_prefill``): its rows of
    the batch over the batch axes, the serving params, every MoE FFN
    through ``moe_ep``."""
    b_axes = train_batch_axes(mesh)
    flags = RunFlags(distributed=True, token_axes=b_axes,
                     moe_combine=plan.get("moe_combine", "psum"))
    sh = shape if global_batch is None else dataclasses.replace(
        shape, global_batch=global_batch)
    rows, uneven = local_rows(sh.global_batch, mesh, b_axes)
    model = Transformer(cfg, serving_params(cfg, mesh), device="meta")
    batch = as_batch(input_specs(cfg, sh), rows, "meta")
    lengths = torch.zeros(rows, dtype=torch.int32, device="meta")

    def fn(params, batch, lengths):
        with torch.inference_mode():
            return prefill(model, batch, lengths, flags=flags, mesh=mesh)

    rec, _ = measure(quiet_moe(fn), model.state_dict(), batch, lengths)
    rec.update(rows=rows, uneven=uneven)
    return rec


def trace_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, plan,
                 global_batch: Optional[int] = None) -> Dict:
    """One rank's decode step (the reference's ``lower_decode``): the
    cache split per ``cache_specs`` over the plan's batch and sequence
    axes, the serving params."""
    b_axes = tuple(plan["decode_batch_axes"])
    s_axes = tuple(plan["decode_seq_axes"])
    flags = RunFlags(distributed=True, token_axes=b_axes,
                     decode_seq_axes=s_axes,
                     moe_combine=plan.get("moe_combine", "psum"))
    sh = shape if global_batch is None else dataclasses.replace(
        shape, global_batch=global_batch)
    model = Transformer(cfg, serving_params(cfg, mesh), device="meta")
    cache, tokens, facts = decode_args(cfg, sh, mesh, b_axes, s_axes)

    def fn(params, cache, tokens):
        with torch.inference_mode():
            return decode_step(model, cache, tokens, flags=flags, mesh=mesh)

    rec, _ = measure(quiet_moe(fn), model.state_dict(), cache, tokens)
    rec.update(facts)
    return rec


def _mesh_shape(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, [int(s) for s in mesh.axis_sizes]))


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             profile: str = "baseline") -> Dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    result: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "time": time.time()}
    if not shape_applicable(cfg, shape):
        result["status"] = "skipped"
        result["reason"] = ("long_500k needs sub-quadratic attention; "
                            f"{arch} is a pure full-attention arch "
                            "(see DESIGN.md §Arch-applicability)")
        return result
    mesh = dry_mesh(mesh_kind)
    plan = make_plan(cfg, shape, mesh, profile=profile)
    result["plan"] = plan
    result["no_counterpart"] = list(NO_COUNTERPART)
    result["mesh_shape"] = _mesh_shape(mesh)
    result["rank"] = mesh.rank
    trace = {"train": trace_train, "prefill": trace_prefill,
             "decode": trace_decode}[shape.kind]
    try:
        result["full"] = trace(cfg, shape, mesh, plan)
        result["status"] = "ok"
    except Exception as e:
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    return result


def _timed_cell(arch: str, shape_name: str, mesh_kind: str,
                profile: str) -> Dict:
    t0 = time.time()
    rec = run_cell(arch, shape_name, mesh_kind, profile=profile)
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "tiny", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at a time, each in its own process")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    cells = [(arch, shape_name, mesh_kind) for mesh_kind in meshes
             for arch in archs for shape_name in shapes]
    done: Dict[str, Dict] = {}

    def finish(rec: Dict) -> None:
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        status = rec["status"]
        extra = ""
        if status == "ok":
            mem = rec["full"]["memory"]
            extra = (f"flops={rec['full']['flops']:.3e} "
                     f"temp={mem['temp_bytes'] / 2**30:.2f}GiB "
                     f"args={mem['argument_bytes'] / 2**30:.2f}GiB")
        elif status == "error":
            extra = rec["error"][:120]
        print(f"[{rec['wall_s']:7.1f}s] {tag:55s} {status:8s} {extra}",
              flush=True)
        done[tag] = {"cell": tag, "status": status, "wall_s": rec["wall_s"]}

    if args.jobs <= 1:
        for cell in cells:
            finish(_timed_cell(*cell, args.profile))
    else:
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")
                ) as pool:
            futures = [pool.submit(_timed_cell, *cell, args.profile)
                       for cell in cells]
            for fut in concurrent.futures.as_completed(futures):
                finish(fut.result())
    summary = [done[f"{a}__{s}__{m}"] for a, s, m in cells]
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    n_ok = sum(1 for s in summary if s["status"] == "ok")
    n_skip = sum(1 for s in summary if s["status"] == "skipped")
    n_err = len(summary) - n_ok - n_skip
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
