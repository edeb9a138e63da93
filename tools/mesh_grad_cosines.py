#!/usr/bin/env python3
"""How far the FSDP + TP train step's bf16 gradients sit from the single
process's, with the row-parallel partial products summed in f32 and
rounded once (``models/layers.py`` ``row_parallel``, as the step runs) and
with each rank's partial rounded to bf16 before the sum.

    PYTHONPATH=src python3 tools/mesh_grad_cosines.py [--arch A] [--device cpu]

Spawns 4 gloo ranks on a (data 2, model 2) mesh, all on ``cuda:0`` (the
default; it refuses to run without a card) or on the CPU with ``--device
cpu``, draws the arch's smoke config (capacity factor 8 for a MoE) from
seed 0 in the single process and on every rank, takes one step of 8 rows
of 128 tokens, and prints, for each way of summing, the five leaves whose
step-1 gradient has the least cosine to the single process's, with the
single process's own bf16-to-f32 cosine beside them (what bf16 alone
costs), and the card's name and power limit. On the CPU it takes about
35 s.
"""
import argparse
import dataclasses
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.params import train_plan, unshard_leaf  # noqa: E402
from repro_torch.models.transformer import RunFlags  # noqa: E402
from repro_torch.parallel.collectives import psum  # noqa: E402
from repro_torch.parallel.sharding import batch_rows  # noqa: E402
from repro_torch.train import (OptConfig, build_train_step,  # noqa: E402
                               init_train_state)

MESH = ((2, 2), ("data", "model"))
OCFG = OptConfig(lr=3e-4, warmup_steps=2, total_steps=20)


def config(arch: str, dtype: str):
    cfg = get_config(arch, smoke=True)
    over = {"dtype": dtype}
    if cfg.moe is not None:
        over["moe"] = dataclasses.replace(cfg.moe, capacity_factor=8.0)
    return dataclasses.replace(cfg, **over)


def batch(cfg, device):
    b = SyntheticLM(cfg, 8, 128, seed=0).batch(0)
    return {k: torch.from_numpy(v).long().to(device) for k, v in b.items()}


def single(cfg, device):
    state = init_train_state(cfg, OCFG, torch.Generator(device).manual_seed(0),
                             device)
    step = build_train_step(cfg, OCFG, keep_grads=True)
    step(state, batch(cfg, device))
    return {k: v.cpu() for k, v in step.grads.items()}


def bf16_partials(h, w, mesh, axis="model"):
    """``row_parallel`` with each rank's partial rounded to h.dtype."""
    return psum(h @ w.to(h.dtype), axis, mesh)


def rank_main(rank, world, store, out, arch, device, way):
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        if way == "bf16":
            L.row_parallel = A.row_parallel = bf16_partials
        mesh = make_mesh(*MESH)
        cfg = config(arch, "bfloat16")
        state = init_train_state(
            cfg, OCFG, torch.Generator(device).manual_seed(0), device,
            mesh=mesh)
        step = build_train_step(cfg, OCFG, mesh=mesh, keep_grads=True,
                                flags=RunFlags(distributed=True))
        step(state, {k: batch_rows(v, mesh, ("data",))
                     for k, v in batch(cfg, device).items()})
        plan = train_plan(cfg, mesh)
        grads = {k: unshard_leaf(cfg, k, v, plan[k], mesh).cpu()
                 for k, v in step.grads.items()}
        if rank == 0:
            torch.save(grads, out)
    finally:
        dist.destroy_process_group()


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA card: pass --device cpu to run on the CPU")
    ref16 = single(config(args.arch, "bfloat16"), args.device)
    ref32 = single(config(args.arch, "float32"), args.device)
    result = {"arch": args.arch + " smoke", "device": args.device}
    if args.device == "cuda":
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    for way in ("f32", "bf16"):
        work = tempfile.mkdtemp(prefix="mesh_cos_")
        out = os.path.join(work, "grads.pt")
        try:
            mp.spawn(rank_main, args=(4, os.path.join(work, "store"), out,
                                      args.arch, args.device, way), nprocs=4)
            mesh = torch.load(out)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        rows = sorted((cosine(mesh[k], ref16[k]), k,
                       cosine(ref16[k], ref32[k])) for k in ref16)[:5]
        result[f"partials_{way}"] = [
            {"leaf": k, "mesh_vs_single": c, "single_bf16_vs_f32": s}
            for c, k, s in rows]
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
