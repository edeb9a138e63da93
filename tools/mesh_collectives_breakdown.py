#!/usr/bin/env python3
"""What one collective costs when 4 ranks share one CUDA card over gloo, as
``chip_smoke.py`` phase 17 runs them.

    python3 tools/mesh_collectives_breakdown.py

Spawns 4 ranks on ``cuda:0`` (a ``(data 1, model 4)`` mesh, gloo, as phase
17) and times, per rank and by the host clock, the buffers a qwen2-moe
decode step and prefill hand to ``parallel/collectives.py``: the
attention merge's psum of (8, 16, 1, 128) f32, the aux psum (130 f32),
the decode's all_to_all of (4, 16, 2048) bf16 and the prefill's of
(4, 1024, 2048) bf16. Each in four ways: the module's (pinned host
buffers; a psum as one all_to_all and a local sum), staged by pageable
copies (``t.to("cpu")`` and back; a psum as gloo's all_reduce), gloo on
host tensors (no copy: what gloo alone costs), and the device
synchronisation alone (no collective: what waiting for a card shared by
4 contexts costs). Each at torch's default thread count and at 2 threads
a rank (8 host cores over 4 ranks). Prints the card's name and power
limit, then one JSON line of ms per call, rank by rank.
"""
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.parallel import collectives as COLL  # noqa: E402

WORLD = 4
CASES = {  # name: (shape, dtype, collective, calls)
    "psum_attn_o": ((8, 16, 1, 128), torch.float32, "psum", 100),
    "psum_aux": ((130,), torch.float32, "psum", 100),
    "a2a_decode": ((4, 16, 2048), torch.bfloat16, "all_to_all", 100),
    "a2a_prefill": ((4, 1024, 2048), torch.bfloat16, "all_to_all", 10),
}


def pageable(kind, t, mesh):
    """The collective staged by pageable copies."""
    buf = t.to("cpu")
    group = mesh.group(("model",))[0]
    out = torch.empty_like(buf)
    if kind == "psum":
        out.copy_(buf)
        dist.all_reduce(out, group=group)
    else:
        dist.all_to_all_single(out, buf, group=group)
    return out.to(t.device)


def host(kind, t, mesh):
    """gloo alone, on a host tensor."""
    group = mesh.group(("model",))[0]
    if kind == "psum":
        dist.all_reduce(t, group=group)
        return t
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def module(kind, t, mesh):
    fn = COLL.psum if kind == "psum" else COLL.all_to_all
    return fn(t, "model", mesh)


def sync_only(kind, t, mesh):
    t.add_(0)
    torch.cuda.synchronize()
    return t


def rank_main(rank: int, store: str, out: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((1, WORLD), ("data", "model"))
        res = {}
        for threads in (torch.get_num_threads(), 2):
            torch.set_num_threads(threads)
            for way, fn in (("module_pinned", module),
                            ("pageable", pageable), ("gloo_host", host),
                            ("sync_only", sync_only)):
                for name, (shape, dtype, kind, calls) in CASES.items():
                    dev = "cpu" if way == "gloo_host" else "cuda"
                    t = torch.ones(shape, dtype=dtype, device=dev)
                    for _ in range(3):
                        fn(kind, t, mesh)
                    torch.cuda.synchronize()
                    dist.barrier()
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn(kind, t, mesh)
                    torch.cuda.synchronize()
                    res[f"threads_{threads}/{way}/{name}"] = \
                        (time.perf_counter() - t0) / calls * 1e3
        with open(os.path.join(out, f"{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    work = tempfile.mkdtemp()
    try:
        mp.spawn(rank_main, args=(os.path.join(work, "store"), work),
                 nprocs=WORLD, join=True)
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(work, f"{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"cpu_count": os.cpu_count(), "ms_per_call": ranks}))


if __name__ == "__main__":
    main()
