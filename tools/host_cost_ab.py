#!/usr/bin/env python3
"""Host cost of the kernel wrappers, one tree against another, on one
CUDA card.

    git archive <parent> | tar -x -C build/parent
    python3 tools/host_cost_ab.py build/parent

Runs, in turn, the other tree, this one, this one, the other (each in a
process of its own, from that tree's root, with that tree's
``chip_smoke.py`` and ``src``): phases 1 and 2 (the card, the kernels'
build), the host microseconds of one call of ``rmsnorm`` (8 x 768 bf16),
``rmsnorm_residual`` and ``flash_attention`` (q = k = v (1, 64, 12, 64)
bf16) under ``inference_mode``, averaged over 20,000 calls (5,000 for
flash) with no synchronisation between them, then phase 5 (tacc-100m
served) three times and phase 9 (20 train steps). Prints one JSON line a
run and the card's name and power limit; writes ``chiprun_out/ab.json``
and each run's output as ``chiprun_out/ab_<i>_<tree>.txt``.
"""
import json
import os
import subprocess
import sys

RUN = r'''
import json, sys, time
import chip_smoke as S
import torch
from repro_torch.kernels import flash_attention, rmsnorm, rmsnorm_residual
S.phase_device()
S.phase_build()

def host_us(fn, n=20000):
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n

g = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(8, 768, generator=g, device="cuda").bfloat16()
w = torch.ones(768, device="cuda")
q = torch.randn(1, 64, 12, 64, generator=g, device="cuda").bfloat16()
with torch.inference_mode():
    calls = {"rmsnorm_us": host_us(lambda: rmsnorm(x, w)),
             "rmsnorm_residual_us": host_us(lambda: rmsnorm_residual(x, x, w)),
             "flash_attention_us": host_us(lambda: flash_attention(q, q, q, causal=True), 5000)}
cfg = S.get_config("tacc-100m")
params = S.init_params(cfg, torch.Generator(device="cuda").manual_seed(S.SEED), "cuda")
serve = [S.phase_serve(cfg, params) for _ in range(3)]
del params
train = S.phase_train(cfg)
print("AB " + json.dumps({
    **calls,
    "decode_step_ms_mean": [s["decode_step_ms_mean"] for s in serve],
    "decode_step_ms_p50": [s["decode_step_ms_p50"] for s in serve],
    "prefill_ms_mean": [s["prefill_ms_mean"] for s in serve],
    "tokens_per_s": [s["tokens_per_s"] for s in serve],
    "train_step_ms_mean": train["step_ms_mean"],
    "train_step_ms_p50": train["step_ms_p50"],
    "launches": serve[0]["launches"]}))
'''

root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
other = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                        else os.path.join(root, "build", "parent"))
out = os.path.join(root, "chiprun_out")
os.makedirs(out, exist_ok=True)
rows = []
for i, (tag, d) in enumerate([("parent", other), ("change", root),
                              ("change", root), ("parent", other)]):
    r = subprocess.run([sys.executable, "-c", RUN], cwd=d,
                       capture_output=True, text=True, timeout=900)
    with open(os.path.join(out, f"ab_{i}_{tag}.txt"), "w") as f:
        f.write(r.stdout + "\n--- stderr\n" + r.stderr)
    line = [l for l in r.stdout.splitlines() if l.startswith("AB ")]
    rec = json.loads(line[-1][3:]) if line else {"rc": r.returncode,
                                                  "err": r.stderr[-2000:]}
    rec["tree"] = tag
    rows.append(rec)
    print(json.dumps(rec), flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
with open(os.path.join(out, "ab.json"), "w") as f:
    json.dump(rows, f, indent=1)
