#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: every kernel under src/repro_torch/kernels/csrc/ with nvcc,
   built anew so that ptxas reports on each; HGMMA (wgmma) in the SASS of
   every bf16 flash-attention kernel (forward, K1b-dq and K1b-dkdv, each
   at D = 64, 128 and 192), no spills in the three bf16 kernels at D =
   192, and 128-bit global loads and stores in every 16-byte rmsnorm
   kernel;
3. kernels: each kernel against its plain PyTorch version at the serving
   shapes of tacc-100m (k/v as strided views of one tensor, as the model
   gives them), with its time, the plain version's, one PyTorch library
   call's where there is one, and its bound on this card; flash attention
   also at its edges (a row with no valid key, a ragged tile at a batch
   boundary, head dim 128; in f32 S = 33, 65 and 129 with lengths around
   the tile edges, with and without its key split, and a base 4 bytes off,
   which must be copied), its o bit-equal over two calls and its strided
   k/v read without a copy, and ptxas's spills of the D = 64 f32 forward
   kernels 0; K1 at D = 192 (MLA's q/k width) in both dtypes, timed at
   deepseek-v2's prefill shape q (1, 512, 128, 192) and checked at
   S = 33, 65, 129 and 512 with lengths around the tile edges and 0,
   causal and full; the norms at theirs (one row, a ragged last
   block, a row or base off 16 bytes, rows of 512, 1536, 2048, 5120, 8192
   and 16384, and the serving job's rows of 64 in phase 10),
   each with the variant the wrapper launched; and the launch floor, an
   empty kernel's time; K1, K2 and K3 also at the training shapes
   (q (16, 128, 12, 64), rows (2048, 768));
4. consistency: full-width tacc-100m, prefill + 4 decode steps against the
   full forward, and a prefill against the plain path on the CPU;
5. serve: ServeEngine(max_batch=8, max_seq=512) serves 16 requests; every
   kernel's launch count must move;
6. profile: torch.profiler over 8 prefills and 16 decode steps, for the
   time the card is busy and idle;
7. kernels_bwd: each backward kernel (K1b-dq, K1b-dkdv, and K2b and K3b,
   each giving dx and dw in one launch) against its plain backward, at the
   training shapes of tacc-100m and at their edges (flash also with q and
   dO as transposed views and k/v as views of one fused tensor, read in
   place), with its time, the plain version's, the backward of one PyTorch
   call where there is one, and its bound; K1b's and dw's outputs must be
   bit-equal over two calls, dw also under a CUDA graph's replay; ptxas's
   spills of the D = 64 K1b kernels (bf16 and f32) must be 0; K1b bf16 at
   D = 192 (MLA's q/k width; SDPA's backward under the first backend that
   takes the shape, named), timed at q and k/v (8, 128, 64, 192) and held
   at its edges, with V's last 64 columns zero as MLA pads them, dV's
   padded columns exact zeros;
8. train_consistency: full-width tacc-100m, one forward and backward of
   train_logits + cross_entropy on the card through the kernels and on the
   CPU through the plain path, from the same weights and tokens;
9. train: 20 steps of build_train_step on SyntheticLM batches (global
   batch 16, seq 128, lr 3e-4, remat="full"): the loss on batch 0 and on
   a batch never trained on, taken without a gradient before the first
   step and after the last, must fall by stated margins, and every
   forward and backward kernel must launch as often as the code says; a
   torch.profiler window over 3 steps;
10. cluster: the scenario of examples/train_cluster_torch.py at full
   width through the port's TACC on the card: tacc-100m trained 60 steps
   (global batch 16, seq 128, lr 3e-4, checkpoints every 15 steps to a
   temporary directory, quanta of 10), failed once at step 20 and
   preempted by a smoke torch_serve job submitted at step 30. The job must
   complete with exactly 1 restart and at least 1 preemption, the serving
   job too; its final checkpoint, read back from disk, is held against a
   straight 60-step loop: the same optimizer step, every leaf bit-equal
   (the path is deterministic), and, printed beside them, the last loss's
   difference (bar rel 1e-4) and every parameter's (bar: phase 9's share
   of the summed lr); the card's allocated memory must come back
   within 100 MB; every kernel must have launched (the backward kernels
   exactly as often as the steps run say); K1 is also held against its
   plain version at the serving job's shape (head dim 16, run padded);
   before the service starts, the job's initial state, drawn on this
   host's CPU, must have the leaf sums of tools/jax_loss_curve.json, and
   after it the straight run's 60 losses must stay within that file's bar
   of JAX's curve at every step (rel 1e-3 at step 0);
11. moe_serve: qwen2-moe-a2.7b at full width and depth (15,146,403,840
   parameters), seed 0, its bf16 weights drawn leaf by leaf with the
   router in f32 (the card never holds the f32 model): K1 on layer 0's q,
   k, v from a 512-token prefill and K2/K3 at rows (512, 2048) and (8,
   2048), each against its plain version with its times and bound; the
   MoE dispatch against the dense oracle on layer 0's FFN input (routes
   equal to the CPU's, aux terms, the routed experts' f32 sums within
   ``MOE_ROUTED_BAR``, and a planted fault, the dispatch's outputs sent
   to the next token, beyond it), both timed at 512 and 8 rows; a 2048-
   and a 4096-token prefill through each path (``moe_apply`` takes the
   dispatch from ``DISPATCH_MIN_ROWS`` rows on); prefill + 4 decode steps
   against the full forward, and the first 2 layers at full width against
   the CPU's plain path; phase 5's traffic served, every kernel launched
   as often as the code says and the dispatch never (no call reaches its
   rows); a profile; every registered config at smoke
   size, prefill + decode against its full forward; the peak under 40 GB
   above what earlier phases left and the memory given back;
12. mla_serve: deepseek-v2-236b at full width, cut to its first 4 of 60
   layers (the dense MLA prelayer and 3 MLA + MoE layers; 13,302,912,000
   parameters), seed 0, bf16 weights drawn leaf by leaf with the router in
   f32: K1 at D = 192 on layer 0's q, k, v from a 512-token prefill and
   K2/K3 at MLA's widths (5120, 1536, 512), each against its plain
   version with its times and bound; the absorbed decode against the
   naive one at layers 0 and 3, in f32 and bf16; prefill + 4 decode steps
   against the full forward, and the first 2 layers against the CPU on a
   32-token prompt; phase 5's traffic served, every kernel launched as
   often as the code says, no host sync; a profile; the peak under 40 GB
   above the phase's start and the memory given back;
13. xlstm_serve: xlstm-125m at full width and depth (145,014,600
   parameters, 9 mLSTM and 3 sLSTM layers, no FFN), seed 0, bf16 weights
   drawn leaf by leaf with the sLSTM's recurrent matrices in f32: each
   recurrent mixer's sequence pass (one 512-token row, with its cache)
   and decode step (8 rows) timed on one layer, host-paced; prefill + 4
   decode steps against the full forward, and all 12 layers against the
   CPU's plain path; phase 5's traffic served, every kernel launched as
   often as the code says (K2 only: no attention layer, no FFN); a
   profile of 16 decode steps (a traced prefill took about 90 s); the
   peak under 40 GB above the phase's start and the memory given back;
14. jamba_serve: jamba-1.5-large-398b at full width cut to layers 2-4 of
   its period as prelayers (Mamba + dense, Mamba + MoE, attention +
   dense; 12,937,224,192 parameters), seed 0, bf16 weights drawn leaf by
   leaf with the router, a_log and dt_w in f32: K1 on the attention
   layer's q, k, v from a 512-token prefill (64 query heads over 8 KV
   heads, no RoPE) and K2/K3 at rows (512, 8192) and (8, 8192), each
   against its plain version with its times and bound; the Mamba mixer
   timed as phase 13's; prefill + 4 decode steps against the full
   forward, and the cut's layers 0 and 2 against the CPU on a 32-token
   prompt; phase 5's traffic, every kernel launched as often as the code
   says; a profile; the peak under 40 GB above the phase's start and the
   memory given back;
15. paged_serve: internlm2-1.8b at full width and depth (1,889,110,016
   parameters; 24 layers of d_model 2048, 16 query heads over 8 KV heads
   of 128), seed 0, bf16 weights drawn leaf by leaf: K1 on layer 0's q,
   k, v from a 512-token prefill and K2/K3 at rows (512, 2048) and (8,
   2048), each against its plain version with its times and bound; the
   port's PagedKVCache (a bf16 pool of 64 pages of 64 positions a layer,
   8 pages a sequence) held to the model's own dense decode: 8 of phase
   5's prompts prefilled at 512 slots, each row's valid prefix written
   into its pages, 32 greedy decode steps, at each step and layer the
   step's k/v appended and ``attend`` on the step's q bit-equal to the
   dense ``decode_attention_ref`` output; after step 16 two rows retire
   and two new prompts take their pages, whose block tables must show
   the LIFO reuse and whose stale tails are masked; the gather, ``attend``
   and the dense attention timed at (B 8, H 16, KV 8, HD 128, S 512),
   device and host-paced; then ``serve_phase``'s checks as in phases
   12-14;
16. tcloud: ``repro_torch.core.tcloud.main`` on the card, each run in its
   own temporary ``--cluster-root``: (a) ``demo --device cuda``, its
   three jobs completed (40/40, 4/4, 1/1) with the logs of
   tests/test_system.py, every forward and backward kernel launched (the
   backward ones as often as the train job's steps say), the train job's
   last loss within rel 1e-3 of the same demo run on the CPU in this
   phase; (b) ``hash`` and ``submit --watch`` of a spec file holding
   tacc-100m trained at full width (global batch 16, seq 128, lr 3e-4,
   20 steps, checkpoints every 10) and internlm2-1.8b served at full
   width (max_batch 8, max_seq 512, 32 new tokens, 16 requests): the
   hashes, both jobs completed, checkpoints at steps 10 and 20, the train
   job's step ms and the serve job's wall and tokens/s, every kernel
   launched; the allocated memory back within 100 MB;
17. mesh_serve: qwen2-moe-a2.7b whole over a mesh of 4 ranks (data 1,
   model 4), each a process of its own on the one card, talking over gloo
   (NCCL refuses two ranks on one device), every collective staged
   through the host. (a) In this process, the model whole: teacher-forced
   logits of 4 rows (a prefill and 32 fed decode steps) and the greedy
   tokens of phase 5's first 4 prompts with 8 new tokens each (the mesh
   traffic), saved to a temporary file, the memory given back. (b) Each rank draws only its shard (16 of 64 experts a layer,
   ``init_serving_params(shard=...)``) and holds 128 of the 512 cache
   positions (flags from ``decode_plan``: the batch replicated, the
   sequence over the mesh); its teacher-forced logits at capacity factor
   8 within 0.05 (prefill) and 0.08 (decode) of (a); the mesh traffic
   at capacity 8 and at the config's own 1.25, every kernel launched as
   often as the code says, the ranks' tokens equal, the dropped
   assignments and the tokens parting from (a) counted; collectives,
   bytes and staged bytes per prefill and decode step, peak memory, and
   rank 0's prefill and decode-step ms and tokens/s. (c) Each rank's
   cache shard zeroed in turn before the first decode step must move the
   logits past the decode bar. (d) deepseek-v2 at full width cut to
   layers 0-1 (40 of 160 experts a rank, 128 of 512 latent positions):
   layer 0's sequence-sharded absorbed decode against the whole-cache one
   (phase 12's bars, the written shard bit-equal) and teacher-forced
   logits against the single process at (b)'s bars. (e) jamba's layer 0
   (Mamba + dense FFN) and xlstm-125m's first period (3 mLSTM, 1 sLSTM)
   at full width, whole weights on every rank: each rank's Mamba
   conv/ssm and mLSTM conv a quarter of d_inner (the mixers compute on
   their block of it), the mLSTM's C, n, m and the sLSTM's state whole;
   teacher-forced logits (8 fed steps) at (b)'s bars; each rank's state
   shards zeroed in turn before the first decode step must move the
   logits past the decode bar (jamba's ssm alone reported too); the mesh
   traffic, every kernel launched as the code says, the ranks' tokens
   equal; rank 0's decode step ms;
18. mesh_train: training over a mesh of 4 ranks (data 2, model 2) on the
   one card over gloo, FSDP over data and tensor parallelism over model.
   (a) In this process: tacc-100m whole (phase 9's setup: global batch
   16, seq 128, lr 3e-4, remat="full") for 6 steps, and qwen2-moe-a2.7b
   at full width cut to layers 0-1 (1.83e9 parameters; its dense oracle)
   for 3 steps of batch 8, and for 3 steps of batch 8 each the mixers
   tensor-parallel since ROADMAP item 15c: deepseek-v2's layer 0 (MLA +
   dense FFN, K1 and K1b at D = 192 on a rank's 64 heads), jamba's layer
   0 (Mamba + dense FFN) and xlstm-125m's first period; each step's loss
   and grad norm, step 1's
   gradients and the params after the last step (and tacc-100m's after
   step 1) saved to a temporary directory, the memory given back; the
   cases run in groups (``MESH_TRAIN_GROUPS``), each group's saved
   states on the disk only while it runs. (b)
   Each rank draws the same state and keeps its blocks, takes its rows of
   each batch and runs the FSDP + TP step: every step's loss and grad
   norm within rel 1e-3 of (a), every leaf of step 1's gradient at cosine
   >= 0.999 with (a)'s (phase 8's bars), every leaf's move from the
   seed's state over the steps at the case's cosine to (a)'s move (the
   reference's max-abs 5e-3 reported beside it), every kernel launched as
   often as phase 9's count says on every rank; per step and rank the
   collectives, bytes sent and staged, the step's ms, and the peak
   memory. (c) Faulted runs must miss those bars: one step with each
   rank's gradient block of layer 0's wq zeroed in turn (its cosine and
   the move), and each case's steps with the psum of the gradients over
   the batch axes left out (the move); for item 15c's cases their steps
   with rank 0's block of MLA's w_uq zeroed, Mamba's x_proj sum over
   model left out, or the sLSTM's recurrent rows used without their
   gather (step 1's least gradient cosine and the move). The sLSTM's
   input-gate bias b_i, whose exact gradient is zero, is reported apart
   (``rounding_only``). (d) The qwen2-moe cut over the
   same mesh through moe_ep at capacity factor 8 against (a)'s dense
   oracle at (b)'s bars, no assignment dropped. K1, K1b, K2, K2b, K3 and
   K3b are also held to their plain versions and timed at a rank's local
   shapes in (b);
19. tools: the ported tools of ROADMAP items 16a-16e. (a) The tuning
   table (``kernels/autotune.py``): with an empty table every phase-3
   shape's plan is the default rule's (``key_splits``, ``pick_variant``);
   under probe tables K1 f32 at the serving shape runs at splits 1, 2 and
   8 (8 leaves the first q tiles' runs of keys empty) and K2 and K3 at
   (512, 768) as ``wide``, and under the committed table each entry runs
   at its bucket's shape: each as the table says (the wrapper's record)
   and within phase 3's bar of its plain version. (b) The kernel bench
   (``benchmarks_torch/bench_kernels_torch.py``) at its points, held to
   the committed ``BENCH_kernels_torch.json`` as its ``--check`` holds it;
   a line a point. (c) ``examples/quickstart_torch.py``'s training, 5
   steps of 2 microbatches, on the card and on the CPU from one seed:
   each step's loss and grad norm within rel 1e-3, every kernel launched
   as the code counts. (d) The serving bench at the smoke config (every
   forward kernel launched, every request finished) and the checkpoint
   bench at d_model 256;
20. dryrun: the dry run (``repro_torch.launch.dryrun``, ROADMAP item 16f)
   against the card's own counts. (a) tacc-100m at full width, one
   process: phase 9's train step (16 x 128, remat="full"), a prefill of
   (8, 512) and one decode step, each run on the card under the counter
   (``launch/count.py``) and traced on the meta device: FLOPs by dtype and
   each kernel's calls and work equal, each kernel's launches on the card
   equal to its calls; the train state's bytes (params and AdamW) within
   1% of the growth of ``torch.cuda.memory_allocated()`` while it is
   built; each predicted peak within 25% of ``max_memory_allocated()``
   above the call's start. (b) Phase 18's five cases: one rank's step
   traced on ``Mesh.view((2, 2), ..., dry=True)`` at the case's rows must
   tally the collectives of every live rank's step after the first, kind
   by kind, count and bytes; the dry peak printed beside each rank's
   ``peak_gb`` (gloo's staging has no place in it). (c) The two cells of
   the reference's tiny check (tests/distributed_checks.py:235) on the
   production mesh's 16 x 16 view: internlm2-1.8b ``train_4k`` and
   qwen2-moe-a2.7b ``decode_32k``, each ``ok`` with FLOPs above 0, with
   its H100 roofline row and whether a rank's peak fits the card.

Every phase from 12 on prints the card's name and power limit beside its
times. Then one ``{"kernels": [...]}`` line with each kernel's launches
in phase 5 (forward kernels) or phase 9 (backward kernels), and in phase 10
(``cluster_launches``) and in phase 11 (``moe_launches``, with the
numbers at qwen2-moe's shapes), K1's row with its f32
numbers at both timed shapes (no path launches it), a row for K1 at
D = 192 with its launches in phase 12 and its numbers there (f32 from
phase 3), every forward kernel's launches in phases 13, 14 and 15 and its
numbers at jamba's and internlm2's shapes, every kernel's launches in
phase 16's demo and submitted spec file, each forward kernel's launches
summed over phase 17's ranks, every kernel's launches on each rank of
phase 18's tacc-100m run with its numbers at the local shapes there, a
row for each of K1b-dq and K1b-dkdv at D = 192 with its launches on
each rank of phase 18's deepseek-v2 run and its numbers from phase 7,
every kernel's launches in phase 19's quickstart training and serving
bench and in phase 20 (a)'s counted train step, prefill and decode step;
before it one line with each phase's wall seconds; and the last line
``{"ok": true, "device": {...}}``. Exits non-zero, before printing
anything, when no CUDA card is present.
"""
import contextlib
import dataclasses
import datetime
import gc
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from repro_torch.ckpt import restore_checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import tcloud as TC
from repro_torch.core.executor import TorchTrainRuntime
from repro_torch.core.schema import ResourceSpec, RuntimeEnv, TaskSpec
from repro_torch.data import SyntheticLM, input_specs, to_torch
from repro_torch.kernels import (build, flash_attention, flash_attention_bwd,
                                 flash_attention_bwd_plain,
                                 flash_attention_plain, flash_bwd_dkdv,
                                 flash_bwd_dq, rmsnorm, rmsnorm_bwd,
                                 rmsnorm_bwd_plain, rmsnorm_plain,
                                 rmsnorm_residual,
                                 rmsnorm_residual_bwd,
                                 rmsnorm_residual_bwd_plain,
                                 rmsnorm_residual_plain)
from repro_torch.kernels.flash_attention import _plain_forward
from repro_torch.kernels.flash_attention import _bwd_inputs as bwd_inputs
from repro_torch.kernels.flash_attention import _forward as flash_forward
from repro_torch.kernels.flash_attention import _in_place as flash_in_place
from repro_torch.kernels.rmsnorm import (REDUCE_LANES, REDUCERS, bwd_blocks,
                                         launch_empty, pick_variant)
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s,
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
from repro_torch.launch import dryrun as DRY
from repro_torch.launch.count import (H100_MEMORY_BYTES, HBM_BYTES_PER_S,
                                      PEAK_FLOPS)
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import (Transformer, cast_for_compute, decode_step,
                                init_cache, init_params, init_serving_params,
                                model_defs, prefill, state_from_jax,
                                train_logits)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.params import (KEEP_F32, mamba_dims, mlstm_dims,
                                       serving_plan, shard_leaf,
                                       train_plan)
from repro_torch.models.transformer import MIXERS, RunFlags
from repro_torch.parallel import collectives as COLL
from repro_torch.parallel.decode_attn import (PagedKVCache, gather_paged_kv,
                                              paged_decode_attention)
from repro_torch.parallel.sharding import (batch_rows, cache_specs,
                                           decode_plan, local_shard,
                                           train_batch_axes)
from repro_torch.serve import ServeEngine
from repro_torch.train import (OptConfig, TrainConfig, build_train_step,
                               cross_entropy, init_train_state)


MAX_BATCH, MAX_SEQ = 8, 512
N_REQUESTS, MAX_NEW = 16, 32
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 20, 16, 128
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 50) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed and timed by CUDA events, so host dispatch is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int = 50) -> float:
    """Time of one call issued from Python, back to back, by CUDA events:
    what the serving loop pays, host dispatch included."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, flops: float, dtype: torch.dtype):
    """The least time (ms) the card could take, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 1 ---------------------------------------------------------------

def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them: printed
    beside the times of a phase, since a card set below its limit runs
    slower under load."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "it runs on a CUDA card only")
    smi = card()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit({"phase": "device", **dev, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return dev


# -- phase 2 ---------------------------------------------------------------

def kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel: the flash kernels as
    ``flash_fwd_wgmma<bf16, 64>``, ``flash_fwd_f32<float, 64>`` (with its
    keys split over blocks: ``flash_fwd_f32<float, 64, split>``),
    ``flash_fwd_f32_merge<float, 64>`` or ``flash_bwd_dq_f32<float, 64>``,
    the norm kernels as
    ``rmsnorm_kernel<bf16, residual=1, V=8, NV=8, warp>``, others by their
    mangled name."""
    m = re.search(r"(flash_(?:fwd|bwd_[a-z]+)_(?:wgmma|f32)(?:_merge)?)"
                  r"I(f?|\d+__nv_bfloat16)Li(\d+)E(?:Lb([01])E)?", mangled)
    if m:
        f32 = m.group(2) == "f" or "_f32" in m.group(1)
        split = ", split" if m.group(4) == "1" else ""
        return (f"{m.group(1)}<{'float' if f32 else 'bf16'}, {m.group(3)}"
                f"{split}>")
    m = re.search(r"(rmsnorm(?:_bwd)?_kernel)I(f|\d+__nv_bfloat16)Lb([01])E"
                  r"Li(\d+)ELi(\d+)ELb([01])E", mangled)
    if m:
        return (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}, "
                f"residual={m.group(3)}, V={m.group(4)}, NV={m.group(5)}, "
                f"{'wide' if m.group(6) == '1' else 'warp'}>")
    m = re.search(r"(empty_kernel)", mangled)
    return m.group(1) if m else mangled


def sass(library: str) -> dict:
    """The SASS of each kernel of a built library, by readable name."""
    out = subprocess.run(
        [build.tool("cuobjdump"), "--dump-sass",
         str(build.library_path(library))],
        capture_output=True, text=True, check=True).stdout
    return {kernel_name(part.split("\n", 1)[0].strip()): part
            for part in out.split("Function : ")[1:]}


WGMMA_KERNELS = [f"{k}<bf16, {d}>" for k in (
    "flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")
    for d in (64, 128, 192)]
# the kernels at MLA's q/k width (96 accumulator floats a thread), which
# must not spill
D192_KERNELS = tuple(f"{k}<bf16, 192>" for k in (
    "flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma"))


def hgmma_counts() -> dict:
    """HGMMA (wgmma) instructions in the SASS of each flash-attention kernel
    of the built library. Fails unless every bf16 instantiation, forward
    and backward, has them, so a kernel that lost its tensor cores cannot
    pass."""
    counts = {n: text.count("HGMMA")
              for n, text in sass("flash_attention").items()}
    if not all(counts.get(n) for n in WGMMA_KERNELS):
        raise AssertionError(f"a bf16 flash kernel lacks HGMMA: {counts}")
    return counts


def wide_access_counts() -> dict:
    """128-bit global loads and stores (LDG/STG with .128) in the SASS of
    each rmsnorm kernel, forward and backward. Fails unless the bf16
    warp-per-row kernels of K2, K3, K2b and K3b are there and every kernel
    with 16-byte accesses (V > 1) has both, so a kernel that lost its
    vectors cannot pass."""
    counts = {n: {op: len(re.findall(rf"\b{op}(?:\.\w+)*?\.128\b", text))
                  for op in ("LDG", "STG")}
              for n, text in sass("rmsnorm").items()}
    vector = {n: c for n, c in counts.items()
              if n.startswith(("rmsnorm_kernel<", "rmsnorm_bwd_kernel<"))
              and "V=1," not in n}
    warp = [n for n in vector if "<bf16," in n and n.endswith("warp>")]
    if (not all(any(n.startswith(kind) and f"residual={res}" in n
                    for n in warp)
                for kind in ("rmsnorm_kernel<", "rmsnorm_bwd_kernel<")
                for res in (0, 1))
            or not all(c["LDG"] and c["STG"] for c in vector.values())):
        raise AssertionError(f"the 16-byte rmsnorm kernels lack 128-bit "
                             f"loads or stores: {counts}")
    return counts


def ptxas_report(report: str) -> dict:
    """ptxas's registers, spills and performance warnings, by kernel."""
    out, name = {}, "?"
    for ln in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "registers" in ln or "spill" in ln or "Performance" in ln:
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def phase_build() -> dict:
    """Returns ptxas's report by kernel name. The D = 192 bf16 kernels,
    forward and backward (96 accumulator registers a thread), must not
    spill."""
    t0 = time.perf_counter()
    reports = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_report(rep) for name, rep in reports.items()}
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas,
          "hgmma": hgmma_counts(), "ldst128": wide_access_counts()})
    flat = {k: v for rep in ptxas.values() for k, v in rep.items()}
    require_no_spills(flat, D192_KERNELS, "build_spills")
    return flat


# -- phase 3 ---------------------------------------------------------------

def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(1e-30)))
    return torch.pow(2.0, e - 7)


def flash_case(dtype, lengths_list, *, causal=True, S=MAX_SEQ, D=None,
               timed=True, offset=0, H=None, KV=None):
    """K1 against its plain version; o must be bit-equal over two calls.
    k/v are strided views of one fused tensor, which the wrapper must pass
    to the kernel uncopied; ``offset`` (elements) puts the bases of q and
    of the fused k/v tensor off 16 bytes, so the wrapper must copy them.
    Heads and head dim are tacc-100m's unless given."""
    cfg = get_config("tacc-100m")
    B, H, KV = len(lengths_list), H or cfg.n_heads, KV or cfg.n_kv_heads
    D = D or cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(offset + B * S * H * D, generator=g,
                    device="cuda").to(dtype)[offset:].view(B, S, H, D)
    # k/v as project_qkv gives them: strided views of one (B,S,2,KV,D) tensor
    kv = torch.randn(offset + B * S * 2 * KV * D, generator=g,
                     device="cuda").to(dtype)[offset:].view(B, S, 2, KV, D)
    k, v = kv[:, :, 0], kv[:, :, 1]
    return flash_check(q, k, v, lengths_list, causal=causal, timed=timed,
                       offset=offset)


def flash_check(q, k, v, lengths_list, *, causal=True, timed=True, offset=0):
    """K1 on these q, k, v against its plain version (``flash_case``): o
    bit-equal over two calls, every view the kernel can read taken in place
    (none when ``offset`` is set), and, ``timed``, its times and bound."""
    dtype, (B, S, H, D) = q.dtype, q.shape
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    o = flash_attention(q, k, v, causal=causal, lengths=lengths)
    again = flash_attention(q, k, v, causal=causal, lengths=lengths)
    ref = flash_attention_plain(q, k, v, causal=causal, lengths=lengths)
    torch.cuda.synchronize()
    tol = 3e-2 if dtype == torch.bfloat16 else 3e-5
    err = max_err(o, ref)
    taken = {n: flash_in_place(t)[0] is t for n, t in (("q", q), ("k", k),
                                                       ("v", v))}
    case = {"dtype": str(dtype).split(".")[-1], "q": list(q.shape),
            "kv": list(k.shape), "lengths": lengths_list, "causal": causal,
            "max_abs_err": err, "tol": tol,
            "bit_equal_over_two_calls": bool(torch.equal(o, again)),
            "read_in_place": taken, "offset_bytes": offset * q.element_size()}
    if not (torch.isfinite(o.float()).all() and err <= tol
            and case["bit_equal_over_two_calls"]):
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version or itself: {case}")
    if any(taken.values()) if offset else not all(taken.values()):
        raise AssertionError(f"flash_attention copied a view it can read in "
                             f"place, or read one it cannot: {case}")
    if not timed:
        return case
    # operations this data needs: QK^T and PV over the keys each row attends
    qpos = np.arange(S)
    keys = sum(int(np.minimum(qpos + 1, n).sum()) if causal and n > 0
               else S * (n if n > 0 else S) for n in lengths_list)
    flops = 4.0 * keys * H * D
    b_ms, b_by = bound(nbytes(q, k, v, o, lengths), flops, dtype)
    kpos = torch.arange(S, device="cuda")
    mask = kpos[None, None, None, :] < lengths[:, None, None, None]
    if causal:
        mask = mask & (kpos[:, None] >= kpos[None, :])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kernel = lambda: flash_attention(q, k, v, causal=causal,  # noqa: E731
                                     lengths=lengths)
    case.update(
        ms=time_ms(kernel), call_ms=call_ms(kernel),
        plain_ms=time_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, lengths=lengths), iters=10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        library="F.scaled_dot_product_attention(attn_mask, enable_gqa=True)",
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes(q, k, v, o, lengths),
        flops=flops)
    return case


def _norm_within_bar(y: torch.Tensor, ref: torch.Tensor):
    """Whether a normed output is within K2's and K3's bar of its plain
    version, and the bar: one bf16 ulp in bf16, 1e-5 in f32."""
    if y.dtype == torch.bfloat16:
        return (bool(((y.float() - ref.float()).abs() <= _bf16_ulp(ref)).all()),
                "1 bf16 ulp")
    return max_err(y, ref) <= 1e-5, 1e-5


def rms_case(dtype, rows, residual: bool, *, D=None, offset=0, timed=True):
    """One case of K2 (``residual`` False) or K3: rows of D (tacc-100m's
    d_model by default), x at ``offset`` elements into its storage. K3's
    sum must equal its plain version's bit for bit, and its normed output
    is held to K2's bar against the plain norm of that sum."""
    D = D or get_config("tacc-100m").d_model
    g = torch.Generator(device="cuda").manual_seed(SEED + rows + D)
    x = torch.randn(offset + rows * D, generator=g,
                    device="cuda").to(dtype)[offset:].view(rows, D)
    r = torch.randn(rows, D, generator=g, device="cuda").to(dtype)
    w = torch.randn(D, generator=g, device="cuda")
    eps = 1e-5
    case = {"dtype": str(dtype).split(".")[-1], "x": [rows, D],
            "x_offset_bytes": offset * x.element_size()}
    if residual:
        (y, s), (ry, rs) = (rmsnorm_residual(x, r, w, eps),
                            rmsnorm_residual_plain(x, r, w, eps))
        torch.cuda.synchronize()
        ok, tol = _norm_within_bar(y, ry)
        ok = ok and torch.equal(s, rs)
        case.update(variant=rmsnorm_residual.variant,
                    max_abs_err=max_err(y, ry), tol=tol,
                    sum_bit_equal=bool(torch.equal(s, rs)))
        kernel, plain, library, lib_name = (
            lambda: rmsnorm_residual(x, r, w, eps),
            lambda: rmsnorm_residual_plain(x, r, w, eps), None, None)
        moved, flops = nbytes(x, r, w, y, s), 5.0 * x.numel()
    else:
        y, ry = rmsnorm(x, w, eps), rmsnorm_plain(x, w, eps)
        torch.cuda.synchronize()
        ok, tol = _norm_within_bar(y, ry)
        case.update(variant=rmsnorm.variant, max_abs_err=max_err(y, ry),
                    tol=tol)
        wx = w.to(dtype)                # F.rms_norm fuses only for one dtype
        kernel, plain, library, lib_name = (
            lambda: rmsnorm(x, w, eps), lambda: rmsnorm_plain(x, w, eps),
            lambda: F.rms_norm(x, (D,), wx, eps),
            "F.rms_norm (weight in the input dtype)")
        moved, flops = nbytes(x, w, y), 4.0 * x.numel()
    ok = ok and bool(torch.isfinite(y.float()).all())
    if not ok:
        raise AssertionError(f"{'rmsnorm_residual' if residual else 'rmsnorm'}"
                             f" disagrees with its plain version: {case}")
    if not timed:
        return case
    b_ms, b_by = bound(moved, flops, torch.float32)
    case.update(ms=time_ms(kernel), call_ms=call_ms(kernel),
                plain_ms=time_ms(plain),
                library_ms=time_ms(library) if library else None,
                library=lib_name, bound_ms=b_ms, bound_by=b_by, bytes=moved,
                flops=flops,
                # one read and one write of x by PyTorch's copy kernel: what
                # any kernel that reads and writes rows this size costs here
                copy_ms=time_ms(lambda: torch.empty_like(x).copy_(x)))
    return case


def rms_cases(residual: bool, floor: float) -> list:
    """K2's or K3's cases: the timed serving shapes first, then the
    training shape, then the edges, each variant, and the JAX suite's
    shapes, in both dtypes."""
    bf16, f32 = torch.bfloat16, torch.float32
    timed = [rms_case(dt, n, residual) for dt in (bf16, f32)
             for n in (MAX_SEQ, MAX_BATCH)]
    timed.append(rms_case(bf16, TRAIN_BATCH * TRAIN_SEQ, residual))
    for c in timed:
        c["floor_ms"] = floor
    edges = [(1, {}), (13, {}),                      # a ragged last block
             (MAX_BATCH, {"D": 770}),                 # row bytes off 16
             (MAX_BATCH, {"offset": 1}),              # base 2 or 4 bytes off
             # every warp-layout width kept (1536, 2048), then the wide one
             (MAX_BATCH, {"D": 1536}), (MAX_BATCH, {"D": 2048}),
             (MAX_BATCH, {"D": 8192}), (MAX_BATCH, {"D": 16384}),
             # deepseek-v2's kv_norm and d_model (phase 12)
             (MAX_BATCH, {"D": 512}), (MAX_BATCH, {"D": 5120}),
             (100, {"D": 384}), (8, {"D": 128}),      # tests/test_kernels.py
             # the serving job's prefill and decode rows in phase 10 (the
             # smoke config's d_model)
             (64, {"D": 64}), (2, {"D": 64})]
    return timed + [rms_case(dt, rows, residual, timed=False, **kw)
                    for dt in (bf16, f32) for rows, kw in edges]


KERNELS = [
    # (wrapper, source, TPU kernel it replaces)
    (flash_attention, "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:82"),
    (rmsnorm, "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "src/repro/kernels/rmsnorm.py:32"),
    (rmsnorm_residual, "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "src/repro/kernels/rmsnorm.py:51"),
]


def spill_bytes(lines) -> "int | None":
    """Spill stores plus loads in ptxas's report of one kernel (None when
    there is no report)."""
    found = [int(n) for ln in lines or ()
             for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)]
    return sum(found) if found else None


def require_no_spills(ptxas: dict, names, phase: str) -> dict:
    """ptxas's spill bytes of each named kernel, emitted; fails unless each
    is reported and 0."""
    spills = {n: spill_bytes(ptxas.get(n)) for n in names}
    emit({"phase": phase, "spill_bytes": spills})
    if any(v != 0 for v in spills.values()):
        raise AssertionError(f"kernels spill (or ptxas did not report "
                             f"them): {spills}")
    return spills


def phase_kernels(ptxas: dict) -> dict:
    """Phase 3. The D = 64 f32 forward kernels (the model's head dim),
    whole or split, must not spill."""
    require_no_spills(ptxas, ("flash_fwd_f32<float, 64>",
                              "flash_fwd_f32<float, 64, split>"),
                      "kernels_spills")
    bf16, f32 = torch.bfloat16, torch.float32
    floor = time_ms(launch_empty)
    cases = {
        "flash_attention": [
            flash_case(bf16, [MAX_SEQ]),          # a full 512-token prefill
            flash_case(bf16, [136]),              # serve prompts' expected length
            flash_case(f32, [MAX_SEQ]),
            flash_case(bf16, [MAX_SEQ], D=128),
            # the training shape: q (16, 128, 12, 64)
            flash_case(bf16, [TRAIN_SEQ] * TRAIN_BATCH, S=TRAIN_SEQ),
            flash_case(f32, [TRAIN_SEQ] * TRAIN_BATCH, S=TRAIN_SEQ),
            flash_case(bf16, [37, 0], timed=False),
            flash_case(f32, [300, 1], timed=False),
            flash_case(bf16, [MAX_SEQ], causal=False, timed=False),
            flash_case(f32, [100], S=200, timed=False),   # ragged tile edge
            # a ragged tile edge at a batch boundary: a store past S would
            # land in the next batch's rows
            flash_case(bf16, [200, 150], S=200, timed=False),
            # eight rows with lengths at and around tile edges
            flash_case(bf16, [1, 64, 65, 512, 0, 300, 511, 128], timed=False),
            flash_case(bf16, [1], S=1, timed=False),
            flash_case(bf16, [200, 512], D=128, timed=False),
            flash_case(f32, [77], S=300, D=128, timed=False),
            flash_case(bf16, [77], S=300, D=128, timed=False),
            # f32 at the edges of its tiles and of its strides; a case with
            # fewer (batch, head, q tile) blocks than SMs (132 on the H100)
            # splits its keys over two blocks: 36, 96, 108, 120 below
            # split, 192 do not
            flash_case(f32, [33, 32, 31], S=33, timed=False),
            flash_case(f32, [65, 64, 63, 1], S=65, timed=False),
            flash_case(f32, [129, 128, 0], S=129, timed=False),
            flash_case(f32, [0, 77], timed=False),
            flash_case(f32, [0, 77], causal=False, timed=False),
            flash_case(f32, [200, 512], D=128, timed=False),
            flash_case(f32, [300, 77], S=300, offset=1, timed=False),
        ],
        "rmsnorm": rms_cases(False, floor),
        "rmsnorm_residual": rms_cases(True, floor),
        "flash_attention_d192": flash_d192_cases(),
    }
    emit({"phase": "kernels", "floor_ms": floor, "cases": cases})
    return cases


def flash_d192_cases() -> list:
    """K1 at D = 192, MLA's q/k width: timed at deepseek-v2's prefill shape
    in both dtypes, then at the tile edges (S = 33, 65, 129, 512, lengths
    around them and 0), causal and full, with tacc-100m's GQA heads. The
    f32 cases with fewer blocks than SMs split their keys."""
    bf16, f32 = torch.bfloat16, torch.float32
    mla = get_config(MLA_ARCH)
    timed = [flash_case(dt, [MAX_SEQ], D=192, H=mla.n_heads,
                        KV=mla.n_kv_heads) for dt in (bf16, f32)]
    edges = [([33, 32, 31], {"S": 33}), ([65, 64, 63, 1], {"S": 65}),
             ([129, 128, 0], {"S": 129}),
             ([1, 64, 65, 512, 0, 300, 511, 128], {}),
             ([0, 77], {"causal": False}), ([MAX_SEQ], {"causal": False})]
    return timed + [flash_case(dt, lens, D=192, timed=False, **kw)
                    for dt in (bf16, f32) for lens, kw in edges]


# -- phase 4 ---------------------------------------------------------------

def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-6)


def phase_consistency(cfg, params) -> dict:
    B, S, NDEC = 2, 128, 4
    model = Transformer(cfg, cast_for_compute(cfg, params, "cuda"),
                        device="cuda")
    rng = np.random.RandomState(SEED)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    out = {"phase": "consistency", "batch": B, "seq": S}
    with torch.inference_mode():
        full, _ = train_logits(model, {"tokens": toks})
        if not (torch.isfinite(full).all()
                and full.shape == (B, S, cfg.vocab_size)):
            raise AssertionError(f"full forward: shape {tuple(full.shape)}, "
                                 f"finite {bool(torch.isfinite(full).all())}")
        Sp = S - NDEC
        pt = F.pad(toks[:, :Sp], (0, NDEC))
        lengths = torch.full((B,), Sp, dtype=torch.int32, device="cuda")
        lg, cache = prefill(model, {"tokens": pt}, lengths)
        out["prefill_vs_full"] = rel_err(lg, full[:, Sp - 1])
        out["decode_vs_full"] = []
        for i in range(NDEC):
            lg, cache = decode_step(model, cache, toks[:, Sp + i])
            out["decode_vs_full"].append(rel_err(lg, full[:, Sp + i]))
        # the same weights through the plain path on the CPU
        lens1 = torch.tensor([Sp - 21], dtype=torch.int32)
        lg_gpu, _ = prefill(model, {"tokens": toks[:1]}, lens1.cuda())
        cpu_model = Transformer(cfg, cast_for_compute(cfg, params, "cpu"),
                                device="cpu")
        lg_cpu, _ = prefill(cpu_model, {"tokens": toks[:1].cpu()}, lens1)
        out["prefill_vs_cpu_plain"] = rel_err(lg_gpu, lg_cpu)
    out["bars"] = {"prefill_vs_full": 0.05, "decode_vs_full": 0.08,
                   "prefill_vs_cpu_plain": 0.03}
    emit(out)
    if not (out["prefill_vs_full"] < 0.05
            and max(out["decode_vs_full"]) < 0.08
            and out["prefill_vs_cpu_plain"] < 0.03):
        raise AssertionError(f"full-width consistency failed: {out}")
    return out


# -- phase 5 ---------------------------------------------------------------

def phase_serve(cfg, params) -> dict:
    engine = ServeEngine(cfg, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                         seed=SEED, device="cuda")
    prompts = serve_prompts(cfg)
    for fn, _, _ in KERNELS:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run(prompts, max_new=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn, _, _ in KERNELS}
    tokens = sum(len(r.tokens) for r in results)
    pf, dc = engine.timings["prefill"], engine.timings["decode"]
    out = {"phase": "serve", "requests": len(results), "tokens": tokens,
           "prompt_tokens": sum(len(p) for p in prompts),
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "prefills": len(pf), "prefill_ms_mean": 1e3 * float(np.mean(pf)),
           "prefill_ms_p50": 1e3 * float(np.median(pf)),
           "decode_steps": len(dc), "decode_step_ms_mean": 1e3 * float(np.mean(dc)),
           "decode_step_ms_p50": 1e3 * float(np.median(dc)),
           "launches": launches}
    emit(out)
    ok = (len(results) == N_REQUESTS and all(r.done for r in results)
          and all(len(r.tokens) == MAX_NEW for r in results)
          and all(0 <= t < cfg.vocab_size for r in results for t in r.tokens))
    if not ok:
        raise AssertionError("serve returned an unexpected result")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched while serving: {idle}")
    return out


# -- phase 6 ---------------------------------------------------------------

def _trace(fn) -> dict:
    """Run ``fn`` (returns a call count) under torch.profiler: per call, the
    host clock, the time the card was busy, and where it was busy."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {"calls": n, "traced_wall_ms": 1e3 * wall / n,
            "device_busy_ms": sum(per.values()) / 1e3 / n if per else None,
            "top_device_us": [[k[:80], v / n] for k, v in top],
            "top_host_us": [[a.key[:60], a.self_cpu_time_total / n]
                            for a in host[:8]],
            # host time in each CUDA runtime call (cudaLaunchKernel, the
            # copies and synchronisations), per call of ``fn``'s unit
            "cuda_api_host_us": {a.key: a.self_cpu_time_total / n
                                 for a in host if a.key.startswith("cuda")}}


def phase_profile(cfg, params, served: dict) -> dict:
    """Where a prefill and a decode step spend their time. The device's idle
    share is taken against the untraced means of phase 5."""
    engine = ServeEngine(cfg, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                         seed=SEED, device="cuda")
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(1, cfg.vocab_size, 136).tolist()
               for _ in range(MAX_BATCH)]
    out = {"phase": "profile",
           "prefill": _trace(lambda: len([engine.add_request(p, max_new=64)
                                          for p in prompts])),
           "decode": _trace(lambda: len([engine.step() for _ in range(16)]))}
    for name, untraced in (("prefill", served["prefill_ms_mean"]),
                           ("decode", served["decode_step_ms_mean"])):
        busy = out[name]["device_busy_ms"]
        out[name]["device_idle_share"] = (
            None if busy is None else max(0.0, 1.0 - busy / untraced))
    emit(out)
    return out


# -- phase 7 ---------------------------------------------------------------

def grad_within_bar(g: torch.Tensor, ref: torch.Tensor, *,
                    rounds_p: bool = False):
    """Whether a gradient is within the backward kernels' bar of its plain
    version, the bar, and the reading: the least share of max(|ref|, 1)
    that the bar's second term needs for this case to pass. Both compute
    the same f32 formula with sums in another order, then round once: f32
    within 2e-5 of max(|ref|, 1); bf16 within one bf16 ulp of each value
    plus 2e-5 of max |ref| (the f32 sums' difference can cross a rounding
    boundary of a value near 0). ``rounds_p`` (dV of attention in bf16
    only): plus 1e-3 of max |ref|, since both round p to bf16 before the
    PV product, and p's last f32 bit, which the two compute in another
    order, can flip that rounding and move a dV sum by a bf16 ulp of p
    times dO (seen: 2^-8 at D = 128). dQ and dK take p in f32."""
    scale = max(float(ref.float().abs().max()), 1.0)
    d = (g.float() - ref.float()).abs()
    if g.dtype == torch.bfloat16:
        rel = 1e-3 if rounds_p else 2e-5
        need = float((d - _bf16_ulp(ref)).clamp(min=0).max()) / scale
        return need <= rel, f"1 bf16 ulp + {rel:g} max|ref|", need
    need = float(d.max()) / scale
    return need <= 2e-5, "2e-5 max(|ref|, 1)", need


def library_bwd_ms(fn, inputs, grads_out) -> float:
    """Device time of the backward of one PyTorch call: its forward and
    backward (``torch.autograd.grad``) captured together in a CUDA graph,
    less the forward alone. Autograd runs a backward op on its forward's
    stream, so the two are captured together."""
    inputs = [t.detach().requires_grad_(True) for t in inputs]
    both = time_ms(lambda: torch.autograd.grad(fn(*inputs), inputs,
                                               grads_out), iters=20)
    with torch.no_grad():
        fwd = time_ms(lambda: fn(*inputs), iters=20)
    return both - fwd


def sdpa_backend(fn, inputs, grads_out):
    """The first SDPA backend (an ``SDPBackend``), flash first, that runs
    ``fn``'s forward and backward on these inputs (the library call's
    times are taken under it)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                ins = [t.detach().requires_grad_(True) for t in inputs]
                torch.autograd.grad(fn(*ins), ins, grads_out)
            torch.cuda.synchronize()
            return b
        except RuntimeError:            # this backend refuses the shape
            continue
    raise AssertionError("no SDPA backend runs the shape")


def flash_bwd_case(dtype, B, S, H, KV, D, *, causal=True, lengths=None,
                   timed=False, strided=False, vpad=0):
    """K1b-dq and K1b-dkdv against the plain backward on the same q, k, v,
    dO and the kernel forward's o and lse; the lse against the plain
    forward's. ``strided`` (bf16): q and dO are transposed views of
    (B, H, S, D) tensors, k and v views of one fused (B, S, 2, KV, D)
    tensor, and the backward must read all four in place. ``vpad``: V's
    last ``vpad`` columns are zeros, and so dO's (the output's padded
    columns are cut off), as MLA pads V; dV's must come back exact
    zeros."""
    g = torch.Generator(device="cuda").manual_seed(SEED + S + H + D)
    if strided:
        q, do = (torch.randn(B, H, S, D, generator=g, device="cuda")
                 .to(dtype).transpose(1, 2) for _ in range(2))
        kv = torch.randn(B, S, 2, KV, D, generator=g, device="cuda").to(dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
    else:
        q, do = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(B, S, KV, D, generator=g, device="cuda").to(dtype)
                for _ in range(2))
    if vpad:
        v = torch.cat([v[..., :D - vpad], torch.zeros_like(v[..., :vpad])],
                      -1)
        do = torch.cat([do[..., :D - vpad],
                        torch.zeros_like(do[..., :vpad])], -1)
    ln = (None if lengths is None else
          torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    o, lse = flash_forward(q, k, v, causal, ln, True)
    _, lse_ref = _plain_forward(q, k, v, causal, ln)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     lengths=ln)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                lengths=ln)
    rq, rk, rv = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                           causal=causal, lengths=ln)
    torch.cuda.synchronize()
    case = {"dtype": str(dtype).split(".")[-1], "q": [B, S, H, D],
            "kv": [B, S, KV, D], "causal": causal, "lengths": lengths,
            "lse_err": max_err(lse, lse_ref),
            "bit_equal_over_two_calls": all(
                torch.equal(a, b) for a, b in zip((dq, dk, dv), again))}
    if vpad:
        case["v_zero_columns"] = vpad
        case["dv_padded_columns_zero"] = bool(
            (dv[..., D - vpad:] == 0).all())
    if strided:
        case["strides"] = {n: list(t.stride())
                           for n, t in (("q", q), ("k", k), ("dO", do))}
        taken = bwd_inputs(q, k, v, o, do, lse)
        if not all(t is u for t, u in zip(taken, (q, k, v, o, do))):
            raise AssertionError(f"the bf16 backward copied a strided input "
                                 f"that TMA can read: {case}")
    failed = ([] if case["lse_err"] <= 1e-4 * max(float(lse_ref.abs().max()),
                                                   1.0) else ["lse"])
    if not case["bit_equal_over_two_calls"]:
        failed.append("repeat")
    if vpad and not case["dv_padded_columns_zero"]:
        failed.append("dv padded columns")
    for name, a, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        good, tol, need = grad_within_bar(a, r, rounds_p=name == "dv")
        if not (good and bool(torch.isfinite(a.float()).all())):
            failed.append(name)
        case[f"{name}_err"] = max_err(a, r)
        case[f"{name}_tol"] = tol
        case[f"{name}_need"] = need
    case["max_abs_err"] = max(case["dq_err"], case["dk_err"], case["dv_err"])
    if failed:
        raise AssertionError(f"flash backward disagrees with its plain "
                             f"version in {failed}: {case}")
    if not timed:
        return case
    # what this data needs: each product over the (q, key) pairs attended
    qpos = np.arange(S)
    pairs = B * H * (int(np.minimum(qpos + 1, S).sum()) if causal else S * S)
    el = q.element_size()
    qb, kb, rows = B * S * H * D * el, B * S * KV * D * el, B * H * S * 4
    dq_bytes = 4 * qb + 2 * kb + 2 * rows       # q o dO dq, k v, lse delta
    dkdv_bytes = 2 * qb + 4 * kb + 2 * rows     # q dO, k v dk dv, lse delta
    both = 4 * qb + 4 * kb + 2 * rows
    _, delta = flash_bwd_dq(q, k, v, o, lse, do, causal=causal, lengths=ln)
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=causal, lengths=ln), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=causal,
                                              enable_gqa=True)
    backend = sdpa_backend(sdpa, (qt, kt, vt), do.transpose(1, 2))
    from torch.nn.attention import sdpa_kernel

    def sdpa_under(a, b, c):
        with sdpa_kernel([backend]):
            return sdpa(a, b, c)
    lib = library_bwd_ms(sdpa_under, (qt, kt, vt), do.transpose(1, 2))
    for name, fn, nbytes_, products in (
            ("dq", lambda: flash_bwd_dq(q, k, v, o, lse, do,
                                        causal=causal, lengths=ln),
             dq_bytes, 3),
            ("dkdv", lambda: flash_bwd_dkdv(q, k, v, do, lse, delta,
                                            causal=causal, lengths=ln),
             dkdv_bytes, 4)):
        flops = 2.0 * D * pairs * products
        b_ms, b_by = bound(nbytes_, flops, dtype)
        case[name] = {"ms": time_ms(fn), "bound_ms": b_ms, "bound_by": b_by,
                      "bytes": nbytes_, "flops": flops}
    flops = 2.0 * D * pairs * 5
    b_ms, b_by = bound(both, flops, dtype)
    case.update(ms=time_ms(lambda: flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal, lengths=ln)),
        plain_ms=plain_ms, library_ms=lib,
        library="backward of F.scaled_dot_product_attention(is_causal, "
                "enable_gqa=True)", library_backend=backend.name,
        bound_ms=b_ms, bound_by=b_by,
        bytes=both, flops=flops)
    return case


def rms_bwd_case(dtype, rows, residual: bool, *, D=None, offset=0,
                 timed=False):
    """K2b or K3b, dx and dw in one launch, against the plain backward; dw
    must be bit-equal over two calls and, for a timed case, when the same
    launch is captured in a CUDA graph and replayed twice."""
    D = D or get_config("tacc-100m").d_model
    g = torch.Generator(device="cuda").manual_seed(SEED + rows + D + 7)
    x = torch.randn(offset + rows * D, generator=g,
                    device="cuda").to(dtype)[offset:].view(rows, D)
    dy, ds = (torch.randn(rows, D, generator=g, device="cuda").to(dtype)
              for _ in range(2))
    w = torch.randn(D, generator=g, device="cuda")
    eps = 1e-5
    if residual:
        kernel = lambda: rmsnorm_residual_bwd(x, w, dy, ds, eps)  # noqa: E731
        plain = lambda: rmsnorm_residual_bwd_plain(x, w, dy, ds, eps)  # noqa: E731
        wrapper = rmsnorm_residual_bwd
    else:
        kernel = lambda: rmsnorm_bwd(x, w, dy, eps)  # noqa: E731
        plain = lambda: rmsnorm_bwd_plain(x, w, dy, eps)  # noqa: E731
        wrapper = rmsnorm_bwd
    dx, dw = kernel()
    variant = wrapper.variant
    dx2, dw2 = kernel()
    rdx, rdw = plain()
    torch.cuda.synchronize()
    ok, tol, need = grad_within_bar(dx, rdx)
    dw_tol = 1e-5 * float(rdw.abs().max())   # f32 sums over rows, reordered
    repeat = bool(torch.equal(dw, dw2) and torch.equal(dx, dx2))
    ok = (ok and max_err(dw, rdw) <= dw_tol and repeat
          and bool(torch.isfinite(dx.float()).all()))
    case = {"dtype": str(dtype).split(".")[-1], "x": [rows, D],
            "x_offset_bytes": offset * x.element_size(), "variant": variant,
            "max_abs_err": max_err(dx, rdx), "tol": tol, "need": need,
            "dw_err": max_err(dw, rdw), "dw_tol": dw_tol,
            "bit_equal_over_two_calls": repeat}
    if timed:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gdx, gdw = kernel()
        replays = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            replays.append(bool(torch.equal(gdw, dw) and torch.equal(gdx, dx)))
        case["bit_equal_under_graph_replay"] = all(replays)
        ok = ok and all(replays)
    if not ok:
        raise AssertionError(f"{'K3b' if residual else 'K2b'} disagrees with "
                             f"its plain version or itself: {case}")
    if not timed:
        return case
    others = (dy, ds) if residual else (dy,)
    # each input read once, dx and dw written once: the partial and group
    # rows of dw stay in L2 and are not counted
    moved = nbytes(x, *others, w, dx, dw)
    b_ms, b_by = bound(moved, 8.0 * x.numel(), torch.float32)
    if residual:
        lib, lib_name = None, None
    else:
        wx = w.to(dtype)
        lib = library_bwd_ms(lambda a, b: F.rms_norm(a, (D,), b, eps),
                             (x, wx), dy)
        lib_name = "backward of F.rms_norm (weight in the input dtype)"
    case.update(
        ms=time_ms(kernel), plain_ms=time_ms(plain), library_ms=lib,
        library=lib_name, bound_ms=b_ms, bound_by=b_by, bytes=moved,
        flops=8.0 * x.numel(), blocks=bwd_blocks(rows, pick_variant(x, w)),
        dw=f"summed in this launch: each block writes its partial row, the "
           f"last {REDUCERS} blocks each add a slice of the columns over all "
           f"partial rows ({REDUCE_LANES} lanes of every {REDUCE_LANES}th "
           f"row, then the lanes, in order); no separate launch")
    return case


def flash_bwd_d192_cases() -> list:
    """K1b bf16 at D = 192, MLA's q/k width, with V's last 64 columns zero
    as MLA pads them from 128: timed at q and k/v (8, 128, 64, 192), 8 rows
    of 128 tokens over deepseek-v2's 64 of 128 heads that a rank of a
    2-way ``model`` axis holds, then at the tile edges, ragged lengths and
    0, GQA, and non-causal."""
    bf16 = torch.bfloat16
    mla = get_config(MLA_ARCH)
    H = mla.n_heads // MESH_TRAIN[0][1]
    pad = 192 - mla.mla.v_head_dim
    return [flash_bwd_case(bf16, 8, TRAIN_SEQ, H, H, 192, timed=True,
                           vpad=pad),
            flash_bwd_case(bf16, 2, 1, 4, 4, 192, lengths=[1, 0], vpad=pad),
            flash_bwd_case(bf16, 2, 65, 4, 4, 192, lengths=[65, 30],
                           vpad=pad),
            flash_bwd_case(bf16, 2, 200, 4, 4, 192, lengths=[200, 0],
                           vpad=pad),
            flash_bwd_case(bf16, 1, 512, 2, 2, 192, vpad=pad),
            flash_bwd_case(bf16, 2, 200, 8, 2, 192, lengths=[137, 200]),
            flash_bwd_case(bf16, 2, 200, 4, 4, 192, causal=False,
                           lengths=[0, 151], vpad=pad),
            flash_bwd_case(bf16, 1, 128, 4, 4, 192, causal=False)]


def phase_kernels_bwd(ptxas: dict) -> dict:
    """Phase 7: every backward kernel against its plain backward, and
    ptxas's registers and spills for each backward kernel; the D = 64 K1b
    kernels (the training shape's head dim), bf16 and f32, and the bf16
    ones at D = 192 (MLA's), must not spill."""
    require_no_spills(ptxas, ("flash_bwd_dq_wgmma<bf16, 64>",
                              "flash_bwd_dkdv_wgmma<bf16, 64>",
                              "flash_bwd_dq_f32<float, 64>",
                              "flash_bwd_dkdv_f32<float, 64>")
                      + D192_KERNELS[1:], "kernels_bwd_spills")
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config("tacc-100m")
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    TB, TS = TRAIN_BATCH, TRAIN_SEQ
    flash = [flash_bwd_case(bf16, TB, TS, H, KV, HD, timed=True),
             flash_bwd_case(f32, TB, TS, H, KV, HD, timed=True)]
    for dt in (bf16, f32):
        flash += [
            flash_bwd_case(dt, 2, 1, H, KV, HD, lengths=[1, 0]),
            flash_bwd_case(dt, 2, 65, H, KV, HD, lengths=[65, 30]),
            flash_bwd_case(dt, 2, 200, H, KV, HD, lengths=[200, 0]),
            flash_bwd_case(dt, 1, 512, H, KV, HD),
            flash_bwd_case(dt, 2, 200, H, KV, 128, lengths=[137, 200]),
            flash_bwd_case(dt, 2, 130, 4, 4, HD, lengths=[130, 64]),   # G = 1
            flash_bwd_case(dt, 2, 200, H, KV, HD, causal=False,
                           lengths=[0, 151]),
            flash_bwd_case(dt, 1, 128, 4, 4, 128, causal=False),
        ]
    flash.append(flash_bwd_case(bf16, 2, 200, H, KV, HD, lengths=[200, 137],
                                strided=True))
    d192 = flash_bwd_d192_cases()
    N = TB * TS
    norms = {}
    for residual, key in ((False, "K2b"), (True, "K3b")):
        cases = [rms_bwd_case(bf16, N, residual, timed=True),
                 rms_bwd_case(f32, N, residual, timed=True)]
        for dt in (bf16, f32):
            cases += [rms_bwd_case(dt, 1, residual),
                      rms_bwd_case(dt, 13, residual),
                      rms_bwd_case(dt, 13, residual, D=2048),
                      rms_bwd_case(dt, 5, residual, D=770),
                      rms_bwd_case(dt, 7, residual, offset=1),
                      rms_bwd_case(dt, 3, residual, D=8192)]
        norms[key] = cases
    out = {"phase": "kernels_bwd", "flash": flash, "flash_d192": d192,
           **norms, "ptxas": {k: v for k, v in ptxas.items() if "_bwd_" in k},
           "hgmma_d192": {n: hgmma_counts().get(n) for n in D192_KERNELS}}
    emit(out)
    return out


# -- phase 8 ---------------------------------------------------------------

TRAIN_CONSISTENCY_BARS = {"loss_rel": 1e-3, "grad_norm_rel": 1e-3,
                          "min_cosine": 0.999}


def _loss_and_grads(model: Transformer, batch: dict):
    logits, _ = train_logits(model, batch, remat="full")
    loss, _ = cross_entropy(logits, batch["labels"])
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), dict(zip(names, grads))


def phase_train_consistency(cfg, params) -> dict:
    """Phase 8: one forward and backward at full width on the card and on
    the CPU's plain path, from the same f32 weights and tokens. bf16
    activations round differently in the two paths, so the bars sit a few
    times above what the H100 read (loss rel 2.7e-5, grad norm rel 1.5e-5,
    least cosine 0.99957): loss and grad norm within rel 1e-3, every
    parameter's gradient at cosine >= 0.999. A kernel that is wrong by a
    few percent in one leaf's gradient leaves these bars."""
    b = SyntheticLM(cfg, 1, 128, seed=SEED).batch(0)
    batches = {dev: {k: torch.from_numpy(v).long().to(dev) for k, v in b.items()}
               for dev in ("cuda", "cpu")}
    loss_g, g_gpu = _loss_and_grads(
        Transformer(cfg, params, device="cuda", trainable=True),
        batches["cuda"])
    loss_c, g_cpu = _loss_and_grads(
        Transformer(cfg, {k: v.cpu() for k, v in params.items()},
                    device="cpu", trainable=True), batches["cpu"])
    norm = lambda gs: float(torch.sqrt(sum((g.double() ** 2).sum()  # noqa: E731
                                           for g in gs.values())))
    cos = {}
    for name, gc in g_cpu.items():
        a, c = g_gpu[name].double().cpu().flatten(), gc.double().flatten()
        den = float(a.norm() * c.norm())
        cos[name] = 1.0 if den == 0 and float(a.norm() + c.norm()) == 0 \
            else float(a @ c) / max(den, 1e-300)
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
    out = {"phase": "train_consistency", "batch": 1, "seq": 128,
           "loss_gpu": loss_g, "loss_cpu": loss_c,
           "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
           "grad_norm_gpu": norm(g_gpu), "grad_norm_cpu": norm(g_cpu),
           "min_cosine": worst[0][1], "worst_cosines": worst,
           "bars": TRAIN_CONSISTENCY_BARS}
    out["grad_norm_rel"] = (abs(out["grad_norm_gpu"] - out["grad_norm_cpu"])
                            / out["grad_norm_cpu"])
    emit(out)
    bars = TRAIN_CONSISTENCY_BARS
    if not (np.isfinite(loss_g) and out["loss_rel"] < bars["loss_rel"]
            and out["grad_norm_rel"] < bars["grad_norm_rel"]
            and out["min_cosine"] >= bars["min_cosine"]):
        raise AssertionError(f"training consistency failed: {out}")
    return out


# -- phase 9 ---------------------------------------------------------------

# The least fall of the loss over the 20 steps on batch 0 (trained on at
# the first step) and on batch 23 (never trained on), each loss taken
# without a gradient from the same tokens before and after. The evaluation
# is deterministic, so parameters that never moved read a fall of exactly
# 0. The bars sit at about half and a third of what the H100 read: 1.039
# on batch 0, which the model has partly memorised, and 0.0158 held out.
EVAL_FALL = {"batch_0": 0.5, "held_out": 0.005}

BWD_KERNELS = [
    # (name, wrapper whose count is the kernel's, source, what it replaces)
    ("flash_bwd_dq", flash_bwd_dq,
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "XLA's gradient of src/repro/models/attention.py:91"),
    ("flash_bwd_dkdv", flash_bwd_dkdv,
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "XLA's gradient of src/repro/models/attention.py:91"),
    ("rmsnorm_bwd", rmsnorm_bwd, "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "XLA's gradient of src/repro/kernels/ref.py:24"),
    ("rmsnorm_residual_bwd", rmsnorm_residual_bwd,
     "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "XLA's gradient of src/repro/models/transformer.py:187-189"),
]


def expected_train_launches(cfg, steps: int) -> dict:
    """Launches of each kernel in ``steps`` train steps, from the code:
    every block runs under remat="full", so its forward runs twice
    (forward, then recomputed in the backward) and its backward once: K1
    and K1b in each attention or MLA layer, K2 for each mixer norm and
    MLA's latent norms (serve_launches counts them), K3 for each FFN after
    its mixer; out_norm (K2) lies outside the blocks; K2b and K3b each
    give dx and dw in one launch, with no separate dw reduction."""
    specs = cfg.layer_specs
    attn = sum(spec.mixer in ("attn", "mla") for spec in specs)
    norms = len(specs) + sum(1 + bool(cfg.mla.q_lora_rank) for spec in specs
                             if spec.mixer == "mla")
    ffn = sum(spec.ffn != "none" and not spec.parallel for spec in specs)
    per_step = {"flash_attention": 2 * attn, "rmsnorm": 2 * norms + 1,
                "rmsnorm_residual": 2 * ffn, "flash_bwd_dq": attn,
                "flash_bwd_dkdv": attn, "rmsnorm_bwd": norms + 1,
                "rmsnorm_residual_bwd": ffn}
    return {k: steps * v for k, v in per_step.items()}


def _eval_loss(cfg, params, batch: dict) -> float:
    """The training loss (cross-entropy + z-loss) of ``params`` on
    ``batch``, without a gradient."""
    model = Transformer(cfg, params, device="cuda", trainable=True)
    with torch.no_grad():
        logits, _ = train_logits(model, batch, remat="none")
        loss, _ = cross_entropy(logits, batch["labels"],
                                z_loss=TrainConfig().z_loss)
    return float(loss)


def phase_train(cfg) -> dict:
    """Phase 9: the main training path, 20 steps at full width. Batch 0
    (trained on at the first step) and batch 23 (never trained on) are
    evaluated before the first step and after the last."""
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [{k: torch.from_numpy(v).long().cuda()
                for k, v in data.batch(i).items()}
               for i in range(TRAIN_STEPS + 4)]
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    step_fn = build_train_step(cfg, ocfg, TrainConfig(), remat="full")
    state = init_train_state(
        cfg, ocfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    evals = {"batch_0": [_eval_loss(cfg, state["params"], batches[0])],
             "held_out": [_eval_loss(cfg, state["params"], batches[-1])]}
    wrappers = [fn for fn, _, _ in KERNELS] + [fn for _, fn, _, _ in
                                               BWD_KERNELS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases left allocated: the peak below includes it
    allocated_at_start = torch.cuda.memory_allocated()
    for fn in wrappers:
        fn.launches = 0
    losses, gnorms, lrs, step_ms = [], [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
    launches = {fn.__name__: fn.launches for fn in wrappers}
    expected = expected_train_launches(cfg, TRAIN_STEPS)
    evals["batch_0"].append(_eval_loss(cfg, state["params"], batches[0]))
    evals["held_out"].append(_eval_loss(cfg, state["params"], batches[-1]))
    fall = {k: a - b for k, (a, b) in evals.items()}
    steady = step_ms[1:]
    out = {"phase": "train", "steps": TRAIN_STEPS, "global_batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "lr": 3e-4, "remat": "full",
           "loss": losses, "grad_norm": gnorms, "lr_per_step": lrs,
           "step_ms": step_ms,
           "step_ms_mean": float(np.mean(steady)),
           "step_ms_p50": float(np.median(steady)),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3 / float(np.mean(steady)),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "memory_allocated_at_start_gb": allocated_at_start / 1e9,
           "launches": launches, "expected_launches": expected,
           "eval_loss_before_after": evals, "eval_fall": fall,
           "eval_fall_bar": EVAL_FALL}

    # a profiled window of three more steps
    def three():
        for i in range(3):
            step_fn(state, batches[TRAIN_STEPS + i])
        return 3
    prof = _trace(three)
    busy = prof["device_busy_ms"]
    prof["device_idle_share"] = (None if busy is None else
                                 max(0.0, 1.0 - busy / prof["traced_wall_ms"]))
    prof["idle_share_vs_untraced"] = (None if busy is None else max(
        0.0, 1.0 - busy / out["step_ms_mean"]))
    out["profile"] = prof
    emit(out)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"the loss did not fall: {losses}")
    if not all(fall[k] >= EVAL_FALL[k] for k in EVAL_FALL):
        raise AssertionError(f"the evaluated loss fell by {fall}, less than "
                             f"{EVAL_FALL}: {evals}")
    if launches != expected:
        raise AssertionError(f"kernel launches in {TRAIN_STEPS} steps: "
                             f"{launches}, expected {expected}")
    return out


# -- phase 10 --------------------------------------------------------------

# examples/train_cluster_torch.py's scenario at full width: 60 steps in
# the example's quanta of 10, checkpoints every 15 (the failure at step 20
# goes back to 15, so steps 16-20 run twice; the preemption at 30-something
# saves where it stands), and what the service may leave allocated on the
# card
CLUSTER_STEPS, CLUSTER_CKPT_EVERY = 60, 15
MEMORY_SLACK_BYTES = 100e6


def _load_script(relpath: str):
    """A script of the repo (an example or a bench) loaded by path."""
    path = os.path.join(ROOT, relpath)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _error_blocks(log: str) -> list:
    """Each ``runtime error`` entry of a job log with its traceback."""
    blocks, cur = [], None
    for line in log.splitlines():
        if "runtime error" in line:
            cur = [line]
            blocks.append(cur)
        elif re.match(r"\[\d\d:\d\d:\d\d\]", line):
            cur = None
        elif cur is not None:
            cur.append(line)
    return ["\n".join(b) for b in blocks]


def serve_job_flash_case(cfg) -> dict:
    """K1 at the serving job's prefill shape: the smoke config's head dim
    16, which the wrapper runs zero-padded to 64 with the scale of 16,
    one row of max_seq 64 with an 8-token prompt, bf16."""
    S, H, KV, D = 64, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dtype = getattr(torch, cfg.dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(1, S, H, D, generator=g, device="cuda").to(dtype)
    kv = torch.randn(1, S, 2, KV, D, generator=g, device="cuda").to(dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]
    lengths = torch.tensor([8], dtype=torch.int32, device="cuda")
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=True, lengths=lengths)
    ref = flash_attention_plain(q, k, v, causal=True, lengths=lengths)
    torch.cuda.synchronize()
    case = {"q": list(q.shape), "kv": list(k.shape), "dtype": str(q.dtype),
            "max_abs_err": max_err(o, ref), "tol": 3e-2,
            "launched": flash_attention.launches - before}
    if not (torch.isfinite(o.float()).all() and case["launched"] == 1
            and case["max_abs_err"] <= case["tol"]):
        raise AssertionError(f"K1 at head dim {D} (padded) disagrees with "
                             f"its plain version: {case}")
    return case


# JAX's loss curve for this phase's job (tools/jax_loss_curve.py writes it)
JAX_CURVE = os.path.join(ROOT, "tools", "jax_loss_curve.json")
# step 0: the same state and batch, only the forward differs: phase 8's bar
JAX_CURVE_STEP0_BAR = 1e-3
# later steps: this many times the largest gap the port's CPU path showed
# against JAX at that step or before (see jax_curve_bars)
JAX_CURVE_GAP_FACTOR = 3.0


def curve_spec(spec) -> dict:
    """What fixes a training job's loss curve, as its runtime reads it from
    the spec: the model, the optimizer and train configs, the data stream
    and the seed."""
    cfg, ocfg, tcfg = TorchTrainRuntime.configs(spec)
    batch, seq, seed = TorchTrainRuntime.stream(spec)
    return {"arch": cfg.name, "dtype": cfg.dtype, "global_batch": batch,
            "seq_len": seq, "seed": seed,
            **{f.name: getattr(ocfg, f.name)
               for f in dataclasses.fields(ocfg)
               if not isinstance(getattr(ocfg, f.name), torch.dtype)},
            "m_dtype": str(ocfg.m_dtype), "v_dtype": str(ocfg.v_dtype),
            "n_microbatches": tcfg.n_microbatches, "z_loss": tcfg.z_loss,
            "aux_scale": tcfg.aux_scale}


def leaf_sums(state) -> dict:
    """Each leaf of a train state, by name: its float64 sum and sum of
    squares (numpy's pairwise sums, whatever the device)."""
    leaves = [(f"params.{k}", v) for k, v in state["params"].items()]
    leaves += [(f"opt.{part}.{k}", v) for part in ("m", "v")
               for k, v in state["opt"][part].items()]
    leaves.append(("opt.step", state["opt"]["step"]))
    out = {}
    for name, t in leaves:
        a = t.detach().cpu().double().numpy()
        out[name] = [float(a.sum()), float(np.square(a).sum())]
    return out


def jax_curve_bars(jax_losses, cpu_losses) -> list:
    """The bar on |loss - JAX's| / |JAX's| at each step: at step 0
    ``JAX_CURVE_STEP0_BAR``; at step i > 0 ``JAX_CURVE_GAP_FACTOR`` times
    the largest relative gap between the port's CPU path and JAX at steps
    0..i, and never below ``JAX_CURVE_STEP0_BAR``. The card's kernels sum
    in other orders than the CPU's plain path, as that path does against
    XLA: a gap of the same kind, which training carries forward (the
    running max)."""
    bars, worst = [], 0.0
    for i, (j, c) in enumerate(zip(jax_losses, cpu_losses)):
        worst = max(worst, abs(c - j) / abs(j))
        bars.append(JAX_CURVE_STEP0_BAR if i == 0 else
                    max(JAX_CURVE_GAP_FACTOR * worst, JAX_CURVE_STEP0_BAR))
    return bars


def jax_curve_start(ex) -> dict:
    """Phase 10's first check, before the service starts: JAX's curve in
    ``JAX_CURVE`` is for this phase's job (the same spec fields), the job's
    initial state, drawn here on the CPU as its runtime draws it, has the
    file's leaf sums (rel 1e-9), and the file's bar is
    :func:`jax_curve_bars` of its losses. Returns the file."""
    with open(JAX_CURVE) as f:
        ref = json.load(f)
    spec = ex.train_spec(smoke=False, steps=CLUSTER_STEPS,
                         ckpt_every=CLUSTER_CKPT_EVERY)
    if curve_spec(spec) != ref["spec"]:
        raise AssertionError(f"{JAX_CURVE} is for another job: "
                             f"{ref['spec']} against {curve_spec(spec)}")
    cfg, ocfg, _ = TorchTrainRuntime.configs(spec)
    seed = TorchTrainRuntime.stream(spec)[2]
    sums = leaf_sums(init_train_state(
        cfg, ocfg, torch.Generator().manual_seed(seed), "cpu"))
    off = [n for n, want in ref["leaf_sums"].items()
           if n not in sums or not all(
               math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-9)
               for a, b in zip(sums[n], want))]
    if off or set(sums) != set(ref["leaf_sums"]):
        raise AssertionError(
            f"the job's initial state drawn on this host's CPU differs from "
            f"the one JAX's curve starts from ({JAX_CURVE}): torch "
            f"{torch.__version__} here, {ref['port_cpu']['torch']} there; "
            f"rerun tools/jax_loss_curve.py with this torch. Leaves off: "
            f"{off[:8]} of {len(ref['leaf_sums'])}")
    if jax_curve_bars(ref["jax"]["loss"], ref["port_cpu"]["loss"]) \
            != ref["bar"]:
        raise AssertionError(f"{JAX_CURVE}'s bar is not jax_curve_bars of "
                             f"its losses")
    return ref


def jax_curve_gaps(losses, ref: dict) -> dict:
    """The straight run's losses against JAX's curve: each step's relative
    gap, its bar, the largest gap and its step, and the steps over their
    bar."""
    jl, bars = ref["jax"]["loss"], ref["bar"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, jl)]
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    return {"jax_rel_gaps": gaps, "jax_bars": bars[:len(gaps)],
            "jax_max_rel_gap": gaps[worst], "jax_max_rel_gap_step": worst,
            "jax_steps_over_bar": [i for i, g in enumerate(gaps)
                                   if not g <= bars[i]],
            "jax_steps_compared": len(gaps)}


def _straight_run(spec, steps: int):
    """The job's training without the service: the config, OptConfig and
    TrainConfig its runtime builds, the same seed and batches, one loop,
    no checkpoints. Returns (cfg, state, losses, lrs)."""
    cfg, ocfg, tcfg = TorchTrainRuntime.configs(spec)
    batch, seq, seed = TorchTrainRuntime.stream(spec)
    data = SyntheticLM(cfg, batch, seq, seed=seed)
    step_fn = build_train_step(cfg, ocfg, tcfg)
    # drawn on the CPU, as the runtime draws it
    state = init_train_state(cfg, ocfg, torch.Generator().manual_seed(seed),
                             "cuda")
    losses, lrs = [], []
    for i in range(steps):
        state, m = step_fn(state, to_torch(data.batch(i), "cuda"))
        losses.append(m["loss"])
        lrs.append(m["lr"])
    return (cfg, state, [float(x) for x in losses],
            [float(x) for x in lrs])


def _compare_states(cfg, tree, straight) -> dict:
    """The final checkpoint (JAX layout, CPU) against the straight run's
    state: whether every leaf is bit-equal, both optimizer steps, and every
    param's difference."""
    restored = state_from_jax(cfg, tree, "cpu")
    pairs = [(f"params.{k}", restored["params"][k], straight["params"][k])
             for k in straight["params"]]
    for part in ("m", "v"):
        pairs += [(f"opt.{part}.{k}", restored["opt"][part][k],
                   straight["opt"][part][k]) for k in straight["opt"][part]]
    pairs.append(("opt.step", restored["opt"]["step"],
                  straight["opt"]["step"]))
    unequal = [n for n, a, b in pairs
               if a.dtype != b.dtype or not torch.equal(a, b.cpu())]
    d = torch.cat([(restored["params"][k] - straight["params"][k].cpu())
                   .abs().flatten() for k in straight["params"]])
    return {"bit_equal": not unequal, "unequal_leaves": unequal[:8],
            "n_unequal": len(unequal),
            "opt_step": int(restored["opt"]["step"]),
            "straight_opt_step": int(straight["opt"]["step"]),
            "param_max_abs_diff": float(d.max()), "diffs": d}


def phase_cluster() -> dict:
    """Phase 10: the cluster path. The service's runtimes build their
    kernels' inputs from the spec; every kernel's count is zeroed just
    before the service starts and read when it has ended."""
    ex = _load_script("examples/train_cluster_torch.py")
    curve = jax_curve_start(ex)
    serve_k1 = serve_job_flash_case(get_config("tacc-100m", smoke=True))
    wrappers = [fn for fn, _, _ in KERNELS] + [fn for _, fn, _, _ in
                                               BWD_KERNELS]
    gc.collect()
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    try:
        disk_free = shutil.disk_usage(root).free
        for fn in wrappers:
            fn.launches = 0
        t0 = time.perf_counter()
        svc = ex.run_scenario(root, smoke=False, steps=CLUSTER_STEPS,
                              device="cuda", ckpt_every=CLUSTER_CKPT_EVERY,
                              verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in wrappers}
        peak = torch.cuda.max_memory_allocated()
        gc.collect()
        allocated_after = torch.cuda.memory_allocated()

        train = ex.job_named(svc, ex.TRAIN_NAME)
        urgent = ex.job_named(svc, ex.URGENT_NAME)
        with open(os.path.join(train.plan.workdir, "job.log")) as f:
            log = f.read()
        stats = svc.executor.stats.get(train.id, {})
        quanta, saves = stats.get("quanta", []), stats.get("saves", [])
        restores = stats.get("restores", [])
        steps_run = sum(q["steps"] for q in quanta)
        step_ms = [q["step_ms"] for q in quanta]
        out = {"phase": "cluster", "steps": CLUSTER_STEPS,
               "ckpt_every": CLUSTER_CKPT_EVERY,
               "quantum": svc.executor.quantum,
               "status": svc.status(), "wall_s": wall,
               "ticks": svc.ticks, "steps_run": steps_run,
               "step_ms_mean": float(np.mean(step_ms)) if step_ms else None,
               "step_ms_p50": float(np.median(step_ms)) if step_ms else None,
               "quanta": quanta, "saves": len(saves), "save_detail": saves,
               "save_s_total": sum(x["snapshot_s"] + x["write_s"]
                                   for x in saves),
               "restores": restores,
               "restore_s_total": sum(x["seconds"] for x in restores),
               "max_memory_allocated_gb": peak / 1e9,
               "memory_allocated_before_gb": allocated_before / 1e9,
               "memory_allocated_after_gb": allocated_after / 1e9,
               "disk_free_gb_before": disk_free / 1e9,
               "launches": launches}
        out["save_share_of_wall"] = out["save_s_total"] / wall
        out["restore_share_of_wall"] = out["restore_s_total"] / wall

        failures = []
        if train.state.value != "COMPLETED" or train.restarts != 1 \
                or train.preemptions < 1:
            failures.append(f"training job {train.state.value} with "
                            f"{train.restarts} restarts and "
                            f"{train.preemptions} preemptions; wanted "
                            f"COMPLETED, 1 and >= 1")
            for block in _error_blocks(log):
                print(block, file=sys.stderr, flush=True)
        if urgent.state.value != "COMPLETED":
            failures.append(f"serving job {urgent.state.value}")
        if abs(allocated_after - allocated_before) > MEMORY_SLACK_BYTES:
            failures.append(f"allocated memory {allocated_before} -> "
                            f"{allocated_after} bytes across the service")
        # the backward kernels run in training only, the forward ones in
        # the serving job's prefills and decode steps too
        expected = expected_train_launches(get_config("tacc-100m"),
                                           steps_run)
        out["expected_train_launches"] = expected
        backward = {name for name, _, _, _ in BWD_KERNELS}
        for name, n in launches.items():
            if n == 0 or (n != expected[name] if name in backward
                          else n < expected[name]):
                failures.append(f"{name} launched {n} times in "
                                f"{steps_run} train steps and the serving "
                                f"job; training alone launches it "
                                f"{expected[name]} times")

        if train.state.value == "COMPLETED":
            tree, man = restore_checkpoint(os.path.join(train.plan.workdir,
                                                        "ckpt"))
            cfg, straight, losses, lrs = _straight_run(train.spec,
                                                       CLUSTER_STEPS)
            cmp = _compare_states(cfg, tree, straight)
            d = cmp.pop("diffs")
            del straight
            lr_sum = float(sum(lrs))
            last = quanta[-1]["loss"]
            out.update(
                final_step=man["step"], final_checkpoint_bytes=man["nbytes"],
                straight_losses=losses, last_loss=last,
                straight_last_loss=losses[-1],
                last_loss_rel=abs(last - losses[-1]) / abs(losses[-1]),
                lr_sum=lr_sum,
                param_share_beyond_1pct=float((d > 1e-2 * lr_sum)
                                              .float().mean()),
                **cmp)
            if man["step"] != CLUSTER_STEPS:
                failures.append(f"final checkpoint at step {man['step']}")
            if out["opt_step"] != out["straight_opt_step"]:
                failures.append(f"optimizer step {out['opt_step']} in the "
                                f"final checkpoint, "
                                f"{out['straight_opt_step']} in the straight "
                                f"run")
            # the path is deterministic (K1b and K2b/K3b bit-equal over
            # calls), so a resume that restores every leaf ends bit-equal
            if not out["bit_equal"]:
                failures.append(f"{out['n_unequal']} leaves differ from the "
                                f"straight run's: {out['unequal_leaves']}")
            if not out["last_loss_rel"] <= 1e-4:
                failures.append(f"last loss {last} against the straight "
                                f"run's {losses[-1]}")
            if not (out["param_max_abs_diff"] <= 0.25 * lr_sum
                    and out["param_share_beyond_1pct"] <= 5e-3):
                failures.append("the final params differ from the straight "
                                "run's beyond phase 9's share of the lr")
            out.update(jax_curve_gaps(losses, curve))
            if out["jax_steps_compared"] != CLUSTER_STEPS \
                    or out["jax_steps_over_bar"]:
                failures.append(
                    f"the loss left JAX's curve beyond its bar at steps "
                    f"{out['jax_steps_over_bar']} of "
                    f"{out['jax_steps_compared']} (largest gap "
                    f"{out['jax_max_rel_gap']} at step "
                    f"{out['jax_max_rel_gap_step']})")
        out["serve_job_k1"] = serve_k1
        out["failures"] = failures
        emit(out)
        if failures:
            raise AssertionError(f"cluster phase failed: {failures}")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)

# -- phase 11 --------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
# qwen2-moe-a2.7b at full width and depth: 24 layers of 16,783,360
# attention, 588,382,208 MoE (64 routed experts after pad_to, the shared
# block) and 4,096 norm parameters, the embedding and unembedding
MOE_PARAMS = 15_146_403_840
# the dispatch against the dense oracle on the card: the routed experts'
# f32 sums from one route, before the shared block is added and before
# the final rounding, max |dispatch - oracle| over max |oracle|. Each
# expert's products run at another row count in the two (the dispatch's
# rows are the expert's own, the oracle's all of them), so cuBLAS may sum
# in another order and flip a bf16 rounding of an expert's output; the
# combine's f32 sum of k terms runs in another order. The CPU test's bf16
# bar is rel 0.03; this one is a third of it. A planted fault, the
# dispatch's sums rolled by one row (each token given its neighbour's
# experts), must read above it
MOE_ROUTED_BAR = 0.01
# the long prefills that bracket ``DISPATCH_MIN_ROWS``, one token row each
MOE_LONG_PREFILLS = (2048, 4096)
MOE_PEAK_ABOVE_START_BYTES = 40e9
MOE_CPU_LAYERS = 2


def moe_layer_case(cfg, model, tokens: torch.Tensor) -> dict:
    """K1 on layer 0's q, k, v from a real prefill (v a strided view of the
    fused, biased wkv product), then the dispatch against the dense
    oracle on layer 0's FFN input: the routes equal over two calls and to
    the CPU's on the same f32 router and input, the aux terms equal, the
    routed sums within ``MOE_ROUTED_BAR`` and a planted fault beyond it;
    both paths timed at the prefill's rows and a decode step's."""
    layer = model.layers[0]
    S = tokens.shape[1]
    lengths = [S]
    with torch.inference_mode():
        x = L.embed_tokens(cfg, model.embed, tokens)
        positions = torch.arange(S, device="cuda")[None, :]
        h = L.apply_norm(cfg, layer.mixer_norm, x)
        q, k, v = A.project_qkv(cfg, layer.mixer, h, positions)
        k1 = flash_check(q, k, v, lengths)
        k1_prompt = flash_check(q, k, v, [136], timed=False)
        y_mix, _ = A.self_attention(
            cfg, layer.mixer, h, positions,
            lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"))
        hf, _ = rmsnorm_residual(x, y_mix, layer.ffn_norm["scale"],
                                 cfg.norm_eps)
        p = layer.ffn
        flat = hf.reshape(-1, cfg.d_model)
        idx, w, _ = MOE.route(cfg, flat, p["router"])
        idx2, _, _ = MOE.route(cfg, flat, p["router"])
        idx_cpu, _, _ = MOE.route(cfg, flat.cpu(), p["router"].cpu())
        routed = MOE.dispatch_routed(cfg, p, flat, idx, w)
        routed_ref = MOE.dense_routed(cfg, p, flat, idx, w)
        y, aux = MOE.moe_dispatch(cfg, p, hf)
        _, aux_ref = MOE.moe_dense_oracle(cfg, p, hf)
        torch.cuda.synchronize()
        scale = float(routed_ref.abs().max())
        rel = max_err(routed, routed_ref) / scale
        fault = max_err(routed.roll(1, 0), routed_ref) / scale
        aux_rel = {k_: abs(float(aux[k_]) - float(aux_ref[k_]))
                   / abs(float(aux_ref[k_])) for k_ in aux}
        counts = torch.bincount(idx.flatten(), minlength=cfg.moe.n_experts)
        out = {"x": list(hf.shape), "route_equal_over_two_calls":
               bool(torch.equal(idx, idx2)),
               "route_rows_equal_to_cpu": float(
                   (idx.cpu() == idx_cpu).all(-1).float().mean()),
               "experts_used": int((counts > 0).sum()),
               "rows_per_expert_max": int(counts.max()),
               "aux": {k_: float(v_) for k_, v_ in aux.items()},
               "aux_rel": aux_rel, "routed_max_abs": scale,
               "routed_rel_err": rel, "routed_bar": MOE_ROUTED_BAR,
               "planted_fault_rel_err": fault,
               "y_finite": bool(torch.isfinite(y.float()).all()),
               "dispatch_ms": call_ms(lambda: MOE.moe_dispatch(cfg, p, hf),
                                      iters=10),
               "oracle_ms": call_ms(lambda: MOE.moe_dense_oracle(cfg, p, hf),
                                    iters=10)}
        # a decode step's rows: the first MAX_BATCH rows of the prefill
        rows = hf[:, :MAX_BATCH].reshape(MAX_BATCH, 1, -1)
        out["dispatch_ms_decode_rows"] = call_ms(
            lambda: MOE.moe_dispatch(cfg, p, rows), iters=10)
        out["oracle_ms_decode_rows"] = call_ms(
            lambda: MOE.moe_dense_oracle(cfg, p, rows), iters=10)
    if not (out["route_equal_over_two_calls"]
            and out["route_rows_equal_to_cpu"] == 1.0 and out["y_finite"]
            and rel <= MOE_ROUTED_BAR < fault
            and max(aux_rel.values()) <= 1e-6):
        raise AssertionError(f"the MoE dispatch disagrees with the dense "
                             f"oracle on the card: {out}")
    return {"flash_attention": k1, "flash_attention_prompt": k1_prompt,
            "moe": out}


def moe_long_prefills(cfg, model) -> dict:
    """One prompt of each of ``MOE_LONG_PREFILLS`` tokens prefilled through
    the model with ``moe_apply`` on each path (forced through
    ``DISPATCH_MIN_ROWS``): the ms of each, the dispatch's host reads, and
    the last position's logits of the two paths against each other
    (rel 0.03, the 2-layer cut's bar). A row count on each side of the
    threshold, so the choice is measured end to end."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    keep, out = MOE.DISPATCH_MIN_ROWS, {"dispatch_min_rows":
                                        MOE.DISPATCH_MIN_ROWS}
    try:
        with torch.inference_mode():
            for S in MOE_LONG_PREFILLS:
                toks = torch.randint(1, cfg.vocab_size, (1, S), generator=g,
                                     device="cuda")
                lengths = torch.tensor([S - 7], dtype=torch.int32,
                                       device="cuda")
                case, logits = {"rows": S, "path_taken": (
                    "dispatch" if S >= keep else "oracle")}, {}
                for path, min_rows in (("oracle", S + 1), ("dispatch", S)):
                    MOE.DISPATCH_MIN_ROWS = min_rows
                    fn = lambda: prefill(  # noqa: E731
                        model, {"tokens": toks}, lengths)
                    syncs = MOE.dispatch_routed.host_syncs
                    logits[path] = fn()[0]
                    case[f"{path}_host_syncs"] = (
                        MOE.dispatch_routed.host_syncs - syncs)
                    case[f"{path}_ms"] = call_ms(fn, iters=3)
                case["logits_rel_err"] = rel_err(logits["dispatch"],
                                                 logits["oracle"])
                out[str(S)] = case
                del logits
    finally:
        MOE.DISPATCH_MIN_ROWS = keep
    bad = [c for c in out.values() if isinstance(c, dict) and not (
        c["logits_rel_err"] < 0.03 and c["oracle_host_syncs"] == 0
        and c["dispatch_host_syncs"] == cfg.n_layers)]
    if bad:
        raise AssertionError(f"{cfg.name} long prefills: {out}")
    return out


def cut_layers(cfg, params, layers):
    """The model cut to ``layers`` (indices into ``cfg.layer_specs``),
    renumbered from 0 as prelayers of a config without a period, and its
    params (the same tensors under the new names)."""
    cut = dataclasses.replace(
        cfg, prelayers=tuple(cfg.layer_specs[i] for i in layers),
        n_layers=len(layers))
    old = {f"layers.{j}.": f"layers.{i}." for j, i in enumerate(layers)}

    def source(name: str) -> str:
        if not name.startswith("layers."):
            return name
        head = ".".join(name.split(".")[:2]) + "."
        return old[head] + name[len(head):]
    return cut, {n: params[source(n)] for n in model_defs(cut)}


def full_width_consistency(cfg, params, model, cpu_seq: int = 128,
                           cpu_len: int = 103,
                           cpu_layers=tuple(range(MOE_CPU_LAYERS))) -> dict:
    """Prefill at B = 2, S = 128 and 4 decode steps against the full
    forward; then the model cut to ``cpu_layers`` (its first
    ``MOE_CPU_LAYERS`` by default) at full width, a prefill of one row's
    first ``cpu_seq`` tokens with ``cpu_len`` of them valid on the card
    against the same layers on the CPU through the plain path."""
    B, S, NDEC = 2, 128, 4
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         device="cuda")
    out = {"batch": B, "seq": S}
    with torch.inference_mode():
        full, _ = train_logits(model, {"tokens": toks})
        Sp = S - NDEC
        lengths = torch.full((B,), Sp, dtype=torch.int32, device="cuda")
        lg, cache = prefill(model, {"tokens": F.pad(toks[:, :Sp], (0, NDEC))},
                            lengths)
        out["prefill_vs_full"] = rel_err(lg, full[:, Sp - 1])
        out["decode_vs_full"] = []
        for i in range(NDEC):
            lg, cache = decode_step(model, cache, toks[:, Sp + i])
            out["decode_vs_full"].append(rel_err(lg, full[:, Sp + i]))
        del full, cache, lg
        cut, cut_params = cut_layers(cfg, params, cpu_layers)
        lens1 = torch.tensor([cpu_len], dtype=torch.int32)
        row = toks[:1, :cpu_seq]
        lg_gpu, _ = prefill(Transformer(cut, cut_params, device="cuda"),
                            {"tokens": row}, lens1.cuda())
        t0 = time.perf_counter()
        lg_cpu, _ = prefill(
            Transformer(cut, {n: t.cpu() for n, t in cut_params.items()},
                        device="cpu"), {"tokens": row.cpu()}, lens1)
        out["cpu_seconds"] = time.perf_counter() - t0
        out["prefill_vs_cpu_plain"] = rel_err(lg_gpu, lg_cpu)
    out["cpu_cut"] = (f"layers {list(cpu_layers)} of {cfg.n_layers} "
                      f"({[s.mixer + '+' + s.ffn for s in cut.layer_specs]}) "
                      f"at full width, {cpu_len} of {cpu_seq} tokens: the "
                      f"host's time and memory force the cut, not the card")
    out["bars"] = {"prefill_vs_full": 0.05, "decode_vs_full": 0.08,
                   "prefill_vs_cpu_plain": 0.03}
    if not (out["prefill_vs_full"] < 0.05
            and max(out["decode_vs_full"]) < 0.08
            and out["prefill_vs_cpu_plain"] < 0.03):
        raise AssertionError(f"{cfg.name} consistency failed: {out}")
    return out


def serve_launches(cfg, prefills: int, decodes: int) -> dict:
    """Kernel launches of ``prefills`` prefills and ``decodes`` decode
    steps of ``cfg`` (RMSNorm): K1 once an attention or MLA layer a
    prefill (a recurrent layer runs none, and decode attends without it);
    K2 once a layer, once for out_norm, and for an MLA layer once more for
    kv_norm and again for q_norm where the query is low-rank; K3 once a
    layer with an FFN after the mixer (none in a parallel layer, whose FFN
    shares the mixer's norm); K2 and K3 as often in a decode step."""
    specs = cfg.layer_specs
    attn = sum(spec.mixer in ("attn", "mla") for spec in specs)
    mla = sum(1 + bool(cfg.mla.q_lora_rank) for spec in specs
              if spec.mixer == "mla")
    ffn = sum(spec.ffn != "none" and not spec.parallel for spec in specs)
    calls = prefills + decodes
    return {"flash_attention": attn * prefills,
            "rmsnorm": (len(specs) + 1 + mla) * calls,
            "rmsnorm_residual": ffn * calls}


def serve_prompts(cfg) -> list:
    """Phase 5's traffic: 16 prompts of 16-256 tokens, drawn from SEED."""
    rng = np.random.RandomState(SEED)
    return [rng.randint(1, cfg.vocab_size, rng.randint(16, 257)).tolist()
            for _ in range(N_REQUESTS)]


def serve_traffic(cfg, params):
    """Phase 5's traffic through ServeEngine on this model; every count set
    to 0 just before and read just after, against :func:`serve_launches`.
    No call reaches ``DISPATCH_MIN_ROWS`` rows (a prefill has ``MAX_SEQ``,
    a decode step ``MAX_BATCH``), so the MoE dispatch never runs and never
    reads to the host. Returns (the numbers, the engine, which the profile
    goes on serving)."""
    engine = ServeEngine(cfg, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                         seed=SEED, device="cuda")
    prompts = serve_prompts(cfg)
    for fn, _, _ in KERNELS:
        fn.launches = 0
    MOE.dispatch_routed.host_syncs = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run(prompts, max_new=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn, _, _ in KERNELS}
    syncs = MOE.dispatch_routed.host_syncs
    pf, dc = engine.timings["prefill"], engine.timings["decode"]
    expected = serve_launches(cfg, len(pf), len(dc))
    tokens = sum(len(r.tokens) for r in results)
    out = {"requests": len(results), "tokens": tokens,
           "prompt_tokens": sum(len(p) for p in prompts),
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "prefills": len(pf), "prefill_ms_mean": 1e3 * float(np.mean(pf)),
           "prefill_ms_p50": 1e3 * float(np.median(pf)),
           "decode_steps": len(dc),
           "decode_step_ms_mean": 1e3 * float(np.mean(dc)),
           "decode_step_ms_p50": 1e3 * float(np.median(dc)),
           "launches": launches, "expected_launches": expected,
           "moe_path": ("dispatch" if MAX_SEQ >= MOE.DISPATCH_MIN_ROWS
                        else "oracle"),
           "host_syncs": syncs}
    ok = (len(results) == N_REQUESTS and all(r.done for r in results)
          and all(len(r.tokens) == MAX_NEW for r in results)
          and all(0 <= t < cfg.vocab_size for r in results for t in r.tokens))
    if not ok:
        raise AssertionError(f"{cfg.name} serve returned an unexpected result")
    if launches != expected or syncs != 0:
        raise AssertionError(f"{cfg.name} serve launched {launches} (expected "
                             f"{expected}) with {syncs} host syncs")
    return out, engine


def serve_profile(engine, served: dict, prefills: int = 4) -> dict:
    """``prefills`` prefills (none: no prefill window) and 16 decode steps
    of the served engine under torch.profiler; idle shares against the
    untraced means."""
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(1, engine.cfg.vocab_size, 136).tolist()
               for _ in range(max(prefills, 1))]
    out = {"decode": None}
    if prefills:
        out["prefill"] = _trace(lambda: len([
            engine.add_request(p, max_new=64) for p in prompts]))
    else:                       # the decode steps need a live request
        engine.add_request(prompts[0], max_new=64)
    out["decode"] = _trace(lambda: len([engine.step() for _ in range(16)]))
    for name, untraced in (("prefill", served["prefill_ms_mean"]),
                           ("decode", served["decode_step_ms_mean"])):
        if name not in out:
            continue
        busy = out[name]["device_busy_ms"]
        out[name]["device_idle_share"] = (
            None if busy is None else max(0.0, 1.0 - busy / untraced))
    return out


def smoke_arch_case(arch: str) -> dict:
    """``arch`` at its smoke size on the card: prefill + 4 decode steps
    against the full forward, with the JAX suite's inputs for its input
    mode (bf16 frame or patch embeddings)."""
    B, S, NDEC = 2, 32, 4
    cfg = get_config(arch, smoke=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = cast_for_compute(cfg, init_params(cfg, g, "cuda"), "cuda")
    model = Transformer(cfg, params, device="cuda")
    vt, Sp = cfg.vision_tokens, S - NDEC
    bf16 = lambda *shape: torch.randn(*shape, generator=g,  # noqa: E731
                                      device="cuda").bfloat16()
    if cfg.input_mode == "embeds":
        batch = {"frame_embeds": bf16(B, S, cfg.d_model)}
        pb = {"frame_embeds": F.pad(batch["frame_embeds"][:, :Sp],
                                    (0, 0, 0, NDEC))}
        step = lambda pos: batch["frame_embeds"][:, pos][:, None]  # noqa: E731
    else:
        toks = torch.randint(0, cfg.vocab_size, (B, S - vt), generator=g,
                             device="cuda")
        batch = {"tokens": toks}
        pb = {"tokens": F.pad(toks[:, :Sp - vt], (0, NDEC))}
        if vt:
            batch["vision_embeds"] = pb["vision_embeds"] = bf16(
                B, vt, cfg.d_model)
        step = lambda pos: toks[:, pos - vt]  # noqa: E731
    before = {fn.__name__: fn.launches for fn, _, _ in KERNELS}
    with torch.inference_mode():
        full, _ = train_logits(model, batch)
        lg, cache = prefill(model, pb, torch.full(
            (B,), Sp, dtype=torch.int32, device="cuda"))
        out = {"arch": arch, "prefill_vs_full": rel_err(lg, full[:, Sp - 1]),
               "decode_vs_full": []}
        for i in range(NDEC):
            lg, cache = decode_step(model, cache, step(Sp + i))
            out["decode_vs_full"].append(rel_err(lg, full[:, Sp + i]))
    out["launches"] = {fn.__name__: fn.launches - before[fn.__name__]
                       for fn, _, _ in KERNELS}
    if not (out["prefill_vs_full"] < 0.05
            and max(out["decode_vs_full"]) < 0.08):
        raise AssertionError(f"{arch} smoke consistency on the card: {out}")
    return out


def allocated_bytes() -> int:
    """Bytes held by live tensors, after a collection, less cuBLAS's
    workspaces: PyTorch keeps one in its allocator for every stream that
    ran a product (32 MiB each on this card), and the timers run products
    on side streams, so a phase that times them leaves a few behind
    without holding any tensor."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def phase_moe_serve(floor: float) -> dict:
    """Phase 11: qwen2-moe-a2.7b at full width and depth, seed 0, bf16
    weights drawn leaf by leaf with the router in f32, so the card never
    holds the f32 model; its kernels at its shapes, the MoE layer against
    the dense oracle, consistency, serving, a profile; every registered
    config at smoke size; and the memory given back."""
    before = allocated_bytes()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params = init_serving_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    out = {"phase": "moe_serve", "arch": MOE_ARCH,
           "init_s": time.perf_counter() - t0,
           "params": sum(t.numel() for t in params.values()),
           "param_bytes": nbytes(*params.values()),
           "router_dtypes": sorted({str(t.dtype) for k, t in params.items()
                                    if k.endswith(".router")}),
           "memory_allocated_at_start_gb": before / 1e9,
           "memory_after_weights_gb": torch.cuda.memory_allocated() / 1e9}
    if out["params"] != MOE_PARAMS or out["router_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"{MOE_ARCH} weights: {out}")
    model = Transformer(cfg, params, device="cuda")
    clock = [time.perf_counter()]

    def lap() -> float:
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    seconds = {}
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    tokens = torch.randint(1, cfg.vocab_size, (1, MAX_SEQ), generator=g,
                           device="cuda")
    layer = moe_layer_case(cfg, model, tokens)
    bf16 = torch.bfloat16
    out["kernels"] = {
        "flash_attention": [layer.pop("flash_attention"),
                            layer.pop("flash_attention_prompt")],
        "rmsnorm": [rms_case(bf16, n, False, D=cfg.d_model)
                    for n in (MAX_SEQ, MAX_BATCH)],
        "rmsnorm_residual": [rms_case(bf16, n, True, D=cfg.d_model)
                             for n in (MAX_SEQ, MAX_BATCH)]}
    for c in out["kernels"]["rmsnorm"] + out["kernels"]["rmsnorm_residual"]:
        c["floor_ms"] = floor
    out["moe_layer"] = layer["moe"]
    seconds["kernels_and_moe_layer"] = lap()
    out["long_prefills"] = moe_long_prefills(cfg, model)
    seconds["long_prefills"] = lap()
    out["consistency"] = full_width_consistency(cfg, params, model)
    seconds["consistency"] = lap()
    del model
    served, engine = serve_traffic(cfg, params)
    out["serve"] = served
    seconds["serve"] = lap()
    out["profile"] = serve_profile(engine, served)
    seconds["profile"] = lap()
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["peak_above_start_gb"] = (torch.cuda.max_memory_allocated()
                                  - before) / 1e9
    del engine, params
    out["smoke_archs"] = [smoke_arch_case(a) for a in sorted(list_archs())]
    seconds["smoke_archs"] = lap()
    out["seconds"] = seconds
    after = allocated_bytes()
    out["memory_allocated_after_gb"] = after / 1e9
    emit(out)
    if out["peak_above_start_gb"] * 1e9 > MOE_PEAK_ABOVE_START_BYTES:
        raise AssertionError(f"{MOE_ARCH} peaked {out['peak_above_start_gb']}"
                             f" GB above the phase's start")
    if abs(after - before) > MEMORY_SLACK_BYTES:
        raise AssertionError(f"allocated memory {before} -> {after} bytes "
                             f"across phase 11")
    return out


# -- phase 12 --------------------------------------------------------------

MLA_ARCH = "deepseek-v2-236b"
# deepseek-v2 at full width cut to its first 4 of 60 layers, the dense MLA
# prelayer and 3 MLA + MoE layers: 1,048,576,000 embedding and unembedding,
# 149,227,520 a mixer, 188,743,680 the dense FFN, 3,823,206,400 a MoE FFN
# and the norms; 26.6 GB in bf16. Five layers would take 36.5 GB, too close
# to the 40 GB bar on the phase's peak
MLA_LAYERS = 4
MLA_PARAMS = 13_302_912_000
MLA_DECODE_LAYERS = (0, 3)
# the absorbed decode against the naive one on the same layer, input and
# cache. f32: tests/test_attention.py's atol 1e-4 / rtol 1e-3, elementwise.
# bf16: max |absorbed - naive| over max |naive| of the layer's output. The
# two forms round different intermediates to bf16 (q_lat, ctx and o
# against K, V and o, each to 2^-9 relative): about 1e-2 of the output's
# largest entry at worst; 5.6e-3 read on the CPU at full width
# (deepseek-v2's layer 0, seed 0, 64 cached tokens). The bar is twice the
# estimate
MLA_DECODE_BF16_BAR = 2e-2
# phase 11's bar on the peak above the phase's start, and its CPU cut's
# layers; the CPU's prompt is short, since its dense MoE oracle takes about
# 4 TFLOP a layer at 512 rows
MLA_CPU_SEQ, MLA_CPU_LEN = 32, 27


def mla_k1_case(cfg, model, tokens: torch.Tensor) -> dict:
    """K1 at D = 192 on layer 0's q, k and V zero-padded to 192 from a real
    prefill, timed (``flash_check``), and again at a serve prompt's
    expected length."""
    layer = model.layers[0]
    S = tokens.shape[1]
    with torch.inference_mode():
        x = L.embed_tokens(cfg, model.embed, tokens)
        positions = torch.arange(S, device="cuda")[None, :]
        h = L.apply_norm(cfg, layer.mixer_norm, x)
        q, k, v, _, _ = MLA.mla_qkv(cfg, layer.mixer, h, positions)
        case = flash_check(q, k, v, [S])
        prompt = flash_check(q, k, v, [136], timed=False)
    if q.shape[-1] != 192:
        raise AssertionError(f"{cfg.name}'s q/k head dim is {q.shape[-1]}")
    return {"full": case, "prompt": prompt}


def mla_decode_cases(cfg, model) -> dict:
    """The absorbed decode against the naive one at ``MLA_DECODE_LAYERS``,
    in f32 (the layer's weights and the cache cast up) and bf16: each
    layer's cache from a real prefill of 2 rows (64 and 41 tokens), one
    new unit-RMS input row each. The caches the two forms write must be
    bit-equal. Both forms timed in bf16."""
    B, S, ROOM = 2, 64, 8
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    toks = torch.randint(1, cfg.vocab_size, (B, S), generator=g,
                         device="cuda")
    lengths = torch.tensor([S, 41], dtype=torch.int32, device="cuda")
    out = {"rows": B, "cached": lengths.tolist(), "layers": {},
           "bars": {"float32": "atol 1e-4, rtol 1e-3 elementwise",
                    "bfloat16": MLA_DECODE_BF16_BAR}}
    failures = []
    with torch.inference_mode():
        _, cache = prefill(model, {"tokens": toks}, lengths)
        h0 = torch.randn(B, 1, cfg.d_model, generator=g, device="cuda")
        for i in MLA_DECODE_LAYERS:
            layer = model.layers[i]
            res = {}
            for dt in (torch.float32, torch.bfloat16):
                p = {k: v.to(dt) if v.dim() > 1 else v
                     for k, v in layer.mixer.items()}
                base = {k: F.pad(v, (0, 0, 0, ROOM)).to(dt)
                        for k, v in cache["layers"][i].items()}
                h = h0.to(dt)

                def run(absorbed, p=p, base=base, h=h):
                    return MLA.mla_decode_attention(
                        cfg, p, h, {k: v.clone() for k, v in base.items()},
                        lengths, absorbed=absorbed)
                (ya, ca), (yn, cn) = run(True), run(False)
                d = (ya.float() - yn.float()).abs()
                name = str(dt).split(".")[-1]
                r = {"rel_err": float(d.max() / yn.float().abs().max()),
                     "max_abs_err": float(d.max()),
                     "caches_bit_equal": all(torch.equal(ca[k], cn[k])
                                             for k in ca),
                     "finite": bool(torch.isfinite(ya.float()).all())}
                if dt == torch.float32:
                    r["within"] = bool((d <= 1e-4 + 1e-3 * yn.float().abs())
                                       .all())
                else:
                    r["within"] = r["rel_err"] <= MLA_DECODE_BF16_BAR
                    r["absorbed_ms"] = call_ms(lambda: run(True), iters=10)
                    r["naive_ms"] = call_ms(lambda: run(False), iters=10)
                if not (r["within"] and r["caches_bit_equal"]
                        and r["finite"]):
                    failures.append((i, name))
                res[name] = r
            out["layers"][str(i)] = res
        del cache
    if failures:
        raise AssertionError(f"the absorbed MLA decode disagrees with the "
                             f"naive one at {failures}: {out}")
    return out


def mla_kernels(cfg, model, floor: float) -> dict:
    """K1 at D = 192 on a 512-token prefill's q/k/v (``mla_k1_case``) and
    K2/K3 at MLA's widths, each against its plain version with its times
    and bound."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    tokens = torch.randint(1, cfg.vocab_size, (1, MAX_SEQ), generator=g,
                           device="cuda")
    k1 = mla_k1_case(cfg, model, tokens)
    bf16, m = torch.bfloat16, cfg.mla
    widths = (cfg.d_model, m.q_lora_rank, m.kv_lora_rank)
    out = {"flash_attention": [k1["full"], k1["prompt"]],
           "rmsnorm": [rms_case(bf16, n, False, D=w) for w in widths
                       for n in (MAX_SEQ, MAX_BATCH)],
           "rmsnorm_residual": [rms_case(bf16, n, True, D=cfg.d_model)
                                for n in (MAX_SEQ, MAX_BATCH)]}
    for c in out["rmsnorm"] + out["rmsnorm_residual"]:
        c["floor_ms"] = floor
    return out


def serve_phase(phase: str, cfg, n_params: int, parts, *,
                cpu_layers=tuple(range(MOE_CPU_LAYERS)), cpu_seq: int = 128,
                cpu_len: int = 103, profile_prefills: int = 4,
                reduced: str = "none") -> dict:
    """Phases 12 to 14: ``cfg`` at full width, seed 0, bf16 weights drawn
    leaf by leaf with the ``KEEP_F32`` leaves in f32 (every other matrix
    bf16), so the card never holds the f32 model; each of ``parts`` (name,
    fn(cfg, model)); prefill + 4 decode steps against the full forward
    and ``cpu_layers`` against the CPU's plain path; phase 5's traffic,
    every kernel launched as often as the code says; a profile of
    ``profile_prefills`` prefills and 16 decode steps; the peak under 40
    GB above the phase's start, by part, and the memory given back."""
    before = allocated_bytes()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_serving_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    leaf = {n: n.rsplit(".", 1)[-1] for n in params}
    f32 = sorted({leaf[n] for n, t in params.items()
                  if t.dim() >= 2 and t.dtype == torch.float32})
    out = {"phase": phase, "arch": cfg.name, "card": card(),
           "layers": [s.mixer + "+" + s.ffn for s in cfg.layer_specs],
           "reduced": reduced, "init_s": time.perf_counter() - t0,
           "params": sum(t.numel() for t in params.values()),
           "param_bytes": nbytes(*params.values()),
           "f32_matrices": f32,
           "memory_allocated_at_start_gb": before / 1e9,
           "memory_after_weights_gb": torch.cuda.memory_allocated() / 1e9}
    keep = sorted({leaf[n] for n in params} & set(KEEP_F32))
    if (out["params"] != n_params or f32 != keep or not all(
            t.dtype == torch.bfloat16 for n, t in params.items()
            if t.dim() >= 2 and leaf[n] not in KEEP_F32)):
        raise AssertionError(f"{cfg.name} weights: {out}")
    model = Transformer(cfg, params, device="cuda")
    clock, seconds, peaks = [time.perf_counter()], {}, {}

    def lap(name: str) -> None:
        """The seconds and the peak above the phase's start of the part
        just run, then a fresh peak for the next one."""
        clock.append(time.perf_counter())
        seconds[name] = clock[-1] - clock[-2]
        peaks[name] = (torch.cuda.max_memory_allocated() - before) / 1e9
        torch.cuda.reset_peak_memory_stats()

    for name, fn in parts:
        out[name] = fn(cfg, model)
        lap(name)
    out["consistency"] = full_width_consistency(cfg, params, model, cpu_seq,
                                                cpu_len, cpu_layers)
    lap("consistency")
    del model
    served, engine = serve_traffic(cfg, params)
    out["serve"] = served
    out["cache_bytes"] = nbytes(*(t for c in engine.cache["layers"]
                                  for t in c.values()))
    lap("serve")
    out["profile"] = serve_profile(engine, served, profile_prefills)
    lap("profile")
    out["peak_above_start_gb_by_part"] = peaks
    out["peak_above_start_gb"] = max(peaks.values())
    del engine, params
    out["seconds"] = seconds
    after = allocated_bytes()
    out["memory_allocated_after_gb"] = after / 1e9
    emit(out)
    if out["peak_above_start_gb"] * 1e9 > MOE_PEAK_ABOVE_START_BYTES:
        raise AssertionError(f"{cfg.name} peaked {out['peak_above_start_gb']}"
                             f" GB above the phase's start")
    if abs(after - before) > MEMORY_SLACK_BYTES:
        raise AssertionError(f"allocated memory {before} -> {after} bytes "
                             f"across {phase}")
    return out


def phase_mla_serve(floor: float) -> dict:
    """Phase 12: deepseek-v2-236b at full width, cut to ``MLA_LAYERS``
    layers, the router in f32: K1 at D = 192 and K2/K3 at its widths, the
    absorbed decode against the naive one, then ``serve_phase``'s checks."""
    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    return serve_phase(
        "mla_serve", cfg, MLA_PARAMS,
        [("kernels", lambda c, m: mla_kernels(c, m, floor)),
         ("decode_absorbed_vs_naive", mla_decode_cases)],
        cpu_seq=MLA_CPU_SEQ, cpu_len=MLA_CPU_LEN,
        reduced=f"depth only: {MLA_LAYERS} of "
                f"{get_config(MLA_ARCH).n_layers} layers")


# -- phases 13 and 14 -------------------------------------------------------

XLSTM_ARCH = "xlstm-125m"
# xlstm-125m whole: 12 layers (9 mLSTM, 3 sLSTM) of d_model 768, no FFN,
# the tied embedding of 50,304 rows; 290 MB in bf16
XLSTM_PARAMS = 145_014_600
JAMBA_ARCH = "jamba-1.5-large-398b"
# jamba at full width, cut to layers 2-4 of its 8-layer period, as
# prelayers with no period: Mamba + dense, Mamba + MoE, attention + dense.
# One whole period holds 4 MoE layers of 10.08e9 parameters; this is the
# one 3-layer window with the attention layer and a single MoE layer:
# 12,937,224,192 parameters, 25.87 GB in bf16
JAMBA_LAYERS = slice(2, 5)
JAMBA_PARAMS = 12_937_224_192
# the CPU's layers of the cut: Mamba + dense and attention + dense (its
# dense MoE oracle over 16 experts of 24,576 would take about 2 TFLOP on
# the host at 512 rows), on a short prompt as phase 12's
JAMBA_CPU_LAYERS = (0, 2)
RECURRENT = ("mamba", "mlstm", "slstm")


def jamba_cut(cfg):
    return dataclasses.replace(cfg, prelayers=cfg.period[JAMBA_LAYERS],
                               n_layers=len(cfg.period[JAMBA_LAYERS]))


def mixer_times(cfg, model) -> dict:
    """Each recurrent mixer kind of the model, on its first layer: the
    sequence pass over one 512-token row with its cache (as a prefill runs
    it) and a decode step of ``MAX_BATCH`` rows, bf16, host-paced
    (``call_ms``: these passes launch a few dozen small ops a step, so the
    host's dispatch is their time); outputs and state finite; the state's
    bytes a row."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    out = {}
    for i, (spec, block) in enumerate(zip(cfg.layer_specs, model.layers)):
        if spec.mixer not in RECURRENT or spec.mixer in out:
            continue
        seq, dec, init = MIXERS[spec.mixer]
        x = torch.randn(1, MAX_SEQ, cfg.d_model, generator=g,
                        device="cuda").bfloat16()
        xd = torch.randn(MAX_BATCH, 1, cfg.d_model, generator=g,
                         device="cuda").bfloat16()
        positions = torch.arange(MAX_SEQ, device="cuda")[None, :]
        lengths = torch.tensor([MAX_SEQ - 7], dtype=torch.int32, device="cuda")
        lengths8 = torch.full((MAX_BATCH,), 64, dtype=torch.int32,
                              device="cuda")
        cache = init(cfg, MAX_BATCH, MAX_SEQ, torch.device("cuda"))

        def run_seq(block=block, seq=seq, x=x, positions=positions,
                    lengths=lengths):
            return seq(cfg, block.mixer, x, positions, lengths=lengths,
                       want_cache=True)

        def run_dec(block=block, dec=dec, xd=xd, cache=cache):
            return dec(cfg, block.mixer, xd, cache, lengths8)
        with torch.inference_mode():
            (y, c), (yd, cd) = run_seq(), run_dec()
            finite = all(bool(torch.isfinite(t.float()).all()) for t in
                         (y, yd, *c.values(), *cd.values()))
            out[spec.mixer] = {
                "layer": i, "seq_rows": [1, MAX_SEQ],
                "seq_ms": call_ms(run_seq, iters=3),
                "decode_rows": MAX_BATCH,
                "decode_ms": call_ms(run_dec, iters=20),
                "state": {k: [list(v.shape), str(v.dtype).split(".")[-1]]
                          for k, v in c.items()},
                "state_bytes_a_row": nbytes(*c.values()), "finite": finite}
        if not finite:
            raise AssertionError(f"{cfg.name} {spec.mixer}: {out}")
    return out


def attn_kernels(cfg, model, floor: float) -> dict:
    """K1 on the first attention layer's q, k, v from a 512-token prefill
    (the layers before it run first: jamba's two Mamba layers, whose
    attention has 64 query heads over 8 KV heads and no RoPE, so k and v
    are views of the fused ``wkv`` product; internlm2's layer 0, 16 over
    8 with RoPE), again at a serve prompt's expected length, and K2/K3 at
    rows (512, d_model) and (8, d_model), each against its plain version
    with its times and bound."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    S = MAX_SEQ
    tokens = torch.randint(1, cfg.vocab_size, (1, S), generator=g,
                           device="cuda")
    at = [s.mixer for s in cfg.layer_specs].index("attn")
    with torch.inference_mode():
        x = L.embed_tokens(cfg, model.embed, tokens)
        positions = torch.arange(S, device="cuda")[None, :]
        for block in model.layers[:at]:
            x, _, _ = block(x, positions, None, False)
        layer = model.layers[at]
        h = L.apply_norm(cfg, layer.mixer_norm, x)
        q, k, v = A.project_qkv(cfg, layer.mixer, h, positions)
        k1 = [flash_check(q, k, v, [S]), flash_check(q, k, v, [136],
                                                      timed=False)]
    want = ([1, S, cfg.n_heads, cfg.head_dim],
            [1, S, cfg.n_kv_heads, cfg.head_dim])
    if (k1[0]["q"], k1[0]["kv"]) != want:
        raise AssertionError(f"{cfg.name}'s attention shapes: {k1[0]}")
    bf16 = torch.bfloat16
    out = {"flash_attention": k1,
           "rmsnorm": [rms_case(bf16, n, False, D=cfg.d_model)
                       for n in (MAX_SEQ, MAX_BATCH)],
           "rmsnorm_residual": [rms_case(bf16, n, True, D=cfg.d_model)
                                for n in (MAX_SEQ, MAX_BATCH)]}
    for c in out["rmsnorm"] + out["rmsnorm_residual"]:
        c["floor_ms"] = floor
    return out


def phase_xlstm_serve() -> dict:
    """Phase 13: xlstm-125m whole, its mixers timed. Its prefill runs every
    mLSTM and sLSTM step in turn, a few dozen launches a step over 512
    steps and 12 layers: one traced prefill took about 90 s, so the
    profile takes the decode steps only (the prefill's idle share, 0.849,
    is PERF.md's reading from before the cut)."""
    cfg = get_config(XLSTM_ARCH)
    return serve_phase("xlstm_serve", cfg, XLSTM_PARAMS,
                           [("mixers", mixer_times)],
                           cpu_layers=tuple(range(cfg.n_layers)),
                           profile_prefills=0)


def phase_jamba_serve(floor: float) -> dict:
    """Phase 14: the jamba cut at full width, with K1/K2/K3 at its shapes
    and the Mamba mixer's times."""
    cfg = jamba_cut(get_config(JAMBA_ARCH))
    return serve_phase(
        "jamba_serve", cfg, JAMBA_PARAMS,
        [("kernels", lambda c, m: attn_kernels(c, m, floor)),
         ("mixers", mixer_times)],
        cpu_layers=JAMBA_CPU_LAYERS, cpu_seq=MLA_CPU_SEQ, cpu_len=MLA_CPU_LEN,
        reduced=f"depth only: layers {JAMBA_LAYERS.start}-"
                f"{JAMBA_LAYERS.stop - 1} of the 8-layer period, 3 of "
                f"{get_config(JAMBA_ARCH).n_layers}")


# -- phase 15 --------------------------------------------------------------

PAGED_ARCH = "internlm2-1.8b"
# internlm2-1.8b whole: 24 attention + SwiGLU layers of d_model 2048, 16
# query heads over 8 KV heads of 128, SwiGLU 8192, vocab 92,544; 3.78 GB
# in bf16
PAGED_PARAMS = 1_889_110_016
# each layer's page pool holds exactly MAX_BATCH sequences of MAX_SEQ
# positions, so the pages of a retired sequence are the only free ones
PAGE_SIZE = 64
PAGES_PER_SEQ = MAX_SEQ // PAGE_SIZE
NUM_PAGES = MAX_BATCH * PAGES_PER_SEQ
PAGED_STEPS, PAGED_RETIRE_AT, PAGED_RETIRED = 32, 16, (2, 5)


def padded_batch(rows) -> tuple:
    """(tokens (len(rows), MAX_SEQ), lengths) on the card, each row's
    prompt at its start."""
    toks = torch.zeros(len(rows), MAX_SEQ, dtype=torch.long, device="cuda")
    for i, p in enumerate(rows):
        toks[i, :len(p)] = torch.tensor(p, device="cuda")
    return toks, torch.tensor([len(p) for p in rows], dtype=torch.int32,
                              device="cuda")


def write_prefix(cache: PagedKVCache, seq, k: torch.Tensor, v: torch.Tensor,
                 n: int) -> None:
    """A prefill row's first ``n`` positions of k/v (S, KV, HD) into the
    sequence's pages; the pages' other slots keep what they held."""
    row = torch.from_numpy(cache.tables[seq]).long().cuda()
    pos = torch.arange(n, device="cuda")
    cache.k_pages[row[pos // cache.page_size], pos % cache.page_size] = k[:n]
    cache.v_pages[row[pos // cache.page_size], pos % cache.page_size] = v[:n]


def paged_case(cfg, model) -> dict:
    """The port's ``PagedKVCache`` held to the model's own dense decode.
    Each layer gets a bf16 pool of ``NUM_PAGES`` pages of ``PAGE_SIZE``;
    8 of phase 5's prompts are prefilled at ``MAX_SEQ`` slots and each
    row's valid prefix written into its pages, then ``PAGED_STEPS`` greedy
    decode steps run through ``decode_step``. The model's dense
    ``decode_attention_ref`` is wrapped for each step to take its q, the
    k/v the step wrote (read back from the dense cache) and its output;
    the paged cache appends that k/v and its ``attend`` on that q must
    equal the dense output bit for bit, at every step and layer. After
    step ``PAGED_RETIRE_AT``, the rows at ``PAGED_RETIRED`` retire and two
    new prompts take their pages: their block tables must show the LIFO
    reuse, and their pages' stale tails, masked, must not move the output.
    Then the gather, ``attend`` and the dense attention at this shape,
    timed."""
    prompts = serve_prompts(cfg)
    B, n_layers = MAX_BATCH, cfg.n_layers
    caches = [PagedKVCache(num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                           num_kv_heads=cfg.n_kv_heads,
                           head_dim=cfg.head_dim,
                           pages_per_seq=PAGES_PER_SEQ, dtype=torch.bfloat16,
                           device="cuda") for _ in range(n_layers)]
    seqs = [f"req{i}" for i in range(B)]
    dense_attention = A.decode_attention_ref
    taps = []

    def tap(q, k_cache, v_cache, lengths):
        o = dense_attention(q, k_cache, v_cache, lengths)
        rows = torch.arange(q.shape[0], device=q.device)
        pos = (lengths - 1).long()
        taps.append((q, k_cache[rows, pos], v_cache[rows, pos], lengths, o,
                     k_cache, v_cache))
        return o

    out = {"pool": {"num_pages": NUM_PAGES, "page_size": PAGE_SIZE,
                    "pages_per_seq": PAGES_PER_SEQ, "dtype": "bfloat16",
                    "pool_bytes_a_layer": nbytes(caches[0].k_pages,
                                                 caches[0].v_pages)},
           "steps": PAGED_STEPS, "layers": n_layers,
           "retire_after_step": PAGED_RETIRE_AT,
           "retired_slots": list(PAGED_RETIRED)}
    mismatches, stale = [], 0
    with torch.inference_mode():
        toks, lens = padded_batch(prompts[:B])
        logits, dense = prefill(model, {"tokens": toks}, lens)
        for c, d in zip(caches, dense["layers"]):
            for b, seq in enumerate(seqs):
                c.reserve(seq)
                write_prefix(c, seq, d["k"][b], d["v"][b], len(prompts[b]))
        tables = {s: caches[0].tables[s].tolist() for s in seqs}
        tok = logits.argmax(-1)
        for step in range(PAGED_STEPS):
            if step == PAGED_RETIRE_AT:
                new = prompts[B:B + len(PAGED_RETIRED)]
                retired = [seqs[i] for i in PAGED_RETIRED]
                for c in caches:
                    for seq in retired:
                        c.release(seq)
                admitted = [f"req{B + j}" for j in range(len(new))]
                for c in caches:
                    for seq in admitted:
                        c.reserve(seq)
                for slot, seq in zip(PAGED_RETIRED, admitted):
                    seqs[slot] = seq
                toks2, lens2 = padded_batch(new)
                lg2, d2 = prefill(model, {"tokens": toks2}, lens2)
                slots = torch.tensor(PAGED_RETIRED, device="cuda")
                for d, dn in zip(dense["layers"], d2["layers"]):
                    for k in d:
                        d[k][slots] = dn[k]
                dense["lengths"][slots] = lens2
                tok[slots] = lg2.argmax(-1)
                for c, dn in zip(caches, d2["layers"]):
                    for j, seq in enumerate(admitted):
                        write_prefix(c, seq, dn["k"][j], dn["v"][j],
                                     len(new[j]))
                out["admitted"] = {
                    "lengths": [len(p) for p in new],
                    "tables": {s: caches[0].tables[s].tolist()
                               for s in admitted},
                    # the first sequence admitted takes the pages of the
                    # last one retired, in their order, and so on back
                    "lifo": [caches[0].tables[s].tolist() for s in admitted]
                    == [tables[s] for s in reversed(retired)],
                    "same_in_every_layer": all(
                        {s: c.tables[s].tolist() for s in c.tables}
                        == {s: caches[0].tables[s].tolist()
                            for s in caches[0].tables} for c in caches)}
            taps.clear()
            A.decode_attention_ref = tap
            try:
                logits, dense = decode_step(model, dense, tok)
            finally:
                A.decode_attention_ref = dense_attention
            if len(taps) != n_layers:
                raise AssertionError(f"{len(taps)} dense decode attentions "
                                     f"in a step of {n_layers} layers")
            for i, (c, (q, kn, vn, ln, o, kc, vc)) in enumerate(
                    zip(caches, taps)):
                c.append(seqs, kn, vn, ln - 1)
                got = c.attend(seqs, q, ln)
                if not torch.equal(got, o):
                    mismatches.append({"step": step, "layer": i,
                                       "max_abs_err": max_err(got, o)})
                if step == PAGED_RETIRE_AT:
                    # positions past each row's length where the pages
                    # hold other bytes than the dense cache: masked
                    kp, _ = gather_paged_kv(c.k_pages, c.v_pages,
                                            c.block_tables(seqs))
                    past = (torch.arange(MAX_SEQ, device="cuda")[None, :]
                            >= ln[:, None])
                    stale += int(((kp != kc).flatten(2).any(-1)
                                  & past).sum())
            tok = logits.argmax(-1)
        q, _, _, ln, _, kc, vc = taps[-1]
        c = caches[-1]
        bt = c.block_tables(seqs)
        kp, vp = gather_paged_kv(c.k_pages, c.v_pages, bt)
        gather_bytes = 2 * nbytes(kp, vp)
        out["timed"] = {
            "card": card(),
            "shape": {"B": B, "H": cfg.n_heads, "KV": cfg.n_kv_heads,
                      "HD": cfg.head_dim, "S": MAX_SEQ},
            "layer": n_layers - 1, "lengths": ln.tolist(),
            "gather_bytes": gather_bytes,
            "gather_bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
            "gather_ms": time_ms(lambda: gather_paged_kv(
                c.k_pages, c.v_pages, bt)),
            "attend_ms": time_ms(lambda: paged_decode_attention(
                q, c.k_pages, c.v_pages, bt, ln)),
            "dense_ms": time_ms(lambda: dense_attention(q, kc, vc, ln)),
            "gather_call_ms": call_ms(lambda: gather_paged_kv(
                c.k_pages, c.v_pages, c.block_tables(seqs))),
            "attend_call_ms": call_ms(lambda: c.attend(seqs, q, ln)),
            "dense_call_ms": call_ms(lambda: dense_attention(q, kc, vc, ln))}
        out["dense_cache"] = {"shape": list(kc.shape),
                              "contiguous": kc.is_contiguous(),
                              "gathered_contiguous": kp.is_contiguous()}
    out.update(checks=PAGED_STEPS * n_layers, mismatches=mismatches[:8],
               n_mismatches=len(mismatches), bit_equal=not mismatches,
               initial_tables=tables, stale_positions_masked=stale)
    del caches, taps, dense
    if mismatches or not (out["admitted"]["lifo"]
                          and out["admitted"]["same_in_every_layer"]
                          and stale > 0):
        raise AssertionError(f"paged decode against the dense decode: {out}")
    return out


def phase_paged_serve(floor: float) -> dict:
    """Phase 15: internlm2-1.8b at full width and depth, K1/K2/K3 at its
    shapes, the paged cache held to its dense decode, then
    ``serve_phase``'s checks."""
    return serve_phase(
        "paged_serve", get_config(PAGED_ARCH), PAGED_PARAMS,
        [("kernels", lambda c, m: attn_kernels(c, m, floor)),
         ("paged", paged_case)])


# -- phase 16 --------------------------------------------------------------

def tcloud_specs() -> list:
    """The spec file of phase 16 (b): tacc-100m trained at full width as
    phase 9 trains it, with checkpoints every 10 of its 20 steps, and
    internlm2-1.8b served at full width with phase 5's engine shape."""
    return [
        TaskSpec(name="train-tacc100m-full", tenant="lab-a",
                 resources=ResourceSpec(chips=4),
                 runtime=RuntimeEnv(backend="torch_train",
                                    checkpoint_interval_steps=10),
                 entry={"arch": "tacc-100m", "smoke": False,
                        "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
                        "lr": 3e-4}, total_steps=TRAIN_STEPS,
                 estimated_duration_s=60),
        TaskSpec(name="serve-internlm2-full", tenant="lab-b",
                 resources=ResourceSpec(chips=2, qos="realtime", priority=5),
                 runtime=RuntimeEnv(backend="torch_serve"),
                 entry={"arch": PAGED_ARCH, "smoke": False,
                        "max_batch": MAX_BATCH, "max_seq": MAX_SEQ,
                        "max_new": MAX_NEW}, total_steps=N_REQUESTS,
                 estimated_duration_s=30)]


def run_tcloud(argv) -> tuple:
    """``repro_torch.core.tcloud.main(argv)``: (its standard output, the
    ``TACC`` it drove or None). The CLI makes its service itself, so its
    class is wrapped for the call to keep the instance, whose status,
    logs and runtimes' stats the phase reads."""
    made = []

    class Kept(TC.TACC):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    cls, TC.TACC = TC.TACC, Kept
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = TC.main(argv)
    finally:
        TC.TACC = cls
    if rc != 0:
        raise AssertionError(f"tcloud {argv} returned {rc}")
    return buf.getvalue(), (made[0] if made else None)


def tcloud_jobs(svc) -> dict:
    """name -> (status row, its full log, its runtimes' stats)."""
    rows = {r["name"]: r for r in svc.status()}
    return {j.spec.name: (rows[j.spec.name],
                          "".join(svc.logs(j.id, tail=10_000)),
                          svc.executor.stats.get(j.id, {}))
            for j in svc.jobs.values()}


def phase_tcloud() -> dict:
    """Phase 16: the tcloud CLI on the card, each run in its own temporary
    ``--cluster-root``. (a) ``demo --device cuda``: every job completes,
    with the logs of tests/test_system.py, every kernel launched (the
    backward ones as often as the train job's steps say), and the train
    job's last loss within rel 1e-3 of the same demo run on the CPU in
    this phase. (b) ``hash`` and ``submit --watch`` of ``tcloud_specs``:
    the hashes, both jobs complete, checkpoints at steps 10 and 20, the
    train job's step ms and the serve job's wall and tokens/s, every
    kernel launched. The allocated memory must come back within 100 MB."""
    wrappers = [fn for fn, _, _ in KERNELS] + [fn for _, fn, _, _ in
                                               BWD_KERNELS]
    backward = {name for name, _, _, _ in BWD_KERNELS}
    before = allocated_bytes()
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="chip_smoke_tcloud_")
    out = {"phase": "tcloud", "card": card(),
           "memory_allocated_before_gb": before / 1e9}
    failures = []

    def launched(run: str, train_cfg, train_steps: int) -> dict:
        n = {fn.__name__: fn.launches for fn in wrappers}
        want = expected_train_launches(train_cfg, train_steps)
        for name, k in n.items():
            if k == 0 or (k != want[name] if name in backward
                          else k < want[name]):
                failures.append(f"{run}: {name} launched {k} times; its "
                                f"train job alone launches it {want[name]}")
        return {"launches": n, "expected_train_launches": want}

    try:
        # (a) the demo on the card, then on the CPU
        for fn in wrappers:
            fn.launches = 0
        t0 = time.perf_counter()
        text, svc = run_tcloud(["--cluster-root", os.path.join(root, "a"),
                                "--device", "cuda", "demo"])
        torch.cuda.synchronize()
        demo = {"wall_s": time.perf_counter() - t0}
        demo.update(launched("demo", get_config("tacc-100m", smoke=True),
                             40))
        jobs = tcloud_jobs(svc)
        del svc
        t0 = time.perf_counter()
        _, cpu_svc = run_tcloud(["--cluster-root", os.path.join(root, "cpu"),
                                 "--device", "cpu", "demo"])
        demo["cpu_wall_s"] = time.perf_counter() - t0
        cpu_jobs = tcloud_jobs(cpu_svc)
        del cpu_svc
        demo["status"] = [jobs[n][0] for n in jobs]
        want = {"train-tacc100m": ("40/40", "checkpoint"),
                "serve-internlm2": ("4/4", "served"),
                "hello-shell": ("1/1", "hello from TACC")}
        for name, (progress, needle) in want.items():
            row, log, _ = jobs[name]
            if (row["state"], row["progress"]) != ("COMPLETED", progress) \
                    or needle not in log:
                failures.append(f"demo {name}: {row}, {needle!r} "
                                f"{'in' if needle in log else 'not in'} "
                                f"its log")
                for block in _error_blocks(log):
                    print(block, file=sys.stderr, flush=True)
            if cpu_jobs[name][0]["state"] != "COMPLETED":
                failures.append(f"demo on the CPU {name}: "
                                f"{cpu_jobs[name][0]}")
        losses = [[q["loss"] for q in j["train-tacc100m"][2].get("quanta",
                                                                  [])]
                  for j in (jobs, cpu_jobs)]
        demo.update(losses=losses[0], cpu_losses=losses[1])
        if losses[0] and losses[1]:
            demo["last_loss_rel"] = (abs(losses[0][-1] - losses[1][-1])
                                     / abs(losses[1][-1]))
        if not demo.get("last_loss_rel", 1.0) <= 1e-3:
            failures.append(f"demo's last loss {losses[0][-1:]} on the card,"
                            f" {losses[1][-1:]} on the CPU (bar rel 1e-3)")
        demo["shell_log"] = jobs["hello-shell"][1].strip().splitlines()[-1]
        demo["stdout_lines"] = len(text.splitlines())
        out["demo"] = demo

        # (b) a spec file at full width: hash, then submit --watch
        path = os.path.join(root, "specs.json")
        specs = tcloud_specs()
        with open(path, "w") as f:
            json.dump([s.to_dict() for s in specs], f)
        text, _ = run_tcloud(["hash", path])
        hashes = [ln.split() for ln in text.splitlines()]
        sub = {"hash": hashes}
        if hashes != [[s.spec_hash(), s.name] for s in specs]:
            failures.append(f"hash printed {hashes}")
        for fn in wrappers:
            fn.launches = 0
        t0 = time.perf_counter()
        text, svc = run_tcloud(["--cluster-root", os.path.join(root, "b"),
                                "--device", "cuda", "submit", path,
                                "--watch"])
        torch.cuda.synchronize()
        sub["wall_s"] = time.perf_counter() - t0
        sub.update(launched("submit", get_config("tacc-100m"), TRAIN_STEPS))
        jobs = tcloud_jobs(svc)
        sub["ticks"] = svc.ticks
        del svc
        sub["status"] = [jobs[n][0] for n in jobs]
        train, serve = (jobs[s.name] for s in specs)
        saves = train[2].get("saves", [])
        quanta = train[2].get("quanta", [])
        served = serve[2].get("quanta", [])
        wall = sum(q["seconds"] for q in served)
        tokens = sum(q["tokens"] for q in served)
        sub.update(
            train_step_ms=[q["step_ms"] for q in quanta],
            train_losses=[q["loss"] for q in quanta],
            saves=len(saves), saved_steps=sorted({x["step"] for x in saves}),
            save_s_total=sum(x["snapshot_s"] + x["write_s"] for x in saves),
            checkpoint_bytes=saves[-1]["bytes"] if saves else None,
            serve_requests=sum(q["requests"] for q in served),
            serve_tokens=tokens, serve_wall_s=wall,
            serve_tokens_per_s=tokens / wall if wall else None)
        for spec, (row, log, _) in zip(specs, (train, serve)):
            if (row["state"], row["progress"]) != (
                    "COMPLETED", f"{spec.total_steps}/{spec.total_steps}"):
                failures.append(f"submit {spec.name}: {row}")
                for block in _error_blocks(log):
                    print(block, file=sys.stderr, flush=True)
        # a save every 10 steps; the completed job saves once more, at its
        # last step, as the reference's runtime does
        if sub["saved_steps"] != [10, 20]:
            failures.append(f"train job saved at {sub['saved_steps']}")
        if sub["serve_tokens"] != N_REQUESTS * MAX_NEW:
            failures.append(f"serve job generated {tokens} tokens")
        out["submit"] = sub
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    after = allocated_bytes()
    out["memory_allocated_after_gb"] = after / 1e9
    if abs(after - before) > MEMORY_SLACK_BYTES:
        failures.append(f"allocated memory {before} -> {after} bytes "
                        f"across phase 16")
    out["failures"] = failures
    emit(out)
    if failures:
        raise AssertionError(f"tcloud phase failed: {failures}")
    return out


# -- phase 17 --------------------------------------------------------------

# 4 ranks on one card: NCCL refuses two ranks on one device, so the ranks
# talk over gloo and the collectives stage each buffer through the host
MESH = ((1, 4), ("data", "model"))
MESH_BACKEND = "gloo"
MESH_TIMEOUT_S = 300
# the reference checks' capacity factor, at which no assignment drops
# (tests/distributed_checks.py:38-40); the traffic also runs at the
# config's own 1.25
MESH_CAPACITY = 8.0
# teacher-forced rows: every rank's 128 of the 512 positions hold valid
# keys of some row, so zeroing any one rank's shard moves the logits
MESH_TF_LENGTHS = (480, 352, 224, 96)
MESH_TF_STEPS = 32
MESH_BARS = {"prefill": 0.05, "decode": 0.08}
# deepseek-v2 at full width cut to layers 0-1: the dense MLA prelayer and
# one MLA + MoE layer of 160 experts, 40 a rank
MESH_MLA_LAYERS = 2
MESH_MLA_TF_LENGTHS = (480, 224)
MESH_MLA_TF_STEPS = 8
# the mesh engines' traffic: phase 5's first 4 prompts, 8 new tokens each
# (all 16 with 32 new took about 90 s of host-bound decode steps at
# qwen2-moe's two capacity factors)
MESH_PROMPTS, MESH_NEW = 4, 8
# the recurrent cuts served with d_inner over model (phase 17 (e)): each
# rank's Mamba conv/ssm and mLSTM conv a quarter of d_inner
MESH_REC_TF_STEPS = 8


def jamba_layer0(cfg):
    """jamba's layer 0 alone (Mamba + dense FFN), as a prelayer."""
    return dataclasses.replace(cfg, prelayers=cfg.period[:1], n_layers=1)


def xlstm_period(cfg):
    """xlstm-125m's first period: 3 mLSTM and 1 sLSTM layers."""
    return dataclasses.replace(cfg, n_layers=len(cfg.period))


def mesh_rec_cfgs() -> list:
    """(name, config) of phase 17 (e): jamba's layer 0 and xlstm-125m's
    first period at full width."""
    return [("jamba", jamba_layer0(get_config(JAMBA_ARCH))),
            ("xlstm", xlstm_period(get_config(XLSTM_ARCH)))]


def mesh_prompts(cfg) -> list:
    return serve_prompts(cfg)[:MESH_PROMPTS]


def mesh_cfgs():
    """(qwen2-moe-a2.7b whole, deepseek-v2-236b cut to its first
    ``MESH_MLA_LAYERS`` layers)."""
    return (get_config(MOE_ARCH), dataclasses.replace(
        get_config(MLA_ARCH), n_layers=MESH_MLA_LAYERS))


def with_capacity(cfg, cf: float):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def tf_inputs(cfg, lengths, steps: int):
    """Teacher-forced rows: prompts of ``lengths`` tokens padded to
    ``MAX_SEQ`` and the token fed at each of ``steps`` decode steps, from
    one seed, so every process draws the same."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    toks = torch.randint(1, cfg.vocab_size, (len(lengths), MAX_SEQ),
                         generator=g, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    toks = toks * (torch.arange(MAX_SEQ, device="cuda")[None]
                   < lens[:, None])
    feed = torch.randint(1, cfg.vocab_size, (steps, len(lengths)),
                         generator=g, device="cuda")
    return toks, lens, feed


def mesh_reference(path: str) -> dict:
    """Phase 17 (a): each model whole in this one process, its
    teacher-forced logits (a prefill and each fed decode step) and, for
    qwen2-moe, phase 5's traffic's greedy tokens, saved to ``path``; the
    memory given back before the ranks start."""
    qcfg, dcfg = mesh_cfgs()
    ref, out = {}, {}
    for name, cfg, lengths, steps in (
            ("moe", qcfg, MESH_TF_LENGTHS, MESH_TF_STEPS),
            ("mla", dcfg, MESH_MLA_TF_LENGTHS, MESH_MLA_TF_STEPS),
            *((f"rec_{n}", c, MESH_TF_LENGTHS, MESH_REC_TF_STEPS)
              for n, c in mesh_rec_cfgs())):
        t0 = time.perf_counter()
        params = init_serving_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        model = Transformer(cfg, params, device="cuda")
        toks, lens, feed = tf_inputs(cfg, lengths, steps)
        with torch.inference_mode():
            lg, cache = prefill(model, {"tokens": toks}, lens)
            logits = [lg.float().cpu()]
            for f in feed:
                lg, cache = decode_step(model, cache, f)
                logits.append(lg.float().cpu())
        ref[name] = torch.stack(logits)
        del model, cache, lg
        out[name] = {"params": sum(t.numel() for t in params.values()),
                     "param_bytes": nbytes(*params.values())}
        if name != "mla":
            engine = ServeEngine(cfg, params, max_batch=MAX_BATCH,
                                 max_seq=MAX_SEQ, seed=SEED, device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            results = engine.run(mesh_prompts(cfg), max_new=MESH_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            ref[f"{name}_tokens"] = [r.tokens for r in results]
            out[name].update(
                tokens_per_s=sum(len(r.tokens) for r in results) / wall,
                prefill_ms_mean=1e3 * float(np.mean(
                    engine.timings["prefill"])),
                decode_step_ms_mean=1e3 * float(np.mean(
                    engine.timings["decode"])))
            del engine
        del params
        out[name]["seconds"] = time.perf_counter() - t0
    torch.save(ref, path)
    return out


def serve_stepwise(engine, prompts) -> tuple:
    """``engine.run(prompts, max_new=MESH_NEW)``, admission and decode in
    the same order, with the collectives counted around each prefill and
    each decode step: (results, per prefill, per decode step)."""
    queue, results, pre, steps = list(prompts), [], [], []
    while queue or engine.active():
        while queue:
            COLL.reset_stats()
            r = engine.add_request(queue[0], max_new=MESH_NEW)
            if r is None:
                break
            pre.append(dict(COLL.STATS))
            results.append(r)
            queue.pop(0)
        if engine.active():
            COLL.reset_stats()
            engine.step()
            steps.append(dict(COLL.STATS))
    return results, pre, steps


def _mean_stats(rows) -> dict:
    """Each count of ``rows`` (copies of ``collectives.STATS``) averaged,
    and ``by_kind``'s kind by kind."""
    out = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]
           if k != "by_kind"}
    kinds = sorted({kind for r in rows for kind in r["by_kind"]})
    out["by_kind"] = {kind: {f: float(np.mean([
        r["by_kind"].get(kind, {}).get(f, 0) for r in rows]))
        for f in ("count", "bytes", "interpod_bytes")} for kind in kinds}
    return out


def _shard_cache(cache, specs, mesh) -> dict:
    return {"layers": [{k: local_shard(t, sp[k], mesh) for k, t in c.items()}
                       for c, sp in zip(cache["layers"], specs)],
            "lengths": cache["lengths"]}


def mesh_moe(mesh, ref) -> dict:
    """Phase 17 (b) and (c) on one rank: qwen2-moe-a2.7b drawn as this
    rank's shard; teacher-forced logits at ``MESH_CAPACITY``; each rank's
    cache shard zeroed in turn before the first decode step; phase 5's
    traffic at ``MESH_CAPACITY`` and at the config's own factor."""
    cfg, _ = mesh_cfgs()
    rank = mesh.rank
    b, s = decode_plan(cfg, ShapeConfig("mesh_serve", MAX_SEQ, MAX_BATCH,
                                        "decode"), mesh)
    flags = RunFlags(distributed=True, token_axes=b, decode_seq_axes=s)
    specs = cache_specs(cfg, b, s)["layers"]
    plan = serving_plan(cfg, mesh, flags.ep_axis)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_serving_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda",
        shard=(mesh, plan))
    torch.cuda.synchronize()
    out = {"plan": {"batch_axes": list(b), "seq_axes": list(s)},
           "init_s": time.perf_counter() - t0,
           "params_held": sum(t.numel() for t in params.values()),
           "param_bytes": nbytes(*params.values()),
           "experts": [list(params[k].shape) for k in
                       ("layers.0.ffn.w_in", "layers.0.ffn.w_out")]}
    full = with_capacity(cfg, MESH_CAPACITY)
    model = Transformer(full, params, device="cuda")
    toks, lens, feed = tf_inputs(cfg, MESH_TF_LENGTHS, MESH_TF_STEPS)
    with torch.inference_mode():
        lg, whole = prefill(model, {"tokens": toks}, lens, flags=flags,
                            mesh=mesh)
        cache = _shard_cache(whole, specs, mesh)
        del whole
        out["cache_shard"] = list(cache["layers"][0]["k"].shape)
        base = {"layers": [{k: t.clone() for k, t in c.items()}
                           for c in cache["layers"]],
                "lengths": cache["lengths"]}
        errs = [rel_err(lg, ref["moe"][0])]
        MOE.moe_ep.dropped = 0
        for i, f in enumerate(feed):
            COLL.reset_stats()
            lg, cache = decode_step(model, cache, f, flags=flags, mesh=mesh)
            if i == 0:
                out["tf_decode_step_collectives"] = dict(COLL.STATS)
            errs.append(rel_err(lg, ref["moe"][i + 1]))
        out["tf"] = {"rows": len(MESH_TF_LENGTHS), "steps": MESH_TF_STEPS,
                     "prefill_vs_single": errs[0],
                     "decode_vs_single": errs[1:],
                     "dropped": int(MOE.moe_ep.dropped)}
        del cache
        out["fault"] = []
        for victim in range(mesh.size(s)):
            c = {"layers": [{k: t.clone() for k, t in layer.items()}
                            for layer in base["layers"]],
                 "lengths": base["lengths"]}
            if mesh.axis_index(s) == victim:
                for layer in c["layers"]:
                    for t in layer.values():
                        t.zero_()
            lg, c = decode_step(model, c, feed[0], flags=flags, mesh=mesh)
            out["fault"].append(rel_err(lg, ref["moe"][1]))
            del c
        del base, model
    prompts = mesh_prompts(cfg)
    out["traffic"] = {}
    for tag, c in (("capacity_8", full), ("capacity_1.25", cfg)):
        engine = ServeEngine(c, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                             seed=SEED, device="cuda", flags=flags, mesh=mesh)
        for fn, _, _ in KERNELS:
            fn.launches = 0
        MOE.moe_ep.dropped = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        results, pre, steps = serve_stepwise(engine, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        out["traffic"][tag] = dict(
            mesh_traffic_numbers(engine, results, pre, steps, wall, cfg,
                                 ref["moe_tokens"]),
            capacity_factor=c.moe.capacity_factor,
            dropped=int(MOE.moe_ep.dropped))
        del engine
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    return out


def mesh_traffic_numbers(engine, results, pre, steps, wall: float, cfg,
                         single_tokens) -> dict:
    """One mesh engine's traffic: requests, tokens, host-clock times, the
    kernels' launches against the code's counts, the tokens that part
    from the single process's, and the collectives a prefill and a decode
    step."""
    tokens = [r.tokens for r in results]
    pf, dc = engine.timings["prefill"], engine.timings["decode"]
    n_tok = sum(len(t) for t in tokens)
    return {"requests": len(results), "tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall, "prefills": len(pf),
            "prefill_ms_mean": 1e3 * float(np.mean(pf)),
            "decode_steps": len(dc),
            "decode_step_ms_mean": 1e3 * float(np.mean(dc)),
            "decode_step_ms_p50": 1e3 * float(np.median(dc)),
            "launches": {fn.__name__: fn.launches for fn, _, _ in KERNELS},
            "expected_launches": serve_launches(cfg, len(pf), len(dc)),
            "tokens_parting_from_single": sum(
                a != b for x, y in zip(tokens, single_tokens)
                for a, b in zip(x, y)),
            "per_prefill": _mean_stats(pre),
            "per_decode_step": _mean_stats(steps),
            "tokens_list": tokens}


def mesh_mla(mesh, ref) -> dict:
    """Phase 17 (d) on one rank: deepseek-v2 cut to ``MESH_MLA_LAYERS``
    layers, this rank's 40 of 160 experts and 128 of 512 latent positions:
    the sequence-sharded absorbed MLA decode of layer 0 against the
    whole-cache absorbed decode on the same input (phase 12's bars), and
    teacher-forced logits against the single process."""
    _, cfg = mesh_cfgs()
    b, s = decode_plan(cfg, ShapeConfig("mesh_serve", MAX_SEQ, MAX_BATCH,
                                        "decode"), mesh)
    flags = RunFlags(distributed=True, token_axes=b, decode_seq_axes=s)
    specs = cache_specs(cfg, b, s)["layers"]
    torch.cuda.reset_peak_memory_stats()
    params = init_serving_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda",
        shard=(mesh, serving_plan(cfg, mesh, flags.ep_axis)))
    out = {"params_held": sum(t.numel() for t in params.values()),
           "experts": list(params["layers.1.ffn.w_in"].shape)}
    model = Transformer(with_capacity(cfg, MESH_CAPACITY), params,
                        device="cuda")
    toks, lens, feed = tf_inputs(cfg, MESH_MLA_TF_LENGTHS, MESH_MLA_TF_STEPS)
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    h0 = torch.randn(len(lens), 1, cfg.d_model, generator=g, device="cuda")
    with torch.inference_mode():
        lg, whole = prefill(model, {"tokens": toks}, lens, flags=flags,
                            mesh=mesh)
        errs = [rel_err(lg, ref["mla"][0])]
        layer = model.layers[0]
        out["layer0"] = {}
        for dt in (torch.float32, torch.bfloat16):
            p = {k: v.to(dt) if v.dim() > 1 else v
                 for k, v in layer.mixer.items()}
            wc = {k: v.to(dt) for k, v in whole["layers"][0].items()}
            lc = {k: local_shard(v, specs[0][k], mesh).clone()
                  for k, v in wc.items()}
            y_whole, wc = MLA.mla_decode_attention(
                cfg, p, h0.to(dt), {k: v.clone() for k, v in wc.items()},
                lens)
            y_shard, lc = MLA.mla_decode_attention(
                cfg, p, h0.to(dt), lc, lens, seq_axes=flags.decode_seq_axes,
                batch_axes=flags.token_axes, mesh=mesh)
            d = (y_shard.float() - y_whole.float()).abs()
            r = {"max_abs_err": float(d.max()),
                 "rel_err": float(d.max() / y_whole.float().abs().max()),
                 "cache_shard_bit_equal": all(
                     torch.equal(lc[k], local_shard(wc[k], specs[0][k], mesh))
                     for k in lc)}
            r["within"] = (bool((d <= 1e-4 + 1e-3 * y_whole.float().abs())
                                .all()) if dt == torch.float32
                           else r["rel_err"] <= MLA_DECODE_BF16_BAR)
            out["layer0"][str(dt).split(".")[-1]] = r
        cache = _shard_cache(whole, specs, mesh)
        out["cache_shard"] = list(cache["layers"][0]["ckv"].shape)
        del whole
        for i, f in enumerate(feed):
            lg, cache = decode_step(model, cache, f, flags=flags, mesh=mesh)
            errs.append(rel_err(lg, ref["mla"][i + 1]))
        del cache, model
    out["tf"] = {"rows": len(MESH_MLA_TF_LENGTHS),
                 "steps": MESH_MLA_TF_STEPS, "prefill_vs_single": errs[0],
                 "decode_vs_single": errs[1:]}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    return out


def mesh_recurrent(mesh, ref) -> dict:
    """Phase 17 (e) on one rank: jamba's layer 0 and xlstm-125m's first
    period, whole weights (the mixers cut their d_inner block at first
    use), each rank's Mamba conv/ssm and mLSTM conv a quarter of d_inner:
    teacher-forced logits against the single process; for jamba each
    rank's ssm shard zeroed in turn before the first decode step; the
    traffic (``MESH_PROMPTS`` prompts, ``MESH_NEW`` new tokens)."""
    out = {}
    for name, cfg in mesh_rec_cfgs():
        b, s = decode_plan(cfg, ShapeConfig("mesh_serve", MAX_SEQ, MAX_BATCH,
                                            "decode"), mesh)
        flags = RunFlags(distributed=True, token_axes=b, decode_seq_axes=s)
        specs = cache_specs(cfg, b, s)["layers"]
        torch.cuda.reset_peak_memory_stats()
        params = init_serving_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda",
            shard=(mesh, serving_plan(cfg, mesh, flags.ep_axis)))
        model = Transformer(cfg, params, device="cuda")
        toks, lens, feed = tf_inputs(cfg, MESH_TF_LENGTHS, MESH_REC_TF_STEPS)
        rec, key = {"params_held": sum(t.numel() for t in params.values())}, \
            f"rec_{name}"
        with torch.inference_mode():
            lg, whole = prefill(model, {"tokens": toks}, lens, flags=flags,
                                mesh=mesh)
            errs = [rel_err(lg, ref[key][0])]
            cache = _shard_cache(whole, specs, mesh)
            del whole
            rec["state_shards"] = {
                f"{i}.{k}": list(t.shape)
                for i, c in enumerate(cache["layers"]) for k, t in c.items()
                if "model" in specs[i][k]}
            base = {"layers": [{k: t.clone() for k, t in c.items()}
                               for c in cache["layers"]],
                    "lengths": cache["lengths"]}
            for i, f in enumerate(feed):
                lg, cache = decode_step(model, cache, f, flags=flags,
                                        mesh=mesh)
                errs.append(rel_err(lg, ref[key][i + 1]))
            rec["tf"] = {"rows": len(MESH_TF_LENGTHS),
                         "steps": MESH_REC_TF_STEPS,
                         "prefill_vs_single": errs[0],
                         "decode_vs_single": errs[1:]}
            del cache
            # each rank's state shards zeroed in turn: every d_inner block
            # (``fault``), and Mamba's ssm alone (``fault_ssm``)
            rec["fault"], rec["fault_ssm"] = [], []
            split = [[k for k in spec if "model" in spec[k]]
                     for spec in specs]
            for tag, names in (("fault", None), ("fault_ssm", ("ssm",))):
                if names and not any("ssm" in keys for keys in split):
                    continue
                for victim in range(mesh.size(("model",))):
                    c = {"layers": [{k: t.clone() for k, t in layer.items()}
                                    for layer in base["layers"]],
                         "lengths": base["lengths"]}
                    if mesh.axis_index(("model",)) == victim:
                        for layer, keys in zip(c["layers"], split):
                            for k in keys:
                                if names is None or k in names:
                                    layer[k].zero_()
                    lg, c = decode_step(model, c, feed[0], flags=flags,
                                        mesh=mesh)
                    rec[tag].append(rel_err(lg, ref[key][1]))
                    del c
            del base
        engine = ServeEngine(cfg, params, max_batch=MAX_BATCH,
                             max_seq=MAX_SEQ, seed=SEED, device="cuda",
                             flags=flags, mesh=mesh)
        for fn, _, _ in KERNELS:
            fn.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        results, pre, steps = serve_stepwise(engine, mesh_prompts(cfg))
        torch.cuda.synchronize()
        rec["traffic"] = mesh_traffic_numbers(
            engine, results, pre, steps, time.perf_counter() - t1, cfg,
            ref[f"{key}_tokens"])
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del engine, model, params
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = rec
    return out


def gloo_on_cuda() -> dict:
    """Whether gloo itself takes ``all_to_all`` and ``all_gather`` on CUDA
    tensors (the collectives stage through the host regardless)."""
    out = {}
    x = torch.arange(4.0, device="cuda")
    for name, call in (
            ("all_to_all", lambda: dist.all_to_all_single(
                torch.empty_like(x), x)),
            ("all_gather", lambda: dist.all_gather_into_tensor(
                torch.empty(4 * x.numel(), device="cuda"), x))):
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:          # recorded, not raised: a probe
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return out


def mesh_rank(rank: int, world: int, store: str, work: str) -> None:
    """One rank of phase 17, a process of its own on the one card; writes
    its results to ``work``/rank<r>.json. A rank that raises makes the
    spawn, and so the phase, fail."""
    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, os.cpu_count() // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        MESH_BACKEND, init_method=f"file://{store}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_mesh(*MESH)
        ref = torch.load(os.path.join(work, "ref.pt"))
        t0 = time.perf_counter()
        out = {"rank": rank, "coords": mesh.coords, "moe": mesh_moe(mesh, ref)}
        gc.collect()
        torch.cuda.empty_cache()
        out["mla"] = mesh_mla(mesh, ref)
        gc.collect()
        torch.cuda.empty_cache()
        out["recurrent"] = mesh_recurrent(mesh, ref)
        out["seconds"] = time.perf_counter() - t0
        out["gloo_on_cuda"] = gloo_on_cuda()
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def mesh_failures(ranks: list) -> list:
    """Every bar of phase 17 over every rank's results."""
    qcfg, dcfg = mesh_cfgs()
    n = len(ranks)
    E, E_d = MOE.padded_experts(qcfg.moe), dcfg.moe.n_experts
    fails = []

    def need(ok, what):
        if not ok:
            fails.append(what)
    tokens = [r["moe"]["traffic"]["capacity_8"]["tokens_list"] for r in ranks]
    need(all(t == tokens[0] for t in tokens), "ranks picked other tokens")
    rec = mesh_rec_cfgs()
    for name, cfg in rec:
        tokens = [r["recurrent"][name]["traffic"]["tokens_list"]
                  for r in ranks]
        need(all(t == tokens[0] for t in tokens),
             f"{name}: ranks picked other tokens")
    for r in ranks:
        m, d, tag = r["moe"], r["mla"], f"rank {r['rank']}"
        need(m["experts"][0][0] == E // n and m["experts"][1][0] == E // n,
             f"{tag} holds {m['experts']} experts")
        need(m["cache_shard"][1] == MAX_SEQ // n,
             f"{tag} cache shard {m['cache_shard']}")
        need(m["tf"]["prefill_vs_single"] < MESH_BARS["prefill"]
             and max(m["tf"]["decode_vs_single"]) < MESH_BARS["decode"],
             f"{tag} teacher-forced logits off the single process")
        need(m["tf"]["dropped"] == 0, f"{tag} dropped at capacity 8")
        need(all(e > MESH_BARS["decode"] for e in m["fault"]),
             f"{tag}: a zeroed shard stayed within the bar {m['fault']}")
        traffic = dict(m["traffic"], **{
            name: r["recurrent"][name]["traffic"] for name, _ in rec})
        for tag2, t in traffic.items():
            need(t["launches"] == t["expected_launches"]
                 and any(v > 0 for v in t["launches"].values()),
                 f"{tag} {tag2} launched {t['launches']}")
            need(t["requests"] == MESH_PROMPTS
                 and t["tokens"] == MESH_PROMPTS * MESH_NEW,
                 f"{tag} {tag2} served {t['requests']} / {t['tokens']}")
        for name, cfg in rec:
            e = r["recurrent"][name]
            need(e["tf"]["prefill_vs_single"] < MESH_BARS["prefill"]
                 and max(e["tf"]["decode_vs_single"]) < MESH_BARS["decode"],
                 f"{tag} {name} teacher-forced logits off the single "
                 f"process")
            quarter = {"mamba": lambda: mamba_dims(cfg)[0] // n,
                       "mlstm": lambda: mlstm_dims(cfg)[0] // n}
            need(e["state_shards"] and all(
                quarter[cfg.layer_specs[int(k.split(".")[0])].mixer]()
                in shape for k, shape in e["state_shards"].items()),
                f"{tag} {name} state shards {e['state_shards']}")
            need(len(e["fault"]) == n
                 and all(f > MESH_BARS["decode"] for f in e["fault"]),
                 f"{tag} {name}: a zeroed state shard stayed within the bar "
                 f"{e['fault']}")
        need(m["traffic"]["capacity_8"]["dropped"] == 0,
             f"{tag} dropped at capacity 8")
        need(d["experts"][0] == E_d // n and d["cache_shard"][1]
             == MAX_SEQ // n, f"{tag} deepseek shards {d['experts']}, "
             f"{d['cache_shard']}")
        need(all(v["within"] and v["cache_shard_bit_equal"]
                 for v in d["layer0"].values()),
             f"{tag} sharded MLA decode {d['layer0']}")
        need(d["tf"]["prefill_vs_single"] < MESH_BARS["prefill"]
             and max(d["tf"]["decode_vs_single"]) < MESH_BARS["decode"],
             f"{tag} deepseek teacher-forced logits off the single process")
    return fails


def phase_mesh_serve() -> dict:
    """Phase 17: (a) the single-process reference, saved and freed; (b)
    to (d) in 4 ranks on the one card over gloo (``mesh_rank``); every
    bar checked over every rank's results."""
    before = allocated_bytes()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="mesh_serve_")
    t0 = time.perf_counter()
    try:
        single = mesh_reference(os.path.join(work, "ref.pt"))
        t_ref = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        world = math.prod(MESH[0])
        mp.spawn(mesh_rank, args=(world, os.path.join(work, "store"), work),
                 nprocs=world, join=True)
        ranks = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    qcfg, _ = mesh_cfgs()
    fails = mesh_failures(ranks)
    r0 = ranks[0]["moe"]["traffic"]
    out = {"phase": "mesh_serve", "card": card(),
           "mesh": dict(zip(*reversed(MESH))), "backend": MESH_BACKEND,
           "interconnect": "none: 4 processes share one card over gloo, "
                           "every collective staged through the host; "
                           "NCCL and NVLink times not measured",
           "single_process": single,
           "traffic": {"prompts": MESH_PROMPTS, "new_tokens": MESH_NEW},
           "rank0": {tag: {k: t[k] for k in (
               "prefill_ms_mean", "decode_step_ms_mean",
               "decode_step_ms_p50", "tokens_per_s", "wall_s")}
               for tag, t in dict(r0, **{
                   f"recurrent_{n}": ranks[0]["recurrent"][n]["traffic"]
                   for n, _ in mesh_rec_cfgs()}).items()},
           "ranks": [{
               "rank": r["rank"], "seconds": r["seconds"],
               "peak_gb": {"moe": r["moe"]["peak_gb"],
                           "mla": r["mla"]["peak_gb"]},
               "shards": {"experts": r["moe"]["experts"],
                          "kv_cache": r["moe"]["cache_shard"],
                          "mla_experts": r["mla"]["experts"],
                          "latent_cache": r["mla"]["cache_shard"]},
               "params_held": r["moe"]["params_held"],
               "param_bytes": r["moe"]["param_bytes"],
               "init_s": r["moe"]["init_s"],
               "per_decode_step": r["moe"]["traffic"]["capacity_8"][
                   "per_decode_step"],
               "per_prefill": r["moe"]["traffic"]["capacity_8"][
                   "per_prefill"],
               "tf": r["moe"]["tf"], "fault": r["moe"]["fault"],
               "traffic": {tag: {k: v for k, v in t.items()
                                 if k != "tokens_list"}
                           for tag, t in r["moe"]["traffic"].items()},
               "mla": {k: r["mla"][k] for k in ("tf", "layer0")},
               "recurrent": {n: {k: ({a: b for a, b in v.items()
                                      if a != "tokens_list"}
                                     if k == "traffic" else v)
                                 for k, v in e.items()}
                             for n, e in r["recurrent"].items()},
               "gloo_on_cuda": r["gloo_on_cuda"]} for r in ranks],
           "launches": {fn.__name__: sum(
               r["moe"]["traffic"]["capacity_8"]["launches"][fn.__name__]
               for r in ranks) for fn, _, _ in KERNELS},
           "recurrent": {n: {"arch": c.name, "layers": [
               sp.mixer + "+" + sp.ffn for sp in c.layer_specs]}
               for n, c in mesh_rec_cfgs()},
           "bars": dict(MESH_BARS, mla_layer0={
               "float32": "atol 1e-4, rtol 1e-3 elementwise",
               "bfloat16": MLA_DECODE_BF16_BAR},
               fault=f"each zeroed shard above {MESH_BARS['decode']}"),
           "reference_s": t_ref, "seconds": time.perf_counter() - t0,
           "failures": fails}
    after = allocated_bytes()
    out["memory_allocated_after_gb"] = after / 1e9
    emit(out)
    if fails:
        raise AssertionError(f"mesh_serve phase failed: {fails}")
    if abs(after - before) > MEMORY_SLACK_BYTES:
        raise AssertionError(f"allocated memory {before} -> {after} bytes "
                             f"across phase 17")
    return out


# -- phase 18 --------------------------------------------------------------

# 4 ranks on one card over gloo, as phase 17's, training: FSDP over data,
# tensor parallelism over model
MESH_TRAIN = ((2, 2), ("data", "model"))
MESH_TRAIN_STEPS = 6
# qwen2-moe-a2.7b at full width cut to layers 0-1 (1.83e9 parameters: its
# AdamW state does not fit one card whole at 24 layers), 3 steps of 8 rows
MESH_TRAIN_MOE_LAYERS, MESH_TRAIN_MOE_STEPS, MESH_TRAIN_MOE_BATCH = 2, 3, 8
# the mixers with tensor parallelism since ROADMAP item 15c, at full width:
# deepseek-v2's layer 0 (MLA + dense FFN, 1.386e9 parameters), jamba's
# layer 0 (Mamba + dense FFN, 2.098e9) and xlstm-125m's first period (3
# mLSTM + 1 sLSTM), 3 steps of 8 rows each
MESH_TRAIN_TP_STEPS, MESH_TRAIN_TP_BATCH = 3, 8
# the cases of one spawn of the ranks, after their reference: each saved
# state lies on the temporary disk only while its group runs (the first
# group's about 34 GB, jamba's 25 GB; 80 GB were free on the H100's host)
MESH_TRAIN_GROUPS = (("dense", "moe", "mla", "xlstm"), ("mamba",))
# phase 8's bars for the loss, the grad norm and each leaf's gradient
MESH_TRAIN_BARS = {"loss_rel": 1e-3, "grad_norm_rel": 1e-3,
                   "min_cosine": 0.999}
# the params' bar, a case's: every leaf's move from the seed's state over
# the steps at this cosine or more to the single process's move
# (mesh_move_parts). Set from the sound and faulted runs on the H100
# (PERF.md §6): tacc-100m's least leaf 0.9859 (embed.tok), its faulted runs
# 0.8555-0.8558 (a zeroed quarter of wq, one step) and 0.5887 (the batch
# psum left out). The qwen2-moe cut's least is 0.8608, layers.1.mixer.bkv:
# the K half of a qkv bias has an exactly zero gradient (softmax ignores a
# shift shared by every key), so AdamW makes its rounding noise a full move
# in both runs. The cuts of item 15c (3 steps; their faults after one
# step, the sLSTM's after three): deepseek-v2's least 0.9973 (embed.tok),
# its fault 0.2773; jamba's 0.9973 (embed.tok), its fault 0.4479 after
# three steps; xlstm-125m's 0.99864 (layers.2.mixer.w_f; its sLSTM b_i,
# with an exactly zero gradient, reported apart), its fault 0.98547
# (layers.3.mixer.r_o), under 0.99 and at gradient cosine 0.99405 under
# the 0.999 bar. The reference check's params bar
# (tests/distributed_checks.py:229), max abs 5e-3, is reported and gates
# nothing: six AdamW steps at lr 3e-4 move an entry by about 1.6e-3 at
# most, so two runs of any sign lie within it.
MESH_TRAIN_MOVE_BARS = {"dense": 0.95, "moe": 0.8, "mla": 0.95,
                        "mamba": 0.95, "xlstm": 0.99}
MESH_TRAIN_PARAMS_MAX_ABS = 5e-3
# (c): the FSDP + TP leaf whose gradient block is zeroed on one rank at a
# time, in a step of its own; each rank holds a quarter of it
MESH_TRAIN_FAULT_LEAF = "layers.0.mixer.wq"
TRAIN_WRAPPERS = [fn for fn, _, _ in KERNELS] + [fn for _, fn, _, _ in
                                                 BWD_KERNELS]


def mesh_train_cases(names=None) -> list:
    """(name, config, global batch, steps): tacc-100m whole, the qwen2-moe
    cut at phase 17's capacity factor, at which no assignment drops, and
    the cuts of MLA (``mla``), Mamba (``mamba``) and the xLSTM mixers
    (``xlstm``); those of ``names`` only, in this order, when given."""
    moe = with_capacity(dataclasses.replace(
        get_config(MOE_ARCH), n_layers=MESH_TRAIN_MOE_LAYERS), MESH_CAPACITY)
    tp = (MESH_TRAIN_TP_BATCH, MESH_TRAIN_TP_STEPS)
    cases = [("dense", get_config("tacc-100m"), TRAIN_BATCH,
              MESH_TRAIN_STEPS),
             ("moe", moe, MESH_TRAIN_MOE_BATCH, MESH_TRAIN_MOE_STEPS),
             ("mla", dataclasses.replace(get_config(MLA_ARCH), n_layers=1),
              *tp),
             ("mamba", jamba_layer0(get_config(JAMBA_ARCH)), *tp),
             ("xlstm", xlstm_period(get_config(XLSTM_ARCH)), *tp)]
    return [c for c in cases if names is None or c[0] in names]


def mesh_train_setup(cfg, batch: int, steps: int):
    """Phase 9's optimizer and the case's global batches, the same in every
    process."""
    data = SyntheticLM(cfg, batch, TRAIN_SEQ, seed=SEED)
    batches = [{k: torch.from_numpy(v).long().cuda()
                for k, v in data.batch(i).items()} for i in range(steps)]
    return OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS), \
        batches


def mesh_train_reference(work: str, names) -> dict:
    """Phase 18 (a): each case of ``names`` in this one process from the
    seed's state: each step's loss and grad norm; step 1's gradients and
    the params after the last step (and after step 1 where one of (c)'s
    faulted runs takes one step) saved under ``work`` for the ranks to
    read; the memory given back before they start."""
    out = {}
    for name, cfg, batch, steps in mesh_train_cases(names):
        t0 = time.perf_counter()
        ocfg, batches = mesh_train_setup(cfg, batch, steps)
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(
            cfg, ocfg, torch.Generator(device="cuda").manual_seed(SEED),
            "cuda")
        step = build_train_step(cfg, ocfg, TrainConfig(), remat="full",
                                keep_grads=True)
        rec = {"loss": [], "grad_norm": [], "step_ms": []}
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            rec["step_ms"].append(1e3 * (time.perf_counter() - t1))
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            if i == 0:
                torch.save({k: v.cpu() for k, v in step.grads.items()},
                           os.path.join(work, f"{name}_grads.pt"))
                if any(n == 1 for _, _, n in
                       mesh_train_fault_runs(name, steps)):
                    torch.save({k: v.cpu() for k, v in
                                state["params"].items()},
                               os.path.join(work, f"{name}_params1.pt"))
            # a step's kept gradients would live through the next one's
            # forward and backward
            step.grads = None
        torch.save({k: v.cpu() for k, v in state["params"].items()},
                   os.path.join(work, f"{name}_params.pt"))
        rec.update(params=sum(t.numel() for t in state["params"].values()),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   seconds=time.perf_counter() - t0)
        del state, step, m
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = rec
    return out


def _owner(mesh, spec) -> bool:
    """Whether this rank counts its block of a leaf under ``spec`` once:
    the first of the ranks holding the same block."""
    split = {a for e in spec if e is not None
             for a in ((e,) if isinstance(e, str) else e)}
    return all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in split)


# the elements of a leaf taken to f64 at a time by the parts below: a rank
# never holds a whole block of deepseek-v2's vocab (0.5e9 entries) in f64
PARTS_PIECE = 1 << 24


def _pieces(*ts: torch.Tensor):
    """Aligned pieces of ``PARTS_PIECE`` elements of the flattened ``ts``,
    each on the card in f64 (``ts[0]``'s device)."""
    flat = [t.reshape(-1) for t in ts]
    dev = flat[0].device
    for i in range(0, max(flat[0].numel(), 1), PARTS_PIECE):
        yield [t[i:i + PARTS_PIECE].to(dev).double() for t in flat]


def mesh_grad_parts(cfg, grads, plan, mesh, path: str) -> dict:
    """Per leaf, this rank's block against the same block of the single
    process's gradient: [a.b, a.a, b.b] in f64, zeros where another rank
    counts the block."""
    ref = torch.load(path, mmap=True)
    out = {}
    for k, g in grads.items():
        out[k] = [0.0, 0.0, 0.0]
        if not _owner(mesh, plan[k]):
            continue
        for a, r in _pieces(g, shard_leaf(cfg, k, ref[k], plan[k], mesh)):
            for j, v in enumerate(((a * r).sum(), (a * a).sum(),
                                   (r * r).sum())):
                out[k][j] += float(v)
    return out


def mesh_move_parts(cfg, params, plan, mesh, path: str) -> dict:
    """Per leaf, this rank's move from the seed's state (drawn again here)
    against the single process's move over the same steps, whose params
    ``path`` holds: [d.r, d.d, r.r, max |d - r|, max |r|] in f64, with
    d = p - p0 and r = p_ref - p0 (so d - r = p - p_ref); zeros where
    another rank counts the block."""
    ref = torch.load(path, mmap=True)
    p0 = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                     "cuda", mesh=mesh, plan=plan)
    out = {}
    for k, p in params.items():
        base = p0.pop(k)
        out[k] = [0.0] * 5
        if not _owner(mesh, plan[k]):
            continue
        for q, b, want in _pieces(p, base, shard_leaf(cfg, k, ref[k],
                                                      plan[k], mesh)):
            d, r = q - b, want - b
            part = [(d * r).sum(), (d * d).sum(), (r * r).sum()]
            out[k][:3] = [x + float(v) for x, v in zip(out[k][:3], part)]
            out[k][3] = max(out[k][3], float((d - r).abs().max()))
            out[k][4] = max(out[k][4], float(r.abs().max()))
        del base
    return out


def rounding_only(cfg) -> set:
    """The leaves whose exact gradient is zero, so that in both runs their
    gradient is rounding and AdamW makes it a full move: each sLSTM
    layer's input-gate bias ``b_i``. A shift of every step's input-gate
    pre-activation moves the stabiliser m by as much, which leaves i_s,
    f_s and h = o c / n as they were."""
    return {f"layers.{i}.mixer.b_i" for i, spec in enumerate(cfg.layer_specs)
            if spec.mixer == "slstm"}


def moved(parts: list, skip=()) -> dict:
    """Every rank's :func:`mesh_move_parts` of one run put together: the
    least cosine of a leaf's move to the single process's and its leaf
    (``skip`` left out), the largest difference as a share of the single
    process's largest move in that leaf, and the largest difference (the
    reference check's measure)."""
    cos, share = {}, {}
    for k in (k for k in parts[0] if k not in skip):
        s = [sum(p[k][j] for p in parts) for j in range(3)]
        cos[k] = _cosine(*s)
        top = max(p[k][4] for p in parts)
        share[k] = max(p[k][3] for p in parts) / max(top, 1e-300)
    worst = min(cos, key=cos.get)
    return {"min_move_cosine": cos[worst], "min_move_leaf": worst,
            "max_move_share": max(share.values()),
            "params_max_abs": max(p[k][3] for p in parts for k in p)}


# the MLA case's faulted leaf: one rank's block of it zeroed in the state
MESH_TRAIN_MLA_FAULT_LEAF = "layers.0.mixer.w_uq"


def _rank_rows_only(r: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sLSTM fault: this rank's rows of a recurrent matrix in place,
    zeros where the gather would put the other ranks' (no gather)."""
    live = mesh.live((axis,))
    n, i, rows = mesh.size(live), mesh.axis_index(live), r.shape[1]
    return F.pad(r, (0, 0, i * rows, (n - 1 - i) * rows))


def _partial_dt_bc(uc: torch.Tensor, w: torch.Tensor, mesh, axis: str
                   ) -> torch.Tensor:
    """The Mamba fault: this rank's partial (dt_low, B, C), its sum over
    ``model`` left out."""
    return (uc.float() @ w.to(uc.dtype).float()).to(uc.dtype).float()


@contextlib.contextmanager
def train_fault(kind: str, mesh, rank: int = 0):
    """A fault planted in the mesh step for (c): "zero" zeroes ``rank``'s
    block of the fault leaf's gradient before the update; "skip_psum"
    leaves out the psum over the batch axes of every gradient whose leaf
    is not split over them (``train.step._sum_over_batch``), so each data
    rank updates its replicas from its own rows; "skip_x_proj_psum" leaves
    out the sum of Mamba's ``x_proj`` partials over ``model``
    (``models.mamba._dt_bc``); "r_block" has each rank use its rows of the
    sLSTM's recurrent matrices without the gather
    (``models.xlstm._gather_recurrent``). "zero_w_uq" plants nothing here:
    :func:`mesh_train_faults` zeroes ``rank``'s block of
    ``MESH_TRAIN_MLA_FAULT_LEAF`` in the state."""
    from repro_torch.models import mamba as MB
    from repro_torch.models import xlstm as XL
    from repro_torch.train import step as STEP

    def zero(grads, *a, **kw):
        if dist.get_rank() == rank:
            grads[MESH_TRAIN_FAULT_LEAF] = torch.zeros_like(
                grads[MESH_TRAIN_FAULT_LEAF])
        return real(grads, *a, **kw)

    module, name, fake = {
        "zero": (STEP, "adamw_update", zero),
        "skip_psum": (STEP, "_sum_over_batch", lambda grads, *a, **kw: grads),
        "skip_x_proj_psum": (MB, "_dt_bc", _partial_dt_bc),
        "r_block": (XL, "_gather_recurrent", _rank_rows_only),
        "zero_w_uq": (None, None, None)}[kind]
    if module is None:
        yield
        return
    real = getattr(module, name)
    setattr(module, name, fake)
    try:
        yield
    finally:
        setattr(module, name, real)


# the faults of item 15c's cases (mesh_train_fault_runs), each held at
# step 1 to the gradient bar, which it must miss, and to its case's move bar
TP_FAULTS = ("zero_w_uq", "skip_x_proj_psum", "r_block")


def mesh_train_fault_runs(name: str, steps: int) -> list:
    """(c)'s runs of a case, (fault, rank, steps): for tacc-100m each
    rank's block of the fault leaf zeroed in a step of its own; for it and
    the MoE cut the batch psum left out over the case's steps; for the
    cuts of item 15c each mixer's hazard over the case's steps: rank 0's
    block of MLA's ``w_uq`` zeroed, Mamba's ``x_proj`` sum over ``model``
    left out (one step each), the sLSTM's recurrent rows used without
    their gather (the case's steps)."""
    world = math.prod(MESH_TRAIN[0])
    # one step misses every bar for MLA's and Mamba's faults; the sLSTM's
    # moves part from the single process's only over the case's steps
    tp = {"mla": ("zero_w_uq", 0, 1), "mamba": ("skip_x_proj_psum", None, 1),
          "xlstm": ("r_block", None, steps)}
    if name in tp:
        return [tp[name]]
    zero = [("zero", r, 1) for r in range(world)] if name == "dense" else []
    return zero + [("skip_psum", None, steps)]


def mesh_train_faults(mesh, name: str, cfg, batch: int, steps: int,
                      work: str) -> list:
    """Phase 18 (c) on one rank: the case's steps with a fault planted
    (:func:`train_fault`, :func:`mesh_train_fault_runs`), each run from the
    seed's state and held to the single process after as many steps. Each
    run's fault-leaf gradient parts at step 1 (tacc-100m) and move
    parts."""
    ocfg, batches = mesh_train_setup(cfg, batch, steps)
    axes = train_batch_axes(mesh)
    plan = train_plan(cfg, mesh)
    runs = mesh_train_fault_runs(name, steps)
    out = []
    for kind, rank, steps in runs:
        state = init_train_state(
            cfg, ocfg, torch.Generator(device="cuda").manual_seed(SEED),
            "cuda", mesh=mesh)
        step = build_train_step(
            cfg, ocfg, TrainConfig(), remat="full", mesh=mesh,
            keep_grads=True, flags=RunFlags(distributed=True, token_axes=axes))
        rec = {"fault": kind, "rank": rank, "steps": steps, "loss": [],
               "grad_norm": []}
        if kind == "zero_w_uq" and dist.get_rank() == rank:
            state["params"][MESH_TRAIN_MLA_FAULT_LEAF].zero_()
        with train_fault(kind, mesh, rank or 0):
            for i, b in enumerate(batches[:steps]):
                state, m = step(state, {k: batch_rows(v, mesh, axes)
                                        for k, v in b.items()})
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
                if i == 0 and kind == "zero":
                    leaf = MESH_TRAIN_FAULT_LEAF
                    rec["grad_parts"] = mesh_grad_parts(
                        cfg, {leaf: step.grads[leaf]}, plan, mesh,
                        os.path.join(work, f"{name}_grads.pt"))[leaf]
                elif i == 0 and kind in TP_FAULTS:
                    rec["grad_parts"] = mesh_grad_parts(
                        cfg, step.grads, plan, mesh,
                        os.path.join(work, f"{name}_grads.pt"))
                step.grads = None
        state["opt"] = None
        rec["move_parts"] = mesh_move_parts(
            cfg, state["params"], plan, mesh, os.path.join(
                work, f"{name}_params1.pt" if steps == 1 else
                f"{name}_params.pt"))
        out.append(rec)
        del state, step, m
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_train_case(mesh, name: str, cfg, batch: int, steps: int,
                    work: str) -> dict:
    """Phase 18 (b) or (d) on one rank: the seed's state drawn whole and
    cut to this rank's blocks, its rows of each batch, the FSDP + TP step
    with the MoE through moe_ep; per step the metrics, the collectives,
    bytes sent and staged and the step's ms; step 1's gradient and the
    final params against the single process's (read from ``work``); every
    kernel's launches in the steps."""
    ocfg, batches = mesh_train_setup(cfg, batch, steps)
    axes = train_batch_axes(mesh)
    plan = train_plan(cfg, mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(
        cfg, ocfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda",
        mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = build_train_step(
        cfg, ocfg, TrainConfig(), remat="full", mesh=mesh, keep_grads=True,
        flags=RunFlags(distributed=True, token_axes=axes))
    rows = [{k: batch_rows(v, mesh, axes) for k, v in b.items()}
            for b in batches]
    MOE.moe_ep.dropped = 0
    per_step, parts = [], None
    for fn in TRAIN_WRAPPERS:
        fn.launches = 0
    for i, b in enumerate(rows):
        COLL.reset_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        per_step.append({"ms": 1e3 * (time.perf_counter() - t1),
                         "loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         **COLL.STATS})
        if i == 0:
            held = {fn: fn.launches for fn in TRAIN_WRAPPERS}
            parts = mesh_grad_parts(cfg, step.grads, plan, mesh,
                                    os.path.join(work, f"{name}_grads.pt"))
            for fn in TRAIN_WRAPPERS:     # the check launched no kernel
                if fn.launches != held[fn]:
                    raise AssertionError(f"{fn.__name__} launched outside "
                                         f"the steps")
        # kept, a step's gradients (a rank's 3.2 GB of jamba's cut) would
        # live through the next step's forward and backward, beside its own
        step.grads = None
    launches = {fn.__name__: fn.launches for fn in TRAIN_WRAPPERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    params_held = sum(t.numel() for t in state["params"].values())
    state["opt"] = None
    move = mesh_move_parts(cfg, state["params"], plan, mesh,
                           os.path.join(work, f"{name}_params.pt"))
    out = {"steps": per_step, "grad_parts": parts, "move_parts": move,
           "launches": launches,
           "expected_launches": expected_train_launches(cfg, steps),
           "dropped": int(MOE.moe_ep.dropped), "init_s": init_s,
           "params_held": params_held, "peak_gb": peak_gb,
           "peak_reserved_gb": reserved_gb,
           "rows": list(rows[0]["tokens"].shape)}
    del state, step, m
    return out


def mesh_train_rank(rank: int, world: int, store: str, work: str,
                    names) -> None:
    """One rank of phase 18, a process of its own on the one card, over the
    cases of ``names``; writes its results to ``work``/rank<r>.json."""
    # the four ranks' f32 states and gradient sums fill most of the card:
    # segments that grow in place strand less of it between allocations
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, os.cpu_count() // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        MESH_BACKEND, init_method=f"file://{store}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_mesh(*MESH_TRAIN)
        out = {"rank": rank, "coords": mesh.coords}
        t0 = time.perf_counter()
        for name, cfg, batch, steps in mesh_train_cases(names):
            out[name] = mesh_train_case(mesh, name, cfg, batch, steps, work)
            gc.collect()
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            out[name]["faults"] = mesh_train_faults(mesh, name, cfg, batch,
                                                    steps, work)
            out[name]["faults_s"] = time.perf_counter() - t1
            gc.collect()
            torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t0
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _cosine(dot: float, aa: float, bb: float) -> float:
    if aa == 0 and bb == 0:
        return 1.0
    return dot / max(math.sqrt(aa * bb), 1e-300)


def mesh_train_results(name: str, ref: dict, ranks: list) -> dict:
    """One case's numbers over every rank: the worst step's loss and grad
    norm against the single process, each leaf's cosine, the params' move
    (:func:`moved`), and (c): each faulted run's move and worst loss and
    grad norm, and for a zeroed block the fault leaf's cosine at step 1."""
    cases = [r[name] for r in ranks]
    loss_rel = max(abs(s["loss"] - a) / abs(a) for c in cases
                   for s, a in zip(c["steps"], ref["loss"]))
    gn_rel = max(abs(s["grad_norm"] - a) / abs(a) for c in cases
                 for s, a in zip(c["steps"], ref["grad_norm"]))
    leaves = cases[0]["grad_parts"]
    sums = {k: [sum(c["grad_parts"][k][j] for c in cases) for j in range(3)]
            for k in leaves}
    whole = [math.sqrt(sum(v[j] for v in sums.values())) for j in (1, 2)]
    share = {k: [math.sqrt(v[j]) / max(w, 1e-300)
                 for j, w in zip((1, 2), whole)] for k, v in sums.items()}
    skip = rounding_only(next(c for n, c, _, _ in mesh_train_cases((name,))))
    cos = {k: _cosine(*v) for k, v in sums.items() if k not in skip}
    out = {"loss_rel_max": loss_rel, "grad_norm_rel_max": gn_rel,
           "min_cosine": min(cos.values()),
           "worst_cosines": sorted(cos.items(), key=lambda kv: kv[1])[:5],
           "least_gradient_shares": sorted(
               share.items(), key=lambda kv: max(kv[1]))[:5],
           "rounding_only": {k: {"cosine": _cosine(*sums[k]),
                                 "gradient_share": share[k],
                                 **moved([c["move_parts"] for c in cases],
                                         set(leaves) - {k})}
                             for k in sorted(skip)},
           **moved([c["move_parts"] for c in cases], skip),
           "leaves": len(cos)}
    out["faults"] = []
    for j, f in enumerate(cases[0]["faults"]):
        runs = [c["faults"][j] for c in cases]
        leaf = {}
        if f["fault"] == "zero":
            g = [sum(r["grad_parts"][i] for r in runs) for i in range(3)]
            leaf = {"fault_leaf_cosine": _cosine(*g)}
        elif f["fault"] in TP_FAULTS:
            g = {k: _cosine(*[sum(r["grad_parts"][k][i] for r in runs)
                              for i in range(3)])
                 for k in runs[0]["grad_parts"] if k not in skip}
            worst = min(g, key=g.get)
            leaf = {"min_cosine": g[worst], "min_cosine_leaf": worst}
        out["faults"].append({
            "fault": f["fault"], "rank": f["rank"], "steps": f["steps"],
            **leaf, "loss_rel_max": max(
                abs(x - a) / abs(a) for r in runs
                for x, a in zip(r["loss"], ref["loss"])),
            "grad_norm_rel_max": max(
                abs(x - a) / abs(a) for r in runs
                for x, a in zip(r["grad_norm"], ref["grad_norm"])),
            **moved([r["move_parts"] for r in runs], skip)})
    return out


def mesh_train_failures(res: dict, ranks: list) -> list:
    bars, fails = MESH_TRAIN_BARS, []
    for name, r in res.items():
        if not (r["loss_rel_max"] < bars["loss_rel"]
                and r["grad_norm_rel_max"] < bars["grad_norm_rel"]):
            fails.append(f"{name}: loss or grad norm off the single process")
        if not r["min_cosine"] >= bars["min_cosine"]:
            fails.append(f"{name}: a gradient leaf at cosine "
                         f"{r['min_cosine']}")
        move = MESH_TRAIN_MOVE_BARS[name]
        if not r["min_move_cosine"] >= move:
            fails.append(f"{name}: {r['min_move_leaf']} moved at cosine "
                         f"{r['min_move_cosine']} to the single process")
        steps = next(s for n, _, _, s in mesh_train_cases() if n == name)
        if [(f["fault"], f["rank"], f["steps"]) for f in r["faults"]] != \
                mesh_train_fault_runs(name, steps):
            fails.append(f"{name}: (c) did not run its faulted runs")
        for f in r["faults"]:
            if f["fault"] == "zero" and not f["fault_leaf_cosine"] < \
                    bars["min_cosine"]:
                fails.append(f"{name}: rank {f['rank']}'s zeroed block "
                             f"kept cosine {f['fault_leaf_cosine']}")
            if f["fault"] in TP_FAULTS and not f["min_cosine"] < \
                    bars["min_cosine"]:
                fails.append(f"{name}: fault {f['fault']} kept every "
                             f"gradient leaf at cosine {f['min_cosine']}")
            if not f["min_move_cosine"] < move:
                fails.append(f"{name}: fault {f['fault']} {f['rank']} "
                             f"moved within the bar, at "
                             f"{f['min_move_cosine']}")
    for rank in ranks:
        for name in res:
            c = rank[name]
            if c["launches"] != c["expected_launches"] or not any(
                    v > 0 for v in c["launches"].values()):
                fails.append(f"rank {rank['rank']} {name} launched "
                             f"{c['launches']}")
            if c["dropped"]:
                fails.append(f"rank {rank['rank']} {name} dropped "
                             f"{c['dropped']} at capacity 8")
            if not all(math.isfinite(s["loss"]) for s in c["steps"]):
                fails.append(f"rank {rank['rank']} {name}: a loss is not "
                             f"finite")
    return fails


def mesh_train_kernels() -> dict:
    """K1, K1b, K2, K2b, K3 and K3b at a rank's local shapes in (b),
    against their plain versions, with their times, bound and library
    calls: q (8, 128, 6, 64) over k/v (8, 128, 2, 64), norms of rows
    (1024, 768)."""
    bf16 = torch.bfloat16
    cfg = get_config("tacc-100m")
    data, model = MESH_TRAIN[0]
    B, H, KV = (TRAIN_BATCH // data, cfg.n_heads // model,
                cfg.n_kv_heads // model)
    rows = B * TRAIN_SEQ
    return {"flash_attention": flash_case(bf16, [TRAIN_SEQ] * B,
                                          S=TRAIN_SEQ, H=H, KV=KV),
            "flash_bwd": flash_bwd_case(bf16, B, TRAIN_SEQ, H, KV,
                                        cfg.head_dim, timed=True),
            "rmsnorm": rms_case(bf16, rows, False),
            "rmsnorm_residual": rms_case(bf16, rows, True),
            "rmsnorm_bwd": rms_bwd_case(bf16, rows, False, timed=True),
            "rmsnorm_residual_bwd": rms_bwd_case(bf16, rows, True,
                                                 timed=True)}


def phase_mesh_train() -> dict:
    """Phase 18: (a) the single-process reference, saved and freed; (b)
    to (d) in 4 ranks on the one card over gloo (``mesh_train_rank``);
    every bar checked over every rank's results; the kernels at (b)'s
    local shapes."""
    before = allocated_bytes()
    torch.cuda.empty_cache()
    kernels = mesh_train_kernels()
    t0 = time.perf_counter()
    world = math.prod(MESH_TRAIN[0])
    single, ranks = {}, [{"seconds": 0.0} for _ in range(world)]
    t_ref, disk, t_group, card_used = 0.0, {}, {}, {}
    for names in MESH_TRAIN_GROUPS:
        work = tempfile.mkdtemp(prefix="mesh_train_")
        try:
            t1 = time.perf_counter()
            single.update(mesh_train_reference(work, names))
            t_ref += time.perf_counter() - t1
            disk["+".join(names)] = shutil.disk_usage(work).free / 1e9
            gc.collect()
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info()
            card_used["+".join(names)] = (total - free) / 1e9
            mp.spawn(mesh_train_rank, args=(
                world, os.path.join(work, "store"), work, names),
                nprocs=world, join=True)
            for r in range(world):
                with open(os.path.join(work, f"rank{r}.json")) as f:
                    got = json.load(f)
                got["seconds"] += ranks[r]["seconds"]
                ranks[r].update(got)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        t_group["+".join(names)] = time.perf_counter() - t1
    res = {name: mesh_train_results(name, single[name], ranks)
           for name in single}
    fails = mesh_train_failures(res, ranks)
    out = {"phase": "mesh_train", "card": card(),
           "mesh": dict(zip(*reversed(MESH_TRAIN))), "backend": MESH_BACKEND,
           "interconnect": "none: 4 processes share one card over gloo, "
                           "every collective staged through the host; "
                           "NCCL and NVLink times not measured",
           "cases": {name: {"arch": cfg.name, "layers": cfg.n_layers,
                            "global_batch": batch, "seq": TRAIN_SEQ,
                            "steps": steps}
                     for name, cfg, batch, steps in mesh_train_cases()},
           "reduced": {"moe": f"layers 0-{MESH_TRAIN_MOE_LAYERS - 1} of "
                              f"24, capacity factor {MESH_CAPACITY}",
                       "mla": "layer 0 of 60 (MLA + dense FFN)",
                       "mamba": "layer 0 of 72 (Mamba + dense FFN)",
                       "xlstm": "layers 0-3 of 12 (one period: 3 mLSTM, "
                                "1 sLSTM)"},
           "single_process": single, "results": res,
           "ranks": [{"rank": r["rank"], "coords": r["coords"],
                      "seconds": r["seconds"],
                      **{name: {k: r[name][k] for k in (
                          "steps", "launches",
                          "expected_launches", "dropped", "init_s",
                          "params_held", "peak_gb", "peak_reserved_gb",
                          "rows", "faults_s")}
                         for name in single}} for r in ranks],
           "launches": ranks[0]["dense"]["launches"],
           "kernels": kernels, "bars": MESH_TRAIN_BARS,
           "move_bars": MESH_TRAIN_MOVE_BARS,
           "reference_params_max_abs": MESH_TRAIN_PARAMS_MAX_ABS,
           "fault_leaf": MESH_TRAIN_FAULT_LEAF,
           "mla_fault_leaf": MESH_TRAIN_MLA_FAULT_LEAF,
           "tmp_free_gb_after_reference": disk,
           "card_used_gb_before_ranks": card_used, "group_s": t_group,
           "reference_s": t_ref, "seconds": time.perf_counter() - t0,
           "failures": fails}
    after = allocated_bytes()
    out["memory_allocated_after_gb"] = after / 1e9
    emit(out)
    if fails:
        raise AssertionError(f"mesh_train phase failed: {fails}")
    if abs(after - before) > MEMORY_SLACK_BYTES:
        raise AssertionError(f"allocated memory {before} -> {after} bytes "
                             f"across phase 18")
    return out


# -- phase 19 --------------------------------------------------------------

# the ported tools: the tuning table, the kernel bench, the examples, the
# serving and checkpoint benches
TOOLS_MICROBATCHES, TOOLS_TRAIN_STEPS = 2, 5
TOOLS_CKPT_D_MODEL = 256
# K1 f32 at the serving shape under probe tables: splits 8 leaves the first
# q tiles' runs of keys empty past the causal diagonal
TOOLS_PROBE_SPLITS = (1, 2, 8)
TOOLS_PROBE_NORM = ((MAX_SEQ, 768), "wide")


def tools_table(bench, cases: dict) -> dict:
    """Phase 19 (a): with an empty table every phase-3 shape's plan is the
    default rule's; under probe tables and under the committed table each
    choice launches as the table says and meets phase 3's bar against the
    plain version (``bench.run_point``, untimed)."""
    from repro_torch.kernels import autotune as AT
    empty = AT.AutotuneTable()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    departed = []
    for c in cases["flash_attention"] + cases["flash_attention_d192"]:
        (B, S, H, D), dt = c["q"], getattr(torch, c["dtype"])
        plan = AT.plan_key_splits(B, S, H, bench.FA._kernel_head_dim(D), dt,
                                  sms, empty)
        if plan != (bench.FA.key_splits(B, S, H, dt, sms), False):
            departed.append((c["q"], c["dtype"], plan))
    norms = 0
    for c in cases["rmsnorm"] + cases["rmsnorm_residual"]:
        (N, D), dt = c["x"], getattr(torch, c["dtype"])
        vector = ((D * torch.finfo(dt).bits // 8) % 16 == 0
                  and c["x_offset_bytes"] % 16 == 0)
        plan = AT.plan_rmsnorm_rows(N, D, dt, vector, empty)
        norms += 1
        if plan != (bench.RMS.variant_for(D, vector), False):
            departed.append((c["x"], c["dtype"], plan))
    runs = []

    def run(point, table, want, label):
        r = bench.run_point(point, torch.device("cuda"), table, timed=False)
        r.update(label=label, want=want,
                 ok=(r["choice"] == want and r["from_table"]
                     and not bench.violations(point.name, r)))
        runs.append(r)
    serve_f32 = dict(B=1, S=MAX_SEQ, H=12, KV=4, D=64, dtype=torch.float32)
    for n in TOOLS_PROBE_SPLITS:
        probe = AT.AutotuneTable()
        probe.record("flash_attention", torch.float32, (1, 12, MAX_SEQ, 64),
                     [n])
        run(bench.Point(f"probe splits={n}", "flash", serve_f32, {}), probe,
            f"splits={n}", "probe")
    (N, D), name = TOOLS_PROBE_NORM
    probe = AT.AutotuneTable()
    probe.record("rmsnorm", torch.bfloat16, (N, D),
                 [bench.RMS.VARIANTS.index(name)])
    for kind in ("rmsnorm", "rmsnorm_residual"):
        run(bench.Point(f"probe {kind} {name}", kind,
                        dict(N=N, D=D, dtype=torch.bfloat16), {}),
            probe, name, "probe")
    committed = AT.AutotuneTable.load()
    for key, choice in sorted(committed.entries.items()):
        for point, want in bench.entry_points(key, choice):
            run(point, committed, want, "committed")
    out = {"empty_table_shapes": len(cases["flash_attention"])
           + len(cases["flash_attention_d192"]) + norms,
           "empty_table_departed": departed,
           "committed_entries": committed.entries,
           "runs": [{k: r[k] for k in ("label", "kind", "choice", "want",
                                       "from_table", "max_err", "tol",
                                       "err_unit", "exact", "ok")}
                    for r in runs]}
    if departed or not all(r["ok"] for r in runs):
        raise AssertionError(f"the tuning table's plans: {out}")
    return out


def tools_bench(bench) -> dict:
    """Phase 19 (b): the kernel bench's snapshot at its points, held to the
    committed ``BENCH_kernels_torch.json`` as ``--check`` holds it."""
    snap = bench.snapshot(device="cuda", verbose=False)
    for name, r in snap["points"].items():
        print(f"bench {name}: max_err {r['max_err']:.4g} (tol {r['tol']:g} "
              f"{r['err_unit']}) device_ms {r['device_ms']:.6g} cold_ms "
              f"{r['cold_ms']:.6g} bound_ms {r['bound_ms']:.6g} "
              f"frac_of_bound {r['frac_of_bound']:.4g} {r['choice']}",
              flush=True)
    if not os.path.exists(bench.DEFAULT_OUT):
        raise AssertionError(f"no committed snapshot at {bench.DEFAULT_OUT}")
    with open(bench.DEFAULT_OUT, encoding="utf-8") as f:
        committed = json.load(f)
    bad = bench.check(snap, committed)
    return {"snapshot": snap, "violations": bad}


def tools_microbatches(quickstart) -> dict:
    """Phase 19 (c): quickstart's training, 2 microbatches a step, on the
    card and on the CPU from the same seed: each step's loss and grad norm
    within phase 8's rel 1e-3; every kernel launched as the code counts
    (each microbatch a forward and backward)."""
    wrappers = TRAIN_WRAPPERS
    for fn in wrappers:
        fn.launches = 0
    cfg, _, card_m = quickstart.train("cuda", TOOLS_TRAIN_STEPS, verbose=False)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    _, _, cpu_m = quickstart.train("cpu", TOOLS_TRAIN_STEPS, verbose=False)
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(card_m, cpu_m)]
           for k in ("loss", "grad_norm")}
    expected = expected_train_launches(cfg, TOOLS_TRAIN_STEPS *
                                       TOOLS_MICROBATCHES)
    out = {"steps": TOOLS_TRAIN_STEPS, "microbatches": TOOLS_MICROBATCHES,
           "loss_card": [m["loss"] for m in card_m],
           "loss_cpu": [m["loss"] for m in cpu_m],
           "grad_norm_card": [m["grad_norm"] for m in card_m],
           "grad_norm_cpu": [m["grad_norm"] for m in cpu_m],
           "rel": rel, "bars": {k: TRAIN_CONSISTENCY_BARS[f"{k}_rel"]
                                for k in rel},
           "launches": launches, "expected_launches": expected}
    if not (all(np.isfinite(out["loss_card"]))
            and all(max(rel[k]) < out["bars"][k] for k in rel)
            and launches == expected):
        raise AssertionError(f"microbatches on the card: {out}")
    return out


def tools_benches(serving, preemption) -> dict:
    """Phase 19 (d): the serving bench at the smoke config (every forward
    kernel must launch) and the checkpoint bench at d_model 256."""
    wrappers = [fn for fn, _, _ in KERNELS]
    for fn in wrappers:
        fn.launches = 0
    served = serving.run_bench(device="cuda")
    launches = {fn.__name__: fn.launches for fn in wrappers}
    n_requests, max_new = 12, 8
    rows = serving.rows(served, n_requests, max_new)
    for line in rows:
        print(f"serving bench: {line}", flush=True)
    for eng, res, _ in served.values():
        if not (all(r.done and len(r.tokens) == max_new for r in res)
                and all(s.request is None for s in eng._slots)):
            raise AssertionError("the serving bench left a request unfinished "
                                 "or a slot held")
    if not all(launches.values()):
        raise AssertionError(f"the serving bench launched a kernel no time: "
                             f"{launches}")
    n, ts, ta, tw, tr = preemption.measure_ckpt(TOOLS_CKPT_D_MODEL, "cuda")
    return {"serving": rows, "serving_launches": launches,
            "serving_steps": {k: e._steps for k, (e, _, _) in served.items()},
            "ckpt": {"d_model": TOOLS_CKPT_D_MODEL, "state_bytes": n,
                     "save_s": ts, "async_submit_s": ta, "async_wait_s": tw,
                     "restore_s": tr}}


def phase_tools(cases: dict) -> dict:
    """Phase 19: (a) the tuning table, (b) the kernel bench and its gate,
    (c) microbatches on the card, (d) the serving and checkpoint benches."""
    bench = _load_script("benchmarks_torch/bench_kernels_torch.py")
    out = {"phase": "tools", "card": card()}
    t0 = time.perf_counter()
    out["table"] = tools_table(bench, cases)
    out["bench"] = tools_bench(bench)
    out["microbatches"] = tools_microbatches(
        _load_script("examples/quickstart_torch.py"))
    out["benches"] = tools_benches(
        _load_script("benchmarks_torch/bench_serving_torch.py"),
        _load_script("benchmarks_torch/bench_preemption_torch.py"))
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if out["bench"]["violations"]:
        raise AssertionError(f"the kernel bench's gate: "
                             f"{out['bench']['violations']}")
    return out


# -- phase 20 --------------------------------------------------------------

DRY_PREFILL = (8, 512)          # (a)'s prefill: rows, tokens
DRY_STATE_BAR = 0.01            # state bytes against the allocator's growth
DRY_PEAK_BAR = 0.25             # predicted peak against the measured one
# the reference's tiny dry-run check (tests/distributed_checks.py:235-245)
DRY_CELLS = (("internlm2-1.8b", "train_4k"), ("qwen2-moe-a2.7b",
                                              "decode_32k"))
# each wrapper's counter record: the backward kernels count as one call
DRY_NAMES = {"flash_attention": "flash_attention",
             "flash_bwd_dq": "flash_attention_bwd",
             "flash_bwd_dkdv": "flash_attention_bwd",
             "rmsnorm": "rmsnorm", "rmsnorm_residual": "rmsnorm_residual",
             "rmsnorm_bwd": "rmsnorm_bwd",
             "rmsnorm_residual_bwd": "rmsnorm_residual_bwd"}


def dry_compare(card_rec: dict, meta_rec: dict, launches: dict,
                measured_peak: int) -> dict:
    """(a)'s comparison of one call on the card with its dry run: FLOPs by
    dtype and each kernel's record equal, each wrapper's launches equal to
    its kernel's calls, and the predicted peak (the storages the call
    made, ``peak_bytes_est`` less the arguments) against the allocator's."""
    mem = meta_rec["memory"]
    predicted = mem["peak_bytes_est"] - mem["argument_bytes"]
    calls = {k: v["calls"] for k, v in meta_rec["kernels"].items()}
    want = {fn: calls.get(DRY_NAMES[fn], 0) for fn in launches}
    return {"flops_by_dtype": {"card": card_rec["flops_by_dtype"],
                               "meta": meta_rec["flops_by_dtype"]},
            "flops_equal": (card_rec["flops_by_dtype"]
                            == meta_rec["flops_by_dtype"]),
            "bytes_accessed": {"card": card_rec["bytes_accessed"],
                               "meta": meta_rec["bytes_accessed"]},
            "kernels_equal": card_rec["kernels"] == meta_rec["kernels"],
            "kernels": meta_rec["kernels"],
            "launches": launches, "launches_equal_calls": launches == want,
            "peak_predicted_bytes": predicted,
            "peak_measured_bytes": measured_peak,
            "peak_rel": abs(predicted - measured_peak) / max(measured_peak,
                                                             1),
            "trace_s": meta_rec["trace_s"], "card_s": card_rec["trace_s"]}


def dry_on_card(fn, *args) -> tuple:
    """``fn(*args)`` once to warm (kernels loaded, cuBLAS's workspace,
    K2b's scratch), then once counted: (its record, each wrapper's
    launches in it, the allocator's peak above its start)."""
    fn(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    for fn_ in TRAIN_WRAPPERS:
        fn_.launches = 0
    rec, _ = DRY.measure(fn, *args, track="cuda")
    torch.cuda.synchronize()
    launches = {fn_.__name__: fn_.launches for fn_ in TRAIN_WRAPPERS}
    return rec, launches, torch.cuda.max_memory_allocated() - start


def dryrun_one_process() -> dict:
    """Phase 20 (a)."""
    cfg = get_config("tacc-100m")
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    state = init_train_state(
        cfg, ocfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - a0
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batch = {k: torch.from_numpy(v).long().cuda()
             for k, v in data.batch(0).items()}
    step = build_train_step(cfg, ocfg, TrainConfig(), remat="full")
    card_rec, launches, peak = dry_on_card(step, state, batch)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    ms, mb, _ = DRY.train_args(cfg, ocfg, shape)
    meta_rec, _ = DRY.measure(build_train_step(cfg, ocfg, TrainConfig(),
                                               remat="full"), ms, mb)
    state_bytes = sum(DRY.storage_bytes(ms).values())
    out = {"train": dict(dry_compare(card_rec, meta_rec, launches, peak),
                         state_bytes=state_bytes, state_grown_bytes=grown,
                         state_rel=abs(state_bytes - grown) / grown,
                         memory=meta_rec["memory"])}
    params = cast_for_compute(cfg, state["params"], "cuda")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    model = Transformer(cfg, params, device="cuda")
    meta_model = Transformer(cfg, DRY.serving_params(cfg), device="meta")
    rows, seq = DRY_PREFILL
    toks = torch.from_numpy(SyntheticLM(cfg, rows, seq, seed=0).batch(0)[
        "tokens"]).long().cuda()
    lengths = torch.full((rows,), seq, dtype=torch.int32, device="cuda")
    mbatch = DRY.as_batch(input_specs(cfg, ShapeConfig(
        "prefill", seq, rows, "prefill")), rows, "meta")
    mlen = torch.zeros(rows, dtype=torch.int32, device="meta")
    cache = init_cache(cfg, rows, seq, "cuda")
    mcache, mtok, _ = DRY.decode_args(
        cfg, ShapeConfig("decode", seq, rows, "decode"), None, (), ())
    with torch.inference_mode():
        card_rec, launches, peak = dry_on_card(
            lambda t, n: prefill(model, {"tokens": t}, n), toks, lengths)
        meta_rec, _ = DRY.measure(
            lambda b, n: prefill(meta_model, b, n), mbatch, mlen)
        out["prefill"] = dry_compare(card_rec, meta_rec, launches, peak)
        card_rec, launches, peak = dry_on_card(
            lambda c, t: decode_step(model, c, t), cache, toks[:, 0])
        meta_rec, _ = DRY.measure(
            lambda c, t: decode_step(meta_model, c, t), mcache, mtok)
        out["decode"] = dry_compare(card_rec, meta_rec, launches, peak)
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dryrun_mesh_cases(mt: dict) -> dict:
    """Phase 20 (b): each case of phase 18 dry on rank 0's view of (data
    2, model 2), its tally against every live rank's at step 2."""
    out = {}
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    for name, cfg, batch, steps in mesh_train_cases():
        view = Mesh.view(*MESH_TRAIN, 0, dry=True)
        state, rows, facts = DRY.train_args(
            cfg, ocfg, ShapeConfig(name, TRAIN_SEQ, batch, "train"), view)
        step = build_train_step(
            cfg, ocfg, TrainConfig(), remat="full", mesh=view,
            keep_grads=True, flags=RunFlags(
                distributed=True, token_axes=train_batch_axes(view)))
        rec, _ = DRY.measure(DRY.quiet_moe(step), state, rows)
        live = [r[name]["steps"][1]["by_kind"] for r in mt["ranks"]]
        out[name] = {"dry": rec["collectives"], "live_by_rank": live,
                     "equal": all(t == rec["collectives"] for t in live),
                     "rows": facts["rows"], "trace_s": rec["trace_s"],
                     "dry_peak_gb": rec["memory"]["peak_bytes_est"] / 1e9,
                     "peak_gb_by_rank": [r[name]["peak_gb"]
                                         for r in mt["ranks"]]}
    return out


def dryrun_production() -> dict:
    """Phase 20 (c)."""
    roof = _load_script("benchmarks_torch/roofline_torch.py")
    total = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for arch, shape in DRY_CELLS:
        rec = DRY.run_cell(arch, shape, "single")
        row = roof.analyse_cell(rec) if rec["status"] == "ok" else None
        out[f"{arch}__{shape}"] = {
            "status": rec["status"], "error": rec.get("error"),
            "flops": rec.get("full", {}).get("flops", 0.0),
            "trace_s": rec.get("full", {}).get("trace_s"),
            "memory": rec.get("full", {}).get("memory"),
            "collectives": rec.get("full", {}).get("collectives"),
            "roofline": row,
            "fits_card": (None if row is None else
                          rec["full"]["memory"]["peak_bytes_est"] <= total)}
    out["card_total_memory_bytes"] = total
    out["assumed_memory_bytes"] = H100_MEMORY_BYTES
    return out


def phase_dryrun(mt: dict) -> dict:
    """Phase 20: (a), (b) and (c), each bar checked after the line is
    printed."""
    t0 = time.perf_counter()
    one = dryrun_one_process()
    t1 = time.perf_counter()
    mesh = dryrun_mesh_cases(mt)
    t2 = time.perf_counter()
    prod = dryrun_production()
    out = {"phase": "dryrun", "card": card(), "one_process": one,
           "mesh_cases": mesh, "production": prod,
           "bars": {"state_rel": DRY_STATE_BAR, "peak_rel": DRY_PEAK_BAR},
           "seconds": {"one_process": t1 - t0, "mesh_cases": t2 - t1,
                       "production": time.perf_counter() - t2}}
    emit(out)
    bad = []
    for kind, c in one.items():
        for k in ("flops_equal", "kernels_equal", "launches_equal_calls"):
            if not c[k]:
                bad.append(f"(a) {kind}: {k}")
        if c["peak_rel"] > DRY_PEAK_BAR:
            bad.append(f"(a) {kind}: peak {c['peak_predicted_bytes']} "
                       f"against {c['peak_measured_bytes']}")
    if one["train"]["state_rel"] > DRY_STATE_BAR:
        bad.append(f"(a) state bytes {one['train']['state_bytes']} against "
                   f"{one['train']['state_grown_bytes']}")
    bad += [f"(b) {name}: tallies differ" for name, c in mesh.items()
            if not c["equal"]]
    bad += [f"(c) {cell}: {c['status']} {c['error']}"
            for cell, c in prod.items() if isinstance(c, dict)
            and (c["status"] != "ok" or not c["flops"] > 0)]
    if bad:
        raise AssertionError(f"phase 20: {bad}")
    return out


def kernel_line(served: dict, cases: dict, bwd: dict, trained: dict,
                cluster: dict, moe: dict, mla: dict, xl: dict,
                jb: dict, pg: dict, tc: dict, ms: dict, mt: dict,
                tl: dict, dr: dict) -> dict:
    """The ``{"kernels": [...]}`` line: forward kernels with their serve
    launches and phase 3 numbers, backward kernels with their train
    launches and phase 7 numbers (bf16 at the training shapes); every
    kernel also with its launches in the cluster run (phase 10); the
    forward kernels also with their launches serving qwen2-moe-a2.7b and
    their numbers at its shapes (phase 11: K1 on a 512-token prefill's q,
    K2/K3 at rows (512, 2048)); K2 and K3 also with their launches serving
    deepseek-v2 and their numbers at its widths (phase 12); and a row for K1
    at D = 192, launched serving deepseek-v2 (phase 12), with its numbers
    there in bf16 and at the same shape in f32 (phase 3); the forward
    kernels also with their launches serving xlstm-125m (phase 13) and the
    jamba cut (phase 14), and their numbers at jamba's shapes (K1 on the
    attention layer's q (1, 512, 64, 128), K2/K3 at rows (512, 8192) and
    (8, 8192)); the forward kernels also with their launches serving
    internlm2-1.8b (phase 15) and their numbers at its shapes (K1 on layer
    0's q (1, 512, 16, 128), K2/K3 at rows (512, 2048) and (8, 2048));
    every kernel with its launches in tcloud's demo and its submitted
    spec file (phase 16); and the forward kernels with their launches
    summed over the 4 ranks serving qwen2-moe-a2.7b over a mesh (phase
    17); and every kernel with a rank's launches training tacc-100m over
    the (data 2, model 2) mesh, by rank, and its numbers at a rank's local
    shapes there (phase 18: q (8, 128, 6, 64), rows (1024, 768)); and every
    kernel with its launches in quickstart's training on the card (phase
    19 (c), 2 microbatches a step), the forward kernels also in the
    serving bench's (phase 19 (d)); and every kernel with its launches in
    phase 20 (a)'s counted train step, prefill and decode step."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "floor_ms")
    rows = [{"name": fn.__name__, "route": "cuda", "source": src,
             "replaces": tpu, "launches": served["launches"][fn.__name__],
             "launches_in": "serve (phase 5)",
             "train_launches": trained["launches"][fn.__name__],
             "cluster_launches": cluster["launches"][fn.__name__],
             **{k: cases[fn.__name__][0][k] for k in keys
                if k in cases[fn.__name__][0]},
             "shape": (cases[fn.__name__][0].get("q")
                       or cases[fn.__name__][0]["x"]),
             "dtype": cases[fn.__name__][0]["dtype"],
             "moe_launches": moe["serve"]["launches"][fn.__name__],
             "moe_launches_in": f"serve {MOE_ARCH} (phase 11)",
             "moe_shape": {k: moe["kernels"][fn.__name__][0].get(k)
                           for k in ("q", "x") + keys
                           if k in moe["kernels"][fn.__name__][0]}}
            for fn, src, tpu in KERNELS]
    for row in rows:
        name = row["name"]
        row.update(xlstm_launches=xl["serve"]["launches"][name],
                   xlstm_launches_in=f"serve {XLSTM_ARCH} (phase 13)",
                   jamba_launches=jb["serve"]["launches"][name],
                   jamba_launches_in=f"serve {JAMBA_ARCH} layers 2-4 "
                                     f"(phase 14)",
                   jamba_shapes=[{k: c.get(k) for k in ("q", "x", "variant")
                                  + keys if k in c}
                                 for c in jb["kernels"][name]],
                   paged_launches=pg["serve"]["launches"][name],
                   paged_launches_in=f"serve {PAGED_ARCH} (phase 15)",
                   paged_shapes=[{k: c.get(k) for k in ("q", "x", "variant")
                                  + keys if k in c}
                                 for c in pg["kernels"][name]])
    # K1 f32 launches on neither path: its phase 3 numbers at both shapes
    fwd = cases["flash_attention"]
    rows[0].update({f"f32_{n}": {k: fwd[i][k] for k in keys
                                 if k in fwd[i] and k != "floor_ms"}
                    for n, i in (("serve", 2), ("train", 5))})
    for row in rows[1:]:
        row.update(mla_launches=mla["serve"]["launches"][row["name"]],
                   mla_launches_in=f"serve {MLA_ARCH} (phase 12)",
                   mla_shapes=[{k: c.get(k) for k in ("x", "variant") + keys
                                if k in c}
                               for c in mla["kernels"][row["name"]]])
    k1, k1_f32 = mla["kernels"]["flash_attention"][0], \
        cases["flash_attention_d192"][1]
    rows.append({"name": "flash_attention (D = 192)", "route": "cuda",
                 "source": KERNELS[0][1], "replaces": KERNELS[0][2],
                 "launches": mla["serve"]["launches"]["flash_attention"],
                 "launches_in": f"serve {MLA_ARCH} (phase 12)",
                 **{k: k1[k] for k in keys if k in k1 and k != "floor_ms"},
                 "shape": k1["q"], "dtype": k1["dtype"],
                 "f32": {k: k1_f32[k] for k in keys
                         if k in k1_f32 and k != "floor_ms"}})
    fl, f32, k2, k3 = (bwd["flash"][0], bwd["flash"][1], bwd["K2b"][0],
                       bwd["K3b"][0])

    def flash_row(c, part, err):
        return {**c[part], "plain_ms": c["plain_ms"],
                "library_ms": c["library_ms"], "max_abs_err": err}
    per = {"flash_bwd_dq": {**flash_row(fl, "dq", fl["dq_err"]),
                            "shape": fl["q"],
                            "f32": flash_row(f32, "dq", f32["dq_err"])},
           "flash_bwd_dkdv": {**flash_row(fl, "dkdv",
                                          max(fl["dk_err"], fl["dv_err"])),
                              "shape": fl["kv"],
                              "f32": flash_row(f32, "dkdv", max(
                                  f32["dk_err"], f32["dv_err"]))},
           "rmsnorm_bwd": {**k2, "shape": k2["x"]},
           "rmsnorm_residual_bwd": {**k3, "shape": k3["x"]}}
    for name, fn, src, what in BWD_KERNELS:
        c = per[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": what, "launches": trained["launches"][name],
                     "launches_in": "train (phase 9)",
                     "cluster_launches": cluster["launches"][name],
                     **{k: c.get(k) for k in keys if k != "floor_ms"},
                     "shape": c["shape"], "dtype": fl["dtype"],
                     **{k: c[k] for k in ("f32", "dw") if k in c}})
    # K1b at D = 192 (MLA's q/k width, bf16): phase 7's timed case, its
    # launches training deepseek-v2's layer 0 over (data 2, model 2)
    d192 = bwd["flash_d192"][0]
    for name, fn, src, what in BWD_KERNELS[:2]:
        part = "dq" if name == "flash_bwd_dq" else "dkdv"
        by_rank = [r["mla"]["launches"][name] for r in mt["ranks"]]
        rows.append({
            "name": f"{name} (D = 192)", "route": "cuda", "source": src,
            "replaces": what, "launches": by_rank[0],
            "launches_in": "train deepseek-v2 layer 0 over (data 2, model "
                           "2), one rank (phase 18)",
            "launches_by_rank": by_rank,
            "max_abs_err": (d192["dq_err"] if part == "dq" else
                            max(d192["dk_err"], d192["dv_err"])),
            "ms": d192[part]["ms"], "plain_ms": d192["plain_ms"],
            "bound_ms": d192[part]["bound_ms"],
            "bound_by": d192[part]["bound_by"],
            "library_ms": d192["library_ms"],
            "library_backend": d192["library_backend"],
            "whole_ms": d192["ms"], "shape": d192["q"],
            "dtype": d192["dtype"],
            "v_zero_columns": d192["v_zero_columns"]})
    for row in rows:
        if row["name"] in tc["demo"]["launches"]:
            row.update(tcloud_launches={
                run: tc[run]["launches"][row["name"]]
                for run in ("demo", "submit")},
                tcloud_launches_in="tcloud demo and submit --watch "
                                   "(phase 16)")
        if row["name"] in ms["launches"]:
            row.update(mesh_launches=ms["launches"][row["name"]],
                       mesh_launches_by_rank=[
                           r["traffic"]["capacity_8"]["launches"][
                               row["name"]] for r in ms["ranks"]],
                       mesh_launches_in=f"serve {MOE_ARCH} over 4 ranks "
                                        f"(phase 17)")
        name = row["name"]
        if name in mt["launches"]:
            local = mt["kernels"]
            c = local.get(name)
            if name in ("flash_bwd_dq", "flash_bwd_dkdv"):
                fb = local["flash_bwd"]
                part = "dq" if name == "flash_bwd_dq" else "dkdv"
                c = {**fb[part], "plain_ms": fb["plain_ms"],
                     "library_ms": fb["library_ms"],
                     "max_abs_err": (fb["dq_err"] if part == "dq" else
                                     max(fb["dk_err"], fb["dv_err"])),
                     "q": fb["q"]}
            row.update(
                mesh_train_launches=mt["launches"][name],
                mesh_train_launches_by_rank=[
                    r["dense"]["launches"][name] for r in mt["ranks"]],
                mesh_train_launches_in="train tacc-100m over (data 2, "
                                       "model 2), one rank (phase 18)",
                mesh_train_shape={k: c.get(k) for k in ("q", "x") + keys
                                  if k in c})
        if name in tl["microbatches"]["launches"]:
            row.update(tools_launches={
                "quickstart_train": tl["microbatches"]["launches"][name],
                "serving_bench": tl["benches"]["serving_launches"].get(name)},
                tools_launches_in="quickstart's 5 training steps, 2 "
                                  "microbatches, and the serving bench "
                                  "(phase 19)")
        one = dr["one_process"]
        if name in one["train"]["launches"]:
            row.update(dryrun_launches={
                k: one[k]["launches"][name]
                for k in ("train", "prefill", "decode")},
                dryrun_launches_in="tacc-100m's counted train step, prefill "
                                   "and decode step, each equal to the dry "
                                   "run's calls (phase 20 (a))")
    return {"kernels": rows}


def main() -> None:
    start, seconds = time.perf_counter(), {}

    def timed(name, fn, *args):
        """``fn(*args)``, its wall seconds kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    dev = timed("1 device", phase_device)
    ptxas = timed("2 build", phase_build)
    cases = timed("3 kernels", phase_kernels, ptxas)
    floor = cases["rmsnorm"][0]["floor_ms"]
    cfg = get_config("tacc-100m")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         "cuda")
    timed("4 consistency", phase_consistency, cfg, params)
    served = timed("5 serve", phase_serve, cfg, params)
    timed("6 profile", phase_profile, cfg, params, served)
    bwd = timed("7 kernels_bwd", phase_kernels_bwd, ptxas)
    timed("8 train_consistency", phase_train_consistency, cfg, params)
    trained = timed("9 train", phase_train, cfg)
    del params
    cluster = timed("10 cluster", phase_cluster)
    moe = timed("11 moe_serve", phase_moe_serve, floor)
    mla = timed("12 mla_serve", phase_mla_serve, floor)
    xl = timed("13 xlstm_serve", phase_xlstm_serve)
    jb = timed("14 jamba_serve", phase_jamba_serve, floor)
    pg = timed("15 paged_serve", phase_paged_serve, floor)
    tc = timed("16 tcloud", phase_tcloud)
    ms = timed("17 mesh_serve", phase_mesh_serve)
    mt = timed("18 mesh_train", phase_mesh_train)
    tl = timed("19 tools", phase_tools, cases)
    dr = timed("20 dryrun", phase_dryrun, mt)
    emit({"phase_seconds": seconds, "card": card(),
          "total_s": time.perf_counter() - start})
    emit(kernel_line(served, cases, bwd, trained, cluster, moe, mla, xl, jb,
                     pg, tc, ms, mt, tl, dr))
    emit({"ok": True, "device": dev})


if __name__ == "__main__":
    main()
