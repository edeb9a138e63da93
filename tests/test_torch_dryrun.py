"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's on the CPU: ``input_specs``, ``make_plan``, ``param_count``, a
rank's block shapes and the roofline's analytic counts equal to JAX's for
every config; the counted matmul FLOPs of a prefill and a decode step
equal to the ``dot_general`` FLOPs of JAX's jaxpr at smoke size (its
attention, a Pallas call in interpret mode, is the kernel's and counted by
its formula); a dry rank's collectives tally equal to a live gloo rank's, and a
6-head step whose model axis splits wq by columns held to one process and
to JAX;
the counter itself (a known peak, one record per kernel call, the same
counts on the CPU and on meta); and the kernels' meta branch.
"""
import dataclasses
import json
import math
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.data import SyntheticLM, input_specs, to_torch
from repro_torch.kernels import flash_attention as FA_fn
from repro_torch.kernels import rmsnorm_bwd
from repro_torch.kernels import rmsnorm as rmsnorm_fn
from repro_torch.kernels import rmsnorm_residual, rmsnorm_residual_bwd
from repro_torch.launch import count, dryrun
from repro_torch.launch.count import Counter
from repro_torch.launch.mesh import Mesh
from repro_torch.models import (Transformer, decode_step, prefill,
                                 state_from_jax)
from repro_torch.models.params import (POD_FSDP_RULES, abstract_params,
                                       model_defs, param_count, params_to_jax,
                                       train_plan)
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import batch_rows, train_batch_axes
from repro_torch.train import OptConfig, TrainConfig, build_train_step
from repro_torch.train import init_train_state

FA = sys.modules["repro_torch.kernels.flash_attention"]
RMS = sys.modules["repro_torch.kernels.rmsnorm"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmarks_torch"))
import compare_profiles_torch  # noqa: E402
import roofline_torch  # noqa: E402

ARCHS = list_archs()
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DOT_OPS = ("mm", "addmm", "bmm", "baddbmm")
MESH22 = ((2, 2), ("data", "model"))
MESH14 = ((1, 4), ("data", "model"))


def _jax_dryrun(monkeypatch):
    """The reference's dry-run module. Importing it asks
    ``repro.runtime`` for 512 host devices (XLA_FLAGS, read when JAX
    first starts a backend); the request is stubbed out here, so the
    worker's JAX keeps its own device count."""
    from repro import runtime
    monkeypatch.setattr(runtime, "force_host_device_count",
                        lambda n, env=None: n)
    import repro.launch.dryrun as jd
    return jd


def _dtype(d) -> str:
    return str(d).rsplit(".", 1)[-1]


# -- what the dry run is given -----------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    from repro.configs import get_config as jget
    from repro.configs.base import SHAPES as JSHAPES
    from repro.data.synthetic import input_specs as jspecs
    for name in SHAPES:
        mine = input_specs(get_config(arch), SHAPES[name])
        ref = jspecs(jget(arch), JSHAPES[name])
        assert list(mine) == list(ref), (name, list(mine), list(ref))
        for k, v in mine.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(ref[k].shape), (name, k)
            assert _dtype(v.dtype) == _dtype(ref[k].dtype), (name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_plan_equals_jax(arch, monkeypatch):
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jget
    from repro.configs.base import SHAPES as JSHAPES
    jd = _jax_dryrun(monkeypatch)
    for kind, (shape, axes) in MESHES.items():
        view = dryrun.dry_mesh(kind)
        assert (view.axis_sizes, view.axis_names) == (shape, axes)
        amesh = AbstractMesh(shape, axes)
        for name in SHAPES:
            for profile in ("baseline", "optimized"):
                mine = dryrun.make_plan(get_config(arch), SHAPES[name], view,
                                        profile)
                ref = jd.make_plan(jget(arch), JSHAPES[name], amesh, profile)
                assert mine == ref, (kind, name, profile)
    assert set(dryrun.NO_COUNTERPART) <= set(mine)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_block_shapes_equal_jax(arch, monkeypatch):
    """``param_count`` and, on both production meshes under the rules the
    plan picks, a rank's block of every leaf: the port's
    ``abstract_params`` against the shapes JAX's ``param_specs`` give."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import model_defs as jdefs
    from repro.models.params import param_count as jcount
    from repro.models.params import param_specs as jspecs
    cfg, jcfg = get_config(arch), jget(arch)
    assert param_count(model_defs(cfg)) == jcount(jdefs(jcfg))
    jd = _jax_dryrun(monkeypatch)
    for kind, (shape, axes) in MESHES.items():
        view = dryrun.dry_mesh(kind)
        plan = dryrun.make_plan(cfg, SHAPES["train_4k"], view)
        rules = dryrun._rules(plan)
        blocks = abstract_params(model_defs(cfg), mesh=view,
                                 plan=train_plan(cfg, view, rules))
        tree = params_to_jax(cfg, blocks)
        # a stand-in with the attributes param_specs reads of a mesh
        mesh = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape, np.int8))
        specs = jspecs(jdefs(jcfg), mesh, jd._rules(plan))
        sizes = dict(zip(axes, shape))

        def block(d, spec):
            dims = list(d.shape)
            for i, e in enumerate(spec):
                for a in (() if e is None else (e,) if isinstance(e, str)
                          else e):
                    dims[i] //= sizes[a]
            return tuple(dims)

        want = jax.tree.map(block, jdefs(jcfg), specs,
                            is_leaf=lambda x: hasattr(x, "init"))
        got = jax.tree.map(lambda t: tuple(t.shape), tree)
        assert jax.tree.structure(want, is_leaf=lambda x: isinstance(
            x, tuple)) is not None
        flat_w = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple))
        flat_g = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))
        assert flat_g == flat_w, kind


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_analytic_counts_equal_jax(arch):
    sys.path.insert(0, ROOT)
    from benchmarks import roofline as jr
    from repro.configs import get_config as jget
    from repro.configs.base import SHAPES as JSHAPES
    cfg, jcfg = get_config(arch), jget(arch)
    assert roofline_torch.active_params(cfg) == jr.active_params(jcfg)
    assert (roofline_torch.nonembedding_params(cfg)
            == jr.nonembedding_params(jcfg))
    for name in SHAPES:
        assert (roofline_torch.model_flops(cfg, SHAPES[name])
                == jr.model_flops(jcfg, JSHAPES[name])), name


# -- counted FLOPs against JAX's jaxpr -----------------------------------------

def _jaxpr_dot_flops(jaxpr) -> float:
    """2 x the multiply-adds of every ``dot_general`` in ``jaxpr`` and the
    jaxprs it calls (a scan's body times its length), leaving out Pallas
    calls (the kernels, counted by their own formula)."""
    total = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            a = eqn.invars[0].aval.shape
            out = eqn.outvars[0].aval.shape
            if lc:          # none: an outer product, elementwise
                total += 2.0 * math.prod(out) * math.prod(a[i] for i in lc)
            continue
        if prim == "pallas_call":
            continue
        times = eqn.params.get("length", 1) if prim == "scan" else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    total += times * _jaxpr_dot_flops(inner)
    return total


def _port_dots(rec) -> float:
    return sum(rec["flops_by_op"].get(k, 0.0) for k in DOT_OPS)


SERVE_B, SERVE_S = 2, 16


def _jax_serve_flops(arch, steps):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import abstract_params as jabs
    from repro.models import model_defs as jdefs
    from repro.models.transformer import RunFlags as JFlags
    from repro.models.transformer import decode_step as jdecode
    from repro.models.transformer import init_cache as jcache
    from repro.models.transformer import prefill as jprefill
    from repro.data.synthetic import input_specs as jspecs
    from repro.configs.base import ShapeConfig as JShape
    jcfg = jget(arch, smoke=True)
    params = jabs(jdefs(jcfg))
    flags = JFlags(backend="interpret")
    batch = jspecs(jcfg, JShape("p", SERVE_S, SERVE_B, "prefill"))
    lengths = jax.ShapeDtypeStruct((SERVE_B,), jnp.int32)
    pre = None if "prefill" not in steps else jax.make_jaxpr(
        lambda p, b, n: jprefill(jcfg, p, b, n, flags=flags))(
        params, batch, lengths)
    cache = jax.eval_shape(lambda: jcache(jcfg, SERVE_B, SERVE_S))
    tok = jspecs(jcfg, JShape("d", SERVE_S, SERVE_B, "decode"))["tokens"]
    dec = jax.make_jaxpr(lambda p, c, t: jdecode(jcfg, p, c, t,
                                                 flags=flags))(
        params, cache, tok)
    return (None if pre is None else _jaxpr_dot_flops(pre.jaxpr),
            _jaxpr_dot_flops(dec.jaxpr))


# the recurrent mixers (Mamba, mLSTM, sLSTM) write some of their products
# as einsums in JAX and as broadcast products in the port, so their
# sequence passes count differently (the xLSTM decode step too); those
# configs are held on the steps whose products are written alike
DOT_CELLS = [(a, ("prefill", "decode")) for a in ARCHS
             if a not in ("jamba-1.5-large-398b", "xlstm-125m")] + [
    ("jamba-1.5-large-398b", ("decode",))]


def _attention_dots(cfg) -> float:
    """JAX's attention products at the smoke prefill (QK^T and PV over the
    whole square, which its kernel in interpret mode computes in one block
    at this size; MLA's V zero-padded to the q/k width)."""
    sq = 2.0 * SERVE_B * cfg.n_heads * SERVE_S * SERVE_S
    total = 0.0
    for s in cfg.layer_specs:
        if s.mixer == "attn":
            total += 2 * sq * cfg.head_dim
        elif s.mixer == "mla":
            total += 2 * sq * (cfg.mla.qk_nope_head_dim
                               + cfg.mla.qk_rope_head_dim)
    return total


@pytest.mark.parametrize("arch,steps", DOT_CELLS,
                         ids=[a for a, _ in DOT_CELLS])
def test_counted_serving_dots_equal_jax_jaxpr(arch, steps):
    """At smoke size on meta, one prefill and one decode step: the port's
    counted matmul FLOPs equal the dot_general FLOPs of JAX's traced
    functions, less JAX's attention products in the prefill, which the
    port leaves to the flash kernel's count; that count is the kernel's
    formula at every attention layer."""
    cfg = get_config(arch, smoke=True)
    model = Transformer(cfg, dryrun.serving_params(cfg), device="meta")
    batch = dryrun.as_batch(input_specs(cfg, ShapeConfig(
        "p", SERVE_S, SERVE_B, "prefill")), SERVE_B, "meta")
    lengths = torch.zeros(SERVE_B, dtype=torch.int32, device="meta")
    with torch.inference_mode():
        pre, _ = dryrun.measure(lambda: prefill(model, batch, lengths))
        cache, tokens, _ = dryrun.decode_args(
            cfg, ShapeConfig("d", SERVE_S, SERVE_B, "decode"), None, (), ())
        dec, _ = dryrun.measure(lambda: decode_step(model, cache, tokens))
    jpre, jdec = _jax_serve_flops(arch, steps)
    if "prefill" in steps:
        assert _port_dots(pre) == jpre - _attention_dots(cfg)
    assert _port_dots(dec) == jdec
    attn = [s for s in cfg.layer_specs if s.mixer in ("attn", "mla")]
    k = pre["kernels"]["flash_attention"]
    assert k["calls"] == len(attn)
    D = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
         if cfg.mla else cfg.head_dim)
    per = 4.0 * cfg.n_heads * D * SERVE_B * SERVE_S * (SERVE_S + 1) // 2
    assert k["flops"] == per * len(attn)
    assert "flash_attention" not in dec["kernels"]


# -- the counter ---------------------------------------------------------------

def test_counter_peak_follows_storages():
    """A known case on the CPU: 4 MB, then 8 MB beside it, the first freed,
    a view of the second and an in-place op (no new storage), then 2 MB:
    the peak is 12 MB, 10 MB live at the end."""
    mb = 1 << 20
    with Counter("cpu") as c:
        a = torch.empty(mb, dtype=torch.float32)
        b = torch.zeros(2 * mb, dtype=torch.float32)
        del a
        v = b[:10].view(2, 5)
        b.add_(1.0)
        d = torch.empty(mb // 2, dtype=torch.float32)
    assert c.peak == 12 * mb
    assert c.live == 10 * mb
    del b, v, d


def test_kernel_on_cpu_counted_once():
    """A wrapper called on CPU tensors under a counter records its own work
    once, and the plain version's ops inside are not counted again."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 4, 64, generator=g)
    k = torch.randn(2, 16, 2, 64, generator=g)
    x = torch.randn(8, 64, generator=g)
    w = torch.ones(64)
    with Counter("cpu") as c:
        FA_fn(q, k, k, causal=True)
        rmsnorm_fn(x, w)
    assert c.flops_by_op == {}
    assert c.kernels["flash_attention"]["calls"] == 1
    assert c.kernels["rmsnorm"]["calls"] == 1
    fb, ff, fd = FA.flash_work(2, 16, 4, 2, 64, torch.float32)
    nb, nf, nd = RMS.norm_work(8, 64, torch.float32, False)
    assert c.flops == {"float32": ff + nf}
    assert c.bytes == fb + nb
    assert count.ACTIVE is None


def test_no_counter_no_record(monkeypatch):
    """With no counter active a wrapper reads no work: it tests
    ``count.ACTIVE`` and calls its kernel (here the plain version)."""
    def unread(*args):
        raise AssertionError("a kernel's work read with no counter active")

    for mod, name in ((FA, "flash_work"), (FA, "flash_bwd_work"),
                      (RMS, "norm_work"), (RMS, "norm_bwd_work")):
        monkeypatch.setattr(mod, name, unread)
    assert count.ACTIVE is None
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 64, generator=g, requires_grad=True)
    x = torch.randn(4, 64, generator=g, requires_grad=True)
    w = torch.ones(64, requires_grad=True)
    FA_fn(q, q, q, causal=True).sum().backward()
    y, s = rmsnorm_residual(x, x, w)
    (y.sum() + s.sum() + rmsnorm_fn(x, w).sum()).backward()
    assert q.grad is not None and x.grad is not None and w.grad is not None


def test_meta_branch_shapes_and_no_launch():
    """On meta each wrapper gives its kernel's outputs (o, dq/dk/dv, y, s,
    dx, dw) at the kernel's shapes and dtypes and counts no launch."""
    launches = [FA_fn.launches, FA.flash_bwd_dq.launches,
                FA.flash_bwd_dkdv.launches, rmsnorm_fn.launches,
                rmsnorm_residual.launches, rmsnorm_bwd.launches,
                rmsnorm_residual_bwd.launches]
    m = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(2, 128, 8, 64, requires_grad=True, **m)
    kv = torch.empty(2, 128, 2, 64, requires_grad=True, **m)
    with Counter("meta") as c:
        o = FA_fn(q, kv, kv, causal=True)
        o.sum().backward()
        x = torch.empty(256, 768, **m)
        w = torch.empty(768, device="meta")
        y, s = rmsnorm_residual(x, x, w)
        dx, dw = rmsnorm_bwd(x, w, x)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert q.grad.shape == q.shape and kv.grad.shape == kv.shape
    assert (y.shape, s.shape, dx.shape, dw.shape, dw.dtype) == (
        x.shape, x.shape, x.shape, (768,), torch.float32)
    assert launches == [FA_fn.launches, FA.flash_bwd_dq.launches,
                        FA.flash_bwd_dkdv.launches, rmsnorm_fn.launches,
                        rmsnorm_residual.launches, rmsnorm_bwd.launches,
                        rmsnorm_residual_bwd.launches]
    assert {k: v["calls"] for k, v in c.kernels.items()} == {
        "flash_attention": 1, "flash_attention_bwd": 1,
        "rmsnorm_residual": 1, "rmsnorm_bwd": 1}
    assert c.kernels["flash_attention_bwd"]["flops"] == FA.flash_bwd_work(
        2, 128, 8, 2, 64, torch.bfloat16)[1]


def test_f32_key_split_scratch_planned_for_the_h100():
    """On meta the f32 forward plans the H100's key split and allocates its
    scratch, so a dry run's peak sees it."""
    m = dict(device="meta", dtype=torch.float32)
    q = torch.empty(1, 512, 12, 64, **m)
    kv = torch.empty(1, 512, 4, 64, **m)
    with Counter("meta") as c, torch.inference_mode():
        FA_fn(q, kv, kv, causal=True)
    splits = FA.key_splits(1, 512, 12, torch.float32, count.H100_SMS)
    assert splits > 1
    assert c.peak == (q.numel() + splits * 12 * 512 * 66) * 4


def test_train_step_counts_equal_on_cpu_and_meta():
    """tacc-100m's smoke step, 2 microbatches, on the CPU with values and on
    meta: every op's FLOPs by dtype, bytes and each kernel's calls and
    work agree (the card's run is held to meta the same way in
    chip_smoke.py phase 20)."""
    cfg = get_config("tacc-100m", smoke=True)
    ocfg = OptConfig()
    tcfg = TrainConfig(n_microbatches=2)
    shape = ShapeConfig("t", 16, 4, "train")
    state = init_train_state(cfg, ocfg, torch.Generator().manual_seed(0),
                             "cpu")
    batch = to_torch(SyntheticLM(cfg, 4, 16).batch(0), "cpu")
    cpu, _ = dryrun.measure(build_train_step(cfg, ocfg, tcfg), state, batch,
                            track="cpu")
    ms, mb, _ = dryrun.train_args(cfg, ocfg, shape, n_micro=2)
    meta, _ = dryrun.measure(build_train_step(cfg, ocfg, tcfg), ms, mb)
    for k in ("flops_by_dtype", "flops_by_op", "bytes_accessed", "kernels",
              "ops"):
        assert cpu[k] == meta[k], k
    assert meta["memory"]["argument_bytes"] == cpu["memory"][
        "argument_bytes"]
    assert meta["memory"]["alias_bytes"] > 0
    assert meta["kernels"]["flash_attention"]["calls"] == (
        2 * 2 * cfg.n_layers)                   # 2 microbatches, remat


def test_meta_memo_changes_no_count():
    """On meta the counter remakes a seen op's outputs from its memo: the
    counts and the peak are those of running every op."""
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    ocfg, tcfg = OptConfig(), TrainConfig(n_microbatches=2)
    shape = ShapeConfig("t", 16, 4, "train")
    recs = []
    for memo in (False, True):
        ms, mb, _ = dryrun.train_args(cfg, ocfg, shape, n_micro=2)
        step = build_train_step(cfg, ocfg, tcfg)
        with Counter("meta", memo=memo) as c:
            step(ms, mb)
        recs.append(c.report())
    assert recs[0] == recs[1]
    assert recs[1]["peak_bytes"] > 0 and recs[1]["flops"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_cells_on_the_tiny_mesh(kind, tmp_path):
    """The three traces at smoke size on the tiny (pod 2, data 2, model 2)
    dry mesh, MoE through moe_ep; then roofline_torch and
    compare_profiles_torch read their artifacts."""
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    mesh = dryrun.dry_mesh("tiny")
    shape = {"train": ShapeConfig("train_4k", 32, 16, "train"),
             "prefill": ShapeConfig("prefill_32k", 32, 8, "prefill"),
             "decode": ShapeConfig("decode_32k", 32, 8, "decode")}[kind]
    plan = dryrun.make_plan(cfg, shape, mesh)
    kw = {"n_micro": 2} if kind == "train" else {}
    rec = getattr(dryrun, f"trace_{kind}")(cfg, shape, mesh, plan, **kw)
    assert rec["flops"] > 0 and rec["memory"]["peak_bytes_est"] > 0
    kinds = set(rec["collectives"])
    assert "all-to-all" in kinds and kinds <= set(C.KINDS)
    if kind == "train":
        assert rec["collectives"]["all-reduce"]["interpod_bytes"] > 0
    cell = {"arch": "qwen2-moe-a2.7b", "shape": shape.name, "mesh": "tiny",
            "status": "ok", "mesh_shape": {"pod": 2, "data": 2, "model": 2},
            "full": rec}
    for d in ("base", "opt"):
        (tmp_path / d).mkdir()
        (tmp_path / d / f"x__{shape.name}__tiny.json").write_text(
            json.dumps(cell))
    rows = roofline_torch.run(str(tmp_path / "base"), str(tmp_path / "out"),
                              ["tiny"])
    assert len(rows) == 1 and rows[0]["dominant"] in (
        "compute", "memory", "collective")
    assert (tmp_path / "out" / "roofline.md").exists()
    lines = compare_profiles_torch.main([
        "--baseline", str(tmp_path / "base"), "--optimized",
        str(tmp_path / "opt"), "--mesh", "tiny", "--out",
        str(tmp_path / "cmp.md")])
    assert len(lines) == 3


def test_jobs_trace_cells_as_one_process_does(tmp_path):
    """``main --jobs 2`` traces each cell in a process of its own: the
    records of :func:`dryrun.run_cell` in this process, ``summary.json``
    in the cells' order, exit 0."""
    out = tmp_path / "dry"
    assert dryrun.main(["--arch", "tacc-100m", "--shape", "decode_32k",
                        "--mesh", "both", "--jobs", "2",
                        "--out", str(out)]) == 0
    summary = json.loads((out / "summary.json").read_text())
    assert [(c["cell"], c["status"]) for c in summary] == [
        (f"tacc-100m__decode_32k__{m}", "ok") for m in ("single", "multi")]
    for mesh in ("single", "multi"):
        rec = json.loads((out / f"tacc-100m__decode_32k__{mesh}.json"
                          ).read_text())
        here = json.loads(json.dumps(dryrun.run_cell(
            "tacc-100m", "decode_32k", mesh)))
        assert rec["status"] == here["status"] == "ok"
        for k in ("flops", "flops_by_dtype", "bytes_accessed", "kernels",
                  "memory", "collectives"):
            assert rec["full"][k] == here["full"][k], k


def test_pod_fsdp_rules_reach_the_training_plan():
    cfg = get_config("llama3-405b")
    view = dryrun.dry_mesh("multi")
    plan = train_plan(cfg, view, POD_FSDP_RULES)
    assert plan["layers.0.mixer.wq"][0] == ("pod", "data")
    assert train_plan(cfg, view)["layers.0.mixer.wq"][0] == "data"


def test_skipped_cell_keeps_jax_reason():
    rec = dryrun.run_cell("llama3-405b", "long_500k", "single")
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]


def test_moe_dispatch_on_meta_names_r8():
    from repro_torch.models import moe as MOE
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    flat = torch.empty(4, cfg.d_model, device="meta")
    idx = torch.zeros(4, cfg.moe.top_k, dtype=torch.long, device="meta")
    with pytest.raises(NotImplementedError, match="R8"):
        MOE.dispatch_routed(cfg, {}, flat, idx, idx.float())


# -- a dry rank's collectives against a live gloo rank's -----------------------

def _tp6(cfg):
    """tacc-100m smoke with 6 query heads and 2 KV heads, on MESH14: the
    model axis of 4 splits wq's 96 columns, 24 a rank, but not whole
    heads."""
    return dataclasses.replace(cfg, n_heads=6)


def _tally_rank(rank, cases):
    """One rank of a 4-rank world: per case, on its mesh, the live step's
    tally, metrics and gradients, the attention leaves it gathered whole
    (``all_gather(..., invariant=True)`` from ``models/attention.py``),
    and a dry rank's tally on ``Mesh.view(..., dry=True)``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention as A
    whole = []
    gather = A.all_gather

    def counted(*args, invariant=False, **kw):
        whole.append(invariant)
        return gather(*args, invariant=invariant, **kw)

    A.all_gather = counted
    out = {}
    for name, cfg, mesh_spec, tree, batches in cases:
        mesh = make_mesh(*mesh_spec)
        axes = train_batch_axes(mesh)
        ocfg = OptConfig()
        flags = dryrun.RunFlags(distributed=True, token_axes=axes)
        state = (init_train_state(cfg, ocfg, torch.Generator().manual_seed(0),
                                  "cpu", mesh=mesh) if tree is None else
                 state_from_jax(cfg, tree, "cpu", mesh=mesh))
        step = build_train_step(cfg, ocfg, TrainConfig(), mesh=mesh,
                                flags=flags, keep_grads=True)
        C.reset_stats()
        whole.clear()
        state, m = step(state, {k: batch_rows(v, mesh, axes)
                                for k, v in batches.items()})
        live, n_whole = C.STATS["by_kind"], sum(whole)
        view = Mesh.view(*mesh_spec, rank, dry=True)
        rows = next(iter(batches.values())).shape[0]
        ms, mb, _ = dryrun.train_args(cfg, ocfg, ShapeConfig(
            "t", 16, rows, "train"), view)
        dry, _ = dryrun.measure(dryrun.quiet_moe(build_train_step(
            cfg, ocfg, TrainConfig(), mesh=view, flags=flags,
            keep_grads=True)), ms, mb)
        out[name] = {"live": live, "dry": dry["collectives"],
                     "whole_gathers": n_whole, "grads": step.grads,
                     "metrics": {k: float(m[k])
                                 for k in ("loss", "grad_norm")}}
    A.all_gather = gather
    return out


@pytest.fixture(scope="module")
def tallies(tmp_path_factory):
    """The 4-rank spawn, and for the 6-head case the references from JAX's
    state (key 0): JAX's jitted single-device step's metrics, and the
    port's single-process step's metrics and gradients."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.train import OptConfig as JaxOptConfig
    from repro.train import build_train_step as jax_build_train_step
    from repro.train import init_train_state as jax_init_train_state
    from test_torch_train_mesh import _spawn, _tensors
    tacc = get_config("tacc-100m", smoke=True).smoke(dtype="float32")
    moe = get_config("qwen2-moe-a2.7b", smoke=True).smoke(dtype="float32")
    moe = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, capacity_factor=8.0))
    jcfg = _tp6(jax_get_config("tacc-100m", smoke=True).smoke(
        dtype="float32"))
    jstate = jax_init_train_state(jcfg, JaxOptConfig(), jax.random.PRNGKey(0))
    tree = _tensors(jax.tree.map(np.asarray, jstate))
    cases, jbatch = [], None
    for name, cfg, mesh_spec, init in (("dense", tacc, MESH22, None),
                                       ("moe", moe, MESH22, None),
                                       ("tp6", _tp6(tacc), MESH14, tree)):
        b = SyntheticLM(cfg, 4, 16, seed=0).batch(0)
        cases.append((name, cfg, mesh_spec, init, to_torch(b, "cpu")))
        jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    res = _spawn(tmp_path_factory.mktemp("tally"), 4, _tally_rank, cases)
    _, cfg, _, _, batches = cases[2]
    _, jm = jax.jit(jax_build_train_step(jcfg, JaxOptConfig()))(jstate,
                                                                jbatch)
    step = build_train_step(cfg, OptConfig(), TrainConfig(), keep_grads=True)
    _, m = step(state_from_jax(cfg, tree, "cpu"), batches)
    ref = {"jax": {k: float(jm[k]) for k in ("loss", "grad_norm")},
           "single": {k: float(m[k]) for k in ("loss", "grad_norm")},
           "grads": dict(step.grads)}
    return cases, res, ref


@pytest.mark.parametrize("name", ["dense", "moe", "tp6"])
def test_dry_tally_equals_live_gloo_rank(tallies, name):
    _, res, _ = tallies
    for r in res:
        assert r[name]["dry"] == r[name]["live"], r[name]
        assert set(r[name]["live"]) <= set(C.KINDS)
        assert all(v["count"] > 0 and v["interpod_bytes"] == 0
                   for v in r[name]["live"].values())


def test_heads_split_by_column_train_as_one_process(tallies):
    """6 query heads over a model axis of 4 (wq's 96 columns split 24 a
    rank): every rank gathers the attention leaves whole (and the dense
    case, whose heads the axis divides, never does); every rank's loss and
    grad norm are within rel 1e-5 of the port's single process and of
    JAX's jitted step from the same state, and every gradient leaf,
    gathered whole, within rel 1e-5 of the single process's."""
    from test_torch_train_mesh import _whole
    cases, res, ref = tallies
    _, cfg, mesh_spec, _, _ = cases[2]
    plan = train_plan(cfg, Mesh.view(*mesh_spec, 0))
    assert "model" in str(plan["layers.0.mixer.wq"])
    assert cfg.n_heads % 4 and cfg.n_heads * cfg.head_dim % 4 == 0
    for r in res:
        assert r["tp6"]["whole_gathers"] > 0 and r["dense"][
            "whole_gathers"] == 0
        for k, got in r["tp6"]["metrics"].items():
            for want in (ref["single"][k], ref["jax"][k]):
                assert abs(got - want) <= 1e-5 * abs(want), k
    assert set(res[0]["tp6"]["grads"]) == set(ref["grads"])
    for name, g in ref["grads"].items():
        whole = _whole(cfg, name, [r["tp6"]["grads"][name] for r in res],
                       plan[name], mesh_spec[0])
        scale = float(g.abs().max()) + 1e-30
        assert float((whole - g).abs().max()) / scale < 1e-5, name
