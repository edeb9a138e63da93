"""The port's training over a mesh of gloo ranks on the CPU, held to the
reference on the same state and batches: each autograd collective's
backward against its transpose, the FSDP + TP train step against JAX's
single-device step at the reference check's bars
(tests/distributed_checks.py:192) and against the port's own single
process, ``moe_ep``'s gradients against ``jax.grad`` of JAX's dense oracle
(distributed_checks.py:61, :98), the vocab-parallel cross-entropy, the
state and batch specs, a mesh checkpoint in JAX's ``Checkpointer``, the
launcher under ``torch.distributed.run``, and the remat path's flags.

Each mesh is one ``torch.multiprocessing.spawn`` of its ranks (a ``file://``
store under a temporary directory); the ranks import no ``jax``, and their
results come back through ``torch.save``.
"""
import dataclasses
import datetime
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.ckpt import Checkpointer, restore_checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import moe as TM
from repro_torch.models import state_from_jax, state_to_jax
from repro_torch.models.params import (DEFAULT_RULES, POD_FSDP_RULES,
                                       grouped_columns, train_plan)
from repro_torch.models.transformer import RunFlags, Transformer
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (batch_rows, gather_shards,
                                           local_shard, train_batch_axes)
from repro_torch.train import (IGNORE, OptConfig, TrainConfig,
                               build_train_step, cross_entropy,
                               init_train_state)
from repro_torch.train.step import batch_shardings, state_shardings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH24 = ((2, 4), ("data", "model"))
MESH22 = ((2, 2), ("data", "model"))
F32 = {"dtype": "float32"}
# the reference check's step: lr 1e-3, 2 warmup steps, 2 microbatches of
# a global batch of 8 rows of 32 tokens
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=50)
MICRO, STEPS = 2, 2
MOE_ARCH = "qwen2-moe-a2.7b"
EP8 = dict(capacity_factor=8.0, n_experts=8, pad_to=8)


# -- spawning ranks ----------------------------------------------------------

def _rank_main(rank, world, store, out, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(fn(rank, *args), os.path.join(out, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp, world, fn, *args):
    """Each rank's return value of ``fn(rank, *args)``, in rank order."""
    out = tmp / "out"
    out.mkdir()
    mp.spawn(_rank_main, args=(world, str(tmp / "store"), str(out), fn,
                               args), nprocs=world, join=True)
    return [torch.load(out / f"{r}.pt") for r in range(world)]


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tensors(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _torch(v):
    """A batch leaf as a tensor: token ids as int64, embeddings as they
    are."""
    t = torch.from_numpy(np.asarray(v))
    return t if t.is_floating_point() else t.long()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _moved(p, ref, p0):
    """How ``p`` moved from ``p0`` against how ``ref`` moved: the cosine
    of (p - p0) with (ref - p0), and max |p - ref| over max |ref - p0|.
    A bar on the params after a few AdamW steps is a share of their move
    (about the summed lr an entry), not of their size."""
    d = (p - p0).double().flatten()
    r = (ref - p0).double().flatten()
    if not float(r.abs().max()) and not float(d.abs().max()):
        return 1.0, 0.0
    cos = float(d @ r / (d.norm() * r.norm()).clamp_min(1e-300))
    return cos, float((d - r).abs().max() / r.abs().max().clamp_min(1e-300))


def _whole(cfg, name, blocks, spec, shape):
    """Leaf ``name`` whole in JAX's column order from every rank's block,
    put together here (not by the collectives under test)."""
    view = Mesh.view(shape, ("data", "model"), 0)
    t = gather_shards(blocks, spec, view)
    cols = grouped_columns(cfg, name, t.shape, spec, view)
    return t if cols is None else t[..., torch.argsort(cols)]


def _tacc(get):
    return get("tacc-100m", smoke=True).smoke(**F32)


def _batches(cfg, seq=32):
    data = SyntheticLM(cfg, 8, seq, seed=0)
    return [data.batch(i) for i in range(STEPS)]


def _smoke(arch):
    """An arch's smoke config in f32, MoE at capacity factor 8."""
    cfg = get_config(arch, smoke=True).smoke(**F32)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


# -- the train step on a rank ------------------------------------------------

def _train(mesh, cfg, tree, batches, **kw):
    """``STEPS`` mesh steps from the whole state ``tree`` (JAX's layout),
    each rank taking its blocks and rows: per step the metrics and the
    collectives' counts, step 1's gradients and the final state (blocks)."""
    state = state_from_jax(cfg, tree, "cpu", mesh=mesh)
    axes = train_batch_axes(mesh)
    step = build_train_step(
        cfg, OptConfig(**OCFG), TrainConfig(MICRO), mesh=mesh,
        flags=RunFlags(distributed=True, token_axes=axes), keep_grads=True,
        **kw)
    out = {"metrics": [], "stats": []}
    for i, b in enumerate(batches):
        rows = {k: batch_rows(_torch(v), mesh, axes, MICRO)
                for k, v in b.items()}
        C.reset_stats()
        state, m = step(state, rows)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["stats"].append(dict(C.STATS))
        if i == 0:
            out["grads"] = {k: v.clone() for k, v in step.grads.items()}
    out["state"] = state
    return out


def _collective_cases(rank, mesh):
    """Each differentiable collective on seeded inputs, with a seeded
    cotangent, and the gradient its backward gives: {name: (x, c, y, g)}.
    An invariant input or cotangent is drawn from the group's seed, so it
    is the same on every rank of the group."""
    gen = lambda seed, *s: torch.randn(  # noqa: E731
        *s, generator=torch.Generator().manual_seed(seed),
        dtype=torch.float64)
    group = 100 + mesh.coords["data"]          # the "model" group's seed
    cases = {
        "all_gather_0": (lambda x: C.all_gather(x, "model", mesh),
                         gen(rank, 3, 2), gen(50 + rank, 12, 2)),
        "all_gather_1": (lambda x: C.all_gather(x, ("model", "data"), mesh,
                                                dim=1),
                         gen(rank, 2, 3), gen(50 + rank, 2, 24)),
        "psum_scatter_0": (lambda x: C.psum_scatter(x, "model", mesh),
                           gen(rank, 8, 2), gen(50 + rank, 2, 2)),
        "psum_scatter_1": (lambda x: C.psum_scatter(x, "model", mesh, dim=1),
                           gen(rank, 2, 8), gen(50 + rank, 2, 2)),
        "all_to_all": (lambda x: C.all_to_all(x, ("model", "data"), mesh),
                       gen(rank, 8, 3), gen(50 + rank, 8, 3)),
        "pvary": (lambda x: C.pvary(x, "model", mesh), gen(group, 5),
                  gen(50 + rank, 5)),
        "psum": (lambda x: C.psum(x, "model", mesh), gen(rank, 5),
                 gen(group + 50, 5)),
        "all_gather_invariant": (
            lambda x: C.all_gather(x, "model", mesh, invariant=True),
            gen(rank, 2, 3), gen(group + 50, 8, 3)),
    }
    out = {}
    for name, (fn, x, c) in cases.items():
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (y * c).sum().backward()
        out[name] = (x.detach(), c, y.detach(), x.grad)
    return out


def _moe_grads(mesh, p, xs, local):
    """moe_ep's gradients of sum(y^2) + the load-balance loss (the
    reference check's loss), each rank on its rows, for both combines:
    the experts and router whole, or (``local``) as this rank's blocks."""
    cfg = dataclasses.replace(get_config(MOE_ARCH, smoke=True),
                              moe=dataclasses.replace(
                                  get_config(MOE_ARCH, smoke=True).moe,
                                  **EP8))
    out = []
    for combine, x in zip(("psum", "allgather"), xs):
        split = {"w_in": ("model",), "w_out": ("model",),
                 "router": (None, "model")} if local[combine] else {}
        leaves = {k: local_shard(v, split.get(k, ()), mesh).clone()
                  .requires_grad_(True) for k, v in p.items()}
        y, aux = TM.moe_ep(cfg, leaves, local_shard(x, ("data",), mesh),
                           ep_axis="model", token_axes=("data",),
                           combine=combine, mesh=mesh,
                           tp_split=frozenset(split))
        loss = (y ** 2).sum() + aux["moe_load_balance"]
        loss.backward()
        out.append({k: v.grad for k, v in leaves.items()})
    return out


def _ce_rank(mesh, logits, labels):
    """The vocab-parallel cross-entropy of this rank's block (rows over
    data, vocab over model), its stats and the gradient of its logits."""
    mine = local_shard(logits, ("data", None, "model"), mesh).clone()
    mine.requires_grad_(True)
    loss, stats = cross_entropy(mine, local_shard(labels, ("data",), mesh),
                                mesh=mesh)
    loss.backward()
    return {"loss": loss.detach(), "stats": stats, "grad": mine.grad}


def _ranks_24(rank, tree, batches, moe_p, xs, logits, labels):
    mesh = make_mesh(*MESH24)
    out = {"collectives": _collective_cases(rank, mesh)}
    out["train"] = _train(mesh, _tacc(get_config), tree, batches)
    out["moe"] = _moe_grads(mesh, moe_p, xs,
                            {"psum": True, "allgather": False})
    out["ce"] = _ce_rank(mesh, logits, labels)
    return out


def _ranks_22(rank, tree, batches, ckpt, archs):
    mesh = make_mesh(*MESH22)
    cfg = _tacc(get_config)
    out = {"train": _train(mesh, cfg, tree, batches)}
    Checkpointer(ckpt, writer=rank == 0).save(
        STEPS, state_to_jax(cfg, out["train"]["state"], mesh=mesh),
        block=True)
    dist.barrier()
    # every config, one step on this mesh
    out["archs"] = {}
    for arch, whole in archs.items():
        c = _smoke(arch)
        res = _train(mesh, c, whole, _batches(c, 16)[:1])
        out["archs"][arch] = {"metrics": res["metrics"],
                              "grads": res["grads"]}
    return out


# -- fixtures ----------------------------------------------------------------

def _single(cfg, tree, batches):
    """The port's own single-process step from the same state: metrics,
    step 1's gradients, the final params."""
    state = state_from_jax(cfg, tree, "cpu")
    step = build_train_step(cfg, OptConfig(**OCFG), TrainConfig(MICRO),
                            keep_grads=True)
    metrics, grads = [], None
    for b in batches:
        state, m = step(state, {k: _torch(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        grads = grads or {k: v.clone() for k, v in step.grads.items()}
    return {"metrics": metrics, "grads": grads, "params": state["params"]}


@pytest.fixture(scope="module")
def reference():
    """tacc-100m smoke in f32: JAX's state from key 0 (JAX's layout), the
    batches, JAX's jitted single-device step over them (its metrics and
    final params under the port's names), and the port's single
    process."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.train import OptConfig as JaxOptConfig
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import build_train_step as jax_build_train_step
    from repro.train import init_train_state as jax_init_train_state
    from repro_torch.models import params_from_jax
    jcfg = _tacc(jax_get_config)
    cfg = _tacc(get_config)
    state = jax_init_train_state(jcfg, JaxOptConfig(**OCFG),
                                 jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, state)
    batches = _batches(cfg)
    step = jax.jit(jax_build_train_step(jcfg, JaxOptConfig(**OCFG),
                                        JaxTrainConfig(MICRO)))
    jm = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append({k: float(v) for k, v in m.items()})
    jparams = params_from_jax(cfg, jax.tree.map(np.asarray, state["params"]))
    return {"cfg": cfg, "tree": tree, "batches": batches, "jax": jm,
            "jax_params": jparams,
            "single": _single(cfg, _tensors(tree), batches)}


def _moe_inputs():
    """One MoE layer at JAX's init and the reference check's tokens: (4, 8)
    for the psum combine, (4, 10) for the all-gather (20 rows a data
    shard, not divisible by the 4 EP ranks)."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import init_params
    from repro.models.moe import moe_defs
    jcfg = jax_get_config(MOE_ARCH, smoke=True)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **EP8))
    p = {k: np.asarray(v) for k, v in
         init_params(moe_defs(jcfg), jax.random.PRNGKey(0)).items()}
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal(s + (jcfg.d_model,)).astype(np.float32)
          for s in ((4, 8), (4, 10))]
    return jcfg, p, xs


def _ce_inputs():
    """Logits (4, 6, 32) with argmax ties planted across and within the
    vocab blocks of 8, labels with IGNORE."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 6, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (4, 6))
    labels[1, :3] = IGNORE
    labels[3, 5] = IGNORE
    for (b, s), (i, j), lab in (((0, 0), (5, 21), 21), ((0, 1), (7, 30), 7),
                                ((0, 2), (2, 3), 3), ((2, 4), (16, 31), 16),
                                ((3, 0), (9, 25), 25)):
        logits[b, s, i] = logits[b, s, j] = 9.0
        labels[b, s] = lab
    return logits, labels


@pytest.fixture(scope="module")
def ranks_24(reference, tmp_path_factory):
    jcfg, moe_p, xs = _moe_inputs()
    logits, labels = _ce_inputs()
    res = _spawn(tmp_path_factory.mktemp("train24"), 8, _ranks_24,
                 _tensors(reference["tree"]), reference["batches"],
                 _tensors(moe_p), _tensors(xs), torch.from_numpy(logits),
                 torch.from_numpy(labels))
    return {"res": res, "moe": (jcfg, moe_p, xs), "ce": (logits, labels)}


@pytest.fixture(scope="module")
def ranks_22(reference, tmp_path_factory):
    from repro_torch.models import state_to_jax as to_jax
    tmp = tmp_path_factory.mktemp("train22")
    archs = {}
    for arch in sorted(list_archs()):
        c = _smoke(arch)
        st = init_train_state(c, OptConfig(**OCFG),
                              torch.Generator().manual_seed(1), "cpu")
        archs[arch] = to_jax(c, st)
    res = _spawn(tmp, 4, _ranks_22, _tensors(reference["tree"]),
                 reference["batches"], str(tmp / "ckpt"), archs)
    return {"res": res, "ckpt": str(tmp / "ckpt"), "archs": archs}


# -- the collectives ---------------------------------------------------------

def _expected_grads(name, views, cases):
    """The transpose of each collective applied to the cotangents, from
    its definition over the ranks' positions (here, not by the module)."""
    model = lambda r: [q for q, v in enumerate(views)  # noqa: E731
                       if v.coords["data"] == views[r].coords["data"]]
    pos = lambda r: views[r].coords["model"]  # noqa: E731
    c = {r: cases[r][name][1] for r in range(len(views))}
    out = {}
    for r in range(len(views)):
        mates = model(r)
        if name == "all_gather_0":
            out[r] = sum(c[s].reshape(4, 3, 2)[pos(r)] for s in mates)
        elif name == "all_gather_1":
            i = views[r].axis_index(("model", "data"))
            out[r] = sum(c[s].reshape(2, 8, 3)[:, i] for s in range(8))
        elif name == "psum_scatter_0":
            out[r] = torch.cat([c[s] for s in sorted(mates, key=pos)])
        elif name == "psum_scatter_1":
            out[r] = torch.cat([c[s] for s in sorted(mates, key=pos)], 1)
        elif name == "all_to_all":
            key = lambda q: views[q].axis_index(("model", "data"))  # noqa
            me = key(r)
            out[r] = torch.cat([c[s].reshape(8, 1, 3)[me]
                                for s in sorted(range(8), key=key)])
        elif name == "pvary":
            out[r] = sum(c[s] for s in mates)
        elif name == "psum":
            out[r] = c[r]
        elif name == "all_gather_invariant":
            out[r] = c[r].reshape(4, 2, 3)[pos(r)]
    return out


@pytest.mark.parametrize("name", [
    "all_gather_0", "all_gather_1", "psum_scatter_0", "psum_scatter_1",
    "all_to_all", "pvary", "psum", "all_gather_invariant"])
def test_collective_backward_is_its_transpose(ranks_24, name):
    """8 ranks (data 2, model 4): each collective's gradient equals its
    transpose applied to the cotangents (all_gather <-> psum_scatter along
    dim 0 and 1, all_to_all <-> itself over axes out of the mesh's order,
    pvary <-> psum, an invariant all_gather <-> this rank's block), in
    f64, exactly up to the sums' rounding."""
    cases = [r["collectives"] for r in ranks_24["res"]]
    views = [Mesh.view(*MESH24, r) for r in range(8)]
    want = _expected_grads(name, views, cases)
    for r in range(8):
        torch.testing.assert_close(cases[r][name][3], want[r], rtol=1e-12,
                                   atol=1e-12, msg=f"rank {r}")
    if name == "pvary":          # the forward is the identity
        assert all(torch.equal(cases[r][name][0], cases[r][name][2])
                   for r in range(8))


# -- the train step ----------------------------------------------------------

def _check_step(reference, ranks, shape):
    """The reference check's bars against JAX (loss abs < 2e-3, every param
    within 5e-3 after the steps) and the port's single process at rel
    1e-5 (loss, grad norm, every leaf of step 1's gradient). The params'
    5e-3 is above two steps' whole move (lr 1e-3), so each leaf's move from
    the initial state is held too (:func:`_moved`): its cosine to JAX's
    move and to the single process's, and its largest difference from the
    single process's as a share of that move. Measured on a CPU with one
    thread a rank, on both meshes: loss within 9.6e-7 of JAX's, params
    within 1.6e-4 of JAX's and 4.9e-6 of the single process's, loss and
    grad norm within rel 1e-7 and every gradient leaf within rel 1.2e-6 of
    the single process's."""
    cfg = reference["cfg"]
    plan = train_plan(cfg, Mesh.view(shape, ("data", "model"), 0))
    single = reference["single"]
    p0 = state_from_jax(cfg, _tensors(reference["tree"]), "cpu")["params"]
    worst = {"jax_cos": 1.0, "single_cos": 1.0, "single_share": 0.0}
    for r in ranks:
        for i, (m, jm, sm) in enumerate(zip(r["train"]["metrics"],
                                            reference["jax"],
                                            single["metrics"])):
            assert abs(m["loss"] - jm["loss"]) < 2e-3, (i, m, jm)
            for k in ("loss", "grad_norm", "ce", "param_norm"):
                assert abs(m[k] - sm[k]) <= 1e-5 * abs(sm[k]), (i, k)
            assert m["tokens"] == sm["tokens"] and m["step"] == i + 1
    for name, spec in plan.items():
        blocks = [r["train"]["grads"][name] for r in ranks]
        g = _whole(cfg, name, blocks, spec, shape)
        assert _rel(g, single["grads"][name]) < 1e-5, name
        p = _whole(cfg, name, [r["train"]["state"]["params"][name]
                               for r in ranks], spec, shape)
        assert float((p - reference["jax_params"][name]).abs().max()) \
            < 5e-3, name
        assert float((p - single["params"][name]).abs().max()) < 1e-4, name
        jax_cos, _ = _moved(p, reference["jax_params"][name], p0[name])
        single_cos, share = _moved(p, single["params"][name], p0[name])
        worst = {"jax_cos": min(worst["jax_cos"], jax_cos),
                 "single_cos": min(worst["single_cos"], single_cos),
                 "single_share": max(worst["single_share"], share)}
    print("moved", shape, worst)
    assert worst["jax_cos"] >= 0.98, worst
    assert worst["single_cos"] >= 0.9999, worst
    assert worst["single_share"] < 0.02, worst


def test_mesh_step_matches_jax_on_2x4(reference, ranks_24):
    """(data 2, model 4): 2 KV heads over 4 model ranks, so each pair of
    ranks gathers and shares one KV head; 2 microbatches, each split over
    data in the reference's order."""
    _check_step(reference, ranks_24["res"], MESH24[0])


def test_mesh_step_matches_jax_on_2x2(reference, ranks_22):
    """(data 2, model 2): the KV heads split, so wkv is stored grouped."""
    _check_step(reference, ranks_22["res"], MESH22[0])


def test_mesh_step_counts_its_collectives(ranks_24, ranks_22):
    """Every rank of a mesh runs the same collectives (the counts agree)
    and the steps issue them, backward ones included; nothing is staged
    on the CPU."""
    for res in (ranks_24["res"], ranks_22["res"]):
        stats = [r["train"]["stats"] for r in res]
        assert all(s == stats[0] for s in stats)
        assert all(s["collectives"] > 0 and s["staged_bytes"] == 0
                   for s in stats[0])


def test_grouped_wkv_holds_whole_heads(ranks_22, reference):
    """On (data 2, model 2) with 4 KV heads a rank's wkv block is its 2 KV
    heads' K columns then their V columns, not JAX's contiguous half."""
    cfg = reference["cfg"]
    view = Mesh.view(MESH22[0], MESH22[1], 0)
    spec = train_plan(cfg, view)["layers.0.mixer.wkv"]
    wkv = torch.from_numpy(np.array(
        reference["tree"]["params"]["period"][0]["mixer"]["wkv"][0]))
    cfg22 = dataclasses.replace(cfg, n_kv_heads=4)
    cols = grouped_columns(cfg22, "layers.0.mixer.wkv",
                           (wkv.shape[0], 2 * 4 * cfg.head_dim), spec, view)
    hd = cfg.head_dim
    assert cols[:2 * hd].tolist() == list(range(2 * hd))
    assert cols[2 * hd:4 * hd].tolist() == list(range(4 * hd, 6 * hd))
    assert grouped_columns(cfg, "layers.0.mixer.wkv", wkv.shape, spec,
                           view) is not None       # 2 KV heads over 2
    assert grouped_columns(cfg, "layers.0.mixer.wkv", wkv.shape,
                           train_plan(cfg, Mesh.view((2, 4), MESH24[1], 0))
                           ["layers.0.mixer.wkv"],
                           Mesh.view((2, 4), MESH24[1], 0)) is None


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_every_config_trains_on_a_mesh(ranks_22, arch):
    """Each config's smoke model in f32, one step of 8 rows of 16 tokens
    on (data 2, model 2), tensor-parallel (biases, LayerNorm, qk-norm,
    GELU, the parallel block, vision and frame inputs, MoE, and the MLA,
    Mamba, mLSTM and sLSTM mixers). Loss and grad norm within rel 1e-5 of
    the port's single process, and every gradient leaf within rel 1e-5,
    or within 1e-8 where the leaf's gradient is zero but for rounding (the
    mLSTM's input-gate bias, whose shift the stabiliser cancels, reads
    1e-11 in both)."""
    cfg = _smoke(arch)
    single = _single(cfg, _tensors(ranks_22["archs"][arch]),
                     _batches(cfg, 16)[:1])
    shape = MESH22[0]
    plan = train_plan(cfg, Mesh.view(shape, ("data", "model"), 0))
    res = [r["archs"][arch] for r in ranks_22["res"]]
    for r in res:
        for k in ("loss", "grad_norm"):
            m, s = r["metrics"][0][k], single["metrics"][0][k]
            assert abs(m - s) <= 1e-5 * abs(s), k
    for name, spec in plan.items():
        g = _whole(cfg, name, [r["grads"][name] for r in res], spec, shape)
        ref = single["grads"][name]
        assert (_rel(g, ref) < 1e-5
                or float((g - ref).abs().max()) < 1e-8), name


def test_an_unread_leaf_gets_a_zero_gradient():
    """musicgen's frame inputs never read ``embed.tok``: the port's step
    gives it a zero gradient, as jax.grad does, where autograd would
    raise; the loss and grad norm equal JAX's jitted step's (rel 1e-5)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.train import OptConfig as JaxOptConfig
    from repro.train import build_train_step as jax_build_train_step
    from repro.train import init_train_state as jax_init_train_state
    arch = "musicgen-medium"
    jcfg = jax_get_config(arch, smoke=True).smoke(**F32)
    state = jax_init_train_state(jcfg, JaxOptConfig(**OCFG),
                                 jax.random.PRNGKey(0))
    cfg = _smoke(arch)
    b = _batches(cfg, 16)[0]
    ours = _single(cfg, _tensors(jax.tree.map(np.asarray, state)), [b])
    _, jm = jax.jit(jax_build_train_step(jcfg, JaxOptConfig(**OCFG)))(
        state, {k: jnp.asarray(v) for k, v in b.items()})
    assert not ours["grads"]["embed.tok"].any()
    for k in ("loss", "grad_norm"):
        assert abs(ours["metrics"][0][k] - float(jm[k])) \
            <= 1e-5 * abs(float(jm[k])), k


# -- moe_ep's gradient -------------------------------------------------------

@pytest.mark.parametrize("case", [0, 1], ids=["psum-local", "allgather-whole"])
def test_moe_ep_gradients_match_jax_oracle(ranks_24, case):
    """moe_ep over 4 EP ranks and 2 token shards at capacity factor 8:
    the gradients of w_in, w_out and router of sum(y^2) + the load-balance
    loss against jax.grad of JAX's dense oracle, rel 5e-3 of the largest
    (the reference check's bar); the psum combine with the experts and
    router held as each rank's blocks, the all-gather combine with them
    whole."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import moe_dense_oracle
    jcfg, p, xs = ranks_24["moe"]

    def loss(p, x):
        y, aux = moe_dense_oracle(jcfg, p, x)
        return jnp.sum(y ** 2) + aux["moe_load_balance"]

    ref = jax.grad(loss)({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(xs[case]))
    grads = [r["moe"][case] for r in ranks_24["res"]]
    views = [Mesh.view(*MESH24, r) for r in range(8)]
    local = case == 0
    for k in ("w_in", "w_out", "router"):
        if local:                # each EP rank's block, summed over data
            got = sum(torch.cat(
                [grads[r][k] for r in sorted(
                    (r for r in range(8) if views[r].coords["data"] == d),
                    key=lambda r: views[r].coords["model"])],
                dim=1 if k == "router" else 0) for d in (0, 1))
        elif k == "router":      # whole on every EP rank: one per shard
            got = sum(g[k] for g, v in zip(grads, views)
                      if v.coords["model"] == 0)
        else:                    # each rank's rows of its own experts
            got = sum(g[k] for g in grads)
        assert _rel(got.numpy(), np.asarray(ref[k])) < 5e-3, k


# -- the vocab-parallel loss -------------------------------------------------

def test_vocab_parallel_cross_entropy_matches_jax(ranks_24):
    """Logits split over 4 vocab ranks and 2 row shards, with IGNORE labels
    and argmax ties within and across the vocab blocks: the loss and every
    stat within rel 1e-6 of JAX's cross_entropy on the whole logits (the
    accuracy and tokens exact), and the gradient of the logits within rel
    1e-6 of jax.grad's."""
    import jax
    import jax.numpy as jnp
    from repro.train.loss import cross_entropy as jax_ce
    logits, labels = ranks_24["ce"]
    jl, js = jax_ce(jnp.asarray(logits), jnp.asarray(labels))
    jg = jax.grad(lambda x: jax_ce(x, jnp.asarray(labels))[0])(
        jnp.asarray(logits))
    res = [r["ce"] for r in ranks_24["res"]]
    for r in res:
        assert abs(float(r["loss"]) - float(jl)) <= 1e-6 * abs(float(jl))
        for k in ("ce", "z_loss"):
            assert abs(float(r["stats"][k]) - float(js[k])) \
                <= 1e-6 * abs(float(js[k])), k
        for k in ("accuracy", "tokens"):
            assert float(r["stats"][k]) == float(js[k]), k
    g = gather_shards([r["grad"] for r in res], ("data", None, "model"),
                      Mesh.view(*MESH24, 0))
    assert _rel(g.numpy(), np.asarray(jg)) < 1e-6


# -- specs, rows, checkpoints ------------------------------------------------

class FakeMesh:
    """Static stand-in with what both packages' plans read."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.axis_sizes = shape
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)


def _jax_path(cfg, name):
    """The reference's tree path of port leaf ``name`` and whether its leaf
    stacks the period's layers on a leading axis."""
    keys = name.split(".")
    if keys[0] != "layers":
        return "".join(f"['{k}']" for k in keys), False
    i, n_pre = int(keys[1]), len(cfg.prelayers)
    head = (f"['prelayers'][{i}]" if i < n_pre else
            f"['period'][{(i - n_pre) % len(cfg.period)}]")
    return head + "".join(f"['{k}']" for k in keys[2:]), i >= n_pre


@pytest.mark.parametrize("arch", sorted(list_archs()))
@pytest.mark.parametrize("shape,names,rules", [
    ((16, 16), ("data", "model"), "default"),
    ((2, 16, 16), ("pod", "data", "model"), "pod_fsdp")],
    ids=["16x16-default", "2x16x16-pod-fsdp"])
def test_state_and_batch_shardings_equal_jax(arch, shape, names, rules,
                                             monkeypatch):
    """state_shardings' spec tree (params and both moments under the
    rules, step replicated) and batch_shardings' specs against the
    reference's (repro/train/step.py:119-139) on a static mesh, each
    NamedSharding read as its spec."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config as jax_get_config
    from repro.models import params as JP
    from repro.train import step as JS
    for mod in (JS, JP):
        monkeypatch.setattr(mod, "NamedSharding", lambda m, spec: spec)
    mesh = FakeMesh(shape, names)
    rule = {"default": (DEFAULT_RULES, JP.DEFAULT_RULES),
            "pod_fsdp": (POD_FSDP_RULES, JP.POD_FSDP_RULES)}[rules]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ours = state_shardings(cfg, mesh, rule[0])
    theirs = JS.state_shardings(jcfg, mesh, rule[1])
    assert ours["opt"]["step"] == tuple(theirs["opt"]["step"]) == ()
    for part, jpart in ((ours["params"], theirs["params"]),
                        (ours["opt"]["m"], theirs["opt"]["m"]),
                        (ours["opt"]["v"], theirs["opt"]["v"])):
        leaves = {jax.tree_util.keystr(path): tuple(leaf)
                  for path, leaf in jax.tree_util.tree_leaves_with_path(
                      jpart, is_leaf=lambda x: isinstance(x, P))}
        for name, spec in part.items():
            path, stacked = _jax_path(cfg, name)
            want = leaves[path]
            assert spec == (want[1:] if stacked else want), name
    batch = {"tokens": np.zeros((8, 4)), "labels": np.zeros((8, 4)),
             "frame_embeds": np.zeros((8, 4, 2))}
    jb = JS.batch_shardings(mesh, ("pod", "data"), batch)
    assert batch_shardings(mesh, ("pod", "data"), batch) == {
        k: tuple(v) for k, v in jb.items()}
    assert batch_shardings(mesh, ("pod", "data"))(batch) == \
        batch_shardings(mesh, ("pod", "data"), batch)


def test_batch_rows_keep_the_reference_microbatch_split():
    """2 microbatches over 2 data ranks: rank d holds rows d of each
    microbatch's halves, so its microbatch i is microbatch i's block d."""
    t = torch.arange(8)
    for d in (0, 1):
        view = Mesh.view((2, 2), ("data", "model"), 2 * d + 1)
        rows = batch_rows(t, view, ("data",), 2)
        assert rows.tolist() == [2 * d, 2 * d + 1, 4 + 2 * d, 5 + 2 * d]
        assert batch_rows(t, view, ("data",), 1).tolist() == \
            list(range(4 * d, 4 * d + 4))


def test_mesh_checkpoint_restores_in_jax(ranks_22, reference):
    """The mesh run's checkpoint (gathered, written by rank 0) restores in
    JAX's Checkpointer bit-equal to the ranks' blocks put together here,
    in JAX's layout."""
    from repro.ckpt import Checkpointer as JaxCheckpointer
    import jax
    cfg = reference["cfg"]
    plan = train_plan(cfg, Mesh.view(MESH22[0], MESH22[1], 0))
    states = [r["train"]["state"] for r in ranks_22["res"]]

    def whole(get):
        return {k: _whole(cfg, k, [get(s)[k] for s in states], plan[k],
                          MESH22[0]) for k in plan}
    want = {"params": whole(lambda s: s["params"]),
            "opt": {"m": whole(lambda s: s["opt"]["m"]),
                    "v": whole(lambda s: s["opt"]["v"]),
                    "step": states[0]["opt"]["step"]}}
    want = state_to_jax(cfg, want)
    tree, man = JaxCheckpointer(ranks_22["ckpt"]).restore()
    assert man["step"] == STEPS
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_w) == len(flat_t)
    for path, leaf in flat_w:
        got = np.asarray(flat_t[path])
        assert got.dtype == leaf.numpy().dtype
        assert np.array_equal(got, leaf.numpy()), path


def _torchrun(args, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.launch.train",
         "--smoke", "--device", "cpu", "--mesh", "tiny"] + args,
        capture_output=True, text=True, timeout=240, cwd=cwd, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout


def test_launch_train_mesh_tiny_resumes_bit_equal(tmp_path):
    """``torch.distributed.run`` of ``launch.train --mesh tiny`` on 8 CPU
    ranks: 2 steps with a checkpoint at each; then, with the last one
    deleted, the same command restores step 1 and writes a step 2 equal
    leaf for leaf, bit for bit, to the unbroken run's."""
    ck = tmp_path / "ck"
    args = ["--steps", "2", "--ckpt-every", "1", "--ckpt-dir", str(ck)]
    out = _torchrun(args, tmp_path)
    assert "step     2 loss" in out and out.count("done") == 1
    first, _ = restore_checkpoint(str(ck), 2)
    shutil.rmtree(ck / "step_0000000002")
    out = _torchrun(args, tmp_path)
    assert "restored step 1" in out
    again, man = restore_checkpoint(str(ck), 2)
    assert man["step"] == 2

    def leaves(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{path}.{k}")
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                yield from leaves(v, f"{path}[{i}]")
        else:
            yield path, t
    a, b = dict(leaves(first)), dict(leaves(again))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- the remat path ----------------------------------------------------------

def test_remat_full_reaches_moe_ep(monkeypatch):
    """Under remat="full" (checkpointed blocks, grad enabled), a MoE layer
    with ``distributed`` flags runs moe_ep, through Transformer.forward and
    through train_logits: the flags and the mesh reach every block."""
    cfg = get_config(MOE_ARCH, smoke=True)
    params = init_train_state(cfg, OptConfig(),
                              torch.Generator().manual_seed(0),
                              "cpu")["params"]
    model = Transformer(cfg, params, device="cpu", trainable=True)
    calls = []
    real = TM.moe_ep

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(TM, "moe_ep", counting)
    mesh = make_mesh((1, 1), ("data", "model"))
    flags = RunFlags(distributed=True)
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.long)}
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs)
    model(batch, remat="full", flags=flags, mesh=mesh)
    assert len(calls) == n_moe
    from repro_torch.models import train_logits
    train_logits(model, batch, remat="full", flags=flags, mesh=mesh)
    assert len(calls) == 2 * n_moe
