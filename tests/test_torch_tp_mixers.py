"""Tensor parallelism of the MLA, Mamba, mLSTM and sLSTM mixers over gloo
ranks on the CPU, held to the port's single process and to JAX.

deepseek-v2 (MLA), jamba (Mamba, with its attention and MoE layers) and
xlstm-125m (mLSTM and sLSTM) at smoke size in f32 train one step on
(data 2, model 2) and on (data 1, model 4): the loss and grad norm within
rel 1e-5 of the port's single process and of JAX's jitted single-device
step from the same state, every gradient leaf (gathered whole by
``unshard_leaf``) within rel 1e-5 of the single process's, and the state
cut into blocks and gathered back by ``state_to_jax(mesh=)`` bit for bit.
The grouped column order keeps Mamba's ``w_in`` and the mLSTM's ``w_up``
in whole channels, [u | z] on every rank. jamba and xlstm-125m serve over
(data 1, model 2) with their d_inner state split as ``cache_specs`` says:
greedy tokens equal to JAX's engine in f32, and each rank's state its
block of the one-process engine's.

One ``torch.multiprocessing.spawn`` a world (4 ranks for both training
meshes, 2 for serving), with a ``file://`` store under a temporary
directory; the ranks import no ``jax``, and their results come back
through ``torch.save``.
"""
import dataclasses
import datetime
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import state_from_jax, state_to_jax
from repro_torch.models.params import (grouped_columns, model_defs,
                                       serving_plan, shard_leaf, shard_params,
                                       train_plan, unshard_leaf)
from repro_torch.models.transformer import RunFlags
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (batch_rows, cache_specs,
                                           decode_plan, gather_shards,
                                           local_shard, train_batch_axes)
from repro_torch.serve import ServeEngine
from repro_torch.train import OptConfig, build_train_step

ARCHS = ("deepseek-v2-236b", "jamba-1.5-large-398b", "xlstm-125m")
SERVED = ("jamba-1.5-large-398b", "xlstm-125m")
AXES = ("data", "model")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# the leaf of each mixer that the training plan must split over model
TP_LEAF = {"deepseek-v2-236b": "layers.0.mixer.w_ukv",
           "jamba-1.5-large-398b": "layers.0.mixer.w_in",
           "xlstm-125m": "layers.3.mixer.r_z"}
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=50)
ROWS, SEQ = 8, 16
PROMPTS = [[5, 17, 3], [200, 1, 9, 77, 31], [8], [250, 4, 4, 4],
           [12, 13, 14, 15, 16, 17], [99, 100]]
MAX_SEQ, MAX_NEW = 32, 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, arch):
    """An arch's smoke config in f32, MoE at capacity factor 8."""
    cfg = get(arch, smoke=True).smoke(dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tensors(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree
    return torch.from_numpy(np.array(tree))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix, tree


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


def _start(tmp, world, fn, *args):
    """``fn(rank, *args)`` started on ``world`` ranks; :func:`_results`
    waits for them. The references are computed while the ranks run."""
    out = tmp / "out"
    out.mkdir()
    ctx = mp.spawn(_rank_main, args=(world, str(tmp / "store"), str(out), fn,
                                     args), nprocs=world, join=False)
    return ctx, out, world


def _results(started):
    """Each rank's return value, in rank order."""
    ctx, out, world = started
    while not ctx.join():
        pass
    return [torch.load(out / f"{r}.pt") for r in range(world)]


def _train_ranks(rank, trees, batches):
    """On each training mesh and for each arch: the state cut into this
    rank's blocks and gathered back, whether that equals the whole state
    bit for bit, then one step's metrics and (rank 0) its gradients
    gathered whole."""
    out = {}
    for tag, shape in MESHES.items():
        mesh = make_mesh(shape, AXES)
        axes = train_batch_axes(mesh)
        x = torch.arange(11.0) * (rank + 1) + 0.5 * rank     # exact sums
        whole = C.psum(x, "model", mesh)
        piece, C.REDUCE_PIECE = C.REDUCE_PIECE, 3
        try:
            out[tag, "psum"] = (x, whole, C.psum(x, "model", mesh))
        finally:
            C.REDUCE_PIECE = piece
        for arch in ARCHS:
            cfg = _cfg(get_config, arch)
            state = state_from_jax(cfg, trees[arch], "cpu", mesh=mesh)
            back = dict(_leaves(state_to_jax(cfg, state, mesh=mesh)))
            same = all(torch.equal(back[k], v)
                       for k, v in _leaves(trees[arch]))
            step = build_train_step(
                cfg, OptConfig(**OCFG), mesh=mesh, keep_grads=True,
                flags=RunFlags(distributed=True, token_axes=axes))
            _, m = step(state, {k: batch_rows(v, mesh, axes)
                                for k, v in batches[arch].items()})
            plan = train_plan(cfg, mesh)
            grads = {k: unshard_leaf(cfg, k, g, plan[k], mesh)
                     for k, g in step.grads.items()}
            out[tag, arch] = {
                "metrics": {k: float(m[k]) for k in ("loss", "grad_norm")},
                "round_trip": same and set(back) == set(
                    k for k, _ in _leaves(trees[arch])),
                "grads": grads if rank == 0 else None}
    return out


def _f32_kv(cache):
    """Attention K/V in f32 (JAX's engine keeps bf16 K/V, into which an f32
    model cannot write); the recurrent entries in their own dtypes."""
    return [{k: (v.float() if k in ("k", "v") else v) for k, v in c.items()}
            for c in cache]


def _engine(cfg, params, **kw):
    eng = ServeEngine(cfg, params, max_batch=2, max_seq=MAX_SEQ,
                      device="cpu", **kw)
    eng.cache["layers"] = _f32_kv(eng.cache["layers"])
    return eng


def _serve_ranks(rank, params):
    """(data 1, model 2): each arch served from this rank's share of the
    weights, with its block of every d_inner state: the tokens and the
    final cache."""
    mesh = make_mesh((1, 2), AXES)
    out = {}
    for arch, p in params.items():
        cfg = _cfg(get_config, arch)
        b, s = decode_plan(cfg, ShapeConfig("serve", MAX_SEQ, 2, "decode"),
                           mesh)
        flags = RunFlags(distributed=True, token_axes=b, decode_seq_axes=s)
        mine = shard_params(cfg, p, mesh, serving_plan(cfg, mesh))
        eng = _engine(cfg, mine, flags=flags, mesh=mesh)
        res = eng.run(PROMPTS, max_new=MAX_NEW)
        out[arch] = {"tokens": [r.tokens for r in res], "steps": eng._steps,
                     "plan": (b, s), "cache": eng.cache["layers"]}
    return out


# -- fixtures ----------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds started on JAX's states and params from key 0 (f32),
    then, while they run, the references: per trained arch one batch,
    JAX's jitted single-device step's metrics and the port's single
    process step from the same state (metrics and gradients); per served
    arch JAX's engine's tokens and the port's single-process engine (its
    tokens and final cache)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import init_params, model_defs
    from repro.serve import ServeEngine as JaxServeEngine
    from repro.train import OptConfig as JaxOptConfig
    from repro.train import build_train_step as jax_build_train_step
    from repro.train import init_train_state as jax_init_train_state
    from repro_torch.models import params_from_jax

    train = {}
    for arch in ARCHS:
        jcfg, cfg = _cfg(jax_get_config, arch), _cfg(get_config, arch)
        jstate = jax_init_train_state(jcfg, JaxOptConfig(**OCFG),
                                      jax.random.PRNGKey(0))
        b = SyntheticLM(cfg, ROWS, SEQ, seed=0).batch(0)
        train[arch] = {"jcfg": jcfg, "cfg": cfg, "jstate": jstate,
                       "tree": _tensors(jax.tree.map(np.asarray, jstate)),
                       "jbatch": {k: jnp.asarray(v) for k, v in b.items()},
                       "batch": {k: torch.from_numpy(np.asarray(v)).long()
                                 for k, v in b.items()}}
    serve = {}
    for arch in SERVED:
        jcfg, cfg = _cfg(jax_get_config, arch), _cfg(get_config, arch)
        jp = init_params(model_defs(jcfg), jax.random.PRNGKey(0))
        serve[arch] = {"jcfg": jcfg, "cfg": cfg, "jp": jp,
                       "params": params_from_jax(
                           cfg, jax.tree.map(np.asarray, jp))}
    trained = _start(tmp_path_factory.mktemp("tp_train"), 4, _train_ranks,
                     {a: r["tree"] for a, r in train.items()},
                     {a: r["batch"] for a, r in train.items()})
    served = _start(tmp_path_factory.mktemp("tp_serve"), 2, _serve_ranks,
                    {a: r["params"] for a, r in serve.items()})

    ref = {}
    for arch, r in train.items():
        _, jm = jax.jit(jax_build_train_step(r["jcfg"], JaxOptConfig(**OCFG)))(
            r["jstate"], r["jbatch"])
        step = build_train_step(r["cfg"], OptConfig(**OCFG), keep_grads=True)
        _, m = step(state_from_jax(r["cfg"], r["tree"], "cpu"), r["batch"])
        ref[arch] = {"jax": {k: float(jm[k]) for k in ("loss", "grad_norm")},
                     "single": {k: float(m[k]) for k in ("loss", "grad_norm")},
                     "grads": dict(step.grads)}

    def f32_kv(path, a):
        return a.astype(jnp.float32) if getattr(path[-1], "key", None) in (
            "k", "v") else a
    engines = {}
    for arch, r in serve.items():
        je = JaxServeEngine(r["jcfg"], r["jp"], max_batch=2, max_seq=MAX_SEQ)
        je.cache = jax.tree_util.tree_map_with_path(f32_kv, je.cache)
        one = _engine(r["cfg"], r["params"])
        engines[arch] = {
            "jax": [t.tokens for t in je.run(PROMPTS, max_new=MAX_NEW)],
            "jax_steps": je._steps,
            "single": [t.tokens for t in one.run(PROMPTS, max_new=MAX_NEW)],
            "single_cache": one.cache["layers"]}
    return {"reference": ref, "trained": _results(trained),
            "engines": engines, "served": _results(served)}


@pytest.fixture(scope="module")
def reference(runs):
    return runs["reference"]


@pytest.fixture(scope="module")
def trained(runs):
    return runs["trained"]


@pytest.fixture(scope="module")
def served(runs):
    return runs["engines"], runs["served"]


# -- training ----------------------------------------------------------------

@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_single_process_and_jax(reference, trained, arch,
                                                 tag):
    """One step on the mesh, the mixer's leaves split over ``model``: every
    rank's loss and grad norm within rel 1e-5 of the port's single process
    and of JAX's jitted step; every gradient leaf, gathered whole, within
    rel 1e-5 of the single process's (or 1e-8 where it is zero but for
    rounding: the mLSTM's input-gate bias, whose shift the stabiliser
    cancels)."""
    shape = MESHES[tag]
    plan = train_plan(_cfg(get_config, arch), Mesh.view(shape, AXES, 0))
    assert "model" in plan[TP_LEAF[arch]], plan[TP_LEAF[arch]]
    ref = reference[arch]
    for r in trained:
        for k in ("loss", "grad_norm"):
            got = r[tag, arch]["metrics"][k]
            for want in (ref["single"][k], ref["jax"][k]):
                assert abs(got - want) <= 1e-5 * abs(want), k
    grads = trained[0][tag, arch]["grads"]
    assert set(grads) == set(ref["grads"])
    for name, g in grads.items():
        want = ref["grads"][name]
        assert (_rel(g, want) < 1e-5
                or float((g - want).abs().max()) < 1e-8), name


@pytest.mark.parametrize("tag", list(MESHES))
def test_psum_in_pieces_equals_one_piece(trained, tag):
    """A reduction over gloo sent in pieces of ``REDUCE_PIECE`` elements (3
    here, 11 elements) equals the one-piece reduction bit for bit, and the
    sum of the ranks' tensors over ``model``, in its ranks' order."""
    shape = MESHES[tag]
    for rank, r in enumerate(trained):
        x, whole, pieces = r[tag, "psum"]
        assert torch.equal(whole, pieces)
        view = Mesh.view(shape, AXES, rank)
        mates = [q for q in range(len(trained)) if Mesh.view(
            shape, AXES, q).coords["data"] == view.coords["data"]]
        want = trained[mates[0]][tag, "psum"][0].clone()
        for q in mates[1:]:
            want = want + trained[q][tag, "psum"][0]
        assert torch.equal(whole, want)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_round_trips_through_mesh_blocks(trained, arch, tag):
    """``state_from_jax(mesh=)`` then ``state_to_jax(mesh=)``, on every
    rank: JAX's state bit for bit, its grouped leaves back in JAX's column
    order."""
    assert all(r[tag, arch]["round_trip"] for r in trained)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch,leaf", [
    ("jamba-1.5-large-398b", "layers.0.mixer.w_in"),
    ("xlstm-125m", "layers.0.mixer.w_up")])
def test_grouped_columns_hold_whole_channels(arch, leaf, tag):
    """Mamba's ``w_in`` and the mLSTM's ``w_up`` are [u | z]: rank r's
    block is [its u channels | its z channels], and the blocks put back
    in JAX's column order give the whole leaf."""
    cfg = _cfg(get_config, arch)
    shape = MESHES[tag]
    views = [Mesh.view(shape, AXES, r) for r in range(shape[0] * shape[1])]
    plan = train_plan(cfg, views[0])
    spec = plan[leaf]
    w = torch.randn(model_defs(cfg)[leaf].shape,
                    generator=torch.Generator().manual_seed(3))
    di, n = w.shape[-1] // 2, shape[1]
    assert grouped_columns(cfg, leaf, w.shape, spec, views[0]) is not None
    blocks = [shard_leaf(cfg, leaf, w, spec, v) for v in views]
    for v, blk in zip(views, blocks):
        j, rows = v.coords["model"], local_shard(w, (spec[0],), v)
        part = di // n
        assert torch.equal(blk, torch.cat(
            [rows[:, j * part:(j + 1) * part],
             rows[:, di + j * part:di + (j + 1) * part]], 1))
    whole = gather_shards(blocks, spec, views[0])
    cols = grouped_columns(cfg, leaf, whole.shape, spec, views[0])
    assert torch.equal(whole[..., torch.argsort(cols)], w)


def test_adamw_in_pieces_equals_whole():
    """AdamW over leaves cut into pieces of ``ADAM_PIECE`` elements along
    dim 0 (7 here: whole rows, a last short piece, a leaf under one piece,
    a 0-d leaf) gives the params and moments of the whole-leaf update bit
    for bit, and the same stats."""
    from repro_torch.train import optimizer as O
    gen = torch.Generator().manual_seed(4)
    shapes = {"w": (5, 3), "v": (4,), "s": ()}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    cfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    runs = []
    for piece in (O.ADAM_PIECE, 7):
        old, O.ADAM_PIECE = O.ADAM_PIECE, piece
        try:
            p = {k: t.clone() for k, t in params.items()}
            opt = O.init_opt(p, cfg)
            for _ in range(3):
                _, opt, stats = O.adamw_update(grads, opt, p, cfg)
            runs.append((p, opt, stats))
        finally:
            O.ADAM_PIECE = old
    (p1, o1, s1), (p2, o2, s2) = runs
    assert len(O._pieces(params["w"])) == 1
    for k in shapes:
        assert torch.equal(p1[k], p2[k]), k
        assert torch.equal(o1["m"][k], o2["m"][k]), k
        assert torch.equal(o1["v"][k], o2["v"][k]), k
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_train_step_takes_every_mixer_on_a_model_axis(arch):
    """The train step builds for MLA, Mamba and the xLSTM mixers on a live
    ``model`` axis, at full width and at smoke size."""
    view = Mesh.view((2, 2), AXES, 0)
    for cfg in (get_config(arch), get_config(arch, smoke=True)):
        assert callable(build_train_step(cfg, OptConfig(), mesh=view))


# -- serving -----------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVED)
def test_recurrent_engine_over_model_axis_matches_jax(served, arch):
    """(data 1, model 2), f32: every rank's greedy tokens equal JAX's
    engine's and the port's single process's; each rank's Mamba
    ``conv``/``ssm`` and mLSTM ``conv`` hold its half of d_inner and equal
    that block of the one-process cache, and the whole states (mLSTM C,
    n, m; sLSTM) the one-process ones: the bf16 windows within one bf16
    ulp of each value, the f32 states within 1e-3 of the entry's largest
    value. The windows round the f32 activations to bf16, so a last-bit
    difference of the ranks' f32 sums can move a window entry by one bf16
    ulp, which later decode steps carry into the states (jamba's 16
    layers after a run: 2.8e-4 at most)."""
    out, ranks = served
    ref = out[arch]
    assert ref["single"] == ref["jax"]
    cfg = _cfg(get_config, arch)
    for rank, r in enumerate(ranks):
        res = r[arch]
        assert res["tokens"] == ref["jax"] and res["steps"] == ref["jax_steps"]
        view = Mesh.view((1, 2), AXES, rank)
        specs = cache_specs(cfg, *res["plan"])["layers"]
        split = 0
        for layer, spec, one, mine in zip(cfg.layer_specs, specs,
                                          ref["single_cache"], res["cache"]):
            if layer.mixer in ("attn", "mla"):
                continue
            for k, t in mine.items():
                want = local_shard(one[k], spec[k], view)
                split += want.shape != one[k].shape
                assert t.shape == want.shape and t.dtype == want.dtype, k
                d = (t.float() - want.float()).abs()
                if t.dtype == torch.bfloat16:
                    ok = bool((d <= 2 ** -7 * want.float().abs()).all())
                else:
                    ok = float(d.max()) <= 1e-3 * float(want.abs().max())
                assert ok, f"{layer} {k}: {float(d.max())}"
        assert split > 0
