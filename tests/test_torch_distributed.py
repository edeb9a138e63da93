"""The port's serving path over a mesh of gloo ranks on the CPU, held to the
reference on the same numpy inputs at the reference checks' own bars
(tests/distributed_checks.py): the sequence-sharded GQA and MLA decode, the
collectives over named axes, expert-parallel MoE with both combines, the
capacity drop rule against JAX's own ``moe_ep``, and the mesh engine's
greedy tokens against JAX's single-device engine.

Each mesh is one ``torch.multiprocessing.spawn`` of its ranks (a ``file://``
store under a temporary directory, so parallel runs never share a port);
its checks report as parametrised cases. Run as a script
(``python tests/test_torch_distributed.py jax-moe-ep IN OUT``) the file runs
JAX's ``moe_ep`` on 4 forced host devices, for the drop-rule test.
"""
import dataclasses
import datetime
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import moe as TM
from repro_torch.models.params import serving_plan, shard_params
from repro_torch.models.transformer import RunFlags
from repro_torch.parallel import collectives as C
from repro_torch.parallel.decode_attn import (sharded_decode_attention,
                                              sharded_mla_decode)
from repro_torch.parallel.sharding import (decode_plan, gather_shards,
                                           local_shard)
from repro_torch.serve import ServeEngine

HERE = os.path.abspath(__file__)
MOE_ARCH = "qwen2-moe-a2.7b"


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


def _tensors(obj):
    """numpy arrays in ``obj`` (dicts, lists, tuples) as tensors: spawn
    hands a tensor over in shared memory, while pickled bytes past the
    pipe's buffer would start the ranks one after another."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj))
    if isinstance(obj, dict):
        return {k: _tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tensors(v) for v in obj)
    return obj


def _spawn(tmp, world, fn, *args):
    """Each rank's return value of ``fn(rank, *args)``, in rank order."""
    out = tmp / "out"
    out.mkdir()
    mp.spawn(_rank_main, args=(world, str(tmp / "store"), str(out), fn,
                               _tensors(args)), nprocs=world, join=True)
    return [torch.load(out / f"{r}.pt") for r in range(world)]


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


# -- mesh (pod 2, data 2, model 2): GQA decode and the collectives -----------

MESH228 = ((2, 2, 2), ("pod", "data", "model"))
SEQ, BATCH = ("data", "model"), ("pod",)


def _decode_inputs():
    rng = np.random.default_rng(0)
    B, S, KV, G, D = 4, 32, 2, 2, 16
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"q": f(B, KV * G, D), "kc": f(B, S, KV, D), "vc": f(B, S, KV, D),
            "kn": f(B, KV, D), "vn": f(B, KV, D),
            "lens": np.asarray([3, 17, 25, 31], np.int32)}


def _ranks_228(rank, inputs):
    mesh = make_mesh(*MESH228)
    t = _t(inputs)
    row, cache = (BATCH, None, None), (BATCH, SEQ, None, None)
    o, kc, vc = sharded_decode_attention(
        local_shard(t["q"], row, mesh), local_shard(t["kc"], cache, mesh),
        local_shard(t["vc"], cache, mesh), local_shard(t["kn"], row, mesh),
        local_shard(t["vn"], row, mesh),
        local_shard(t["lens"], BATCH, mesh), seq_axes=SEQ,
        batch_axes=BATCH, mesh=mesh)
    x = torch.tensor([float(rank)])
    C.reset_stats()
    out = {"o": o, "kc": kc, "vc": vc,
           "psum": C.psum(x, SEQ, mesh), "pmax": C.pmax(x, ("pod", "model"),
                                                        mesh),
           "gather": C.all_gather(x, SEQ, mesh),
           "gather_reversed": C.all_gather(x, ("model", "data"), mesh),
           "a2a_reversed": C.all_to_all(torch.arange(4.) + 10 * rank,
                                        ("model", "data"), mesh),
           "none": C.psum(x, ("nothing",), mesh)}
    out["stats"] = dict(C.STATS)
    return out


@pytest.fixture(scope="module")
def ranks_228(tmp_path_factory):
    inputs = _decode_inputs()
    return inputs, _spawn(tmp_path_factory.mktemp("m228"), 8, _ranks_228,
                          inputs)


def test_sharded_decode_attention_matches_jax(ranks_228):
    """8 ranks, the sequence over (data, model), the batch over pod,
    against JAX's write_kv_cache + decode_attention_ref: output < 1e-4,
    the written caches within 1e-6."""
    import jax.numpy as jnp
    from repro.models.attention import decode_attention_ref, write_kv_cache
    inputs, res = ranks_228
    kc2, vc2 = write_kv_cache(*(jnp.asarray(inputs[k]) for k in
                                ("kc", "vc", "kn", "vn", "lens")))
    o_ref = decode_attention_ref(jnp.asarray(inputs["q"]), kc2, vc2,
                                 jnp.asarray(inputs["lens"]) + 1)
    view = Mesh.view(*MESH228, 0)
    o = gather_shards([r["o"] for r in res], (BATCH, None, None), view)
    assert float(np.abs(o.numpy() - np.asarray(o_ref)).max()) < 1e-4
    for k, ref in (("kc", kc2), ("vc", vc2)):
        whole = gather_shards([r[k] for r in res], (BATCH, SEQ, None, None),
                              view)
        np.testing.assert_allclose(whole.numpy(), np.asarray(ref), atol=1e-6)


def test_collectives_over_named_axes(ranks_228):
    """psum / pmax over axis tuples, all_gather and all_to_all in the
    positions of the axes as listed (also out of the mesh's order), the
    identity over absent axes, and the counts."""
    _, res = ranks_228
    views = [Mesh.view(*MESH228, r) for r in range(8)]
    for r, (v, out) in enumerate(zip(views, res)):
        pod = v.coords["pod"]
        assert out["psum"].item() == sum(range(4 * pod, 4 * pod + 4))
        assert out["pmax"].item() == max(
            q for q, w in enumerate(views)
            if w.coords["data"] == v.coords["data"])
        mates = sorted((w.axis_index(SEQ), q) for q, w in enumerate(views)
                       if w.coords["pod"] == pod)
        assert out["gather"].tolist() == [float(q) for _, q in mates]
        rev = sorted((w.axis_index(("model", "data")), q)
                     for q, w in enumerate(views) if w.coords["pod"] == pod)
        assert out["gather_reversed"].tolist() == [float(q) for _, q in rev]
        me = v.axis_index(("model", "data"))
        assert out["a2a_reversed"].tolist() == [10. * q + me for _, q in rev]
        assert out["none"].item() == r
        assert out["stats"]["collectives"] == 5
        assert out["stats"]["staged_bytes"] == 0     # CPU buffers: none


# -- mesh (data 2, model 4): MLA decode and expert parallelism ---------------

MESH24 = ((2, 4), ("data", "model"))
# (combine, tokens (B, S), experts held as this rank's block): 40 and 18
# tokens a data shard, 18 not divisible by the 4 EP ranks
MOE_CASES = [("psum", (4, 16), True), ("allgather", (4, 10), False),
             ("psum", (4, 9), False), ("allgather", (4, 9), True)]


def _moe_cfg(get, **moe):
    cfg = get(MOE_ARCH, smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def _jax_moe_cfg(**moe):
    from repro.configs import get_config as jax_get_config
    return _moe_cfg(jax_get_config, **moe)


EP8 = dict(capacity_factor=8.0, n_experts=8, pad_to=8)


def _jax_moe_params(jcfg, seed=0):
    """One MoE layer's weights at JAX's init."""
    import jax
    from repro.models import init_params
    from repro.models.moe import moe_defs
    return {k: np.asarray(v) for k, v in
            init_params(moe_defs(jcfg), jax.random.PRNGKey(seed)).items()}


def _mla_inputs():
    rng = np.random.default_rng(1)
    B, S, H, R, DR = 2, 16, 4, 8, 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"q_lat": f(B, H, R), "q_rope": f(B, H, DR), "ckv": f(B, S, R),
            "kr": f(B, S, DR), "ckv_n": f(B, R), "kr_n": f(B, DR),
            "lens": np.asarray([5, 11], np.int32)}


def _ranks_24(rank, mla, moe_p, xs):
    mesh = make_mesh(*MESH24)
    t = _t(mla)
    b = ("data",)
    ctx, ckv, kr = sharded_mla_decode(
        local_shard(t["q_lat"], b, mesh), local_shard(t["q_rope"], b, mesh),
        local_shard(t["ckv"], ("data", "model"), mesh),
        local_shard(t["kr"], ("data", "model"), mesh),
        local_shard(t["ckv_n"], b, mesh), local_shard(t["kr_n"], b, mesh),
        local_shard(t["lens"], b, mesh), sm_scale=1.0 / math.sqrt(8 + 4),
        seq_axes=("model",), batch_axes=b, mesh=mesh)
    cfg = _moe_cfg(get_config, **EP8)
    p = _t(moe_p)
    mine = {k: local_shard(v, ("model",) if k in ("w_in", "w_out") else (),
                           mesh) for k, v in p.items()}
    moe = []
    for (combine, _, local), x in zip(MOE_CASES, xs):
        TM.moe_ep.dropped = 0
        y, aux = TM.moe_ep(cfg, mine if local else p,
                           local_shard(x, ("data", None, None), mesh),
                           ep_axis="model", token_axes=("data",),
                           combine=combine, mesh=mesh)
        moe.append({"y": y, "aux": aux, "dropped": int(TM.moe_ep.dropped),
                    "held": mine["w_in"].shape[0] if local else 8})
    return {"ctx": ctx, "moe": moe}


@pytest.fixture(scope="module")
def ranks_24(tmp_path_factory):
    jcfg = _jax_moe_cfg(**EP8)
    moe_p = _jax_moe_params(jcfg)
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal(shape + (jcfg.d_model,)).astype(np.float32)
          for _, shape, _ in MOE_CASES]
    mla = _mla_inputs()
    res = _spawn(tmp_path_factory.mktemp("m24"), 8, _ranks_24, mla, moe_p,
                 xs)
    return jcfg, mla, moe_p, xs, res


def test_sharded_mla_decode_matches_jax(ranks_24):
    """(data 2, model 4), the latent cache's sequence over model, against
    JAX's single-shard branch (seq_axes=()): < 1e-4."""
    import jax.numpy as jnp
    from repro.parallel.decode_attn import sharded_mla_decode as jax_mla
    _, mla, _, _, res = ranks_24
    a = {k: jnp.asarray(v) for k, v in mla.items()}
    ref, _, _ = jax_mla(a["q_lat"], a["q_rope"], a["ckv"], a["kr"],
                        a["ckv_n"], a["kr_n"], a["lens"],
                        sm_scale=1.0 / math.sqrt(8 + 4), seq_axes=())
    ctx = gather_shards([r["ctx"] for r in res], ("data", None, None),
                        Mesh.view(*MESH24, 0))
    assert float(np.abs(ctx.numpy() - np.asarray(ref)).max()) < 1e-4


@pytest.mark.parametrize("case", range(len(MOE_CASES)),
                         ids=[f"{c}-{s[0]}x{s[1]}-{'local' if loc else 'whole'}"
                              for c, s, loc in MOE_CASES])
def test_moe_ep_matches_jax_oracle(ranks_24, case):
    """moe_ep over 4 EP ranks and 2 token shards at capacity factor 8 (no
    assignment drops) against JAX's moe_dense_oracle: y rel < 2e-3, aux
    within 1e-2, with the experts whole or as each rank's block."""
    import jax.numpy as jnp
    from repro.models.moe import moe_dense_oracle
    jcfg, _, moe_p, xs, res = ranks_24
    y_ref, aux_ref = moe_dense_oracle(
        jcfg, {k: jnp.asarray(v) for k, v in moe_p.items()},
        jnp.asarray(xs[case]))
    outs = [r["moe"][case] for r in res]
    y = gather_shards([o["y"] for o in outs], ("data", None, None),
                      Mesh.view(*MESH24, 0))
    assert _rel(y.numpy(), y_ref) < 2e-3
    for k in aux_ref:
        a = float(aux_ref[k])
        for o in outs:
            assert abs(a - float(o["aux"][k])) < 1e-2 * max(abs(a), 1.0), k
    assert all(o["dropped"] == 0 for o in outs)
    assert {o["held"] for o in outs} == {2 if MOE_CASES[case][2] else 8}


# -- mesh (data 2, model 2): the drop rule against JAX's moe_ep --------------

MESH22 = ((2, 2), ("data", "model"))


def _skewed_inputs(d_model):
    """Tokens leaning toward experts 0 and 1, both on EP rank 0, so that
    at capacity factor 1.25 assignments drop at the send and at the
    experts."""
    p = _jax_moe_params(_jax_moe_cfg(), seed=3)
    rng = np.random.default_rng(4)
    u = rng.standard_normal(d_model).astype(np.float32)
    u /= np.linalg.norm(u)
    x = rng.standard_normal((4, 16, d_model)).astype(np.float32) + 2 * u
    p["router"] = p["router"].copy()
    p["router"][:, 0] += 1.5 * u
    p["router"][:, 1] += 1.2 * u
    return p, x


def _ranks_22(rank, p, x):
    mesh = make_mesh(*MESH22)
    cfg = get_config(MOE_ARCH, smoke=True)
    stats = {}
    TM.moe_ep.dropped = 0
    y, _ = TM.moe_ep(cfg, _t(p), local_shard(x, ("data", None, None), mesh),
                     ep_axis="model", token_axes=("data",), mesh=mesh,
                     stats=stats)
    return {"y": y, "kept": stats["kept"], "dropped": int(TM.moe_ep.dropped)}


def _jax_moe_ep(inp: str, outp: str) -> None:
    """Script mode: JAX's moe_ep on a (2, 2) mesh of forced host devices,
    its oracle, and its oracle with the port's dropped assignments taken
    out (``kept`` in the input), all on the input's weights and tokens."""
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "..", "src"))
    from repro import runtime
    runtime.force_host_device_count(4)
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import compat
    from repro.configs import get_config as jax_get_config
    from repro.models import moe as JM
    d = np.load(inp)
    cfg = jax_get_config(MOE_ARCH, smoke=True)
    p = {k[2:]: jnp.asarray(d[k]) for k in d.files if k.startswith("p_")}
    x = jnp.asarray(d["x"])
    mesh = compat.make_mesh(*MESH22)
    with compat.set_mesh(mesh):
        xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
        y, _ = jax.jit(lambda p, x: JM.moe_ep(
            cfg, p, x, ep_axis="model", token_axes=("data",)))(p, xs)
    y_oracle, _ = JM.moe_dense_oracle(cfg, p, x)
    flat = x.reshape(-1, x.shape[-1])
    idx, w, _ = JM._route(cfg, flat, p["router"])
    E = JM.padded_experts(cfg.moe)
    w = w * jnp.asarray(d["kept"], w.dtype)
    comb = jax.vmap(lambda c, i, v: c.at[i].add(v))(
        jnp.zeros((flat.shape[0], E), x.dtype), idx, w)
    every = JM._expert_ffn(cfg, p["w_in"], p["w_out"],
                           jnp.broadcast_to(flat, (E,) + flat.shape))
    y_kept = (jnp.einsum("ne,end->nd", comb, every).reshape(x.shape)
              + JM._shared(cfg, p, x))
    np.savez(outp, y=np.asarray(y), y_oracle=np.asarray(y_oracle),
             y_kept=np.asarray(y_kept))


def test_moe_ep_drops_as_jax_moe_ep(tmp_path):
    """At the config's own capacity factor 1.25, with routing skewed so
    that assignments drop, the port's moe_ep on 4 gloo ranks and JAX's on
    4 host devices, both on a (data 2, model 2) mesh: outputs equal to f32
    rounding (rel 1e-5), and JAX's output is its oracle with exactly the
    port's dropped assignments taken out."""
    p, x = _skewed_inputs(get_config(MOE_ARCH, smoke=True).d_model)
    res = _spawn(tmp_path, 4, _ranks_22, p, x)
    view = Mesh.view(*MESH22, 0)
    y = gather_shards([r["y"] for r in res], ("data", None, None), view)
    kept = gather_shards([r["kept"] for r in res], ("data", None), view)
    dropped = sum(r["dropped"] for r in res)
    assert dropped == int((~kept).sum()) and dropped > 0
    inp, outp = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, x=x, kept=kept.numpy(),
             **{f"p_{k}": v for k, v in p.items()})
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    run = subprocess.run([sys.executable, HERE, "jax-moe-ep", str(inp),
                          str(outp)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = np.load(outp)
    assert _rel(y.numpy(), ref["y"]) < 1e-5
    assert _rel(ref["y"], ref["y_kept"]) < 1e-5
    assert _rel(ref["y"], ref["y_oracle"]) > 1e-3          # drops matter


# -- mesh (data 1, model 4): the engine --------------------------------------

MESH14 = ((1, 4), ("data", "model"))
ENGINE_ARCHS = ["tacc-100m", MOE_ARCH, "deepseek-v2-236b"]
PROMPTS = [[5, 17, 3], [200, 1, 9, 77, 31, 2, 8, 8, 19, 4, 6], [8],
           [250, 4, 4, 4, 6, 7, 8, 9, 10], [12, 13, 14, 15, 16, 17] * 3,
           [99, 100]]
MAX_SEQ, MAX_NEW = 32, 8


def _engine_cfg(get, arch):
    cfg = get(arch, smoke=True)
    over = {"dtype": "float32"}
    if cfg.moe is not None:
        over["moe"] = dataclasses.replace(cfg.moe, capacity_factor=8.0)
    return cfg.smoke(**over)


def _ranks_14(rank, params):
    mesh = make_mesh(*MESH14)
    out = {}
    for arch, p in params.items():
        cfg = _engine_cfg(get_config, arch)
        b, s = decode_plan(cfg, ShapeConfig("serve", MAX_SEQ, 2, "decode"),
                           mesh)
        flags = RunFlags(distributed=True, token_axes=b, decode_seq_axes=s)
        plan = serving_plan(cfg, mesh)
        mine = shard_params(cfg, _t(p), mesh, plan)
        eng = ServeEngine(cfg, mine, max_batch=2, max_seq=MAX_SEQ,
                          device="cpu", flags=flags, mesh=mesh)
        eng.cache["layers"] = [{k: v.float() for k, v in c.items()}
                               for c in eng.cache["layers"]]
        res = eng.run(PROMPTS, max_new=MAX_NEW)
        out[arch] = {"tokens": [r.tokens for r in res], "steps": eng._steps,
                     "plan": (b, s),
                     "cache": {k: tuple(v.shape) for k, v in
                               eng.cache["layers"][-1].items()},
                     "experts": [mine[k].shape[0] for k, spec in plan.items()
                                 if spec and k.endswith(".w_in")]}
    return out


@pytest.fixture(scope="module")
def ranks_14(tmp_path_factory):
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import init_params, model_defs
    from repro_torch.models import params_from_jax
    params, jcfgs = {}, {}
    for arch in ENGINE_ARCHS:
        jcfg = _engine_cfg(jax_get_config, arch)
        tcfg = _engine_cfg(get_config, arch)
        jp = init_params(model_defs(jcfg), jax.random.PRNGKey(0))
        jcfgs[arch] = (jcfg, jp)
        params[arch] = {k: v.numpy() for k, v in params_from_jax(
            tcfg, jax.tree.map(np.asarray, jp)).items()}
    res = _spawn(tmp_path_factory.mktemp("m14"), 4, _ranks_14, params)
    return jcfgs, res


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_mesh_engine_tokens_equal_jax_engine(ranks_14, arch):
    """4 ranks (data 1, model 4) serving f32 smoke models with f32 caches
    and MoE capacity 8: every rank's greedy tokens equal JAX's
    single-device engine's; each rank holds 8 of 32 cache positions and its
    quarter of the experts."""
    import jax
    import jax.numpy as jnp
    from repro.serve import ServeEngine as JaxServeEngine
    jcfgs, res = ranks_14
    jcfg, jp = jcfgs[arch]
    je = JaxServeEngine(jcfg, jp, max_batch=2, max_seq=MAX_SEQ)
    je.cache = jax.tree.map(lambda a: a.astype(jnp.float32)
                            if a.dtype == jnp.bfloat16 else a, je.cache)
    want = [r.tokens for r in je.run(PROMPTS, max_new=MAX_NEW)]
    for out in (r[arch] for r in res):
        assert out["plan"] == ((), ("data", "model"))
        assert out["steps"] == je._steps
        assert all(shape[1] == MAX_SEQ // 4 for shape in
                   out["cache"].values())
        n_moe = sum(s.ffn == "moe" for s in
                    get_config(arch, smoke=True).layer_specs)
        assert out["experts"] == [8 // 4] * n_moe
        assert out["tokens"] == want


if __name__ == "__main__":
    if sys.argv[1:2] == ["jax-moe-ep"]:
        _jax_moe_ep(*sys.argv[2:4])
    else:
        sys.exit(f"usage: {sys.argv[0]} jax-moe-ep IN.npz OUT.npz")
