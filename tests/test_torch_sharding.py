"""The port's sharding plans against the reference's, with no ranks: every
parameter's spec under both rule sets, the cache spec trees, the decode
plans; and a rank's blocks of the params and caches (the mirror of
tests/test_sharding_structs.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.models import model_defs as jax_model_defs
from repro.models import param_specs as jax_param_specs
from repro.models.params import DEFAULT_RULES as JAX_DEFAULT
from repro.models.params import POD_FSDP_RULES as JAX_POD_FSDP
from repro.parallel.sharding import cache_specs as jax_cache_specs
from repro.parallel.sharding import decode_plan as jax_decode_plan
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import (Mesh, make_local_mesh, make_mesh,
                                     make_production_mesh, make_tiny_mesh)
from repro_torch.models import init_serving_params, model_defs
from repro_torch.models import params as PM
from repro_torch.models.params import (DEFAULT_RULES, POD_FSDP_RULES,
                                       param_specs, serving_plan,
                                       shard_params)
from repro_torch.models.transformer import init_cache
from repro_torch.parallel.collectives import stages
from repro_torch.parallel.sharding import (cache_specs, decode_plan,
                                           gather_shards, local_shard,
                                           train_batch_axes)


class FakeMesh:
    """Static stand-in with what both packages' plans read."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.axis_sizes = shape
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)


MESH1 = FakeMesh((16, 16), ("data", "model"))
MESH2 = FakeMesh((2, 16, 16), ("pod", "data", "model"))
RULES = [(MESH1, DEFAULT_RULES, JAX_DEFAULT),
         (MESH2, POD_FSDP_RULES, JAX_POD_FSDP)]


def _key(k):
    return getattr(k, "key", getattr(k, "idx", k))


def _jax_leaves_by_port_name(cfg, tree, is_leaf):
    """JAX's tree under the port's names, each stacked period leaf split
    into its layers: {name: (leaf, stacked)}."""
    out = {}
    n_pre, period = len(cfg.prelayers), len(cfg.period)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        keys = [_key(k) for k in path]
        if keys[0] in ("embed", "out_norm"):
            out[".".join(map(str, keys))] = (leaf, False)
        elif keys[0] == "prelayers":
            rest = ".".join(map(str, keys[2:]))
            out[f"layers.{keys[1]}.{rest}"] = (leaf, False)
        else:
            rest = ".".join(map(str, keys[2:]))
            for i in range(cfg.n_periods):
                out[f"layers.{n_pre + i * period + keys[1]}.{rest}"] = \
                    (leaf, True)
    return out


@pytest.mark.parametrize("arch", sorted(list_archs()))
@pytest.mark.parametrize("mesh,rules,jax_rules", RULES,
                         ids=["16x16-default", "2x16x16-pod-fsdp"])
def test_param_specs_equal_jax(arch, mesh, rules, jax_rules):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert rules == jax_rules
    specs = param_specs(model_defs(cfg), mesh, rules)
    jspecs = _jax_leaves_by_port_name(
        jcfg, jax_param_specs(jax_model_defs(jcfg), mesh, jax_rules),
        lambda x: isinstance(x, P))
    assert set(specs) == set(jspecs)
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    defs = model_defs(cfg)
    for name, spec in specs.items():
        jspec, stacked = jspecs[name]
        jspec = tuple(jspec)
        if stacked:
            assert jspec[0] is None
            jspec = jspec[1:]
        assert spec == jspec, name
        for dim, part in zip(defs[name].shape, spec):
            parts = () if part is None else (
                (part,) if isinstance(part, str) else part)
            assert dim % int(np.prod([sizes[a] for a in parts])) == 0


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_cache_spec_tree_matches_cache_structure(arch):
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch,
                                                             smoke=True)
    cache = init_cache(cfg, 2, 16, "cpu")
    specs = cache_specs(cfg, ("pod",), ("data", "model"))
    assert set(specs) == set(cache)
    assert len(specs["layers"]) == len(cache["layers"]) == cfg.n_layers
    for c, s in zip(cache["layers"], specs["layers"]):
        assert set(c) == set(s)
        for k in c:
            assert len(s[k]) <= c[k].dim(), (arch, k, s[k], c[k].shape)
    assert len(specs["lengths"]) == cache["lengths"].dim()
    # the reference's per-layer specs, less the stacked layer entry
    jspecs = jax_cache_specs(jcfg, ("pod",), ("data", "model"))
    ref = [{k: tuple(v) for k, v in c.items()} for c in jspecs["prelayers"]]
    per = [{k: tuple(v)[1:] for k, v in c.items()} for c in jspecs["period"]]
    ref += per * jcfg.n_periods
    assert specs["layers"] == ref
    assert specs["lengths"] == tuple(jspecs["lengths"])


@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_decode_plan_equals_jax(mesh, shape):
    for arch in sorted(list_archs()):
        assert decode_plan(get_config(arch), SHAPES[shape], mesh) == \
            jax_decode_plan(jax_get_config(arch), JAX_SHAPES[shape], mesh)
    assert SHAPES[shape].tokens == JAX_SHAPES[shape].tokens
    assert train_batch_axes(mesh) == tuple(
        a for a in ("pod", "data") if a in mesh.axis_names)


def test_decode_plan_shapes():
    cfg = get_config("llama3-405b")
    assert decode_plan(cfg, SHAPES["decode_32k"], MESH2) == (
        ("pod",), ("data", "model"))
    assert decode_plan(cfg, SHAPES["decode_32k"], MESH1) == (
        (), ("data", "model"))
    jcfg = get_config("jamba-1.5-large-398b")
    assert decode_plan(jcfg, SHAPES["long_500k"], MESH2) == (
        (), ("pod", "data", "model"))


def test_meshes_need_their_world():
    local = make_local_mesh()
    assert (local.axis_names, local.axis_sizes) == (("data", "model"),
                                                    (1, 1))
    assert local.groups == {} and local.axis_index("model") == 0
    for build in (make_tiny_mesh, lambda: make_tiny_mesh(multi_pod=True),
                  make_production_mesh, lambda: make_mesh((1, 4),
                                                          ("data", "model"))):
        with pytest.raises(ValueError, match="ranks"):
            build()


def test_mesh_view_positions_and_blocks():
    """Row-major ranks, axis_index over axes in either order, a rank's
    block of a tensor under a spec, and the blocks put back together."""
    shape, names = (2, 2, 2), ("pod", "data", "model")
    views = [Mesh.view(shape, names, r) for r in range(8)]
    assert views[5].coords == {"pod": 1, "data": 0, "model": 1}
    assert [v.axis_index(("data", "model")) for v in views] == \
        [0, 1, 2, 3] * 2
    assert [v.axis_index(("model", "data")) for v in views] == \
        [0, 2, 1, 3] * 2
    t = torch.arange(4 * 8 * 3.).reshape(4, 8, 3)
    spec = ("pod", ("data", "model"), None)
    blocks = [local_shard(t, spec, v) for v in views]
    assert blocks[5].shape == (2, 2, 3)
    assert torch.equal(blocks[5], t[2:4, 2:4])
    assert torch.equal(gather_shards(blocks, spec, views[0]), t)
    assert local_shard(t, (None, None), views[3]) is t
    blocks[1] = blocks[1] + 1        # rank 1 replicates rank 0's block
    with pytest.raises(ValueError, match="replica"):
        gather_shards(blocks, ("pod", None, None), views[0])


def test_only_a_cuda_buffer_under_gloo_is_staged():
    assert stages("gloo", torch.device("cuda", 0))
    assert not stages("gloo", torch.device("cpu"))
    assert not stages("nccl", torch.device("cuda", 0))
    assert not stages(None, torch.device("cuda", 0))


@pytest.mark.parametrize("draw_slice", [PM.DRAW_SLICE, 64 * 64],
                         ids=["whole-leaves", "sliced-leaves"])
def test_sharded_draw_keeps_this_ranks_experts(draw_slice, monkeypatch):
    """Each rank's sharded draw equals its block of the whole draw: the
    experts split over 'model', every other leaf whole and equal."""
    monkeypatch.setattr(PM, "DRAW_SLICE", draw_slice)
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    whole = init_serving_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    for r in range(4):
        mesh = Mesh.view((1, 4), ("data", "model"), r)
        plan = serving_plan(cfg, mesh)
        split = sorted(k for k, s in plan.items() if s)
        assert split == sorted(k for k in whole if k.endswith(
            (".ffn.w_in", ".ffn.w_out")))
        mine = init_serving_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu", shard=(mesh, plan))
        ref = shard_params(cfg, whole, mesh, plan)
        assert set(mine) == set(whole)
        for k, t in mine.items():
            assert t.dtype == whole[k].dtype and torch.equal(t, ref[k]), k
        w = mine["layers.0.ffn.w_in"]
        assert w.shape[0] == 2 and torch.equal(w, whole[
            "layers.0.ffn.w_in"][2 * r:2 * r + 2])
        seen.append(w)
    assert torch.equal(torch.cat(seen), whole["layers.0.ffn.w_in"])
    # one rank on the axis: nothing split
    assert not any(serving_plan(cfg, make_local_mesh()).values())
