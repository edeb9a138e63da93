"""The port's model stack against the JAX reference on bridged weights:
parameter names and shapes, train logits, prefill + decode against the full
forward, and ragged prompt lengths. Bars are the JAX suite's
(tests/test_kernels.py:97, tests/test_serve_consistency.py:58,70)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import model_defs as jax_model_defs
from repro.models.params import ParamDef as JaxParamDef
from repro.models.transformer import prefill as jax_prefill
from repro.models.transformer import train_logits as jax_train_logits
from repro_torch.configs import get_config
from repro_torch.models import (Transformer, decode_step, init_cache,
                                init_params, model_defs, params_from_jax,
                                prefill, train_logits)

B, S, NDEC = 2, 32, 4


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tacc-100m", smoke=True)
    tcfg = get_config("tacc-100m", smoke=True)
    jp = jax_init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    return jcfg, jp, Transformer(tcfg, tp, device="cpu")


def _rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-6)


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _unstacked_jax_shapes(cfg):
    """{port name: shape} from the JAX defs, the period unstacked."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax_model_defs(cfg), is_leaf=lambda x: isinstance(x, JaxParamDef))
    for path, d in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "period":
            j, rest = keys[1], ".".join(keys[2:])
            for i in range(cfg.n_periods):
                out[f"layers.{i * len(cfg.period) + j}.{rest}"] = d.shape[1:]
        else:
            out[".".join(map(str, keys))] = d.shape
    return out


@pytest.mark.parametrize("smoke", [True, False])
def test_param_names_and_shapes_match_jax(smoke):
    shapes = {k: d.shape for k, d in
              model_defs(get_config("tacc-100m", smoke=smoke)).items()}
    assert shapes == _unstacked_jax_shapes(jax_get_config("tacc-100m",
                                                          smoke=smoke))


def test_init_params_draws_at_the_reference_scales(model):
    """Port init and JAX init draw different values from the same
    distributions: ones and zeros exactly, normals at the same std."""
    jcfg, jp, tm = model
    ours = init_params(tm.cfg, torch.Generator().manual_seed(0), device="cpu")
    theirs = params_from_jax(tm.cfg, jax.tree.map(np.asarray, jp))
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in theirs.items()}
    for name, t in ours.items():
        ref = theirs[name]
        if float(ref.std()) == 0.0:
            assert torch.equal(t, ref), name
        else:
            assert abs(float(t.std()) / float(ref.std()) - 1) < 0.05, name


def test_params_from_jax_round_trips_bit_exact(model):
    jcfg, jp, tm = model
    sd = tm.state_dict()
    assert set(sd) == set(model_defs(tm.cfg))
    for name in ("wq", "wkv", "wo"):
        stacked = torch.stack([sd[f"layers.{i}.mixer.{name}"]
                               for i in range(jcfg.n_layers)])
        assert stacked.dtype == torch.float32
        np.testing.assert_array_equal(stacked.numpy(),
                                      np.asarray(jp["period"][0]["mixer"][name]))
    np.testing.assert_array_equal(sd["embed.tok"].numpy(),
                                  np.asarray(jp["embed"]["tok"]))
    bf = {k: v.astype(jnp.bfloat16) for k, v in jp["embed"].items()}
    tok = params_from_jax(tm.cfg, dict(jax.tree.map(np.asarray, jp),
                                       embed=jax.tree.map(np.asarray, bf)))
    assert tok["embed.tok"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tok["embed.tok"].float().numpy(),
                                  np.asarray(bf["tok"], np.float32))


def test_train_logits_match_jax(model):
    jcfg, jp, tm = model
    toks = _tokens((B, S))
    lj, _ = jax.jit(lambda p, t: jax_train_logits(jcfg, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    lt, aux = train_logits(tm, {"tokens": torch.from_numpy(toks).long()})
    assert aux is None                                   # no MoE layer
    assert lt.dtype == torch.float32 and lt.shape == lj.shape
    assert _rel_err(lt.numpy(), lj) < 0.03


def test_prefill_decode_match_jax_full_forward(model):
    jcfg, jp, tm = model
    toks = _tokens((B, S))
    full, _ = jax.jit(lambda p, t: jax_train_logits(jcfg, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    Sp = S - NDEC
    pt = np.pad(toks[:, :Sp], ((0, 0), (0, NDEC)))
    lengths = torch.full((B,), Sp, dtype=torch.int32)
    lg, cache = prefill(tm, {"tokens": torch.from_numpy(pt).long()}, lengths)
    assert _rel_err(lg.numpy(), full[:, Sp - 1]) < 0.05
    for i in range(NDEC):
        pos = Sp + i
        lg, cache = decode_step(tm, cache,
                                torch.from_numpy(toks[:, pos]).long())
        assert _rel_err(lg.numpy(), full[:, pos]) < 0.08, f"step {i}"
    assert cache["lengths"].tolist() == [S] * B
    assert all(c["k"].dtype == torch.bfloat16 for c in cache["layers"])


def test_ragged_prompt_lengths(model):
    """Rows with different prompt lengths prefill independently, and match
    the reference's ragged prefill."""
    jcfg, jp, tm = model
    toks = _tokens((2, S))
    lens = np.asarray([10, 20], np.int32)
    lg, _ = prefill(tm, {"tokens": torch.from_numpy(toks).long()},
                    torch.from_numpy(lens))
    lg0, _ = prefill(tm, {"tokens": torch.from_numpy(toks[:1]).long()},
                     torch.from_numpy(lens[:1]))
    assert _rel_err(lg[0].numpy(), lg0[0].numpy()) < 0.03
    lj, _ = jax.jit(lambda p, t, n: jax_prefill(jcfg, p, {"tokens": t}, n))(
        jp, jnp.asarray(toks), jnp.asarray(lens))
    assert _rel_err(lg.numpy(), lj) < 0.05


def test_init_cache_layout():
    cfg = get_config("tacc-100m", smoke=True)
    cache = init_cache(cfg, 3, 24, device="cpu")
    assert len(cache["layers"]) == cfg.n_layers
    assert cache["layers"][0]["k"].shape == (3, 24, cfg.n_kv_heads,
                                             cfg.head_dim)
    assert cache["lengths"].dtype == torch.int32


@pytest.mark.parametrize("case", [
    "mixer:mamba", "mixer:mlstm", "mixer:slstm", "arch:jamba-1.5-large-398b",
    "arch:xlstm-125m", "mixer:mla"])
def test_other_mixers_raise_naming_the_roadmap(case):
    """The recurrent mixers and the configs that need them raise, naming
    ROADMAP Queue 1 item 14; an MLA layer builds."""
    from repro_torch.configs.base import LayerSpec, MLAConfig
    kind, name = case.split(":")
    if kind == "arch":
        with pytest.raises(KeyError, match="ROADMAP Queue 1, item 14"):
            get_config(name)
        return
    cfg = get_config("tacc-100m", smoke=True)
    bad = type(cfg)(**{**cfg.__dict__, "period": (LayerSpec(name),),
                       "mla": MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                        qk_nope_head_dim=16,
                                        qk_rope_head_dim=8,
                                        v_head_dim=16)})
    if name == "mla":
        defs = model_defs(bad)
        assert defs["layers.0.mixer.w_ukv"].shape == (32, cfg.n_heads, 32)
        assert init_cache(bad, 1, 8, device="cpu")["layers"][0][
            "ckv"].shape == (1, 8, 32)
        return
    with pytest.raises(NotImplementedError, match="item 14"):
        model_defs(bad)
    with pytest.raises(NotImplementedError, match="item 14"):
        init_cache(bad, 1, 8, device="cpu")
