"""The port's layer functions against their JAX counterparts on the same
weights (bridged with ``params_from_jax``) and the same numpy inputs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import model_defs as jax_model_defs
from repro_torch.configs import get_config, list_archs
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.params import params_from_jax

ATOL = 1e-5          # f32 on both sides: the rmsnorm bar of the JAX suite


def _configs(**over):
    """The f32 smoke config on both sides, with the same overrides."""
    return (jax_get_config("tacc-100m", smoke=True).smoke(dtype="float32",
                                                          **over),
            get_config("tacc-100m", smoke=True).smoke(dtype="float32",
                                                      **over))


def _params(jcfg, tcfg, seed=0):
    jp = jax_init_params(jax_model_defs(jcfg), jax.random.PRNGKey(seed))
    jp = jax.tree.map(np.asarray, jp)
    return jp, params_from_jax(tcfg, jp)


def _sub(tp, prefix):
    """The port's leaves under ``prefix`` as a plain dict."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in tp.items() if k.startswith(prefix + ".")}


def _jsub(jp, name):
    """Layer 0's ``name`` group of the JAX params (period unstacked)."""
    return jax.tree.map(lambda a: a[0], jp["period"][0][name])


def _x(shape, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol)


def test_configs_equal_field_for_field():
    """Every registered config, full and smoke, and the f32 smoke
    variant the layer tests use."""
    jcfg, tcfg = _configs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert len(list_archs()) == 11
    for arch in list_archs():
        for smoke in (False, True):
            assert dataclasses.asdict(jax_get_config(arch, smoke=smoke)) == \
                dataclasses.asdict(get_config(arch, smoke=smoke)), arch


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(norm, dtype):
    jcfg, tcfg = _configs(norm=norm)
    rng = np.random.default_rng(3)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    xt = torch.from_numpy(_x((2, 5, 64))).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(dtype)
    out = TL.apply_norm(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                        xt)
    ref = JL.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, xj)
    assert out.dtype == xt.dtype
    _close(out, ref)


def test_rms_head_norm():
    x, s = _x((2, 5, 4, 16)), _x((16,), seed=2)
    _close(TL.rms_head_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
           JL.rms_head_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("decode", [False, True])
def test_apply_rope(decode):
    B, S = 3, 1 if decode else 40
    x = _x((B, S, 4, 16))
    if decode:            # decode positions are the cache lengths
        pos = np.asarray([[0], [17], [511]], np.int32)
    else:
        pos = np.arange(S, dtype=np.int32)[None, :]
    out = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    _close(out, ref)


def test_sincos_pos_emb():
    pos = np.arange(48, dtype=np.int32)[None, :]
    _close(TL.sincos_pos_emb(torch.from_numpy(pos), 64),
           JL.sincos_pos_emb(jnp.asarray(pos), 64))


@pytest.mark.parametrize("gated", [True, False])
def test_apply_ffn(gated):
    jcfg, tcfg = _configs(ffn_gated=gated)
    jp, tp = _params(jcfg, tcfg)
    x = _x((2, 6, 64))
    _close(TL.apply_ffn(tcfg, _sub(tp, "layers.0.ffn"), torch.from_numpy(x)),
           JL.apply_ffn(jcfg, _jsub(jp, "ffn"), jnp.asarray(x)))


def test_embed_tokens_and_unembed():
    jcfg, tcfg = _configs(embedding_multiplier=2.5)
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(4).integers(0, 256, (2, 9)).astype(np.int32)
    xt = TL.embed_tokens(tcfg, _sub(tp, "embed"), torch.from_numpy(toks).long())
    xj = JL.embed_tokens(jcfg, jp["embed"], jnp.asarray(toks))
    _close(xt, xj)
    _close(TL.unembed(tcfg, _sub(tp, "embed"), xt),
           JL.unembed(jcfg, jp["embed"], xj))
    jcap, tcap = _configs(logit_softcap=0.05)
    _close(TL.unembed(tcap, _sub(tp, "embed"), xt),
           JL.unembed(jcap, jp["embed"], xj))


def test_project_qkv_and_output_proj():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    x = _x((2, 7, 64))
    pos = np.arange(7, dtype=np.int32)[None, :]
    tq = TA.project_qkv(tcfg, _sub(tp, "layers.0.mixer"), torch.from_numpy(x),
                        torch.from_numpy(pos))
    jq = JA.project_qkv(jcfg, _jsub(jp, "mixer"), jnp.asarray(x),
                        jnp.asarray(pos))
    for t, j in zip(tq, jq):
        _close(t, j)
    # v comes straight out of the fused (B,S,2,KV,HD) product: a strided view
    assert not tq[2].is_contiguous()
    _close(TA.output_proj(tcfg, _sub(tp, "layers.0.mixer"), tq[0]),
           JA.output_proj(jcfg, _jsub(jp, "mixer"), jq[0]))


def test_write_kv_cache_and_decode_self_attention():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    B, S, KV, HD = 3, 12, tcfg.n_kv_heads, tcfg.head_dim
    kc = _x((B, S, KV, HD), seed=5)
    vc = _x((B, S, KV, HD), seed=6)
    lengths = np.asarray([0, 5, 11], np.int32)
    kn, vn = _x((B, KV, HD), seed=7), _x((B, KV, HD), seed=8)
    tk, tv = TA.write_kv_cache(torch.from_numpy(kc.copy()),
                               torch.from_numpy(vc.copy()),
                               torch.from_numpy(kn), torch.from_numpy(vn),
                               torch.from_numpy(lengths))
    jk, jv = JA.write_kv_cache(jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(kn), jnp.asarray(vn),
                               jnp.asarray(lengths))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    # f32 caches: the reference cannot write an f32 token into a bf16 cache
    # (lax.scatter refuses mixed dtypes at repro/models/attention.py:238)
    x = _x((B, 1, 64), seed=9)
    ty, tcache = TA.decode_self_attention(
        tcfg, _sub(tp, "layers.0.mixer"), torch.from_numpy(x),
        {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())},
        torch.from_numpy(lengths))
    jy, jcache = JA.decode_self_attention(
        jcfg, _jsub(jp, "mixer"), jnp.asarray(x),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, jnp.asarray(lengths))
    _close(ty, jy)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


def test_decode_writes_round_into_a_bf16_cache():
    """The port's bf16 cache takes an f32 model's new K/V rounded to bf16,
    as prefill's cache does."""
    kc = torch.zeros(2, 4, 1, 16, dtype=torch.bfloat16)
    kn = torch.from_numpy(_x((2, 1, 16)))
    TA.write_kv_cache(kc, kc.clone(), kn, kn, torch.tensor([0, 3]))
    assert torch.equal(kc[[0, 1], [0, 3]], kn.bfloat16())
