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
from repro_torch.kernels.bf16x3 import split_bf16x3
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


def _jax_fields(tcfg, jcfg) -> dict:
    """The port's config as a dict of the reference's fields alone."""
    names = {f.name for f in dataclasses.fields(jcfg)}
    return {k: v for k, v in dataclasses.asdict(tcfg).items() if k in names}


def test_configs_equal_field_for_field():
    """Every registered config, full and smoke, and the f32 smoke
    variant the layer tests use, on every field of the reference's; the
    port's own fields (its RoPE scaling) hold their defaults in each."""
    from repro_torch.configs.base import ModelConfig
    jcfg, tcfg = _configs()
    assert dataclasses.asdict(jcfg) == _jax_fields(tcfg, jcfg)
    assert len(list_archs()) == 11
    jax_names = {f.name for f in dataclasses.fields(jcfg)}
    own = [f for f in dataclasses.fields(ModelConfig)
           if f.name not in jax_names]
    assert {f.name for f in own} >= {"rope_scaling", "rope_factor"}
    for arch in list_archs():
        for smoke in (False, True):
            j, t = (jax_get_config(arch, smoke=smoke),
                    get_config(arch, smoke=smoke))
            assert dataclasses.asdict(j) == _jax_fields(t, j), arch
            assert all(getattr(t, f.name) == f.default for f in own), arch


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


def _bf16_configs(**over):
    """The bf16 smoke config on both sides, with the same overrides."""
    return (jax_get_config("tacc-100m", smoke=True).smoke(dtype="bfloat16",
                                                          **over),
            get_config("tacc-100m", smoke=True).smoke(dtype="bfloat16",
                                                      **over))


def _f32_bits(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous().view(torch.int32)


def _rebuilt(g: torch.Tensor) -> torch.Tensor:
    """(hi + mid) + lo of ``g``'s three bf16 terms (lo, mid, hi), in f32."""
    p = split_bf16x3(g).float()
    return (p[:, 2] + p[:, 1]) + p[:, 0]


@pytest.mark.parametrize("lo,hi", [(-110, -60), (-60, 0), (0, 60),
                                   (60, 127), (-110, 127)])
def test_split_bf16x3_rebuilds_f32_bit_for_bit(lo, hi):
    """Random f32 values of both signs, every mantissa, exponents in
    [lo, hi]: the three terms add back to each bit for bit; each term is
    a bf16 value, hi (the last) is g rounded to bf16, and each term is
    smaller than the next."""
    gen = torch.Generator().manual_seed(lo * 1000 + hi)
    shape = (257, 129)
    bits = torch.randint(0, 2 ** 23, shape, generator=gen, dtype=torch.int32)
    exp = torch.randint(lo + 127, hi + 127, shape, generator=gen,
                        dtype=torch.int32)
    sign = torch.randint(0, 2, shape, generator=gen, dtype=torch.int32)
    g = ((sign << 31) | (exp << 23) | bits).view(torch.float32)
    assert torch.isfinite(g).all()
    parts = split_bf16x3(g)
    assert parts.dtype == torch.bfloat16 and parts.shape == (257, 3, 129)
    assert torch.equal(parts[:, 2], g.to(torch.bfloat16))
    mags = parts.float().abs()
    assert (mags[:, 0] <= mags[:, 1]).all() and (mags[:, 1] <= mags[:, 2]).all()
    assert torch.equal(_f32_bits(_rebuilt(g)), _f32_bits(g))


def test_split_bf16x3_edges():
    """Zeros, the largest f32 values below bf16's overflow, 2**-110 (the
    least exponent that splits exactly) and, below it, f32's normal and
    subnormal range, which the terms meet to within half of bf16's least
    subnormal; a strided view splits as its copy does."""
    big = torch.tensor([3.3e38, -3.3e38, 2.0 ** 127 * 1.99, 1.0, -1.0])
    exact = torch.tensor([0.0, 2.0 ** -110, -(2.0 ** -110) * 1.6180339,
                          2.0 ** -110 * 1.9999999])
    g = torch.cat([big, exact])[None, :].repeat(2, 1)
    assert torch.equal(_f32_bits(_rebuilt(g)), _f32_bits(g))
    assert torch.equal(_rebuilt(torch.tensor([[-0.0]])),
                       torch.tensor([[0.0]]))          # -0 comes back +0
    tiny = torch.tensor([[2.0 ** -111 * 1.2345678, 2.0 ** -126 * 1.1,
                          -(2.0 ** -130) * 1.777, 1e-45, -3e-44]])
    assert (_rebuilt(tiny) - tiny).abs().max() <= 2.0 ** -134
    wide = torch.randn(6, 40, generator=torch.Generator().manual_seed(5))
    assert torch.equal(split_bf16x3(wide[:, 7:31]),
                       split_bf16x3(wide[:, 7:31].contiguous()))


def _ulp_close(got: torch.Tensor, want, what: str):
    """Within one bf16 ulp of ``want`` (two 16-bit roundings of f32 sums
    taken in other orders), or 1e-6 of its largest magnitude."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    ulp = np.ldexp(1.0, np.frexp(want)[1] - 8)    # bf16's spacing at want
    bar = ulp + 1e-6 * np.abs(want).max()
    gap = np.abs(got - want)
    assert (gap <= bar).all(), (what, float((gap - bar).max()))


@pytest.mark.parametrize("run", [
    7, 40, pytest.param((7, 40), id="7x40"), pytest.param((40, 7), id="40x7")])
@pytest.mark.parametrize("softcap", [0.0, 0.05])
@pytest.mark.parametrize("tied", [False, True])
def test_unembed_product_against_jax(tied, softcap, run, monkeypatch):
    """The tensor-core path run on the CPU (its GEMMs as the f32 products
    of the upcast bf16 operands, which the card's tensor cores form
    exactly and sum in f32) against JAX's bf16 ``unembed`` and its
    ``jax.vjp``: logits, dx and dw, the backward in vocab blocks and
    token runs of 7 (37 blocks, 3 runs of the 18 tokens, the last ones
    parts) or of 40 (7 blocks, one run), or blocks of one and runs of the
    other; logits equal to the f32 path's."""
    block, run = run if isinstance(run, tuple) else (run, run)
    jcfg, tcfg = _bf16_configs(tie_embeddings=tied, logit_softcap=softcap)
    jp, tp = _params(jcfg, tcfg)
    name = "tok" if tied else "unembed"
    rng = np.random.default_rng(6)
    xt = torch.from_numpy(rng.standard_normal((2, 9, 64)).astype(
        np.float32)).bfloat16()
    ct = rng.standard_normal((2, 9, tcfg.vocab_size)).astype(np.float32)
    jemb = {k: jnp.asarray(v) for k, v in jp["embed"].items()}
    ref, vjp = jax.vjp(lambda x, e: JL.unembed(jcfg, e, x),
                       jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16),
                       jemb)
    rdx, remb = vjp(jnp.asarray(ct))

    monkeypatch.setattr(TL, "TENSOR_CORE_DEVICES", ("cpu",))
    monkeypatch.setattr(TL, "VOCAB_BLOCK", block)
    monkeypatch.setattr(TL, "TC_RUN", run)
    calls, f32_calls = TL.unembed_product.calls, TL.unembed.f32_calls
    x = xt.clone().requires_grad_()
    w = tp[f"embed.{name}"].clone().requires_grad_()
    logits = TL.unembed(tcfg, {name: w}, x)
    assert (TL.unembed_product.calls, TL.unembed.f32_calls) == (
        calls + 1, f32_calls)
    dx, dw = torch.autograd.grad(logits, (x, w), torch.from_numpy(ct))
    assert (logits.dtype, dx.dtype, dw.dtype) == (
        torch.float32, torch.bfloat16, torch.float32)
    _close(logits.detach(), ref, atol=1e-6)
    _ulp_close(dx, rdx, "dx")
    _ulp_close(dw, remb[name], "dw")
    monkeypatch.setattr(TL, "TENSOR_CORE_DEVICES", ())
    assert torch.equal(TL.unembed(tcfg, {name: w}, x).detach(),
                       logits.detach())


@pytest.mark.parametrize("device,dtype,tensor_cores", [
    ("cpu", torch.float32, False), ("cpu", torch.bfloat16, False),
    ("meta", torch.float32, False), ("meta", torch.bfloat16, True),
    ("meta", torch.float16, False)])
def test_unembed_path_choice(device, dtype, tensor_cores, monkeypatch):
    """A bf16 x on the card's device types (meta stands for the card)
    takes the tensor-core product, any other the f32 one; each tally
    counts its path's calls, and the grads come back in the inputs'
    dtypes and shapes (on meta through a whole run of tokens and a
    part)."""
    monkeypatch.setattr(TL, "VOCAB_BLOCK", 4)
    monkeypatch.setattr(TL, "TC_RUN", 4)
    _, tcfg = _configs()
    x = torch.ones(2, 3, 64, dtype=dtype, device=device, requires_grad=True)
    w = torch.ones(256, 64, device=device, requires_grad=True)
    calls, f32_calls = TL.unembed_product.calls, TL.unembed.f32_calls
    logits = TL.unembed(tcfg, {"unembed": w}, x)
    assert (TL.unembed_product.calls - calls,
            TL.unembed.f32_calls - f32_calls) == (
        (1, 0) if tensor_cores else (0, 1))
    assert logits.shape == (2, 3, 256) and logits.dtype == torch.float32
    dx, dw = torch.autograd.grad(logits, (x, w), torch.ones_like(logits))
    assert (dx.shape, dx.dtype, dw.shape, dw.dtype) == (
        x.shape, dtype, w.shape, torch.float32)
    if device == "cpu":
        assert torch.equal(logits, torch.full_like(logits, 64.0))


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
