"""The port's recurrent mixers against ``repro.models.mamba`` and
``repro.models.xlstm`` on bridged weights and numpy inputs, at the smoke
configs of jamba-1.5-large-398b and xlstm-125m (d_model 64): each mixer's
sequence pass at several chunk counts, its prefill cache on ragged lengths
with garbage past them, its empty cache, and a decode chain from the
prefill cache; then whole models: the jamba cut that runs on the card
(layers 2-4 of the period as prelayers) against JAX's train_logits,
prefill and decode_step, both smoke configs' greedy tokens against JAX's
engine with slots reused, one train step's gradients, the compute copy's
dtypes, the engine's splice of a recurrent cache, and the serve launcher.

Bars: f32 atol 1e-4 / rtol 1e-4 (the reference's own chunk-invariance
bar, tests/test_mamba_xlstm.py), bf16 rel 3e-2 (the model-logits bar),
the conv caches within one bf16 ulp, the model bars 0.03 / 0.05 / 0.08
and the gradient bar of tests/test_torch_train.py. JAX's attention cache
is bf16 whatever the model's dtype, so its f32 decode cannot write into
it (ROADMAP Queue 3): the f32 engine tests give both sides f32 K/V and
keep the conv caches in bf16, as the reference writes them."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import mamba as JMB
from repro.models import model_defs as jax_model_defs
from repro.models import xlstm as JXL
from repro.models.params import ParamDef as JaxParamDef
from repro.models.params import _fan_in as jax_fan_in
from repro.models.transformer import decode_step as jax_decode_step
from repro.models.transformer import prefill as jax_prefill
from repro.models.transformer import train_logits as jax_train_logits
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import TrainConfig as JaxTrainConfig
from repro.train.loss import cross_entropy as jax_cross_entropy
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (Transformer, cast_for_compute, decode_step,
                                init_cache, init_params, model_defs,
                                params_from_jax, prefill, train_logits)
from repro_torch.models import mamba as TMB
from repro_torch.models import xlstm as TXL
from repro_torch.models.params import KEEP_F32
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainConfig, cross_entropy

JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-125m"
# (arch, the layer of the period holding the mixer)
MIXER_AT = {"mamba": (JAMBA, 0), "mlstm": (XLSTM, 0), "slstm": (XLSTM, 3)}
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops run as fast on one thread, and the suite's workers
    share the machine's cores: more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jamba_cut(cfg):
    """Layers 2-4 of jamba's period as prelayers (Mamba + dense, Mamba +
    MoE, attention + dense), no period: the cut chip_smoke.py serves."""
    return dataclasses.replace(cfg, prelayers=cfg.period[2:5], n_layers=3)


_JAX_PARAMS = {}


def _params(arch, cut=False, **over):
    """(jax config, port config, JAX params as numpy, port params) of the
    smoke config with ``over`` applied alike (and the jamba cut). The f32
    params are drawn once per (arch, cut): ``over`` only sets the compute
    dtype."""
    jcfg = jax_get_config(arch, smoke=True).smoke(**over)
    tcfg = get_config(arch, smoke=True).smoke(**over)
    if cut:
        jcfg, tcfg = jamba_cut(jcfg), jamba_cut(tcfg)
    if (arch, cut) not in _JAX_PARAMS:
        jp = jax.tree.map(np.asarray, jax_init_params(jax_model_defs(jcfg),
                                                      jax.random.PRNGKey(0)))
        _JAX_PARAMS[arch, cut] = jp, params_from_jax(tcfg, jp)
    return (jcfg, tcfg) + _JAX_PARAMS[arch, cut]


def _mixer(mixer, dtype):
    """(jax config, port config, the mixer's JAX leaves, the port's) of the
    first period's layer holding ``mixer``."""
    arch, j = MIXER_AT[mixer]
    jcfg, tcfg, jp, tp = _params(arch, dtype=dtype)
    pre = f"layers.{j}.mixer."
    return (jcfg, tcfg,
            {k: jnp.asarray(v[0]) for k, v in jp["period"][j]["mixer"].items()},
            {k[len(pre):]: v for k, v in tp.items() if k.startswith(pre)})


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


def _both(x, dtype):
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x, getattr(jnp, dtype)))


def _close(t, j, dtype, what=""):
    if dtype == "float32":
        np.testing.assert_allclose(_np(t), _np(j), **F32_TOL, err_msg=what)
    else:
        assert _rel(t, j) < BF16_REL, (what, _rel(t, j))


def _conv_within_one_ulp(t, j):
    """bf16 conv caches within one bf16 ulp of each entry."""
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    a, b = _np(t), _np(j)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    assert np.all(np.abs(a - b) <= ulp), float(np.max(np.abs(a - b) - ulp))


def _seq(mixer, tcfg, jcfg, tm, jm, tx, jx, lengths=None, n_chunks=8):
    """(port y, port cache or None, JAX y) of the sequence pass."""
    tl = None if lengths is None else torch.from_numpy(lengths)
    if mixer == "mamba":
        ty, tc = TMB.mamba_mixer(tcfg, tm, tx, lengths=tl,
                                 want_cache=tl is not None,
                                 n_chunks=n_chunks)
        return ty, tc, JMB.mamba_mixer(jcfg, jm, jx, n_chunks=n_chunks)
    tmix = TXL.mlstm_mixer if mixer == "mlstm" else TXL.slstm_mixer
    jmix = JXL.mlstm_mixer if mixer == "mlstm" else JXL.slstm_mixer
    ty, tc = tmix(tcfg, tm, tx, lengths=tl, want_cache=tl is not None)
    return ty, tc, jmix(jcfg, jm, jx)


def _jax_prefill_cache(mixer, jcfg, jm, jx, lengths):
    if mixer == "mamba":
        return JMB.mamba_prefill_cache(jcfg, jm, jx, jnp.asarray(lengths))
    return JXL.xlstm_prefill_cache(jcfg, mixer, jm, jx, jnp.asarray(lengths))


# -- the mixers against the reference's ------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,n_chunks", [(32, 1), (32, 2), (32, 8), (30, 8)],
                         ids=["1", "2", "8", "30_shrinks_to_6"])
def test_mamba_mixer_matches_jax(S, n_chunks, dtype):
    """The chunked scan at 1, 2 and 8 chunks, and at an S that makes both
    sides shrink 8 chunks to 6."""
    jcfg, tcfg, jm, tm = _mixer("mamba", dtype)
    tx, jx = _both(_x((2, S, tcfg.d_model)), dtype)
    ty, _, jy = _seq("mamba", tcfg, jcfg, tm, jm, tx, jx, n_chunks=n_chunks)
    assert TMB.n_chunks_for(S, n_chunks) == (6 if S == 30 else n_chunks)
    assert ty.dtype == tx.dtype and ty.shape == jy.shape
    _close(ty, jy, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_xlstm_mixer_matches_jax(mixer, dtype):
    jcfg, tcfg, jm, tm = _mixer(mixer, dtype)
    tx, jx = _both(_x((2, 32, tcfg.d_model), 2), dtype)
    ty, _, jy = _seq(mixer, tcfg, jcfg, tm, jm, tx, jx)
    assert ty.dtype == tx.dtype and ty.shape == jy.shape
    _close(ty, jy, dtype)


def test_xlstm_chunked_time_scan_matches_one_loop():
    """Under a graph, 48 steps run as three checkpointed chunks of 16 (the
    reference's rule halves 64 until it divides S); values equal, and
    gradients within f32 rounding of, one plain loop's."""
    _, tcfg, _, tm = _mixer("mlstm", "float32")
    x = torch.from_numpy(_x((1, 48, tcfg.d_model), 3)).requires_grad_()
    y, _ = TXL.mlstm_mixer(tcfg, tm, x)
    (g,) = torch.autograd.grad(y.square().sum(), x)
    with torch.no_grad():
        y0, _ = TXL.mlstm_mixer(tcfg, tm, x)
    old, TXL.TIME_CHUNK = TXL.TIME_CHUNK, 1          # one plain loop
    try:
        x1 = x.detach().clone().requires_grad_()
        y1, _ = TXL.mlstm_mixer(tcfg, tm, x1)
        (g1,) = torch.autograd.grad(y1.square().sum(), x1)
    finally:
        TXL.TIME_CHUNK = old
    assert torch.equal(y.detach(), y0) and torch.equal(y0, y1.detach())
    torch.testing.assert_close(g, g1, rtol=1e-5, atol=1e-6)


M_INIT = float(np.float32(-1e30))


def _port_cache(mixer, tcfg, tm, tx, lengths):
    tl = torch.from_numpy(lengths)
    if mixer == "mamba":
        return TMB.mamba_prefill_cache(tcfg, tm, tx, tl)
    return TXL.xlstm_prefill_cache(tcfg, mixer, tm, tx, tl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_prefill_cache_matches_jax(mixer, dtype):
    """The cache the sequence pass takes at each row's last step, on
    lengths 0, 1, 2 and S, against the reference's separate masked scan;
    garbage past a row's length changes nothing; the pass's y is the
    unmasked one. States in f32, the conv window in bf16 within 1 ulp,
    ``m`` exactly -1e30 in the empty row."""
    jcfg, tcfg, jm, tm = _mixer(mixer, dtype)
    S = 24
    lengths = np.asarray([0, 1, 2, S], np.int32)
    x = _x((4, S, tcfg.d_model), 4)
    tx, jx = _both(x, dtype)
    ty, tc, jy = _seq(mixer, tcfg, jcfg, tm, jm, tx, jx, lengths=lengths)
    _close(ty, jy, dtype, "y")
    jc = _jax_prefill_cache(mixer, jcfg, jm, jx, lengths)
    assert set(tc) == set(jc)
    for k, ref in jc.items():
        assert tc[k].dtype == getattr(torch, str(ref.dtype)), k
        if k == "conv":
            _conv_within_one_ulp(tc[k], ref)
            continue
        if k == "m":
            assert float(tc[k][0].max()) == M_INIT == float(ref[0].max())
        _close(tc[k][1:], ref[1:], dtype, k)
    garbage = x.copy()
    for b, n in enumerate(lengths):
        garbage[b, n:] = 99.0
    tc2 = _port_cache(mixer, tcfg, tm, torch.from_numpy(garbage).to(tx.dtype),
                      lengths)
    assert all(torch.equal(tc[k], tc2[k]) for k in tc)


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_init_cache_matches_jax(mixer):
    """Every entry's shape, dtype and value, -1e30 for ``m``."""
    jcfg, tcfg, _, _ = _mixer(mixer, "bfloat16")
    tinit = {"mamba": TMB.mamba_init_cache, "mlstm": TXL.mlstm_init_cache,
             "slstm": TXL.slstm_init_cache}[mixer]
    jinit = {"mamba": JMB.mamba_init_cache, "mlstm": JXL.mlstm_init_cache,
             "slstm": JXL.slstm_init_cache}[mixer]
    tc, jc = tinit(tcfg, 3, torch.device("cpu")), jinit(jcfg, 3)
    assert set(tc) == set(jc)
    for k, ref in jc.items():
        assert str(tc[k].dtype).split(".")[1] == str(ref.dtype), k
        np.testing.assert_array_equal(_np(tc[k]), _np(ref), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_decode_chain_from_prefill_matches_jax(mixer, dtype):
    """Each side prefills 2 rows (lengths 5 and 9 of 12), then decodes 4
    tokens from its own cache: every y and the final state against JAX's."""
    jcfg, tcfg, jm, tm = _mixer(mixer, dtype)
    S, NDEC = 12, 4
    lengths = np.asarray([5, 9], np.int32)
    x = _x((2, S + NDEC, tcfg.d_model), 5)
    tx, jx = _both(x, dtype)
    _, tc, _ = _seq(mixer, tcfg, jcfg, tm, jm, tx[:, :S], jx[:, :S],
                    lengths=lengths)
    jc = _jax_prefill_cache(mixer, jcfg, jm, jx[:, :S], lengths)
    tdec = {"mamba": TMB.mamba_decode, "mlstm": TXL.mlstm_decode,
            "slstm": TXL.slstm_decode}[mixer]
    jdec = {"mamba": JMB.mamba_decode, "mlstm": JXL.mlstm_decode,
            "slstm": JXL.slstm_decode}[mixer]
    for i in range(NDEC):
        # each row's next token: the one after its own prompt
        rows = lengths + i
        tin = tx[torch.arange(2), torch.from_numpy(rows).long()][:, None]
        jin = jx[jnp.arange(2), jnp.asarray(rows)][:, None]
        ty, tc = tdec(tcfg, tm, tin, tc)
        jy, jc = jdec(jcfg, jm, jin, jc)
        _close(ty, jy, dtype, f"y at step {i}")
    for k, ref in jc.items():
        assert tc[k].dtype == getattr(torch, str(ref.dtype)), k
        if k == "conv":
            _conv_within_one_ulp(tc[k], ref)
        else:
            _close(tc[k], ref, dtype, k)


# -- parameters ---------------------------------------------------------------

def _jax_defs(jcfg):
    """{port name: the reference's ParamDef}, the period unstacked."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax_model_defs(jcfg), is_leaf=lambda d: isinstance(d, JaxParamDef))
    n_pre, period = len(jcfg.prelayers), len(jcfg.period)
    for path, d in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        rest = ".".join(map(str, keys[2:]))
        if keys[0] == "period":
            for i in range(jcfg.n_periods):
                out[f"layers.{n_pre + i * period + keys[1]}.{rest}"] = d
        elif keys[0] == "prelayers":
            out[f"layers.{keys[1]}.{rest}"] = d
        else:
            out[".".join(map(str, keys))] = d
    return out


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_recurrent_defs_draw_at_the_reference_inits(arch):
    """The port's draw against the reference's defs: zeros and ones exactly
    (``b_f`` ones, not its scale), ``a_log`` log(1 .. d_state) on every row
    (within 1 f32 ulp of JAX's) with no draw, each normal at the reference's
    std within 4 standard errors. tacc-100m's draw is held to
    tools/jax_loss_curve.json's leaf sums by test_torch_loss_curve.py."""
    jcfg, tcfg, _, tp = _params(arch)
    ours = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    defs = _jax_defs(jcfg)
    assert ours.keys() == defs.keys()
    for name, t in ours.items():
        d = defs[name]
        assert tuple(t.shape) == d.shape[-t.dim():] and \
            t.dtype == torch.float32, name
        if d.init == "ssm_a":
            np.testing.assert_allclose(t.numpy(), tp[name].numpy(), rtol=2e-7)
            assert torch.equal(t, t[:1].expand_as(t))
        elif d.init in ("zeros", "ones"):
            assert torch.equal(t, torch.full_like(t, float(d.init == "ones")))
        else:
            std = d.scale if d.init == "embed" else d.scale / math.sqrt(
                jax_fan_in(d))
            assert abs(float(t.std()) / std - 1) < 4 / math.sqrt(
                2 * t.numel()), (name, float(t.std()), std)
    g = torch.Generator().manual_seed(0)
    init_params(tcfg, g, device="cpu")
    no_ssm_a = torch.Generator().manual_seed(0)
    for name, d in model_defs(tcfg).items():
        if d.init not in ("zeros", "ones", "ssm_a"):
            torch.randn(d.shape, generator=no_ssm_a)
    assert torch.equal(g.get_state(), no_ssm_a.get_state())


def test_compute_copy_keeps_the_f32_leaves():
    """``cast_for_compute`` (and so the engine) keeps the router, Mamba's
    a_log and dt_w and the sLSTM's r_z, r_i, r_f, r_o in f32, bit for bit,
    and rounds every other matrix to bf16; vectors keep f32."""
    assert set(KEEP_F32) == {"router", "a_log", "dt_w", "r_z", "r_i",
                             "r_f", "r_o"}
    seen = set()
    for arch in (JAMBA, XLSTM):
        _, tcfg, _, tp = _params(arch)
        cc = cast_for_compute(tcfg, tp, "cpu")
        for name, t in cc.items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in KEEP_F32:
                seen.add(leaf)
                assert t.dtype == torch.float32 and torch.equal(t, tp[name])
            elif t.dim() >= 2:
                assert t.dtype == torch.bfloat16, name
            else:
                assert t.dtype == torch.float32, name
    assert seen == set(KEEP_F32)


@pytest.mark.parametrize("arch,n", [(XLSTM, 145_014_600),
                                    (JAMBA, 12_937_224_192)])
def test_full_size_parameter_count(arch, n):
    """xlstm-125m whole, and the jamba cut chip_smoke.py serves (layers
    2-4 of the period: 25.87 GB in bf16), counted from the defs; the
    reference's defs give the same."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if arch == JAMBA:
        cfg, jcfg = jamba_cut(cfg), jamba_cut(jcfg)
    assert sum(math.prod(d.shape) for d in model_defs(cfg).values()) == n
    assert sum(math.prod(d.shape) for d in jax.tree.leaves(
        jax_model_defs(jcfg), is_leaf=lambda d: isinstance(d, JaxParamDef))) \
        == n


# -- whole models against the reference --------------------------------------

def test_jamba_cut_matches_jax_train_prefill_decode():
    """The jamba cut at smoke width, bf16: train logits (rel 0.03), a
    ragged prefill (0.05) and 4 decode steps, each side from its own
    prefill cache (0.08), against JAX's train_logits, prefill and
    decode_step."""
    jcfg, tcfg, jp, tp = _params(JAMBA, cut=True)
    assert tcfg.n_periods == 0 and [s.mixer for s in tcfg.layer_specs] == \
        ["mamba", "mamba", "attn"]
    model = Transformer(tcfg, tp, device="cpu")
    rng = np.random.default_rng(6)
    B, S, NDEC = 2, 24, 4
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    with torch.inference_mode():
        lt, aux = train_logits(model, {"tokens": torch.from_numpy(toks).long()})
    lj, jaux = jax.jit(lambda p, t: jax_train_logits(jcfg, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    assert _rel(lt, lj) < 0.03
    assert set(aux) == set(jaux)
    lengths = np.asarray([S - NDEC, 11], np.int32)
    with torch.inference_mode():
        tl, tc = prefill(model, {"tokens": torch.from_numpy(toks).long()},
                         torch.from_numpy(lengths))
    jl, jc = jax.jit(lambda p, t, n: jax_prefill(jcfg, p, {"tokens": t}, n))(
        jp, jnp.asarray(toks), jnp.asarray(lengths))
    assert _rel(tl, jl) < 0.05
    jdec = jax.jit(lambda p, c, t: jax_decode_step(jcfg, p, c, t))
    for i in range(NDEC):
        nxt = rng.integers(0, tcfg.vocab_size, (B,)).astype(np.int32)
        with torch.inference_mode():
            tl, tc = decode_step(model, tc, torch.from_numpy(nxt).long())
        jl, jc = jdec(jp, jc, jnp.asarray(nxt))
        assert _rel(tl, jl) < 0.08, f"step {i}"
    assert tc["lengths"].tolist() == (lengths + NDEC).tolist()


PROMPTS = [[5, 17, 3], [200, 1, 9, 77, 31], [8], [250, 4, 4, 4],
           [12, 13, 14, 15, 16, 17], [99, 100]]


def _f32_kv(tree, is_kv):
    return {k: (v.float() if is_kv(k) else v) for k, v in tree.items()}


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_greedy_tokens_identical_to_jax_engine(arch):
    """The f32 smoke config, 6 requests through max_batch 2 so slots are
    reused: the same greedy tokens as JAX's engine. Both engines hold f32
    K/V and bf16 conv windows (see the module docstring)."""
    jcfg, tcfg, jp, tp = _params(arch, dtype="float32")
    je = JaxServeEngine(jcfg, jp, max_batch=2, max_seq=32)

    def f32_kv(path, a):
        return a.astype(jnp.float32) if getattr(path[-1], "key", None) in (
            "k", "v") else a
    je.cache = jax.tree_util.tree_map_with_path(f32_kv, je.cache)
    te = ServeEngine(tcfg, tp, max_batch=2, max_seq=32, device="cpu")
    te.cache["layers"] = [_f32_kv(c, lambda k: k in ("k", "v"))
                          for c in te.cache["layers"]]
    jr, tr = je.run(PROMPTS, max_new=6), te.run(PROMPTS, max_new=6)
    assert je._steps == te._steps
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert all(len(r.tokens) == 6 for r in tr)


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_engine_splices_recurrent_state_whole(arch):
    """An admitted row's cache lands in its slot entry for entry, in the
    entry's own dtype (the conv window bf16, the states f32, ``m`` with
    its -1e30 where no step ran), and the other slot is left alone."""
    _, tcfg, _, tp = _params(arch)
    eng = ServeEngine(tcfg, tp, max_batch=2, max_seq=16, device="cpu")
    empty = init_cache(tcfg, 2, 16, device="cpu")
    dtypes = [{k: v.dtype for k, v in c.items()} for c in empty["layers"]]
    prompt = [3, 1, 4, 1, 5]
    toks = torch.zeros((1, 16), dtype=torch.long)
    toks[0, :len(prompt)] = torch.tensor(prompt)
    with torch.inference_mode():
        _, row = prefill(eng.model, {"tokens": toks},
                         torch.tensor([len(prompt)], dtype=torch.int32))
    assert eng.add_request(prompt, max_new=4) is not None       # slot 0
    for c, r, e, d in zip(eng.cache["layers"], row["layers"], empty["layers"],
                          dtypes):
        assert {k: v.dtype for k, v in c.items()} == d
        for k in c:
            assert torch.equal(c[k][0], r[k][0]), k
            assert torch.equal(c[k][1], e[k][1]), k
    recurrent = [c for c in eng.cache["layers"] if "m" in c or "ssm" in c]
    assert recurrent and all(
        float(c["m"][1].max()) == M_INIT for c in recurrent if "m" in c)
    assert int(eng.cache["lengths"][0]) == len(prompt)


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_train_step_gradients_match_jax(arch):
    """One step's loss (with the MoE aux terms) and every leaf's gradient
    on the f32 smoke width against ``jax.grad``: each leaf within 1e-4 of
    its largest (tests/test_torch_train.py's bar), through the mixers'
    checkpointed time chunks and the blocks' remat. jamba runs its cut,
    which holds each of its layer kinds (Mamba + dense, Mamba + MoE,
    attention + dense): JAX's gradient of the 16-layer smoke config takes
    about 30 s to compile. The sLSTM's ``b_i`` has no gradient: it shifts
    every step's input gate alike, which scales c and n alike and leaves
    h = o c / n as it is, so both sides' values are rounding noise; such a
    leaf (under 1e-6 of the largest gradient of any leaf in JAX) is held
    to that: under 1e-6 of the same largest in the port too."""
    jcfg, tcfg, jp, tp = _params(arch, cut=arch == JAMBA, dtype="float32")
    b = SyntheticLM(tcfg, 2, 32, seed=0).batch(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    z, aux_scale = JaxTrainConfig().z_loss, JaxTrainConfig().aux_scale

    def loss_fn(p, batch):
        logits, aux = jax_train_logits(jcfg, p, batch)
        loss, _ = jax_cross_entropy(logits, batch["labels"], z_loss=z)
        return loss + aux_scale * sum(aux.values())

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, jp), jb)
    model = Transformer(tcfg, {k: v.clone() for k, v in tp.items()},
                        device="cpu", trainable=True)
    logits, aux = train_logits(model, tb)
    loss, _ = cross_entropy(logits, tb["labels"], z_loss=TrainConfig().z_loss)
    if aux is not None:
        loss = loss + TrainConfig().aux_scale * sum(aux.values())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    ref = params_from_jax(tcfg, jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(ref)
    top = max(float(r.abs().max()) for r in ref.values())
    none = sorted(n for n, r in ref.items() if float(r.abs().max()) < 1e-6 * top)
    assert none == ([] if arch == JAMBA else
                    [f"layers.{i}.mixer.b_i" for i in (3, 7)])
    assert float(grads["layers.0.mixer.a_log" if arch == JAMBA else
                       "layers.0.mixer.wq"].abs().max()) > 0
    for name, g in grads.items():
        r = ref[name].numpy()
        if name in none:
            assert float(g.abs().max()) < 1e-6 * top, name
            continue
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-4 * float(np.abs(r).max()),
                                   err_msg=name)


@pytest.mark.parametrize("argv", [
    ["--arch", XLSTM, "--requests", "2", "--max-batch", "2", "--max-seq",
     "16", "--max-new", "2"],
    ["--arch", JAMBA, "--smoke", "--requests", "3", "--max-batch", "2",
     "--max-seq", "24", "--max-new", "4"]], ids=[XLSTM, JAMBA + "-smoke"])
def test_launcher_serves_on_cpu(argv, capsys):
    """xlstm-125m at full width and the jamba smoke config through the
    serve launcher on the CPU."""
    serve_main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    n, new = int(argv[argv.index("--requests") + 1]), \
        int(argv[argv.index("--max-new") + 1])
    assert f"{n} requests, {n * new} tokens" in out and "on cpu" in out
