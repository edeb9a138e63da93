"""The port's MLA against ``repro.models.mla`` and
``repro.parallel.decode_attn`` on bridged weights and numpy inputs, on
deepseek-v2-236b's smoke config: the parameter layout and init scales, the
sequence pass, K1's plain version at head dim 192 against
``flash_attention_xla``, the absorbed decode against JAX's and against the
naive oracle, the JAX state round trip, greedy tokens against JAX's engine
and one train step's loss, aux and gradients against JAX's. Bars: the
sequence pass rel 3e-5 in f32 and 3e-2 in bf16 (K1's bars), decode atol
1e-4 / rtol 1e-3 (tests/test_attention.py's), the model and train bars of
tests/test_torch_train.py. JAX's MLA decode writes the new latent rows
into its cache without a cast, so it cannot decode into a bf16 cache in an
f32 model (ROADMAP Queue 3): the f32 decode tests give both sides f32
caches."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import mla as JMLA
from repro.models import model_defs as jax_model_defs
from repro.models.attention import flash_attention_xla
from repro.models.params import ParamDef as JaxParamDef
from repro.models.params import _fan_in as jax_fan_in
from repro.models.transformer import train_logits as jax_train_logits
from repro.parallel.decode_attn import sharded_mla_decode
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import OptConfig as JaxOptConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_train_state as jax_init_train_state
from repro.train.loss import cross_entropy as jax_cross_entropy
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.kernels import flash_attention, flash_attention_plain
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (Transformer, init_params, model_defs,
                                params_from_jax, state_from_jax, state_to_jax,
                                train_logits)
from repro_torch.models import mla as TMLA
from repro_torch.models.params import mla_defs
from repro_torch.parallel.decode_attn import mla_decode_local
from repro_torch.serve import ServeEngine
from repro_torch.train import (OptConfig, TrainConfig, build_train_step,
                               cross_entropy, init_opt)

ARCH = "deepseek-v2-236b"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops run as fast on one thread, and the suite's workers
    share the machine's cores: more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _params(**over):
    """(jax config, port config, JAX params as numpy, port params) of the
    smoke config with ``over`` applied alike; made once per ``over``."""
    key = tuple(sorted(over.items()))
    if key not in _PARAMS:
        jcfg = jax_get_config(ARCH, smoke=True).smoke(**over)
        tcfg = get_config(ARCH, smoke=True).smoke(**over)
        jp = jax.tree.map(np.asarray, jax_init_params(jax_model_defs(jcfg),
                                                      jax.random.PRNGKey(0)))
        _PARAMS[key] = jcfg, tcfg, jp, params_from_jax(tcfg, jp)
    return _PARAMS[key]


def _mixer(jp, tp):
    """Layer 0's (the dense prelayer's) MLA leaves: JAX's and the port's."""
    return ({k: jnp.asarray(v)
             for k, v in jp["prelayers"][0]["mixer"].items()},
            {k[len("layers.0.mixer."):]: v for k, v in tp.items()
             if k.startswith("layers.0.mixer.")})


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


# -- parameters ---------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "smoke", "no_q_lora"])
def test_mla_defs_match_jax(variant):
    """Leaf names and shapes of the mixer, with and without the query's
    low-rank pair."""
    jcfg, tcfg = jax_get_config(ARCH, smoke=variant != "full"), \
        get_config(ARCH, smoke=variant != "full")
    if variant == "no_q_lora":
        jcfg = jcfg.smoke(mla=dataclasses.replace(jcfg.mla, q_lora_rank=0))
        tcfg = tcfg.smoke(mla=dataclasses.replace(tcfg.mla, q_lora_rank=0))
    ours, ref = mla_defs(tcfg), JMLA.mla_defs(jcfg)
    assert list(ours) == list(ref)
    assert {k: d.shape for k, d in ours.items()} == \
        {k: d.shape for k, d in ref.items()}
    assert ("w_q" in ours) == (variant == "no_q_lora")
    if variant == "full":
        assert ours["w_ukv"].shape == (512, 128, 256)
        assert ours["w_o"].shape == (128, 128, 5120)


def test_init_params_draws_at_the_reference_scales():
    """The port's draw at the std JAX's defs give each leaf (``_fan_in``
    counts every axis but the last and the stacked "layers" one, so w_ukv
    (R, H, dn + dv) has fan-in R H): ones exactly, each normal within 4
    standard errors of its std."""
    jcfg, tcfg, _, _ = _params(dtype="float32")
    ours = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax_model_defs(jcfg), is_leaf=lambda x: isinstance(x, JaxParamDef))
    ref = {}
    for path, d in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] in ("period", "prelayers"):
            keys = [keys[0]] + keys[2:]
        ref[".".join(map(str, keys))] = d
    n_pre = len(tcfg.prelayers)
    checked = 0
    for name, t in ours.items():
        if name.startswith("layers."):
            i, rest = name.split(".", 2)[1:]
            name = ("prelayers." if int(i) < n_pre else "period.") + rest
        d = ref[name]
        if d.init in ("ones", "zeros"):
            assert torch.equal(t, torch.full_like(t, float(d.init == "ones")))
            continue
        std = d.scale if d.init == "embed" else d.scale / math.sqrt(
            jax_fan_in(d))
        assert abs(float(t.std()) / std - 1) < 4 / math.sqrt(2 * t.numel()), \
            (name, float(t.std()), std)
        checked += ".mixer.w_" in name
    assert checked == 3 * 6                  # 6 MLA matrices in 3 layers


def test_jax_state_round_trips_bit_for_bit():
    """A JAX deepseek smoke train state (a dense MLA prelayer before the
    MLA + MoE period) -> ``state_from_jax`` -> ``state_to_jax``: the same
    tree and every leaf bit-equal."""
    jcfg, tcfg, _, _ = _params(dtype="float32")
    state = jax_init_train_state(jcfg, JaxOptConfig(), jax.random.PRNGKey(0))
    state = jax.tree.map(np.asarray, state)
    back = state_to_jax(tcfg, state_from_jax(tcfg, state, "cpu"))
    back = jax.tree.map(lambda t: t.numpy(), back)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    assert len(back["params"]["prelayers"]) == 1
    assert list(back["params"]["prelayers"][0]["mixer"]) == sorted(
        JMLA.mla_defs(jcfg))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- the module against repro.models.mla ------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 3e-5), ("bfloat16", 3e-2)])
def test_mla_self_attention_matches_jax(dtype, tol):
    """The sequence pass with ragged ``lengths``: y, and the latent and
    rope key the cache keeps, within K1's bar of the max."""
    jcfg, tcfg, jp, tp = _params(dtype=dtype)
    jm, tm = _mixer(jp, tp)
    B, S = 2, 40
    x = _x((B, S, tcfg.d_model))
    lengths = np.asarray([S, 23], np.int32)
    pos = np.arange(S, dtype=np.int32)[None, :]
    dt = getattr(torch, dtype)
    ty, (tckv, tkr) = TMLA.mla_self_attention(
        tcfg, tm, torch.from_numpy(x).to(dt), torch.from_numpy(pos),
        lengths=torch.from_numpy(lengths))
    jy, (jckv, jkr) = JMLA.mla_self_attention(
        jcfg, jm, jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(pos),
        lengths=jnp.asarray(lengths))
    assert ty.dtype == dt and ty.shape == jy.shape
    for name, t, j in (("y", ty, jy), ("ckv", tckv, jckv), ("kr", tkr, jkr)):
        assert _rel(t, j) < tol, (name, _rel(t, j))


def test_k1_plain_at_head_dim_192_matches_flash_attention_xla():
    """K1's plain version at MLA's full-width q/k head dim 192 with V
    padded from 128 by ``v_pad`` (the port's equals JAX's), against
    ``flash_attention_xla`` with ragged ``lengths``, f32 (3e-5); the
    padded columns come out exactly 0."""
    B, S, H, D, dv = 2, 70, 2, 192, 128
    q, k, v = _x((B, S, H, D), 2), _x((B, S, H, D), 3), _x((B, S, H, dv), 4)
    lengths = np.asarray([70, 41], np.int32)
    tv = TMLA.v_pad(torch.from_numpy(v), D)
    jv = JMLA.v_pad(jnp.asarray(v), D)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tl = torch.from_numpy(lengths)
    o = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), tv,
                              causal=True, lengths=tl)
    o2 = flash_attention(torch.from_numpy(q), torch.from_numpy(k), tv,
                         causal=True, lengths=tl)
    ref = flash_attention_xla(jnp.asarray(q), jnp.asarray(k), jv, causal=True,
                              lengths=jnp.asarray(lengths), chunk=32,
                              max_chunks=4)
    assert torch.equal(o, o2)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=3e-5)
    assert not o[..., dv:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_local_matches_jax(dtype):
    """``mla_decode_local`` against the single-shard branch of
    ``sharded_mla_decode``: the caches equal, ctx within atol 1e-4 / rtol
    1e-3 in f32 and one bf16 ulp's worth (rtol 1e-2) in bf16, where both
    round ctx to bf16 from f32 sums taken in other orders."""
    B, S, H, R, DR = 3, 12, 4, 32, 8
    lengths = np.asarray([0, 5, 11], np.int32)
    args = [_x((B, H, R), 1), _x((B, H, DR), 2), _x((B, S, R), 3),
            _x((B, S, DR), 4), _x((B, R), 5), _x((B, DR), 6)]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tctx, tckv, tkr = mla_decode_local(
        *[torch.from_numpy(a).to(tdt) for a in args],
        torch.from_numpy(lengths), sm_scale=1 / math.sqrt(24))
    jctx, jckv, jkr = sharded_mla_decode(
        *[jnp.asarray(a, jdt) for a in args], jnp.asarray(lengths),
        sm_scale=1 / math.sqrt(24), seq_axes=())
    np.testing.assert_array_equal(_np(tckv), _np(jckv))
    np.testing.assert_array_equal(_np(tkr), _np(jkr))
    assert tctx.dtype == tdt
    rtol = 1e-3 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(tctx), _np(jctx), atol=1e-4, rtol=rtol)


def _decode_inputs(tcfg):
    B, S = 3, 12
    m = tcfg.mla
    return (_x((B, 1, tcfg.d_model), 9), _x((B, S, m.kv_lora_rank), 5),
            _x((B, S, m.qk_rope_head_dim), 6),
            np.asarray([0, 5, 11], np.int32))


@pytest.mark.parametrize("absorbed", [True, False],
                         ids=["absorbed", "naive"])
def test_mla_decode_matches_jax(absorbed):
    """One decode step of each form, f32 with f32 caches, against JAX's:
    y within atol 1e-4 / rtol 1e-3 and the caches within 1e-6 (their new
    rows are each framework's projection of the same token)."""
    jcfg, tcfg, jp, tp = _params(dtype="float32")
    jm, tm = _mixer(jp, tp)
    x, ckv, kr, lengths = _decode_inputs(tcfg)
    ty, tc = TMLA.mla_decode_attention(
        tcfg, tm, torch.from_numpy(x),
        {"ckv": torch.from_numpy(ckv.copy()),
         "kr": torch.from_numpy(kr.copy())},
        torch.from_numpy(lengths), absorbed=absorbed)
    jy, jc = JMLA.mla_decode_attention(
        jcfg, jm, jnp.asarray(x), {"ckv": jnp.asarray(ckv),
                                   "kr": jnp.asarray(kr)},
        jnp.asarray(lengths), absorbed=absorbed)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4, rtol=1e-3)
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), atol=1e-6)


def test_absorbed_decode_matches_the_naive_oracle():
    """The absorbed form against the naive one on the same inputs (f32, f32
    caches): y within atol 1e-4 / rtol 1e-3, the caches bit-equal; and
    the decode step's y against the sequence pass's last row."""
    _, tcfg, _, tp = _params(dtype="float32")
    _, tm = _mixer({"prelayers": [{"mixer": {}}]}, tp)
    x, ckv, kr, lengths = _decode_inputs(tcfg)
    out = {}
    for absorbed in (True, False):
        out[absorbed] = TMLA.mla_decode_attention(
            tcfg, tm, torch.from_numpy(x),
            {"ckv": torch.from_numpy(ckv.copy()),
             "kr": torch.from_numpy(kr.copy())},
            torch.from_numpy(lengths), absorbed=absorbed)
    np.testing.assert_allclose(_np(out[True][0]), _np(out[False][0]),
                               atol=1e-4, rtol=1e-3)
    for name in ("ckv", "kr"):
        assert torch.equal(out[True][1][name], out[False][1][name])
    # a cache written by the sequence pass, then the next token decoded
    S = 9
    xs = torch.from_numpy(_x((1, S + 1, tcfg.d_model), 11))
    pos = torch.arange(S + 1)[None, :]
    y_seq, (c, r) = TMLA.mla_self_attention(tcfg, tm, xs, pos)
    cache = {"ckv": torch.zeros(1, 16, tcfg.mla.kv_lora_rank),
             "kr": torch.zeros(1, 16, tcfg.mla.qk_rope_head_dim)}
    cache["ckv"][:, :S], cache["kr"][:, :S] = c[:, :S], r[:, :S]
    y_dec, _ = TMLA.mla_decode_attention(tcfg, tm, xs[:, S:], cache,
                                         torch.tensor([S], dtype=torch.int32))
    np.testing.assert_allclose(_np(y_dec[:, 0]), _np(y_seq[:, S]),
                               atol=1e-4, rtol=1e-3)


# -- serving ----------------------------------------------------------------

PROMPTS = [[5, 17, 3], [200, 1, 9, 77, 31], [8], [250, 4, 4, 4],
           [12, 13, 14, 15, 16, 17], [99, 100]]


def test_greedy_tokens_identical_to_jax_engine():
    """The f32 smoke config, max_batch 2 so slots are reused, both engines
    on f32 caches (see the module docstring)."""
    jcfg, tcfg, jp, tp = _params(dtype="float32")
    je = JaxServeEngine(jcfg, jp, max_batch=2, max_seq=32)
    je.cache = jax.tree.map(lambda a: a.astype(jnp.float32)
                            if a.dtype == jnp.bfloat16 else a, je.cache)
    te = ServeEngine(tcfg, tp, max_batch=2, max_seq=32, device="cpu")
    te.cache["layers"] = [{k: v.float() for k, v in c.items()}
                          for c in te.cache["layers"]]
    assert set(te.cache["layers"][0]) == {"ckv", "kr"}
    jr, tr = je.run(PROMPTS, max_new=6), te.run(PROMPTS, max_new=6)
    assert je._steps == te._steps
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert all(len(r.tokens) == 6 for r in tr)


def test_launcher_serves_the_mla_smoke_config_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "3", "--max-batch", "2", "--max-seq", "24", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out


# -- training ---------------------------------------------------------------

def test_train_step_matches_jax():
    """One step on the f32 smoke config from the same state and batch, the
    gradients through K1's plain backward at the padded head dim. Against
    ``jax.grad`` of the step's loss: every leaf's gradient within 1e-4 of
    the leaf's largest. Against JAX's jitted step: loss and ce within rel
    1e-4, grad_norm within rel 2e-3, lr and accuracy within rel 1e-6,
    tokens exact, each aux key within rel 1e-4."""
    jcfg, tcfg, _, _ = _params(dtype="float32")
    ocfg = dict(lr=1e-3, warmup_steps=3, total_steps=10)
    state = jax_init_train_state(jcfg, JaxOptConfig(**ocfg),
                                 jax.random.PRNGKey(0))
    b = SyntheticLM(tcfg, 4, 32, seed=0).batch(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    params = {k: v.clone() for k, v in params_from_jax(
        tcfg, jax.tree.map(np.asarray, state["params"])).items()}
    tcfg_j = JaxTrainConfig()

    def loss_fn(p, batch):
        logits, aux = jax_train_logits(jcfg, p, batch)
        loss, stats = jax_cross_entropy(logits, batch["labels"],
                                        z_loss=tcfg_j.z_loss)
        return loss + tcfg_j.aux_scale * sum(aux.values()), stats

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state["params"], jb)
    model = Transformer(tcfg, params, device="cpu", trainable=True)
    logits, aux = train_logits(model, tb)
    loss, _ = cross_entropy(logits, tb["labels"], z_loss=TrainConfig().z_loss)
    loss = loss + TrainConfig().aux_scale * sum(aux.values())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    ref = params_from_jax(tcfg, jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(ref)
    assert float(grads["layers.0.mixer.w_ukv"].abs().max()) > 0
    for name, g in grads.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-4 * float(np.abs(r).max()),
                                   err_msg=name)

    _, jm = jax.jit(jax_build_train_step(jcfg, JaxOptConfig(**ocfg)))(
        state, jb)
    ours = {"params": params, "opt": init_opt(params, OptConfig(**ocfg))}
    _, tm = build_train_step(tcfg, OptConfig(**ocfg))(ours, tb)
    assert set(tm) == set(jm)
    for k, rtol in (("loss", 1e-4), ("grad_norm", 2e-3), ("lr", 1e-6),
                    ("tokens", 0), ("ce", 1e-4), ("accuracy", 1e-6),
                    ("moe_load_balance", 1e-4), ("moe_router_z", 1e-4)):
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=rtol,
                                   err_msg=k)


def test_full_size_parameter_count():
    """deepseek-v2-236b's defs at full width: the 4-layer cut chip_smoke.py
    serves (the dense MLA prelayer and 3 MLA + MoE layers) holds
    13,302,912,000 parameters."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=4)
    n = sum(math.prod(d.shape) for d in model_defs(cfg).values())
    assert n == 13_302_912_000
