"""The port's MoE FFN against ``repro.models.moe`` on bridged weights and
numpy inputs: routing, aux losses, the dense oracle and the dispatch the
model runs, on qwen2-moe-a2.7b's smoke config and two variants (padded
experts; the sigmoid router with renormalised top-k); the parameter
layout, init scales and the JAX state round trip; the serving weights;
greedy tokens against JAX's engine; one train step's loss, aux and
gradients against JAX's. Bars: routing weights 1e-6 and aux rel 1e-6 (f32,
the same formula); y within 1e-5 of max|y| in f32 and rel 0.03 in bf16;
the model and train bars of tests/test_torch_train.py."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import model_defs as jax_model_defs
from repro.models import moe as JM
from repro.models.params import _fan_in as jax_fan_in
from repro.models.params import ParamDef as JaxParamDef
from repro.models.transformer import train_logits as jax_train_logits
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import OptConfig as JaxOptConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_train_state as jax_init_train_state
from repro.train.loss import cross_entropy as jax_cross_entropy
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (Transformer, cast_for_compute, init_params,
                                init_serving_params, model_defs,
                                params_from_jax, state_from_jax, state_to_jax,
                                train_logits)
from repro_torch.models import moe as TM
from repro_torch.models import params as params_module
from repro_torch.serve import ServeEngine
from repro_torch.train import (OptConfig, TrainConfig, build_train_step,
                               cross_entropy, init_opt)

ARCH = "qwen2-moe-a2.7b"
# the smoke config's MoE (8 experts, top 2, softmax, no renormalisation,
# no padding) and two variants: 6 experts padded to 8 with top 4, so a
# padded expert would be picked if its logit were not -1e30; the sigmoid
# router with renormalised top-k weights
VARIANTS = {"smoke": {},
            "padded": dict(n_experts=6, pad_to=8, top_k=4),
            "sigmoid_norm_topk": dict(router="sigmoid", norm_topk=True)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops run as fast on one thread, and the suite's workers
    share the machine's cores: more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(variant="smoke", **over):
    """The smoke config of both packages with the variant's MoE and
    ``over`` applied alike."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get(ARCH, smoke=True)
        out.append(cfg.smoke(moe=dataclasses.replace(cfg.moe,
                                                     **VARIANTS[variant]),
                             **over))
    return out


_PARAMS = {}


def _params(variant="smoke", **over):
    """(jax config, port config, JAX params as numpy, port params)."""
    key = (variant, tuple(sorted(over.items())))
    if key not in _PARAMS:
        jcfg, tcfg = _configs(variant, **over)
        jp = jax.tree.map(np.asarray, jax_init_params(jax_model_defs(jcfg),
                                                      jax.random.PRNGKey(0)))
        _PARAMS[key] = jcfg, tcfg, jp, params_from_jax(tcfg, jp)
    return _PARAMS[key]


def _port_ffn(tp):
    """Layer 0's MoE leaves of the port's params, by leaf name."""
    return {k[len("layers.0.ffn."):]: v for k, v in tp.items()
            if k.startswith("layers.0.ffn.")}


def _layer0_ffn(jp, tp):
    """Layer 0's MoE leaves: JAX's (the period unstacked) and the port's."""
    return jax.tree.map(lambda a: a[0], jp["period"][0]["ffn"]), _port_ffn(tp)


def _x(shape=(2, 24, 64), seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# -- the module against repro.models.moe ------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_route_matches_jax(variant):
    """Indices equal, f32 weights within 1e-6; a padded expert is never
    picked."""
    jcfg, tcfg, jp, tp = _params(variant)
    pj, pt = _layer0_ffn(jp, tp)
    x = _x().reshape(-1, 64)
    ji, jw, _ = JM._route(jcfg, jnp.asarray(x), pj["router"])
    ti, tw, _ = TM.route(tcfg, torch.from_numpy(x), pt["router"])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    assert int(ti.max()) < tcfg.moe.n_experts
    if tcfg.moe.norm_topk:
        np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_aux_loss_matches_jax(variant):
    jcfg, tcfg, jp, tp = _params(variant)
    pj, pt = _layer0_ffn(jp, tp)
    x = _x().reshape(-1, 64)
    _, _, jaux = JM._route(jcfg, jnp.asarray(x), pj["router"])
    _, _, taux = TM.route(tcfg, torch.from_numpy(x), pt["router"])
    jl, tl = JM._aux_loss(jcfg, jaux), TM.aux_loss(tcfg, taux)
    assert set(tl) == set(jl) == {"moe_load_balance", "moe_router_z"}
    for k in tl:
        assert tl[k].dtype == torch.float32
        np.testing.assert_allclose(_np(tl[k]), _np(jl[k]), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_oracle_and_dispatch_match_jax_oracle(variant, dtype):
    """``moe_dense_oracle``, ``moe_dispatch`` and ``moe_apply`` each against
    ``repro.models.moe.moe_dense_oracle`` on the same weights and x: f32
    within 1e-5 of max|y|, bf16 within rel 0.03; the aux terms within rel
    1e-6 (both route in f32 from the same x)."""
    jcfg, tcfg, jp, tp = _params(variant, dtype=dtype)
    pj, pt = _layer0_ffn(jp, tp)
    x = _x()
    xj = jnp.asarray(x).astype(dtype)
    yj, aj = jax.jit(lambda p, x: JM.moe_dense_oracle(jcfg, p, x))(pj, xj)
    xt = torch.from_numpy(_np(xj))
    xt = xt.to(getattr(torch, dtype))
    scale = float(np.abs(_np(yj)).max())
    for fn in (TM.moe_dense_oracle, TM.moe_dispatch, TM.moe_apply):
        yt, at = fn(tcfg, pt, xt)
        assert yt.dtype == xt.dtype and yt.shape == xt.shape
        err = float(np.abs(_np(yt) - _np(yj)).max())
        assert err <= (1e-5 if dtype == "float32" else 0.03) * scale, \
            (fn.__name__, err, scale)
        for k in at:
            np.testing.assert_allclose(_np(at[k]), _np(aj[k]), rtol=1e-6,
                                       err_msg=f"{fn.__name__} {k}")


def test_dispatch_counts_one_host_read_per_call():
    _, tcfg, _, tp = _params()
    pt = _port_ffn(tp)
    before = TM.dispatch_routed.host_syncs
    TM.moe_dispatch(tcfg, pt, torch.from_numpy(_x()))
    TM.moe_dispatch(tcfg, pt, torch.from_numpy(_x((3, 1, 64))))  # decode
    assert TM.dispatch_routed.host_syncs == before + 2


@pytest.mark.parametrize("shape,dispatch", [((47, 1, 64), False),
                                            ((2, 24, 64), True),
                                            ((1, 96, 64), True)])
def test_moe_apply_takes_the_dispatch_from_its_row_count(monkeypatch, shape,
                                                         dispatch):
    """Below ``DISPATCH_MIN_ROWS`` rows the oracle (no host read), from it
    on the dispatch, counting rows over batch and sequence alike; both
    give the oracle's y."""
    _, tcfg, _, tp = _params()
    pt = _port_ffn(tp)
    monkeypatch.setattr(TM, "DISPATCH_MIN_ROWS", 48)
    x = torch.from_numpy(_x(shape))
    before = TM.dispatch_routed.host_syncs
    y, _ = TM.moe_apply(tcfg, pt, x)
    assert TM.dispatch_routed.host_syncs == before + dispatch
    y_ref, _ = TM.moe_dense_oracle(tcfg, pt, x)
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-5 *
                               float(y_ref.abs().max()))


# -- parameters ---------------------------------------------------------------

def test_full_size_parameter_count():
    """qwen2-moe-a2.7b at full width and depth: 64 routed experts after
    pad_to, the shared block, 15,146,403,840 parameters."""
    cfg = get_config(ARCH)
    defs = model_defs(cfg)
    assert defs["layers.0.ffn.router"].shape == (2048, 64)
    assert defs["layers.0.ffn.w_in"].shape == (64, 2048, 2816)
    assert defs["layers.0.ffn.shared_w_in"].shape == (2048, 11264)
    assert sum(math.prod(d.shape) for d in defs.values()) == 15_146_403_840


def test_init_params_draws_at_the_reference_scales():
    """The port's draw at the std JAX's defs give each leaf (``_fan_in``
    leaves out only the stacked "layers" axis, so an expert's w_in has
    fan-in E * D): ones and zeros exactly, each normal within 4 standard
    errors of its std."""
    jcfg, tcfg, _, _ = _params(dtype="float32")
    ours = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax_model_defs(jcfg), is_leaf=lambda x: isinstance(x, JaxParamDef))
    ref = {}
    for path, d in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        name = ".".join(map(str, keys[2:] if keys[0] == "period" else keys))
        ref[name] = d
    for name, t in ours.items():
        short = (name.split(".", 2)[2] if name.startswith("layers.")
                 else name)
        d = ref[short]
        if d.init in ("ones", "zeros"):
            assert torch.equal(t, torch.full_like(t, float(d.init == "ones")))
            continue
        std = d.scale if d.init == "embed" else d.scale / math.sqrt(
            jax_fan_in(d))
        assert abs(float(t.std()) / std - 1) < 4 / math.sqrt(2 * t.numel()), \
            (name, float(t.std()), std)


def test_jax_state_round_trips_bit_for_bit():
    """A JAX qwen2-moe smoke train state -> ``state_from_jax`` ->
    ``state_to_jax``: the same tree (every dict's keys sorted, as
    ``jax.tree`` rebuilds them) and every leaf bit-equal."""
    jcfg, tcfg = _configs(dtype="float32")
    state = jax_init_train_state(jcfg, JaxOptConfig(), jax.random.PRNGKey(0))
    state = jax.tree.map(np.asarray, state)
    back = state_to_jax(tcfg, state_from_jax(tcfg, state, "cpu"))
    back = jax.tree.map(lambda t: t.numpy() if t.dtype != torch.bfloat16
                        else t.view(torch.int16).numpy(), back)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    assert list(back["params"]["period"][0]["ffn"]) == sorted(
        ["router", "w_in", "w_out", "shared_w_in", "shared_w_out"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("draw_slice", [None, 64], ids=["whole", "sliced"])
def test_serving_params_equal_cast_of_init_params(monkeypatch, draw_slice):
    """``init_serving_params`` casts each leaf as it is drawn; its values
    equal ``cast_for_compute(init_params(...))`` on the same seed, leaf for
    leaf, with the router in f32; also where the leaves are drawn in
    slices (``DRAW_SLICE``, at full width only the largest leaves)."""
    if draw_slice:
        monkeypatch.setattr(params_module, "DRAW_SLICE", draw_slice)
    _, tcfg, _, _ = _params()
    ours = init_serving_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    ref = cast_for_compute(tcfg, init_params(
        tcfg, torch.Generator().manual_seed(3), "cpu"), "cpu")
    assert list(ours) == list(ref)
    for name, t in ref.items():
        assert ours[name].dtype == t.dtype and torch.equal(ours[name], t), \
            name
    assert ours["layers.0.ffn.router"].dtype == torch.float32
    assert ours["layers.0.ffn.w_in"].dtype == torch.bfloat16


# -- serving ----------------------------------------------------------------

PROMPTS = [[5, 17, 3], [200, 1, 9, 77, 31], [8], [250, 4, 4, 4],
           [12, 13, 14, 15, 16, 17], [99, 100]]


def test_greedy_tokens_identical_to_jax_engine():
    """The f32 smoke config, max_batch 2 so slots are reused. JAX's decode
    cannot write an f32 model's K/V into its bf16 cache
    (repro/models/attention.py:238), so both engines get f32 caches."""
    jcfg, tcfg, jp, tp = _params(dtype="float32")
    je = JaxServeEngine(jcfg, jp, max_batch=2, max_seq=32)
    je.cache = jax.tree.map(lambda a: a.astype(jnp.float32)
                            if a.dtype == jnp.bfloat16 else a, je.cache)
    te = ServeEngine(tcfg, tp, max_batch=2, max_seq=32, device="cpu")
    te.cache["layers"] = [{k: v.float() for k, v in c.items()}
                          for c in te.cache["layers"]]
    jr, tr = je.run(PROMPTS, max_new=6), te.run(PROMPTS, max_new=6)
    assert je._steps == te._steps
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert all(len(r.tokens) == 6 for r in tr)


def test_launcher_serves_the_moe_smoke_config_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "3", "--max-batch", "2", "--max-seq", "24", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out


# -- training ---------------------------------------------------------------

def _jax_loss_fn(jcfg, tcfg_jax):
    """The loss of ``repro.train.step``: cross-entropy + z-loss + the aux
    losses times aux_scale, with its stats."""
    def loss_fn(params, batch):
        logits, aux = jax_train_logits(jcfg, params, batch)
        loss, stats = jax_cross_entropy(logits, batch["labels"],
                                        z_loss=tcfg_jax.z_loss)
        loss = loss + tcfg_jax.aux_scale * sum(aux.values())
        return loss, dict(stats, **aux, loss=loss)
    return loss_fn


def test_train_step_matches_jax():
    """One step on the f32 smoke config from the same state and batch.
    Against JAX's jitted step: loss and ce within rel 1e-4, grad_norm
    within rel 2e-3, lr and accuracy within rel 1e-6, tokens exact, each
    aux key within rel 1e-4 (tests/test_torch_train.py's bars; the aux
    keys take the loss's). Against ``jax.grad`` of the same loss: every
    leaf's gradient, the router's included, within 1e-4 of the leaf's
    largest gradient."""
    jcfg, tcfg, jp, _ = _params(dtype="float32")
    ocfg = dict(lr=1e-3, warmup_steps=3, total_steps=10)
    state = jax_init_train_state(jcfg, JaxOptConfig(**ocfg),
                                 jax.random.PRNGKey(0))
    b = SyntheticLM(tcfg, 4, 32, seed=0).batch(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    params = {k: v.clone() for k, v in params_from_jax(
        tcfg, jax.tree.map(np.asarray, state["params"])).items()}

    # gradients of the step's loss
    (_, jstats), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jcfg, JaxTrainConfig()), has_aux=True))(
        state["params"], jb)
    model = Transformer(tcfg, params, device="cpu", trainable=True)
    logits, aux = train_logits(model, tb)
    loss, _ = cross_entropy(logits, tb["labels"], z_loss=TrainConfig().z_loss)
    loss = loss + TrainConfig().aux_scale * sum(aux.values())
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    ref = params_from_jax(tcfg, jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(ref)
    assert float(grads["layers.0.ffn.router"].abs().max()) > 0
    for name, g in grads.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-4 * float(np.abs(r).max()),
                                   err_msg=name)

    # the step itself
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
        if k in aux:
            assert float(jm[k]) > 0
            np.testing.assert_allclose(_np(jstats[k]), _np(jm[k]), rtol=1e-6)
