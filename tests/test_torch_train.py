"""The port's training path against the JAX package on the f32 smoke
config: cross_entropy, AdamW and its schedule, the model's gradients, the
train step over 1 and 10 steps with 1 and 2 microbatches, remat, and the
training entry point. Inputs are made with numpy and given to both."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models.transformer import train_logits as jax_train_logits
from repro.train import OptConfig as JaxOptConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_train_state as jax_init_train_state
from repro.train.loss import cross_entropy as jax_cross_entropy
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro.train.optimizer import init_opt as jax_init_opt
from repro.train.optimizer import lr_at as jax_lr_at
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import main as train_main
from repro_torch.models import Transformer, params_from_jax, train_logits
from repro_torch.train import (IGNORE, OptConfig, TrainConfig, adamw_update,
                               build_train_step, cross_entropy, init_opt,
                               lr_at)

F32 = {"dtype": "float32"}


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# -- loss -------------------------------------------------------------------

@pytest.mark.parametrize("ignored", ["some", "all", "none"])
def test_cross_entropy_matches_jax(ignored):
    """Loss and every stat within rel 1e-6 (f32, the same formula)."""
    rng = np.random.default_rng(len(ignored))
    logits = rng.standard_normal((2, 9, 50), np.float32) * 3
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    if ignored == "some":
        labels[0, :4] = IGNORE
        labels[1, -1] = IGNORE
    elif ignored == "all":
        labels[:] = IGNORE
    loss, stats = cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), z_loss=1e-3)
    jloss, jstats = jax_cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels), z_loss=1e-3)
    np.testing.assert_allclose(_np(loss), _np(jloss), rtol=1e-6)
    assert set(stats) == set(jstats)
    for k in stats:
        np.testing.assert_allclose(_np(stats[k]), _np(jstats[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    if ignored == "all":            # n = max(#unmasked, 1): no 0/0
        assert float(stats["tokens"]) == 1.0 and float(loss) == 0.0


# -- optimizer --------------------------------------------------------------

def _tree(rng):
    """Leaves in sorted order, so both frameworks sum the norms alike."""
    return {"a_mat": rng.standard_normal((6, 5), np.float32),
            "b_vec": rng.standard_normal((5,), np.float32),
            "c_mat": rng.standard_normal((3, 4, 2), np.float32)}


@pytest.mark.parametrize("clip", [0.5, 1e9], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(clip, moments):
    """Three steps on identical trees: params, m, v and the stats within
    rel 1e-5 (f32; bf16 moments round alike: RNE in both). The 1-d leaf
    takes no weight decay."""
    rng = np.random.default_rng(7)
    params, grads = _tree(rng), [_tree(rng) for _ in range(3)]
    tdt, jdt = getattr(torch, moments), getattr(jnp, moments)
    ocfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                     clip_norm=clip, m_dtype=tdt, v_dtype=tdt)
    jcfg = JaxOptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                        clip_norm=clip, m_dtype=jdt, v_dtype=jdt)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    to = init_opt(tp, ocfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = jax_init_opt(jp, jcfg)
    jupdate = jax.jit(jax_adamw_update, static_argnums=3)
    for g in grads:
        tp, to, ts = adamw_update({k: torch.from_numpy(v) for k, v in
                                   g.items()}, to, tp, ocfg)
        jp, jo, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, jo,
                             jp, jcfg)
        for k in ("grad_norm", "lr", "param_norm"):
            np.testing.assert_allclose(_np(ts[k]), _np(js[k]), rtol=1e-6,
                                       err_msg=k)
        for k in params:
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
            assert to["m"][k].dtype == tdt
            np.testing.assert_allclose(_np(to["m"][k]), _np(jo["m"][k]),
                                       rtol=1e-5, atol=1e-8, err_msg=k)
            np.testing.assert_allclose(_np(to["v"][k]), _np(jo["v"][k]),
                                       rtol=1e-5, atol=1e-10, err_msg=k)
    assert int(to["step"]) == int(jo["step"]) == 3
    if clip < 1:
        assert float(ts["grad_norm"]) > clip        # clipping was active


def test_adamw_decays_only_matrices():
    """With zero gradients only weight decay moves a parameter: the 2-d
    and 3-d leaves shrink by lr * wd, the 1-d leaf stays."""
    ocfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=10, min_lr_ratio=1)
    p = {"w": torch.ones(2, 2), "s": torch.ones(2), "t": torch.ones(1, 2, 2)}
    p, _, stats = adamw_update({k: torch.zeros_like(v) for k, v in p.items()},
                               init_opt(p, ocfg), p, ocfg)
    assert float(stats["lr"]) == pytest.approx(0.1)
    assert torch.allclose(p["w"], torch.full((2, 2), 1 - 0.1 * 0.1))
    assert torch.allclose(p["t"], torch.full((1, 2, 2), 1 - 0.1 * 0.1))
    assert torch.equal(p["s"], torch.ones(2))


@pytest.mark.parametrize("step", [0, 1, 5, 50, 77, 100, 150])
def test_lr_at_matches_jax(step):
    """0, inside the warmup (1, 5), its end (10 steps in: 50 with warmup
    50), the middle and end of the cosine, and past the end: rel 1e-6."""
    ocfg = OptConfig(lr=3e-4, warmup_steps=50, total_steps=100)
    jcfg = JaxOptConfig(lr=3e-4, warmup_steps=50, total_steps=100)
    ours = lr_at(ocfg, torch.tensor(step, dtype=torch.int32))
    theirs = jax_lr_at(jcfg, jnp.asarray(step, jnp.int32))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(_np(ours), _np(theirs), rtol=1e-6)


# -- model gradients --------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """The f32 smoke config, JAX train state from key 0, and four batches."""
    jcfg = jax_get_config("tacc-100m", smoke=True).smoke(**F32)
    tcfg = get_config("tacc-100m", smoke=True).smoke(**F32)
    ocfg = dict(lr=1e-3, warmup_steps=3, total_steps=10)
    state = jax_init_train_state(jcfg, JaxOptConfig(**ocfg),
                                 jax.random.PRNGKey(0))
    data = SyntheticLM(tcfg, 4, 32, seed=0)
    return jcfg, tcfg, ocfg, state, [data.batch(i) for i in range(10)]


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _port_params(tcfg, jax_params):
    return {k: v.clone() for k, v in
            params_from_jax(tcfg, jax.tree.map(np.asarray, jax_params)).items()}


def _port_grads(tcfg, params, batch, remat="full"):
    model = Transformer(tcfg, params, device="cpu", trainable=True)
    logits = train_logits(model, _torch_batch(batch), remat=remat)
    loss, _ = cross_entropy(logits, torch.from_numpy(batch["labels"]).long())
    names, ps = zip(*model.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, ps)))


def test_model_gradients_match_jax(smoke):
    """Every leaf's gradient against jax.grad of JAX's train_logits +
    cross_entropy on bridged weights: within 1e-4 of the leaf's largest
    gradient (f32; XLA's chunked attention and remat sum in another
    order)."""
    jcfg, tcfg, _, state, batches = smoke
    b = batches[0]

    def loss_fn(p):
        logits, _ = jax_train_logits(jcfg, p, {"tokens": jnp.asarray(
            b["tokens"])})
        return jax_cross_entropy(logits, jnp.asarray(b["labels"]))[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(state["params"])
    loss, grads = _port_grads(tcfg, _port_params(tcfg, state["params"]), b)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref = params_from_jax(tcfg, jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(ref)
    for name, g in grads.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-4 * float(np.abs(r).max()),
                                   err_msg=name)


def test_remat_full_and_none_give_the_same_gradients(smoke):
    _, tcfg, _, state, batches = smoke
    params = _port_params(tcfg, state["params"])
    l1, g1 = _port_grads(tcfg, params, batches[1], remat="full")
    l2, g2 = _port_grads(tcfg, params, batches[1], remat="none")
    assert torch.equal(l1, l2)
    for name in g1:
        torch.testing.assert_close(g1[name], g2[name], rtol=0, atol=0,
                                   msg=name)
    with pytest.raises(ValueError, match="remat"):
        _port_grads(tcfg, params, batches[1], remat="partial")


# -- train step -------------------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax_over_ten_steps(smoke, micro):
    """Ten steps from the same state on the same batches. Per step: loss
    and ce within rel 1e-4, grad_norm within rel 2e-3, lr and accuracy
    within rel 1e-6, tokens exact.

    Params after step 1 and step 10: every entry within 0.25 of the summed
    learning rates, and all but 0.5% of entries within 1% of it. AdamW's
    first update is g / (|g| + eps), close to sign(g): an entry whose
    gradient is near eps (1e-8) takes the sign of the two frameworks'
    rounding, and moves by up to lr in one and not the other. On this
    config 0.25% of entries do so at step 1 (10% of lr at most) and keep
    their offset; the rest agree to 1e-3 of the summed lr. The same offset
    nudges the later gradients, hence grad_norm's wider bar (6.6e-4 seen).
    A wrong gradient moves whole tensors by up to twice the summed lr."""
    jcfg, tcfg, ocfg, state, batches = smoke
    jstep = jax.jit(jax_build_train_step(
        jcfg, JaxOptConfig(**ocfg), JaxTrainConfig(n_microbatches=micro)))
    tstep = build_train_step(tcfg, OptConfig(**ocfg),
                             TrainConfig(n_microbatches=micro))
    params = _port_params(tcfg, state["params"])
    ours = {"params": params, "opt": init_opt(params, OptConfig(**ocfg))}
    theirs = state
    lr_sum = 0.0
    for i, b in enumerate(batches):
        ours, tm = tstep(ours, _torch_batch(b))
        theirs, jm = jstep(theirs, {k: jnp.asarray(v) for k, v in b.items()})
        assert set(tm) == set(jm)
        for k, rtol in (("loss", 1e-4), ("grad_norm", 2e-3), ("lr", 1e-6),
                        ("tokens", 0), ("ce", 1e-4), ("accuracy", 1e-6)):
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=rtol,
                                       err_msg=f"step {i + 1} {k}")
        assert int(tm["step"]) == int(jm["step"]) == i + 1
        lr_sum += float(jm["lr"])
        if i in (0, 9):
            ref = params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                     theirs["params"]))
            d = np.concatenate([(ours["params"][k] - ref[k]).abs().flatten()
                                .numpy() for k in ref])
            assert d.max() <= 0.25 * lr_sum, (i, d.max(), lr_sum)
            assert np.mean(d > 1e-2 * lr_sum) <= 5e-3, (i, np.mean(
                d > 1e-2 * lr_sum))


# -- entry point ------------------------------------------------------------

def test_launch_train_smoke_on_cpu(capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu --steps 3``
    runs and reports a finite loss."""
    last = train_main(["--smoke", "--device", "cpu", "--steps", "3",
                       "--global-batch", "4", "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "step     3 loss" in out and out.strip().endswith("done")
    assert math.isfinite(last["loss"]) and last["step"] == 3
