"""The port's ServeEngine against the JAX engine: identical greedy tokens with
slot reuse, the slot-lifecycle invariants of tests/test_serve_engine.py, a
checkpoint saved by the JAX package restored into the port, and the serve
launcher."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.ckpt import save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import model_defs as jax_model_defs
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.ckpt import latest_step, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.models import params_from_jax
from repro_torch.serve import ServeEngine

PROMPTS = [[5, 17, 3], [200, 1, 9, 77, 31], [8], [250, 4, 4, 4],
           [12, 13, 14, 15, 16, 17], [99, 100]]


@pytest.fixture(scope="module")
def f32_model():
    jcfg = jax_get_config("tacc-100m", smoke=True).smoke(dtype="float32")
    tcfg = get_config("tacc-100m", smoke=True).smoke(dtype="float32")
    jp = jax_init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, jp


@pytest.fixture(scope="module")
def bf16_model():
    jcfg = jax_get_config("tacc-100m", smoke=True)
    jp = jax_init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0))
    tcfg = get_config("tacc-100m", smoke=True)
    return tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


def _serve_both(jcfg, tcfg, jp, tp, max_new=6):
    """Greedy tokens of both engines, max_batch 2 so slots are reused.

    The JAX decode cannot write an f32 model's new K/V into its bf16 cache
    (lax.scatter refuses mixed dtypes, repro/models/attention.py:238), so
    both engines get f32 caches here.
    """
    je = JaxServeEngine(jcfg, jp, max_batch=2, max_seq=32)
    je.cache = jax.tree.map(lambda a: a.astype(jnp.float32)
                            if a.dtype == jnp.bfloat16 else a, je.cache)
    te = ServeEngine(tcfg, tp, max_batch=2, max_seq=32, device="cpu")
    te.cache["layers"] = [{k: v.float() for k, v in c.items()}
                          for c in te.cache["layers"]]
    jr = je.run(PROMPTS, max_new=max_new)
    tr = te.run(PROMPTS, max_new=max_new)
    assert je._steps == te._steps
    return [r.tokens for r in jr], [r.tokens for r in tr]


def test_greedy_tokens_identical_to_jax_engine(f32_model):
    jcfg, tcfg, jp = f32_model
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    jt, tt = _serve_both(jcfg, tcfg, jp, tp)
    assert len(tt) == len(PROMPTS) and all(len(t) == 6 for t in tt)
    assert tt == jt


def test_jax_checkpoint_restores_into_the_port(f32_model, tmp_path):
    """f32 and bf16 leaves saved by repro.ckpt.save_checkpoint restore bit
    for bit and serve the same tokens as the JAX engine on those params."""
    jcfg, tcfg, jp = f32_model
    mixed = dict(jp, period=jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                         jp["period"]))
    save_checkpoint(str(tmp_path), 3, {"params": mixed})
    assert latest_step(str(tmp_path)) == 3
    state, manifest = restore_checkpoint(str(tmp_path))
    assert "bfloat16" in manifest["dtypes"] and "float32" in manifest["dtypes"]
    tp = params_from_jax(tcfg, state["params"])
    assert tp["layers.0.mixer.wq"].dtype == torch.bfloat16
    assert tp["embed.tok"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["layers.1.ffn.w_in"].float().numpy(),
        np.asarray(mixed["period"][0]["ffn"]["w_in"][1], np.float32))
    np.testing.assert_array_equal(tp["embed.tok"].numpy(),
                                  np.asarray(jp["embed"]["tok"]))
    jt, tt = _serve_both(jcfg, tcfg, mixed, tp, max_new=4)
    assert tt == jt


def test_freed_slot_lengths_pinned(bf16_model):
    cfg, params = bf16_model
    eng = ServeEngine(cfg, params, max_batch=2, max_seq=32, device="cpu")
    assert eng.add_request([1, 2, 3], max_new=2) is not None      # slot 0
    assert eng.add_request([4, 5, 6, 7], max_new=24) is not None  # slot 1
    finished = []
    for _ in range(4):
        finished += eng.step()
        if finished:
            break
    assert [r.request_id for r in finished] == [0]
    assert int(eng.cache["lengths"][0]) == 0          # freed slot reset
    for _ in range(6):                                # slot 1 keeps decoding
        eng.step()
    assert int(eng.cache["lengths"][0]) == 0          # ...and 0 stays pinned
    assert int(eng.cache["lengths"][1]) <= eng.max_seq


def test_idle_engine_step_is_a_noop(bf16_model):
    cfg, params = bf16_model
    eng = ServeEngine(cfg, params, max_batch=2, max_seq=16, device="cpu")
    assert eng.step() == []
    assert eng._steps == 0 and eng.timings["decode"] == []
    assert int(eng.cache["lengths"].max()) == 0


def test_long_workload_never_exceeds_max_seq(bf16_model):
    cfg, params = bf16_model
    eng = ServeEngine(cfg, params, max_batch=2, max_seq=24, device="cpu")
    res = eng.run([[1, 2, 3]] * 6, max_new=8)
    assert len(res) == 6 and all(r.done for r in res)
    assert all(len(r.tokens) == 8 for r in res)
    assert int(eng.cache["lengths"].max()) <= 24
    assert len(eng.timings["prefill"]) == 6
    assert len(eng.timings["decode"]) == eng._steps


def test_engine_casts_matrices_once_and_keeps_norms_f32(bf16_model):
    cfg, params = bf16_model
    eng = ServeEngine(cfg, params, max_batch=1, max_seq=8, device="cpu")
    sd = eng.model.state_dict()
    assert sd["layers.0.mixer.wq"].dtype == torch.bfloat16
    assert sd["embed.tok"].dtype == torch.bfloat16
    assert sd["layers.0.mixer_norm.scale"].dtype == torch.float32
    assert params["layers.0.mixer.wq"].dtype == torch.float32  # caller's


def test_launcher_serves_on_cpu_and_from_a_checkpoint(f32_model, tmp_path,
                                                      capsys):
    from repro_torch.launch.serve import main
    jcfg, _, jp = f32_model
    save_checkpoint(str(tmp_path), 1, {"params": jax_init_params(
        jax_model_defs(jax_get_config("tacc-100m", smoke=True)),
        jax.random.PRNGKey(1))})
    for extra in ([], ["--ckpt-dir", str(tmp_path)]):
        main(["--smoke", "--device", "cpu", "--requests", "3",
              "--max-batch", "2", "--max-seq", "24", "--max-new", "3",
              *extra])
        assert "3 requests, 9 tokens" in capsys.readouterr().out
