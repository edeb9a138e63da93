"""Every architecture the port registers against the JAX package at smoke
size, on weights bridged with ``params_from_jax`` and numpy-made inputs:
parameter names and shapes (full and smoke), train logits, and prefill + 4
decode steps against JAX's full forward. The bars are
tests/test_torch_model.py's: logits rel 0.03, prefill 0.05, decode 0.08.
JAX runs only its full forward, once per arch (its own prefill and decode
over all archs take about 93 s: tests/test_serve_consistency.py, marked
slow)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import model_defs as jax_model_defs
from repro.models.params import ParamDef as JaxParamDef
from repro.models.transformer import train_logits as jax_train_logits
from repro_torch.configs import get_config, list_archs
from repro_torch.models import (Transformer, decode_step, model_defs,
                                params_from_jax, prefill, train_logits)

B, S, NDEC = 2, 32, 4
ARCHS = sorted(list_archs())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops run as fast on one thread, and the suite's workers
    share the machine's cores: more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-6)


def _bf16_values(a):
    """numpy f32 holding bf16-representable values, as JAX's bf16 inputs."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _batch(cfg):
    """The JAX suite's inputs for ``cfg.input_mode`` (numpy, seed 1)."""
    rng = np.random.default_rng(1)
    vt = cfg.vision_tokens
    if cfg.input_mode == "embeds":
        return {"frame_embeds": _bf16_values(
            rng.standard_normal((B, S, cfg.d_model)))}
    if cfg.input_mode == "tokens+vision":
        return {"tokens": rng.integers(0, cfg.vocab_size,
                                       (B, S - vt)).astype(np.int32),
                "vision_embeds": _bf16_values(
                    rng.standard_normal((B, vt, cfg.d_model)))}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v.copy()).long() if v.dtype == np.int32
            else torch.from_numpy(v.copy()) for k, v in batch.items()}


_CACHE = {}


def _arch(arch):
    """(port model, numpy batch, JAX's full-forward logits) for ``arch``,
    made once per arch."""
    if arch not in _CACHE:
        jcfg, tcfg = jax_get_config(arch, smoke=True), get_config(arch,
                                                                  smoke=True)
        jp = jax_init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0))
        model = Transformer(tcfg, params_from_jax(tcfg, jax.tree.map(
            np.asarray, jp)), device="cpu")
        batch = _batch(tcfg)
        logits, _ = jax.jit(lambda p, b: jax_train_logits(jcfg, p, b))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        _CACHE[arch] = model, batch, np.asarray(logits)
    return _CACHE[arch]


def _unstacked_jax_shapes(cfg):
    """{port name: shape} from the JAX defs, the prelayers first, then the
    period unstacked."""
    out = {}
    n_pre = len(cfg.prelayers)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax_model_defs(cfg), is_leaf=lambda x: isinstance(x, JaxParamDef))
    for path, d in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "period":
            j, rest = keys[1], ".".join(keys[2:])
            for i in range(cfg.n_periods):
                out[f"layers.{n_pre + i * len(cfg.period) + j}.{rest}"] = \
                    d.shape[1:]
        elif keys[0] == "prelayers":
            out[f"layers.{keys[1]}.{'.'.join(keys[2:])}"] = d.shape
        else:
            out[".".join(map(str, keys))] = d.shape
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_names_and_shapes_match_jax(arch):
    """Full size (defs only, nothing allocated) and smoke size."""
    for smoke in (False, True):
        shapes = {k: d.shape for k, d in
                  model_defs(get_config(arch, smoke=smoke)).items()}
        assert shapes == _unstacked_jax_shapes(
            jax_get_config(arch, smoke=smoke)), (arch, smoke)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_jax(arch):
    model, batch, ref = _arch(arch)
    with torch.inference_mode():
        logits, aux = train_logits(model, _torch(batch))
    assert logits.dtype == torch.float32 and logits.shape == ref.shape
    assert _rel_err(logits.numpy(), ref) < 0.03
    if model.cfg.moe is None:
        assert aux is None
    else:
        assert set(aux) == {"moe_load_balance", "moe_router_z"}
        assert all(float(v) > 0 for v in aux.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_jax_full_forward(arch):
    model, batch, full = _arch(arch)
    cfg, tb = model.cfg, _torch(batch)
    vt = cfg.vision_tokens
    Sp = S - NDEC
    pad = lambda t, n: torch.nn.functional.pad(t, (0, n))  # noqa: E731
    if cfg.input_mode == "embeds":
        pb = {"frame_embeds": torch.nn.functional.pad(
            tb["frame_embeds"][:, :Sp], (0, 0, 0, NDEC))}
    elif cfg.input_mode == "tokens+vision":
        pb = {"tokens": pad(tb["tokens"][:, :Sp - vt], NDEC),
              "vision_embeds": tb["vision_embeds"]}
    else:
        pb = {"tokens": pad(tb["tokens"][:, :Sp], NDEC)}
    with torch.inference_mode():
        lg, cache = prefill(model, pb, torch.full((B,), Sp, dtype=torch.int32))
        assert _rel_err(lg.numpy(), full[:, Sp - 1]) < 0.05
        for i in range(NDEC):
            pos = Sp + i
            if cfg.input_mode == "embeds":
                tok = tb["frame_embeds"][:, pos][:, None]
            elif cfg.input_mode == "tokens+vision":
                tok = tb["tokens"][:, pos - vt]
            else:
                tok = tb["tokens"][:, pos]
            lg, cache = decode_step(model, cache, tok)
            assert _rel_err(lg.numpy(), full[:, pos]) < 0.08, f"step {i}"
    assert cache["lengths"].tolist() == [S] * B
