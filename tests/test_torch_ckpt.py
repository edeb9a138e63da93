"""The port's checkpoints against the JAX package's: the same on-disk
format both ways (JAX -> port -> JAX bit for bit, with the reference's
skeleton, dtypes and byte count; float8 leaves), JAX's train step resuming
a torch-saved state, a run cut by a save and a restore equal to one that
was not, the async ``Checkpointer`` (snapshot, keep-N, a failed write),
and ``launch/train.py --ckpt-dir`` resuming, then serving its state."""
import json
import os
import shutil
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.ckpt import restore_checkpoint as jax_restore
from repro.ckpt import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.train import OptConfig as JaxOptConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_train_state as jax_init_train_state
from repro_torch.ckpt import (Checkpointer, latest_step, restore_checkpoint,
                              save_checkpoint)
from repro_torch.ckpt import checkpoint as port_ckpt
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, to_torch
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import params_from_jax, state_from_jax, state_to_jax
from repro_torch.train import OptConfig, build_train_step, init_train_state

F32 = {"dtype": "float32"}
OCFG = dict(lr=1e-3, warmup_steps=3, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops run as fast on one thread, and the suite's workers
    share the machine's cores: more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    """The f32 smoke config, JAX train state from key 0, and six batches."""
    jcfg = jax_get_config("tacc-100m", smoke=True).smoke(**F32)
    tcfg = get_config("tacc-100m", smoke=True).smoke(**F32)
    state = jax_init_train_state(jcfg, JaxOptConfig(**OCFG),
                                 jax.random.PRNGKey(0))
    data = SyntheticLM(tcfg, 4, 32, seed=0)
    return jcfg, tcfg, state, [data.batch(i) for i in range(6)]


def _manifest(root, step):
    with open(os.path.join(root, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


# -- the format -------------------------------------------------------------

@pytest.mark.parametrize("period_dtype", ["float32", "bfloat16"])
def test_jax_state_through_the_port_restores_bit_for_bit(smoke, tmp_path,
                                                         period_dtype):
    """A JAX train state -> ``state_from_jax`` -> the port's save ->
    ``repro.ckpt.restore_checkpoint``: every leaf bit-equal, and the
    manifest's skeleton, dtypes, leaf count and bytes equal to those of the
    reference's save of the same state. The bf16 variant casts the period's
    params and first moments to bfloat16 (stored as uint16 views)."""
    _, tcfg, state, _ = smoke

    def leaf(path, x):
        keys = [getattr(k, "key", None) for k in path]
        if period_dtype == "bfloat16" and "period" in keys and "v" not in keys:
            return np.asarray(x.astype(jnp.bfloat16))
        return np.asarray(x)

    # as jax.tree rebuilds it (a jitted step's output): every dict sorted
    state = jax.tree_util.tree_map_with_path(leaf, state)
    ours = state_from_jax(tcfg, state, "cpu")
    save_checkpoint(str(tmp_path / "port"), 7, state_to_jax(tcfg, ours))
    jax_save(str(tmp_path / "ref"), 7, state)
    mine, ref = _manifest(tmp_path / "port", 7), _manifest(tmp_path / "ref", 7)
    for k in ("skeleton", "dtypes", "n_leaves", "nbytes", "step"):
        assert mine[k] == ref[k], k
    if period_dtype == "bfloat16":
        assert "bfloat16" in mine["dtypes"]
    back, _ = jax_restore(str(tmp_path / "port"))
    assert jax.tree.structure(back) == jax.tree.structure(state)
    assert all(jax.tree.leaves(jax.tree.map(_same_bits, back, state)))


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "float8_e5m2"])
def test_float8_leaves_round_trip(tmp_path, dtype):
    """Every bit pattern of a float8 leaf (and a bf16 one beside it): the
    port's save restores bit for bit in the port and, as the ``ml_dtypes``
    type with the same bits, in the reference; the reference's save of the
    same leaves restores into the port."""
    bits = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    bf16_bits = torch.arange(-300, 300, dtype=torch.int16)
    state = {"f8": bits.view(getattr(torch, dtype)),
             "bf16": bf16_bits.view(torch.bfloat16)}
    save_checkpoint(str(tmp_path / "port"), 1, state)
    assert _manifest(tmp_path / "port", 1)["dtypes"] == [dtype, "bfloat16"]
    ours, _ = restore_checkpoint(str(tmp_path / "port"))
    assert ours["f8"].dtype == getattr(torch, dtype)
    assert torch.equal(ours["f8"].view(torch.uint8), bits)
    assert torch.equal(ours["bf16"].view(torch.int16), bf16_bits)
    theirs, _ = jax_restore(str(tmp_path / "port"))
    assert theirs["f8"].dtype == np.dtype(getattr(ml_dtypes, dtype))
    assert np.array_equal(theirs["f8"].view(np.uint8), bits.numpy())
    assert np.array_equal(theirs["bf16"].view(np.int16), bf16_bits.numpy())
    jax_save(str(tmp_path / "ref"), 1, theirs)
    again, _ = restore_checkpoint(str(tmp_path / "ref"))
    assert torch.equal(again["f8"].view(torch.uint8), bits)
    assert torch.equal(again["bf16"].view(torch.int16), bf16_bits)


# -- resuming ---------------------------------------------------------------

def test_jax_resumes_a_torch_saved_state(smoke, tmp_path):
    """The port trains 2 steps from JAX's initial state and saves; JAX
    restores that checkpoint and takes steps 3 and 4 with its jitted step,
    the port takes them from its own state. The bars of
    ``tests/test_torch_train.py``: loss and ce within rel 1e-4, grad_norm
    within rel 2e-3, and every param within 0.25 of the summed lr of the
    two steps, at most 0.5% of entries beyond 1% of it."""
    jcfg, tcfg, state, batches = smoke
    tstep = build_train_step(tcfg, OptConfig(**OCFG))
    ours = state_from_jax(tcfg, jax.tree.map(np.asarray, state), "cpu")
    for b in batches[:2]:
        ours, _ = tstep(ours, to_torch(b, "cpu"))
    save_checkpoint(str(tmp_path), 2, state_to_jax(tcfg, ours))
    theirs, man = jax_restore(str(tmp_path))
    assert man["step"] == 2 and int(theirs["opt"]["step"]) == 2
    theirs = jax.tree.map(jnp.asarray, theirs)
    jstep = jax.jit(jax_build_train_step(jcfg, JaxOptConfig(**OCFG),
                                         JaxTrainConfig()))
    lr_sum = 0.0
    for i in (2, 3):
        ours, tm = tstep(ours, to_torch(batches[i], "cpu"))
        theirs, jm = jstep(theirs, {k: jnp.asarray(v)
                                    for k, v in batches[i].items()})
        for k, rtol in (("loss", 1e-4), ("ce", 1e-4), ("grad_norm", 2e-3),
                        ("lr", 1e-6)):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol,
                                       err_msg=f"step {i + 1} {k}")
        assert int(tm["step"]) == int(jm["step"]) == i + 1
        lr_sum += float(jm["lr"])
    ref = params_from_jax(tcfg, jax.tree.map(np.asarray, theirs["params"]))
    d = np.concatenate([(ours["params"][k] - ref[k]).abs().flatten().numpy()
                        for k in ref])
    assert d.max() <= 0.25 * lr_sum, (d.max(), lr_sum)
    assert np.mean(d > 1e-2 * lr_sum) <= 5e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_n_steps_equal_n_then_save_restore_then_n(tmp_path, dtype):
    """2N = N + save/restore + N on the CPU, bit for bit: params, m, v,
    step and every metric of every step. The restored run builds a new
    train step, as a restarted job does. The checkpoint holds every bit of
    the state and the step is a pure function of (state, batch), so any
    difference would be a fault of the save or of the restore."""
    cfg = get_config("tacc-100m", smoke=True).smoke(dtype=dtype)
    ocfg = OptConfig(**OCFG)
    data = SyntheticLM(cfg, 4, 32, seed=3)
    n = 3

    def fresh():
        return init_train_state(cfg, ocfg, torch.Generator().manual_seed(5),
                                "cpu")

    def run(state, steps, step_fn):
        ms = []
        for i in steps:
            state, m = step_fn(state, to_torch(data.batch(i), "cpu"))
            ms.append({k: v.clone() for k, v in m.items()})
        return state, ms

    straight, m_straight = run(fresh(), range(2 * n),
                               build_train_step(cfg, ocfg))
    half, m_first = run(fresh(), range(n), build_train_step(cfg, ocfg))
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(n, state_to_jax(cfg, half), block=True)
    del half
    tree, man = ck.restore()
    assert man["step"] == n
    resumed, m_second = run(state_from_jax(cfg, tree, "cpu"), range(n, 2 * n),
                            build_train_step(cfg, ocfg))
    for i, (a, b) in enumerate(zip(m_straight, m_first + m_second)):
        for k in a:
            assert torch.equal(a[k], b[k]), (i + 1, k, a[k], b[k])
    for part in ("params", "m", "v"):
        ta = straight["params"] if part == "params" else straight["opt"][part]
        tb = resumed["params"] if part == "params" else resumed["opt"][part]
        assert set(ta) == set(tb)
        for k in ta:
            assert ta[k].dtype == tb[k].dtype
            assert torch.equal(ta[k], tb[k]), (part, k)
    assert resumed["opt"]["step"].dtype == torch.int32
    assert int(resumed["opt"]["step"]) == int(straight["opt"]["step"]) == 2 * n


# -- Checkpointer -----------------------------------------------------------

def test_checkpointer_snapshot_is_a_copy(tmp_path, monkeypatch):
    """An in-place update made after ``save`` returns and before the write
    (held back here until the update is done) does not reach the saved
    leaves: ``save`` copies, even a CPU tensor, before its thread starts."""
    release = threading.Event()
    original = port_ckpt.save_checkpoint

    def held(*args, **kw):
        assert release.wait(30)
        return original(*args, **kw)

    monkeypatch.setattr(port_ckpt, "save_checkpoint", held)
    state = {"w": torch.zeros(1000), "opt": {"step": torch.tensor(3)}}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    state["w"].add_(1.0)
    state["opt"]["step"].add_(1)
    release.set()
    ck.wait()
    back, _ = ck.restore()
    assert torch.equal(back["w"], torch.zeros(1000))
    assert int(back["opt"]["step"]) == 3
    assert ck.saves[-1]["step"] == 1 and ck.saves[-1]["bytes"] == 4008


def test_checkpointer_keeps_the_newest_n(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in range(1, 5):
        ck.save(step, {"x": torch.full((3,), float(step))})
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]
    assert latest_step(str(tmp_path)) == 4
    assert torch.equal(ck.restore(3)[0]["x"], torch.full((3,), 3.0))


def test_a_failed_write_leaves_nothing_and_wait_raises(tmp_path, monkeypatch):
    """A leaf that fails mid-write (the second ``np.save`` raises): no
    ``step_*`` and no ``.tmp`` directory stays, ``wait`` raises the error
    once, and the next save works."""
    calls = {"n": 0}
    real_save = np.save

    def flaky(path, arr):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk full")
        real_save(path, arr)

    monkeypatch.setattr(port_ckpt.np, "save", flaky)
    ck = Checkpointer(str(tmp_path))
    state = {"a": torch.ones(4), "b": torch.ones(4), "c": torch.ones(4)}
    ck.save(5, state)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert os.listdir(tmp_path) == []
    assert latest_step(str(tmp_path)) is None
    ck.wait()                                   # raised once, not again
    ck.save(6, state, block=True)
    assert os.listdir(tmp_path) == ["step_0000000006"]


def test_latest_step_ignores_staging_dirs(tmp_path):
    save_checkpoint(str(tmp_path), 3, {"x": torch.zeros(2)})
    os.makedirs(tmp_path / "step_0000000009.tmp")
    assert latest_step(str(tmp_path)) == 3
    assert restore_checkpoint(str(tmp_path))[1]["step"] == 3


# -- entry points -----------------------------------------------------------

def test_launch_train_resumes_and_serve_reads_its_checkpoint(tmp_path,
                                                             capsys):
    """A straight ``--steps 8 --ckpt-every 4 --ckpt-dir d`` call; with its
    step-8 checkpoint deleted, a second ``--steps 8 --ckpt-dir d`` call
    prints ``restored step 4`` and ends with the same last metrics, bit for
    bit. ``launch/serve.py --ckpt-dir d`` then serves from the torch-saved
    state."""
    common = ["--smoke", "--device", "cpu", "--global-batch", "4",
              "--seq-len", "16", "--steps", "8"]
    d = str(tmp_path / "run")
    straight = train_main(common + ["--ckpt-dir", d, "--ckpt-every", "4"])
    assert sorted(os.listdir(d)) == ["step_0000000004", "step_0000000008"]
    shutil.rmtree(os.path.join(d, "step_0000000008"))
    capsys.readouterr()
    resumed = train_main(common + ["--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "restored step 4" in out and out.strip().endswith("done")
    assert resumed == straight
    assert sorted(os.listdir(d)) == ["step_0000000004", "step_0000000008"]
    serve_main(["--smoke", "--device", "cpu", "--ckpt-dir", d,
                "--requests", "3", "--max-batch", "2", "--max-seq", "24",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
