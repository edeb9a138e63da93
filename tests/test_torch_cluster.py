"""The port's runtimes under the TACC service beside the JAX runtimes: a
JAX-saved state resumed by a ``jax_train`` job of the reference's service
and by a ``torch_train`` job of the port's, and the cluster example
(``examples/train_cluster_torch.py``) surviving its failure and its
preemption on the CPU."""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs
from repro.ckpt import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.core import TACC as RefTACC
from repro.core import ResourceSpec as RefResourceSpec
from repro.core import RuntimeEnv as RefRuntimeEnv
from repro.core import TaskSpec as RefTaskSpec
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.train import OptConfig as JaxOptConfig
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_train_state as jax_init_train_state
from repro_torch.configs import get_config
from repro_torch.core import TACC, ResourceSpec, RuntimeEnv, TaskSpec
from repro_torch.core import executor as port_executor
from repro_torch.models import params_from_jax
from repro_torch.train import OptConfig, lr_at

ROOT = Path(__file__).resolve().parents[1]
ENTRY = {"arch": "tacc-100m", "smoke": True, "global_batch": 4,
         "seq_len": 32, "lr": 1e-3, "warmup": 3, "seed": 0}
TOTAL = 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops run as fast on one thread, and the suite's workers
    share the machine's cores: more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_jax_saved_state_resumes_alike_in_both_runtimes(tmp_path,
                                                          monkeypatch):
    """JAX takes 2 steps from its initial state and saves; the checkpoint
    goes into a ``jax_train`` job's ``workdir/ckpt`` (reference service)
    and a ``torch_train`` job's (the port's). Both log ``restored
    checkpoint @ step 2`` and take two quanta of 2 steps. Both runtimes run
    the f32 smoke config (bf16 rounds differently in XLA and PyTorch), so
    the bars of ``tests/test_torch_train.py`` hold: loss and ce within rel
    1e-4 and grad_norm within rel 2e-3 after each quantum, every param
    within 0.25 of the summed lr of steps 3-6 and at most 0.5% of entries
    beyond 1% of it."""
    f32 = lambda get: (lambda name, smoke=False:
                       get(name, smoke=smoke).smoke(dtype="float32"))
    monkeypatch.setattr(repro.configs, "get_config", f32(jax_get_config))
    monkeypatch.setattr(port_executor, "get_config", f32(get_config))
    jcfg = repro.configs.get_config("tacc-100m", smoke=True)
    ocfg = dict(lr=ENTRY["lr"], warmup_steps=ENTRY["warmup"],
                total_steps=TOTAL)
    state = jax_init_train_state(jcfg, JaxOptConfig(**ocfg),
                                 jax.random.PRNGKey(0))
    jstep = jax.jit(jax_build_train_step(jcfg, JaxOptConfig(**ocfg)))
    data = JaxSyntheticLM(jcfg, ENTRY["global_batch"], ENTRY["seq_len"],
                          seed=ENTRY["seed"])
    for i in range(2):
        state, _ = jstep(state, {k: jnp.asarray(v)
                                 for k, v in data.batch(i).items()})

    ref = RefTACC(str(tmp_path / "ref"), policy="fifo", quantum_steps=2)
    port = TACC(str(tmp_path / "port"), policy="fifo", quantum_steps=2,
                device="cpu")
    rid = ref.submit(RefTaskSpec(
        name="t", resources=RefResourceSpec(chips=1),
        runtime=RefRuntimeEnv(backend="jax_train",
                              checkpoint_interval_steps=100),
        entry=ENTRY, total_steps=TOTAL))
    pid = port.submit(TaskSpec(
        name="t", resources=ResourceSpec(chips=1),
        runtime=RuntimeEnv(backend="torch_train",
                           checkpoint_interval_steps=100),
        entry=ENTRY, total_steps=TOTAL))
    for svc, jid in ((ref, rid), (port, pid)):
        jax_save(str(Path(svc.jobs[jid].plan.workdir) / "ckpt"), 2, state)
    for _ in range(2):
        theirs, ours = ref.tick()[rid], port.tick()[pid]
        for k, rtol in (("loss", 1e-4), ("ce", 1e-4), ("grad_norm", 2e-3),
                        ("lr", 1e-6)):
            np.testing.assert_allclose(ours[k], theirs[k], rtol=rtol,
                                       err_msg=k)
        assert ours["step"] == theirs["step"]
    assert ours["step"] == 6
    for svc, jid in ((ref, rid), (port, pid)):
        assert "restored checkpoint @ step 2" in "".join(svc.logs(jid))
    lr_sum = sum(float(lr_at(OptConfig(**ocfg), torch.tensor(s)))
                 for s in range(3, 7))
    tcfg = get_config("tacc-100m", smoke=True).smoke(dtype="float32")
    want = params_from_jax(tcfg, jax.tree.map(
        np.asarray, ref.executor.runtimes[rid].state["params"]))
    got = port.executor.runtimes[pid].state["params"]
    d = np.concatenate([(got[k] - want[k]).abs().flatten().numpy()
                        for k in want])
    assert d.max() <= 0.25 * lr_sum, (d.max(), lr_sum)
    assert np.mean(d > 1e-2 * lr_sum) <= 5e-3


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_cluster_torch", ROOT / "examples" / "train_cluster_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cluster_example_survives_a_failure_and_a_preemption(capsys):
    """``examples/train_cluster_torch.py --smoke --device cpu --steps 30``:
    the training job completes after at least one restart (the failure at
    step 10) and one preemption (the serving job submitted at step 15),
    and the serving job completes."""
    _example().main(["--smoke", "--device", "cpu", "--steps", "30"])
    out = capsys.readouterr().out
    m = re.search(r"training survived (\d+) restart\(s\) and (\d+) "
                  r"preemption\(s\)", out)
    assert m and int(m.group(1)) >= 1 and int(m.group(2)) >= 1, out
    assert re.search(r"'name': 'urgent-eval'.*'state': 'COMPLETED'", out)
    assert "restored checkpoint @ step 20" in out
