"""Execution Layer (TACC §3.1, layer 4), with the port's runtimes.

Connects execution plans to underlying runtime systems. Three runtimes ship:

  - ``torch_train``: training through ``repro_torch.train`` on one device
    with checkpoint/restore into the plan workdir — preemption and node
    failure resume from the last checkpoint, which is written in JAX's tree
    layout (the JAX package restores it);
  - ``torch_serve``: batched serving through ``repro_torch.serve.ServeEngine``;
  - ``shell``  : runs a staged artifact as a python snippet (logs captured).

The LocalExecutor cooperatively multiplexes runtimes: each scheduler tick
grants every RUNNING job a quantum of real work. Per-job logs are aggregated
to one file per job (tcloud's distributed-monitoring view tails them).
Fail-safe switching (Table 1 of the paper): if a runtime raises, the job's
checkpointed state is kept and the job is requeued up to max_retries, after
which it is FAILED.

The port's counterpart of ``repro/core/executor.py``: the same interface
and control flow, with ``TorchTrainRuntime`` and ``TorchServeRuntime`` in
place of the JAX runtimes. Each runtime resolves its device in its
constructor, so a missing card raises out of ``provision`` (outside the
fail-safe) instead of turning into retries. A runtime's measurements
(``Runtime.stats``) are kept per job in ``LocalExecutor.stats`` when it is
deprovisioned.
"""
from __future__ import annotations

import io
import os
import time
import traceback
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.ckpt import Checkpointer, latest_step
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.compiler import ExecutionPlan
from repro_torch.core.scheduler import Job, JobState
from repro_torch.data import SyntheticLM, to_torch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import (init_serving_params, state_from_jax,
                                state_to_jax)
from repro_torch.serve import ServeEngine
from repro_torch.train import (OptConfig, TrainConfig, build_train_step,
                               init_train_state)


class Runtime:
    """One provisioned task instance."""

    def __init__(self, plan: ExecutionPlan):
        self.plan = plan
        self.logf = open(os.path.join(plan.workdir, "job.log"), "a")
        self.stats: Dict[str, List[Any]] = {}

    def log(self, msg: str) -> None:
        self.logf.write(f"[{time.strftime('%H:%M:%S')}] {msg}\n")
        self.logf.flush()

    def record(self, key: str, value: Any) -> None:
        self.stats.setdefault(key, []).append(value)

    def run_quantum(self, steps: int) -> Dict[str, Any]:
        raise NotImplementedError

    def progress(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        self.logf.close()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TorchTrainRuntime(Runtime):
    """Training on one device; checkpoint/restore in workdir.

    ``stats``: ``restores`` ({step, seconds}: read, then placed on the
    device), ``saves`` ({step, bytes, snapshot_s, write_s}, as
    ``Checkpointer.saves``; every save blocks, as in the reference) and
    ``quanta`` ({step, steps, loss, step_ms}: ``step_ms`` is the quantum's
    wall time less its saves, over its steps; the quantum ends by reading
    the metrics, which waits for the device).
    """

    @staticmethod
    def configs(spec) -> Tuple[ModelConfig, OptConfig, TrainConfig]:
        """The model, optimizer and train configs a spec's entry asks for:
        the keys and defaults of the reference's ``JaxTrainRuntime``."""
        e = spec.entry
        cfg = get_config(e["arch"], smoke=e.get("smoke", True))
        ocfg = OptConfig(lr=float(e.get("lr", 1e-3)),
                         warmup_steps=int(e.get("warmup", 20)),
                         total_steps=spec.total_steps)
        tcfg = TrainConfig(n_microbatches=int(e.get("n_microbatches", 1)))
        return cfg, ocfg, tcfg

    @staticmethod
    def stream(spec) -> Tuple[int, int, int]:
        """(global batch, sequence length, seed) of a spec's data stream;
        the seed also draws the initial state."""
        e = spec.entry
        return (int(e.get("global_batch", 8)), int(e.get("seq_len", 64)),
                int(e.get("seed", 0)))

    def __init__(self, plan: ExecutionPlan, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        super().__init__(plan)
        self.cfg, ocfg, tcfg = self.configs(plan.spec)
        self.batch, self.seq, seed = self.stream(plan.spec)
        self.data = SyntheticLM(self.cfg, self.batch, self.seq, seed=seed)
        self._step_fn = build_train_step(self.cfg, ocfg, tcfg)
        root = os.path.join(plan.workdir, "ckpt")
        self.ckpt = Checkpointer(root, keep=2)
        start = latest_step(root)
        if start is not None:
            t0 = time.perf_counter()
            tree, _ = self.ckpt.restore(start)
            self.state = state_from_jax(self.cfg, tree, self.device)
            _sync(self.device)
            self.record("restores", {"step": start,
                                     "seconds": time.perf_counter() - t0})
            self._step = start
            self.log(f"restored checkpoint @ step {start}")
        else:
            # drawn on the CPU: one seed gives one state on every device
            self.state = init_train_state(
                self.cfg, ocfg, torch.Generator().manual_seed(seed),
                self.device)
            self._step = 0
        self.ckpt_interval = plan.spec.runtime.checkpoint_interval_steps
        self.last_metrics: Dict[str, float] = {}

    def run_quantum(self, steps: int) -> Dict[str, Any]:
        t0 = time.perf_counter()
        saving = 0.0
        for _ in range(steps):
            b = to_torch(self.data.batch(self._step), self.device)
            self.state, m = self._step_fn(self.state, b)
            self._step += 1
            if self._step % self.ckpt_interval == 0:
                _sync(self.device)
                t1 = time.perf_counter()
                self.checkpoint()
                saving += time.perf_counter() - t1
        self.last_metrics = {k: float(v) for k, v in m.items()}
        self.record("quanta", {
            "step": self._step, "steps": steps,
            "loss": self.last_metrics["loss"],
            "step_ms": 1e3 * (time.perf_counter() - t0 - saving) / steps})
        self.log(f"step {self._step} loss={self.last_metrics.get('loss', 0):.4f}")
        return self.last_metrics

    def checkpoint(self) -> None:
        self.ckpt.save(self._step, state_to_jax(self.cfg, self.state),
                       block=True)
        self.record("saves", dict(self.ckpt.saves[-1]))
        self.log(f"checkpoint @ step {self._step}")

    def progress(self) -> int:
        return self._step

    def close(self) -> None:
        self.ckpt.wait()
        # drop the state here: nothing of it outlives deprovisioning
        self.state = self._step_fn = None
        super().close()


class TorchServeRuntime(Runtime):
    """Batched serving; a 'step' serves one request from the workload.

    ``stats``: ``quanta`` ({requests, tokens, seconds}: the requests a
    quantum served, the tokens they generated and the quantum's wall time;
    the engine returns host lists, so the device has finished).
    """

    def __init__(self, plan: ExecutionPlan, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        super().__init__(plan)
        e = plan.spec.entry
        self.cfg = get_config(e["arch"], smoke=e.get("smoke", True))
        seed = int(e.get("seed", 0))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = init_serving_params(self.cfg, gen, self.device)
        self.engine = ServeEngine(self.cfg, params,
                                  max_batch=int(e.get("max_batch", 4)),
                                  max_seq=int(e.get("max_seq", 64)),
                                  device=self.device)
        rng = np.random.RandomState(seed)
        n = plan.spec.total_steps
        self.requests = [list(rng.randint(1, self.cfg.vocab_size, size=8))
                         for _ in range(n)]
        self.max_new = int(e.get("max_new", 8))
        self._done = 0

    def run_quantum(self, steps: int) -> Dict[str, Any]:
        todo = self.requests[self._done:self._done + steps]
        if todo:
            t0 = time.perf_counter()
            results = self.engine.run(todo, max_new=self.max_new)
            self._done += len(todo)
            self.record("quanta", {
                "requests": len(results),
                "tokens": sum(len(r.tokens) for r in results),
                "seconds": time.perf_counter() - t0})
            self.log(f"served {len(results)} requests "
                     f"({self._done}/{len(self.requests)})")
        return {"served": float(self._done)}

    def checkpoint(self) -> None:      # serving is stateless across requests
        pass

    def progress(self) -> int:
        return self._done

    def close(self) -> None:
        self.engine = None
        super().close()


class ShellRuntime(Runtime):
    """Executes the staged 'main' artifact as a python snippet."""

    def __init__(self, plan: ExecutionPlan, store):
        super().__init__(plan)
        self.store = store
        self._done = 0

    def run_quantum(self, steps: int) -> Dict[str, Any]:
        digest = self.plan.staged.get("main")
        out = io.StringIO()
        if digest:
            code = self.store.get(digest).decode()
            import contextlib
            with contextlib.redirect_stdout(out):
                exec(compile(code, "task_main", "exec"),
                     {"__name__": "__tacc_task__"})
        self._done = self.plan.spec.total_steps
        self.log(out.getvalue().strip() or "(no output)")
        return {"done": 1.0}

    def checkpoint(self) -> None:
        pass

    def progress(self) -> int:
        return self._done


class LocalExecutor:
    """Cooperative real executor: binds scheduler actions to runtimes on
    ``device`` (the card by default; ``"cpu"`` runs the plain path)."""

    def __init__(self, store, quantum_steps: int = 10,
                 fail_injector=None, device: DeviceLike = "cuda"):
        self.store = store
        self.quantum = quantum_steps
        self.device = device
        self.runtimes: Dict[str, Runtime] = {}
        self.fail_injector = fail_injector or (lambda job, step: False)
        # job id -> what its runtimes recorded, over every provisioning
        self.stats: Dict[str, Dict[str, List[Any]]] = {}

    def provision(self, job: Job) -> None:
        plan = job.plan
        if plan.backend == "torch_train":
            rt: Runtime = TorchTrainRuntime(plan, self.device)
        elif plan.backend == "torch_serve":
            rt = TorchServeRuntime(plan, self.device)
        else:
            rt = ShellRuntime(plan, self.store)
        self.runtimes[job.id] = rt
        job.progress = float(rt.progress())
        rt.log(f"provisioned on {job.chips} chips (plan {plan.plan_id})")

    def tick(self, running: List[Job]) -> Dict[str, Dict[str, Any]]:
        """Advance every running job one quantum of *real* work."""
        out: Dict[str, Dict[str, Any]] = {}
        for job in running:
            rt = self.runtimes.get(job.id)
            if rt is None:
                self.provision(job)
                rt = self.runtimes[job.id]
            try:
                if self.fail_injector(job, int(job.progress)):
                    raise RuntimeError("injected node failure")
                remaining = job.total_steps - int(job.progress)
                m = rt.run_quantum(min(self.quantum, max(remaining, 0)))
                job.progress = float(rt.progress())
                out[job.id] = m
                if job.progress >= job.total_steps:
                    rt.checkpoint()
                    job.state = JobState.COMPLETED
                    job.end_time = time.time()
                    self.deprovision(job.id)
            except Exception as e:
                rt.log(f"runtime error: {e}\n{traceback.format_exc()[-1000:]}")
                self.deprovision(job.id)
                job.restarts += 1
                if job.restarts > job.spec.max_retries:
                    job.state = JobState.FAILED
                else:
                    job.state = JobState.PENDING   # requeue; resumes from ckpt
                out[job.id] = {"error": str(e)}
        return out

    def checkpoint(self, job_id: str) -> None:
        rt = self.runtimes.get(job_id)
        if rt:
            rt.checkpoint()

    def deprovision(self, job_id: str) -> None:
        rt = self.runtimes.pop(job_id, None)
        if rt:
            rt.close()
            kept = self.stats.setdefault(job_id, {})
            for k, v in rt.stats.items():
                kept.setdefault(k, []).extend(v)

    def logs(self, job: Job, tail: int = 20) -> List[str]:
        p = os.path.join(job.plan.workdir, "job.log")
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return f.readlines()[-tail:]
