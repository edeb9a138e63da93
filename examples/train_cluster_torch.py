"""End-to-end driver on the PyTorch port: train a ~110M-parameter model
THROUGH the full TACC stack — schema -> compiler (CAS) -> scheduler
(priority policy) -> execution layer (torch training, the card's kernels)
— with a node failure injected mid-run (checkpoint restart) and a
high-priority serving task that preempts the training job
(checkpoint-then-preempt). The port's counterpart of
``examples/train_cluster.py``; it imports only ``repro_torch``.

  PYTHONPATH=src python examples/train_cluster_torch.py             # full, card
  PYTHONPATH=src python examples/train_cluster_torch.py --smoke --device cpu

``run_scenario`` is the scenario itself and returns the finished service;
``chip_smoke.py`` runs it on the card at full width.
"""
import argparse
import tempfile
import time
from typing import List, Optional

from repro_torch.core import JobState, ResourceSpec, RuntimeEnv, TACC, TaskSpec

TRAIN_NAME = "train-main"
URGENT_NAME = "urgent-eval"


def train_spec(*, smoke: bool, steps: int, ckpt_every: int = 25) -> TaskSpec:
    """The training job's spec; ``tools/jax_loss_curve.py`` takes JAX's
    reference curve from it."""
    return TaskSpec(
        name=TRAIN_NAME, tenant="lab-a",
        resources=ResourceSpec(chips=8, priority=0),
        runtime=RuntimeEnv(backend="torch_train",
                           checkpoint_interval_steps=ckpt_every),
        entry={"arch": "tacc-100m", "smoke": smoke,
               "global_batch": 8 if smoke else 16,
               "seq_len": 64 if smoke else 128, "lr": 3e-4},
        total_steps=steps, estimated_duration_s=1200)


def run_scenario(root: str, *, smoke: bool, steps: int, device: str = "cuda",
                 ckpt_every: int = 25, verbose: bool = True) -> TACC:
    """Submits the training job, fails it once at progress >= steps // 3,
    submits the urgent serving job at progress >= steps // 2, and ticks
    until every job has ended. Returns the service; ``svc.jobs`` holds the
    two jobs under the names ``TRAIN_NAME`` and ``URGENT_NAME``."""
    say = print if verbose else (lambda *a, **k: None)
    fail_state = {"armed": True}

    def fail_injector(job, step):
        # one injected node failure mid-run for the big training job
        if job.spec.name == TRAIN_NAME and fail_state["armed"] \
                and step >= steps // 3:
            fail_state["armed"] = False
            say(f"  !! injecting node failure for {job.id} at step {step}")
            return True
        return False

    svc = TACC(root, policy="priority", quantum_steps=10,
               fail_injector=fail_injector, device=device)
    train = train_spec(smoke=smoke, steps=steps, ckpt_every=ckpt_every)
    jid = svc.submit(train)
    say(f"submitted {train.name} -> {jid} (spec hash {train.spec_hash()})")

    urgent_sent = False
    while True:
        svc.tick()
        job = svc.jobs[jid]
        if not urgent_sent and job.progress >= steps // 2:
            urgent = TaskSpec(
                name=URGENT_NAME, tenant="lab-b",
                resources=ResourceSpec(chips=8, priority=10,
                                       qos="realtime"),
                runtime=RuntimeEnv(backend="torch_serve"),
                entry={"arch": "tacc-100m", "smoke": True,
                       "max_batch": 2, "max_new": 4},
                total_steps=4, estimated_duration_s=30)
            uid = svc.submit(urgent)
            urgent_sent = True
            say(f"  submitted high-priority {urgent.name} -> {uid}")
        if all(j.state in (JobState.COMPLETED, JobState.FAILED,
                           JobState.KILLED) for j in svc.jobs.values()):
            return svc


def job_named(svc: TACC, name: str):
    return next(j for j in svc.jobs.values() if j.spec.name == name)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model (CI); default is the full ~110M config")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    steps = args.steps or (60 if args.smoke else 300)

    with tempfile.TemporaryDirectory() as td:
        t0 = time.time()
        svc = run_scenario(td, smoke=args.smoke, steps=steps,
                           device=args.device)
        print(f"\nfinished in {time.time()-t0:.0f}s wall")
        for row in svc.status():
            print(" ", row)
        job = job_named(svc, TRAIN_NAME)
        assert job.state == JobState.COMPLETED, job.state
        assert job.restarts >= 1, "failure injection should have fired"
        print(f"\ntraining survived {job.restarts} restart(s) and "
              f"{job.preemptions} preemption(s); last lines of its log:")
        for line in svc.logs(job.id, tail=8):
            print("   ", line.rstrip())


if __name__ == "__main__":
    main()
