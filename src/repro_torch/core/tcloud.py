"""tcloud — TACC's lifecycle CLI (paper §4).

Serverless experience: submit ML tasks from anywhere, monitor distributed
logs, kill tasks — without maintaining an experiment environment. This
implementation drives an in-process TACC service against a state directory;
pointing ``--cluster-root`` elsewhere re-targets another TACC instance
("submit to a different cluster by changing a line of configuration").

  tcloud submit specs.json [--policy backfill] [--watch]
  tcloud demo                     # generate + run a small mixed workload
  tcloud hash specs.json          # reproducibility hashes
  tcloud status / logs are printed by --watch runs

Spec files contain one TaskSpec JSON object or a list of them.

The port's ``tcloud`` (``python -m repro_torch.core.tcloud``): the
reference's commands, arguments and defaults, with the jobs run by the
port's torch runtimes. ``--device`` names the device they run on, the card
by default; ``--device cpu`` runs the plain path.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.core.schema import ResourceSpec, RuntimeEnv, TaskSpec
from repro_torch.core.service import TACC


def _load_specs(path: str) -> List[TaskSpec]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = [data]
    return [TaskSpec.from_dict(d) for d in data]


def _print_status(svc: TACC) -> None:
    rows = svc.status()
    fmt = "{:<18} {:<18} {:<9} {:<10} {:>5} {:>12} {:>8} {:>8}"
    print(fmt.format("id", "name", "tenant", "state", "chips", "progress",
                     "preempt", "restart"))
    for r in rows:
        print(fmt.format(r["id"], r["name"][:18], r["tenant"], r["state"],
                         r["chips"], r["progress"], r["preempt"],
                         r["restarts"]))


def cmd_submit(args) -> int:
    svc = TACC(args.cluster_root, policy=args.policy,
               quantum_steps=args.quantum, device=args.device)
    ids = []
    for path in args.specs:
        for spec in _load_specs(path):
            jid = svc.submit(spec)
            ids.append(jid)
            print(f"submitted {spec.name} -> {jid} "
                  f"(spec hash {spec.spec_hash()})")
    if args.watch:
        svc.run_until_done()
        _print_status(svc)
        for jid in ids:
            print(f"\n--- logs {jid} ---")
            sys.stdout.writelines(svc.logs(jid))
    return 0


def demo_specs() -> List[TaskSpec]:
    return [
        TaskSpec(name="train-tacc100m", tenant="lab-a",
                 resources=ResourceSpec(chips=4),
                 runtime=RuntimeEnv(backend="torch_train",
                                    checkpoint_interval_steps=20),
                 entry={"arch": "tacc-100m", "smoke": True, "global_batch": 8,
                        "seq_len": 64, "lr": 1e-3}, total_steps=40,
                 estimated_duration_s=60),
        TaskSpec(name="serve-internlm2", tenant="lab-b",
                 resources=ResourceSpec(chips=2, qos="realtime", priority=5),
                 runtime=RuntimeEnv(backend="torch_serve"),
                 entry={"arch": "internlm2-1.8b", "smoke": True,
                        "max_batch": 2, "max_new": 4}, total_steps=4,
                 estimated_duration_s=30),
        TaskSpec(name="hello-shell", tenant="lab-a",
                 resources=ResourceSpec(chips=1, qos="besteffort"),
                 runtime=RuntimeEnv(backend="shell"),
                 entry={}, artifacts={"main": "print('hello from TACC')"},
                 total_steps=1, estimated_duration_s=5),
    ]


def cmd_demo(args) -> int:
    svc = TACC(args.cluster_root, policy=args.policy, quantum_steps=10,
               device=args.device)
    for spec in demo_specs():
        jid = svc.submit(spec)
        print(f"submitted {spec.name} -> {jid}")
    svc.run_until_done()
    _print_status(svc)
    for jid in list(svc.jobs):
        print(f"\n--- logs {jid} ---")
        sys.stdout.writelines(svc.logs(jid))
    return 0


def cmd_hash(args) -> int:
    for path in args.specs:
        for spec in _load_specs(path):
            print(spec.spec_hash(), spec.name)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tcloud")
    ap.add_argument("--cluster-root", default="artifacts/tacc-local",
                    help="TACC instance to talk to")
    ap.add_argument("--policy", default="backfill",
                    choices=["fifo", "backfill", "fair", "priority",
                             "goodput"])
    ap.add_argument("--device", default="cuda",
                    help="device the jobs run on (cuda, or cpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("submit")
    p.add_argument("specs", nargs="+")
    p.add_argument("--watch", action="store_true")
    p.add_argument("--quantum", type=int, default=10)
    p.set_defaults(fn=cmd_submit)
    p = sub.add_parser("demo")
    p.set_defaults(fn=cmd_demo)
    p = sub.add_parser("hash")
    p.add_argument("specs", nargs="+")
    p.set_defaults(fn=cmd_hash)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
