"""Training cells: the program's train step (``build_train_step``) driven
on a fixed global batch of seeded sequences, step after step.

Set-up draws the weights, builds the step and its AdamW state once, and
runs the first ``checked_steps`` steps through the window's own call and
feed (this is also the warm-up: every kernel is built and every shape seen).
Their losses, the first step's gradient as the optimizer took it (its first
moment over 1 - b1) and each leaf's change after them are kept for the
comparison. The window then runs further steps on fresh rows until
``--seconds`` have passed. After it the plain reference that the
configuration names (float32, TF32 off) follows the same checked steps from
the same weights and rows.
"""
from __future__ import annotations

import gc
from typing import Dict, Optional

import numpy as np
import torch

from cellbench.harness import compare, manifest, weights, work
from cellbench.harness.program import model_config
from cellbench.harness.tracing import capture, clock, log, span


class Walk:
    """The rows of step ``i``: a frozen copy of the program's synthetic LM
    data (``repro_torch/data/synthetic.py``): a noisy affine walk modulo the
    vocabulary from a seeded start, a pure function of (seed, step)."""

    def __init__(self, vocab: int, rows: int, seq_len: int, seed: int,
                 a: int = 5, b: int = 17, noise: float = 0.05):
        self.vocab, self.rows, self.seq_len, self.seed = vocab, rows, seq_len, seed
        self.a, self.b, self.noise = a, b, noise

    def tokens(self, step: int) -> np.ndarray:
        v = self.vocab
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2**31))
        full = np.zeros((self.rows, self.seq_len + 1), np.int64)
        full[:, 0] = rng.randint(0, v, self.rows)
        noise_mask = rng.rand(self.rows, self.seq_len) < self.noise
        noise_tok = rng.randint(0, v, (self.rows, self.seq_len))
        for t in range(self.seq_len):
            nxt = (self.a * full[:, t] + self.b) % v
            full[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return full

    def batch(self, step: int, device) -> Dict[str, torch.Tensor]:
        full = torch.from_numpy(self.tokens(step))
        if torch.device(device).type == "cuda":
            full = full.pin_memory().to(device, non_blocking=True)
        else:
            full = full.to(device)
        return {"tokens": full[:, :-1], "labels": full[:, 1:]}


def change_norms(p: Dict[str, torch.Tensor], m: Dict, seed: int, device
                 ) -> Dict[str, float]:
    """Each leaf's distance from the seed's draw, the draw made again one
    group at a time."""
    out = {}
    for leaves in weights.groups(m, seed, device, serving=False):
        for name, w0 in leaves:
            out[name] = float((p[name].float() - w0).norm())
        del leaves, w0
    return out


def _faulty(step_fn, fault: Optional[str]):
    """The step with a planted fault (for the tests and the control runs):
    ``unchanged`` returns the state as it was; ``half_batch`` trains on
    the first half of the rows, the mean taken over them."""
    if fault is None:
        return step_fn
    if fault == "unchanged":
        def step(state, batch):
            import copy
            _, metrics = step_fn(copy.deepcopy(state), batch)
            return state, metrics
        return step
    if fault == "half_batch":
        def step(state, batch):
            half = next(iter(batch.values())).shape[0] // 2
            return step_fn(state, {k: v[:half] for k, v in batch.items()})
        return step
    raise ValueError(f"unknown fault {fault!r}")


class Session:
    """The program's train step and state for one cell and seed, and the
    window's own call and feed (``call(i)`` trains on step ``i``'s rows)."""

    def __init__(self, cell, seed: int, device, spans: bool,
                 fault: Optional[str] = None):
        from repro_torch.train.optimizer import OptConfig, init_opt
        from repro_torch.train.step import TrainConfig, build_train_step

        m, tr = cell.config["model"], cell.traffic
        self.m, self.tr, self.seed, self.device = m, tr, seed, device
        self.spans = spans
        self.ocfg = OptConfig(**tr["opt"])
        self.step_fn = _faulty(build_train_step(
            model_config(cell.config), self.ocfg,
            TrainConfig(n_microbatches=tr["microbatches"],
                        z_loss=tr["z_loss"]), remat=tr["remat"]), fault)
        params = weights.draw(m, seed, device, serving=False)
        self.state = {"params": params, "opt": init_opt(params, self.ocfg)}
        d = tr["data"]
        self.walk = Walk(m["vocab_size"], tr["global_batch"], tr["seq_len"],
                         seed, d["walk_a"], d["walk_b"], d["noise"])
        log("weights drawn, step built")

    def call(self, i: int):
        batch = self.walk.batch(i, self.device)
        with span("step_fn", self.spans):
            return self.step_fn(self.state, batch)[1]

    def checked(self) -> Dict:
        """The checked steps (the warm-up too): their losses, the first
        step's gradient as AdamW took it, each leaf's change after them."""
        losses, first = [], None
        for i in range(self.tr["checked_steps"]):
            losses.append(float(self.call(i)["loss"]))
            if i == 0:
                first = {k: float(v.float().norm()) / (1 - self.ocfg.b1)
                         for k, v in self.state["opt"]["m"].items()}
        moved = change_norms(self.state["params"], self.m, self.seed,
                             self.device)
        log(f"checked steps done, losses {losses}")
        return {"losses": losses, "first": first, "moved": moved}


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device,
        fault: Optional[str] = None) -> Dict:
    tr = cell.traffic
    rows, S = tr["global_batch"], tr["seq_len"]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sess = Session(cell, seed, device, trace, fault)
    prog = sess.checked()
    sync()

    n = tr["checked_steps"]
    t0 = clock()
    done = []
    while True:
        done.append(sess.call(n + len(done))["loss"])
        if clock() - t0 >= seconds:
            break
    sync()
    t1 = clock()
    steps = len(done)
    failed = int((~torch.isfinite(torch.stack(done))).sum())
    out = {"window_start": t0, "attempted": steps, "failed": failed,
           "memory_peak_bytes": torch.cuda.max_memory_allocated()
           if cuda else 0,
           "e2e": {"train_tokens_per_s": steps * rows * S / (t1 - t0)}}
    if trace:
        k = tr["trace_steps"]
        tr_, _ = capture(lambda: [sess.call(n + steps + j)
                                  for j in range(k)])
        out["ctx"] = {"kind": "train", "model": sess.m, "traffic": tr,
                      "trace": tr_, "traced_steps": k, "window_s": t1 - t0,
                      "steps": steps,
                      "model_flops": steps * work.train_flops(sess.m, rows, S)}
        out["trace"] = tr_
    log(f"window closed: {steps} steps in {t1 - t0:.3f} s")
    del sess, done
    free()
    ref = reference_readings(cell, seed, device)
    out["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                     for k, v in numbers(prog, ref).items()}
    log("reference done")
    return out


def reference_readings(cell, seed: int, device, control: bool = False
                       ) -> Dict:
    """The configuration's reference's losses, first clipped gradients and
    changes over the checked steps, from the seed's weights and rows (with
    ``control``, its products computed from e4m3 operands)."""
    m, tr = cell.config["model"], cell.traffic
    ref = manifest.reference(cell.config)
    d = tr["data"]
    walk = Walk(m["vocab_size"], tr["global_batch"], tr["seq_len"], seed,
                d["walk_a"], d["walk_b"], d["noise"])
    ref.exact()
    p = weights.draw(m, seed, device, serving=False)
    batches = [(b["tokens"], b["labels"]) for b in
               (walk.batch(i, device) for i in range(tr["checked_steps"]))]
    losses, first = ref.train(m, p, batches, tr["opt"], tr["z_loss"],
                              ref.fp8_mm if control else ref.f32_mm)
    moved = change_norms(p, m, seed, device)
    del p, batches
    gc.collect()
    return {"losses": losses, "first": first, "moved": moved}


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers compared: the widest loss gap over the checked
    steps, and the worst leaf's gap in the first gradient's norm and in
    the change's norm (leaves the reference's gradient moves only)."""
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"],
                                                   ref["losses"])),
        "grad_gap": compare.leaf_gap(prog["first"], ref["first"]),
        "change_gap": compare.leaf_gap(prog["moved"], ref["moved"],
                                       compare.moved_leaves(ref["first"]))}
