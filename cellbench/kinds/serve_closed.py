"""Serving cells under a closed loop: a fixed number of clients, each
sending its next request as soon as its last one has finished, to the
program's engine (``ServeEngine.add_request`` and ``step``).

The requests are drawn from the seed in blocks that all hold the same
prompt and output lengths (quantiles of the traffic file's distributions)
in a seeded order, with seeded token ids; so every seed asks for the same
work block by block, and a window, which ends inside a block, differs from
seed to seed only in that block's part. Set-up draws the weights, builds
the engine and runs the loop until each client's first request has
finished (the ramp, which also warms every shape the window uses). The
window then runs for ``--seconds``: each loop admits every waiting request
(one padded prefill each) and takes one decode step. Its tallies are closed
when it ends; the loop then runs on, outside them, until every request sent
in the window has its first token. A request's time to first token runs
from when its client sent it to when its first token reached the host.

After the window, a sample of the finished requests drawn from the seed
(the longest among them) is run through the plain reference that the
configuration names (float32, TF32 off) over each prompt and its served
tokens; the mean, over the sampled served tokens, of the gap by which a
served token's logit lies below the reference's best is compared. (The
widest gap, logged, does not separate the program from the e4m3 control by
the factor of three a limit needs: it saturates at the spacing of the
reference's top logits.)
"""
from __future__ import annotations

import gc
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from cellbench.harness import compare, manifest, weights, work
from cellbench.harness.program import model_config
from cellbench.harness.tracing import capture, clock, log, span


class Requests:
    """Request ``i`` of a seed: (prompt token ids, tokens to generate)."""

    def __init__(self, traffic: Dict, vocab: int, seed: int):
        n = traffic["block"]
        pr, out = traffic["prompt"], traffic["output"]
        q = [(j + 0.5) / n for j in range(n)]
        z = statistics.NormalDist()
        self.lengths = [int(min(max(round(pr["median"] * np.exp(
            pr["sigma"] * z.inv_cdf(u))), pr["min"]), pr["max"])) for u in q]
        self.outputs = [int(round(out["min"] + (out["max"] - out["min"]) * u))
                        for u in q]
        self.block, self.vocab = n, vocab
        self.rng = np.random.default_rng(seed)
        self.drawn: List = []

    def __call__(self, i: int):
        while len(self.drawn) <= i:
            lp = self.rng.permutation(self.block)
            op = self.rng.permutation(self.block)
            for a, b in zip(lp, op):
                L = self.lengths[a]
                self.drawn.append(
                    (self.rng.integers(0, self.vocab, L).tolist(),
                     self.outputs[b]))
        return self.drawn[i]


class Loop:
    """The clients, the engine and the tallies of what was done."""

    def __init__(self, engine, requests: Requests, clients: int, m: Dict,
                 spans: bool):
        self.engine, self.requests, self.m, self.spans = (
            engine, requests, m, spans)
        self.waiting: List[Dict] = []      # sent, not yet admitted
        self.active: List[Dict] = []       # admitted, not finished
        self.records: List[Dict] = []
        self.tally = self.fresh()
        for _ in range(clients):
            self.send(clock())

    @staticmethod
    def fresh() -> Dict:
        return {"prefill_lengths": [], "decode_rows": [], "flops": 0.0,
                "tokens": 0}

    def send(self, t: float) -> None:
        prompt, max_new = self.requests(len(self.records))
        rec = {"prompt": prompt, "max_new": max_new, "sent": t,
               "first": None, "finished": None, "result": None}
        self.records.append(rec)
        self.waiting.append(rec)

    def admit(self) -> None:
        while self.waiting and self.engine.active() < self.engine.max_batch:
            rec = self.waiting.pop(0)
            with span("add_request", self.spans):
                rec["result"] = self.engine.add_request(
                    rec["prompt"], max_new=rec["max_new"])
            rec["first"] = clock()
            L = len(rec["prompt"])
            self.active.append(rec)
            self.tally["prefill_lengths"].append(L)
            self.tally["flops"] += work.prefill_flops(self.m, L)
            self.tally["tokens"] += 1

    def decode(self) -> None:
        if not self.active:
            return
        for rec in self.active:
            ctx = len(rec["prompt"]) + len(rec["result"].tokens)
            self.tally["flops"] += work.decode_flops(self.m, ctx)
        self.tally["decode_rows"].append(len(self.active))
        self.tally["tokens"] += len(self.active)
        with span("step", self.spans):
            finished = self.engine.step()
        t = clock()
        for r in finished:
            rec = next(x for x in self.active if x["result"] is r)
            rec["finished"] = t
            self.active.remove(rec)
            self.send(t)

    def once(self) -> None:
        self.admit()
        self.decode()


def window(loop: Loop, seconds: float) -> Dict:
    """The measured window: the loop for ``seconds``, its tallies and the
    engine's step times closed at its end (``t1``); then the loop run on,
    into fresh tallies, until each request ``sent`` in it has its first
    token."""
    engine = loop.engine
    loop.tally = loop.fresh()
    n_pre, n_dec = (len(engine.timings["prefill"]),
                    len(engine.timings["decode"]))
    t0 = clock()
    while clock() - t0 < seconds:
        loop.once()
    t1 = clock()
    out = {"t0": t0, "t1": t1, "tally": loop.tally,
           "prefill_s": engine.timings["prefill"][n_pre:],
           "decode_s": engine.timings["decode"][n_dec:],
           "sent": [r for r in loop.records if t0 <= r["sent"] < t1]}
    loop.tally = loop.fresh()
    while any(r["first"] is None for r in out["sent"]):
        loop.once()
    return out


def sample(records: List[Dict], since: float, n: int, seed: int
           ) -> List[Dict]:
    """``n`` requests finished at or after ``since``: the longest (prompt
    and served tokens), and the rest drawn from the seed."""
    done = [r for r in records if r["finished"] is not None
            and r["finished"] >= since]
    if not done:
        return []
    key = lambda r: len(r["prompt"]) + len(r["result"].tokens)   # noqa: E731
    longest = max(done, key=key)
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def reference_gaps(config: Dict, params: Dict, picked: List[Dict],
                   control: bool = False) -> List[float]:
    """The gap of every served token of the picked requests under the
    configuration's float32 reference (or, with ``control``, of the tokens
    that reference computed with its e4m3 products would put first)."""
    ref, m = manifest.reference(config), config["model"]
    ref.exact()
    out = []
    with torch.no_grad():
        for rec in picked:
            prompt, served = rec["prompt"], rec["result"].tokens
            dev = params["embed.tok"].device
            seq = torch.as_tensor(prompt + served[:-1], device=dev)
            pos = range(len(prompt) - 1, len(prompt) - 1 + len(served))
            best = ref.logits(m, params, seq, pos)
            toks = served
            if control:
                toks = ref.logits(m, params, seq, pos,
                                  mm=ref.fp8_mm).argmax(-1).tolist()
            out += compare.token_gaps(best, toks)
            del best
    return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        fault: Optional[str] = None, keep: Optional[Dict] = None) -> Dict:
    from repro_torch.serve.engine import ServeEngine

    m, tr = cell.config["model"], cell.traffic
    cuda = torch.device(device).type == "cuda"
    params = weights.draw(m, seed, device, serving=True)
    engine = ServeEngine(model_config(cell.config), params,
                         max_batch=tr["max_batch"], max_seq=tr["max_seq"],
                         device=device)
    if fault == "altered":          # a token altered where it is produced
        pick = engine._pick
        engine._pick = lambda logits, *a: (pick(logits, *a) + 1) % m["vocab_size"]
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    log("weights drawn, engine built")
    loop = Loop(engine, Requests(tr, m["vocab_size"], seed), tr["clients"],
                m, trace)
    ramp = list(loop.records)
    while any(r["finished"] is None for r in ramp):
        loop.once()

    log(f"ramp done: {len(loop.records)} requests sent")
    w = window(loop, seconds)
    t0, t1, tally, sent = w["t0"], w["t1"], w["tally"], w["sent"]
    ttft = [r["first"] - r["sent"] for r in sent]
    out = {"window_start": t0, "attempted": len(sent),
           "failed": sum(r["result"] is None for r in sent),
           "memory_peak_bytes": torch.cuda.max_memory_allocated()
           if cuda else 0,
           "e2e": {"serve_tokens_per_s": tally["tokens"] / (t1 - t0)}}
    if trace:
        loop.tally = loop.fresh()

        def traced():
            ts = clock()
            while clock() - ts < tr["trace_seconds"]:
                loop.once()
        tr_, _ = capture(traced)
        out["ctx"] = {"kind": "serve", "model": m, "traffic": tr,
                      "trace": tr_, "traced": loop.tally,
                      "window_s": t1 - t0, "window": tally,
                      "prefill_s": w["prefill_s"],
                      "decode_s": w["decode_s"],
                      "ttft_s": ttft}
        out["trace"] = tr_
    log(f"window closed: {len(sent)} sent, {tally['tokens']} tokens")
    picked = sample(loop.records, t0, tr["sample_requests"], seed)
    if keep is not None:
        keep["picked"], keep["params"] = picked, params
    del engine, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gaps = reference_gaps(cell.config, params, picked)
    out["checks"] = {"served_gap_mean": {
        "value": sum(gaps) / len(gaps) if gaps else float("nan"),
        "limit": cell.limits["served_gap_mean"]}}
    out["widest_gap"] = max(gaps, default=float("nan"))
    log(f"reference done: {len(gaps)} tokens, widest gap "
        f"{out['widest_gap']!r}")
    return out
