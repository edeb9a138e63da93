"""The yardstick's arithmetic against hand counts and against the program's
own formulas it was copied from; percentiles, spreads and a trace's busy
time from synthetic numbers; the serving loop's tallies."""
import math

import numpy as np
import pytest
import torch

from cellbench import testing
from cellbench.harness import manifest, stats, work
from cellbench.harness.tracing import Trace, gaps, union
from cellbench.kinds import serve_closed

DENSE = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "vocab_size": 10}


def test_kernel_work_by_hand():
    # B 1, S 4, H 2, KV 1, D 8: 10 causal pairs
    assert work.flash_fwd(1, 4, 2, 1, 8) == (
        2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8), 4.0 * 2 * 8 * 10,
        work.PEAK_BF16)
    assert work.flash_bwd(1, 4, 2, 1, 8)[1] == 10.0 * 2 * 8 * 10
    assert work.norm_fwd(3, 8, False) == (2 * 2 * 3 * 8 + 32, 96.0,
                                          work.PEAK_F32)
    assert work.norm_fwd(3, 8, True)[:2] == (2 * 4 * 3 * 8 + 32, 120.0)
    # a prefill of L 2 padded to S 4: rows 0-1 causal (3 pairs), rows 2-3
    # attend to both valid keys (4); q and o at 4 rows, k and v at 2
    assert work.flash_fwd_masked(4, 2, 2, 1, 8) == (
        2 * (2 * 4 * 2 * 8 + 2 * 2 * 1 * 8), 4.0 * 2 * 8 * 7,
        work.PEAK_BF16)
    assert work.flash_fwd_masked(4, 4, 2, 1, 8) == work.flash_fwd(1, 4, 2,
                                                                 1, 8)
    t, by = work.bound_s((3.35e12, 1.0, work.PEAK_BF16))
    assert (t, by) == (1.0, "bytes")
    t, by = work.bound_s((0.0, 989e12, work.PEAK_BF16))
    assert (t, by) == (1.0, "operations")


@pytest.mark.parametrize("S,H,KV,D", [(2048, 16, 8, 128), (777, 16, 16, 128)])
def test_frozen_kernel_work_equals_the_programs(S, H, KV, D):
    from repro_torch.kernels.flash_attention import flash_bwd_work, flash_work
    from repro_torch.kernels.rmsnorm import norm_bwd_work, norm_work
    bf16 = torch.bfloat16
    assert work.flash_fwd(8, S, H, KV, D)[:2] == flash_work(
        8, S, H, KV, D, bf16)[:2]
    assert work.flash_bwd(8, S, H, KV, D)[:2] == flash_bwd_work(
        8, S, H, KV, D, bf16)[:2]
    for res in (False, True):
        assert work.norm_fwd(S, 2048, res)[:2] == norm_work(
            S, 2048, bf16, res)[:2]
        assert work.norm_bwd(S, 2048, res)[:2] == norm_bwd_work(
            S, 2048, bf16, res)[:2]


def test_model_flops_by_hand():
    layer = 8 * 8 + 8 * 2 * 4 + 8 * 8 + 3 * 8 * 16
    assert work.params(DENSE) == {"layers": 2 * layer, "unembed": 80}
    attn = 4.0 * 2 * 4 * 10 * 2             # 10 pairs, 2 layers
    assert work.train_flops(DENSE, 1, 4) == 6.0 * (2 * layer + 80) * 4 \
        + 3 * attn
    assert work.prefill_flops(DENSE, 4) == 2.0 * 2 * layer * 4 + attn + 160
    assert work.decode_flops(DENSE, 5) == 2.0 * (2 * layer + 80) \
        + 4.0 * 2 * 4 * 5 * 2
    moe = dict(DENSE, moe={"n_experts": 4, "top_k": 2, "d_ff_expert": 16,
                           "d_ff_shared": 32},
               period=[{"mixer": "attn", "ffn": "moe"}])
    # the router, two of four experts and the shared block
    assert work.params(moe)["layers"] == 2 * (
        layer - 3 * 8 * 16 + 8 * 4 + 2 * 3 * 8 * 16 + 3 * 8 * 32)


def test_mla_model_flops_by_hand():
    """tiny-mla: D 64, 4 heads, nope 16, rope 8, v 16, latent 32, no query
    compression; a dense layer of 96, then two layers of 8 experts of 16
    (top-3) and a shared block of 32; vocab 256."""
    m = testing.MLA["model"]
    q, dkv, kr, ukv, o = 64 * 4 * 24, 64 * 32, 64 * 8, 32 * 4 * 32, 4 * 16 * 64
    mla = q + dkv + kr + ukv + o
    dense = 3 * 64 * 96
    moe = 64 * 8 + 3 * 3 * 64 * 16 + 3 * 64 * 32
    assert work.params(m) == {"layers": 3 * mla + dense + 2 * moe,
                              "unembed": 256 * 64}
    # QK^T at nope + rope, PV at v, per head and pair, in 3 layers
    attn = 3 * (2 * 4 * 24 + 2 * 4 * 16) * 10
    assert work.prefill_flops(m, 4) == 2.0 * (3 * mla + dense + 2 * moe) \
        * 4 + attn + 2 * 256 * 64
    # K1 at (H, H, nope + rope), V padded; kv_norm at the latent's width
    assert work.attn_shapes(m) == {(4, 4, 24): 3}
    assert work.norm_calls(m) == {(64, False): 4, (32, False): 3,
                                  (64, True): 3}
    mq = testing.MLA_Q["model"]          # with a query latent of 48
    assert work.params(mq)["layers"] == work.params(m)["layers"] \
        + 3 * (64 * 48 + 48 * 4 * 24 - q)
    assert work.norm_calls(mq) == {(64, False): 4, (48, False): 3,
                                   (32, False): 3, (64, True): 3}


def test_the_published_models_parameters():
    """The drawn models hold their published sizes: InternLM2-1.8B 1.89e9;
    Qwen1.5-MoE-A2.7B 14.3e9, less its 24 shared-expert gates of 2048 the
    port lacks, 2.7e9 active by its card."""
    from cellbench.harness import weights
    import json
    from pathlib import Path
    cfgs = Path(__file__).parent / "configs"
    il = json.loads((cfgs / "internlm2-1.8b.json").read_text())["model"]
    qw = json.loads((cfgs / "qwen2-moe-a2.7b.json").read_text())["model"]
    count = lambda m: sum(math.prod(g[1])                   # noqa: E731
                          for g in weights.layout(m))
    assert count(il) == 1_889_110_016
    assert count(qw) == 14_315_735_040
    p = work.params(qw)
    active = (p["layers"] + 2 * p["unembed"]) / 1e9   # with the embedding
    assert abs(active - 2.69) < 0.02


def test_mfu_readers():
    ctx = {"kind": "train", "steps": 3, "window_s": 2.0,
           "model_flops": 0.5 * 989e12}
    assert manifest.reader("mfu.train")(ctx) == pytest.approx(25.0)
    assert manifest.reader("mfu.serve")(ctx) is None
    ctx = {"kind": "serve", "window_s": 4.0, "window": {"flops": 989e12}}
    assert manifest.reader("mfu.serve")(ctx) == pytest.approx(25.0)


def test_percentile():
    v = list(np.random.default_rng(0).normal(size=101))
    assert stats.percentile(v, 90) == pytest.approx(np.percentile(v, 90))
    assert stats.percentile([5.0], 90) == 5.0


def test_union_gaps_and_idle_share():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert gaps(union(iv), -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                          (4.0, 5.0)]
    t = Trace((0.0, 5.0), [("k", a, b) for a, b in iv],
              [("cellbench.step", 1.5, 5.0), ("aten::item", 2.2, 2.9)])
    assert t.busy_s() == pytest.approx(3.0)
    assert manifest.reader("device_idle_share.train")(
        {"kind": "train", "trace": t}) == pytest.approx(40.0)
    assert t.idle_gaps() == [["cellbench.step > aten::item", 1.0],
                             ["cellbench.step", 1.0]]
    assert t.kernel_s(lambda n: n == "k") == pytest.approx(3.6)


def test_roofline_readers_count_what_the_work_needs():
    """The serving shares count the rows the kernels run: a prefill's
    padded ``max_seq`` rows with its keys masked at the prompt's length, a
    decode step's ``max_batch`` rows, occupied or not."""
    m = {"n_layers": 2, "n_heads": 16, "n_kv_heads": 8, "head_dim": 128,
         "d_model": 2048}
    tr = {"max_seq": 4096, "max_batch": 16}
    bound = 2 * work.bound_s(work.flash_fwd_masked(4096, 1000, 16, 8,
                                                   128))[0]
    assert bound > 2 * work.bound_s(work.flash_fwd(1, 1000, 16, 8, 128))[0]
    b = lambda w: work.bound_s(w)[0]                     # noqa: E731
    norms = sum(3 * b(work.norm_fwd(N, 2048, False))
                + 2 * b(work.norm_fwd(N, 2048, True)) for N in (4096, 16))
    t = Trace((0.0, 1.0), [("flash_fwd_wgmma<128>", 0.0, 4 * bound),
                           ("rmsnorm_kernel<bf16>", 0.5, 0.5 + 2 * norms)])
    ctx = {"kind": "serve", "model": m, "traffic": tr, "trace": t,
           "traced": {"prefill_lengths": [1000], "decode_rows": [3]}}
    assert manifest.reader("attn_roofline.serve")(ctx) == pytest.approx(25.0)
    assert manifest.reader("norm_roofline.serve")(ctx) == pytest.approx(50.0)
    ctx["traced"]["prefill_lengths"] = []
    assert manifest.reader("attn_roofline.serve")(ctx) is None


class FakeEngine:
    """Every step yields one token a slot; a request finishes after its
    max_new tokens (its first from the prefill)."""

    def __init__(self, max_batch):
        self.max_batch, self.slots, self.made = max_batch, [], 0
        self.timings = {"prefill": [], "decode": []}

    def active(self):
        return len(self.slots)

    def add_request(self, prompt, max_new):
        r = type("R", (), {})()
        r.tokens, r.left = [7], max_new - 1
        self.slots.append(r)
        self.made += 1
        self.timings["prefill"].append(0.0)
        return r

    def step(self):
        for r in self.slots:
            r.tokens.append(7)
            r.left -= 1
        self.made += len(self.slots)
        self.timings["decode"].append(0.0)
        done = [r for r in self.slots if r.left <= 0]
        self.slots = [r for r in self.slots if r.left > 0]
        return done


def test_closed_loop_counts_every_token_and_request():
    traffic = {"block": 8, "prompt": {"median": 16, "sigma": 0.75, "min": 4,
                                      "max": 40},
               "output": {"min": 2, "max": 9}}
    reqs = serve_closed.Requests(traffic, 100, 2 ** 31 + 5)
    again = serve_closed.Requests(traffic, 100, 2 ** 31 + 5)
    assert [reqs(i) for i in range(20)] == [again(i) for i in range(20)]
    # every block holds the same lengths, in a seeded order
    assert sorted(len(reqs(i)[0]) for i in range(8)) == sorted(
        len(reqs(i)[0]) for i in range(8, 16))
    loop = serve_closed.Loop(FakeEngine(3), reqs, 5, DENSE, False)
    for _ in range(40):
        loop.once()
    made = sum(len(r["result"].tokens) for r in loop.records
               if r["result"] is not None)
    assert loop.tally["tokens"] == made
    done = [r for r in loop.records if r["finished"] is not None]
    # a closed loop: every finished request's client has sent another
    assert len(loop.records) == 5 + len(done)
    assert all(len(r["result"].tokens) == r["max_new"] for r in done)
    assert len(loop.tally["prefill_lengths"]) == sum(
        r["first"] is not None for r in loop.records)


def test_window_counts_only_the_tokens_made_in_it(monkeypatch):
    """The window's tallies close at its end: the loop that then runs on
    until every request sent in the window has its first token adds
    nothing to them."""
    engine, now, made_at = FakeEngine(3), [0.0], {}

    def clock():
        now[0] += 1.0
        made_at[now[0]] = engine.made
        return now[0]

    monkeypatch.setattr(serve_closed, "clock", clock)
    traffic = {"block": 8, "prompt": {"median": 16, "sigma": 0.75, "min": 4,
                                      "max": 40},
               "output": {"min": 2, "max": 9}}
    loop = serve_closed.Loop(engine,
                             serve_closed.Requests(traffic, 100, 7), 5,
                             DENSE, False)
    for _ in range(10):
        loop.once()
    w = serve_closed.window(loop, 30.0)
    assert w["tally"]["tokens"] == made_at[w["t1"]] - made_at[w["t0"]]
    assert len(w["decode_s"]) == len(w["tally"]["decode_rows"])
    assert len(w["prefill_s"]) == len(w["tally"]["prefill_lengths"])
    # the run-on did admit the window's last requests, outside its tallies
    assert loop.tally["tokens"] > 0
    assert all(r["first"] is not None for r in w["sent"])
