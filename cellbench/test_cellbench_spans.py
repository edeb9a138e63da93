"""The readers of the program's spans (``harness/attribution.py`` and the
seven metrics on it) on hand-built traces: each idle gap charged whole to
the innermost program span around its midpoint; the four idle shares and
the idle charged to no program span adding up to the device's idle share;
runtime calls counted by the span their start lies in; None where the
trace holds no program span, and nothing in the train cell. Then a traced
run of the test serving cell on the CPU, whose spans match its tallies."""
import json
from pathlib import Path

import pytest

from cellbench import testing
from cellbench.harness import attribution, manifest
from cellbench.harness.tracing import Trace

ROOT = Path(__file__).resolve().parents[1]
SERVE = "qwen2-moe-a2.7b.serve-longprompt"
IDLE = {"idle_moe_dispatch_share.serve", "idle_launch_share.serve",
        "idle_upload_share.serve", "idle_sample_share.serve"}
COUNTS = {"host_syncs_per_prefill.serve",
          "host_syncs_per_decode_step.serve",
          "launches_per_decode_step.serve"}
NEW = IDLE | COUNTS
P = attribution.PREFIX


def _trace(busy, host, window=(0.0, 10.0)):
    return Trace(window, [("kernel", a, b) for a, b in busy], host)


def _ctx(trace):
    return {"kind": "serve", "trace": trace}


def _read(name, ctx):
    return manifest.reader(name)(ctx)


# a prefill (0.5-4.5) with its upload, the model's call holding one MoE
# dispatch and its host read, the splice and the sample; then a decode step
# (5-9.5) with its uploads, the model's call and the sample. Runtime calls:
# three syncs and a copy in the prefill, one launch outside its model span,
# two syncs and three launches in the decode step, one of each outside.
HOST = [
    ("cellbench.add_request", 0.4, 4.6), ("cellbench.step", 4.9, 9.6),
    (P + "engine.prefill", 0.5, 4.5), (P + "engine.upload", 0.6, 1.0),
    (P + "model.prefill", 1.0, 3.0), (P + "moe.dispatch", 1.5, 2.5),
    (P + "moe.host_read", 1.8, 2.0), (P + "engine.splice", 3.0, 3.5),
    (P + "engine.sample", 3.5, 4.4),
    (P + "engine.decode", 5.0, 9.5), (P + "engine.upload", 5.1, 5.3),
    (P + "model.decode", 5.3, 8.0), (P + "engine.upload", 8.0, 8.2),
    (P + "engine.sample", 8.5, 9.4),
    ("cudaMemcpyAsync", 0.7, 0.8), ("cudaStreamSynchronize", 0.8, 0.9),
    ("cudaStreamSynchronize", 1.85, 1.95), ("cudaMemcpy", 3.6, 3.7),
    ("cudaLaunchKernel", 3.1, 3.15), ("aten::mm", 1.1, 1.4),
    ("cudaStreamSynchronize", 5.2, 5.25), ("cudaDeviceSynchronize", 9.3,
                                           9.7),
    ("cudaLaunchKernel", 5.4, 5.45), ("cudaLaunchKernelExC", 6.0, 6.1),
    ("cuLaunchKernel", 7.0, 7.1),
    ("cudaStreamSynchronize", 9.7, 9.8), ("cudaLaunchKernel", 9.75, 9.8)]
# the idle gaps, each by the innermost program span around its midpoint:
# (0, 0.2) none; (0.7, 0.9) upload; (1.2, 1.3) model.prefill; (1.6, 1.7)
# dispatch; (1.85, 1.95) host_read; (2.2, 2.9) model.prefill (it starts in
# the dispatch, its midpoint 2.55 lies past it); (3.2, 3.3) splice; (4.2,
# 4.9) none (it starts in the sample, its midpoint 4.55 lies past the
# prefill); (5.15, 5.25) upload; (6.0, 6.4) model.decode; (8.3, 8.5) the
# decode step's own span; (9.0, 9.2) sample; (9.9, 10) none
BUSY = [(0.2, 0.7), (0.9, 1.2), (1.3, 1.6), (1.7, 1.85), (1.95, 2.2),
        (2.9, 3.2), (3.3, 4.2), (4.9, 5.15), (5.25, 6.0), (6.4, 8.3),
        (8.5, 9.0), (9.2, 9.9)]
WANT = {None: 0.2 + 0.7 + 0.1, "engine.upload": 0.2 + 0.1,
        "model.prefill": 0.1 + 0.7, "moe.dispatch": 0.1,
        "moe.host_read": 0.1, "engine.splice": 0.1, "engine.sample": 0.2,
        "model.decode": 0.4, "engine.decode": 0.2}


def test_each_gap_goes_to_the_innermost_span_around_its_midpoint():
    got = attribution.idle_by_span(_trace(BUSY, HOST))
    assert set(got) == set(WANT)
    for k, v in WANT.items():
        assert got[k] == pytest.approx(v), k


def test_the_four_shares_and_the_unspanned_idle_make_the_idle_share():
    t = _trace(BUSY, HOST)
    shares = {n: _read(n, _ctx(t)) for n in IDLE}
    assert shares == pytest.approx({
        "idle_moe_dispatch_share.serve": 2.0,
        "idle_launch_share.serve": 15.0,    # model.*, splice, bare decode
        "idle_upload_share.serve": 3.0, "idle_sample_share.serve": 2.0})
    rest = 100 * attribution.idle_by_span(t)[None] / t.window_s
    assert sum(shares.values()) + rest == pytest.approx(
        _read("device_idle_share.serve", _ctx(t)))


def test_runtime_calls_are_counted_by_the_span_they_start_in():
    t = _trace(BUSY, HOST)
    assert _read("host_syncs_per_prefill.serve", _ctx(t)) == 3.0
    assert _read("host_syncs_per_decode_step.serve", _ctx(t)) == 2.0
    assert _read("launches_per_decode_step.serve", _ctx(t)) == 3.0
    # a second decode step with no call halves the rate
    more = HOST + [(P + "engine.decode", 9.85, 9.95)]
    assert _read("launches_per_decode_step.serve",
                 _ctx(_trace(BUSY, more))) == 1.5


def test_none_without_program_spans_and_none_in_the_train_cell():
    bare = [x for x in HOST if not x[0].startswith(P)]
    for n in NEW:
        assert _read(n, _ctx(_trace(BUSY, bare))) is None, n
        assert _read(n, {"kind": "train", "trace": _trace(BUSY, HOST)}) \
            is None, n
    # a dense model's serving trace: no dispatch span, the rest are read
    dense = [x for x in HOST if not x[0].startswith(P + "moe.")]
    assert _read("idle_moe_dispatch_share.serve",
                 _ctx(_trace(BUSY, dense))) is None
    assert _read("idle_launch_share.serve", _ctx(_trace(BUSY, dense))) > 0
    # a share that the spans leave no idle time is 0, not None
    assert _read("idle_moe_dispatch_share.serve", _ctx(_trace(
        [(0.0, 10.0)], HOST))) == 0.0


@pytest.mark.parametrize("cell", ["internlm2-1.8b.train-s2048", SERVE])
def test_only_the_serving_cell_reports_the_seven(cell):
    names = {m["name"] for m in manifest.load_cell(ROOT, cell).per_layer}
    assert names & NEW == (NEW if cell == SERVE else set())
    spec = {m["name"]: m for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for n in NEW:
        assert spec[n]["source"] == "program_span"
        assert spec[n]["moves"] == "serve_tokens_per_s"
        assert spec[n]["better"] == "lower"
        assert spec[n]["workloads"] == [SERVE]


def test_a_traced_serving_run_opens_a_span_per_prefill_and_step(tmp_path):
    from cellbench.kinds import serve_closed
    cell = manifest.load_cell(testing.make_root(tmp_path), "tiny-moe.serve")
    out = serve_closed.run(cell, 2 ** 31 + 5, 1.0, True, "cpu")
    ctx = out["ctx"]
    sp = attribution.spans(ctx["trace"])
    assert sum(n == "engine.prefill" for n, _, _ in sp) == len(
        ctx["traced"]["prefill_lengths"]) > 0
    assert sum(n == "engine.decode" for n, _, _ in sp) == len(
        ctx["traced"]["decode_rows"]) > 0
    got = {n: _read(n, ctx) for n in NEW}
    # the CPU trace holds no device interval and no CUDA runtime call;
    # the test cell's 64-row prefills take the oracle, so no dispatch span
    assert got["idle_moe_dispatch_share.serve"] is None
    assert sum(got[n] for n in IDLE - {"idle_moe_dispatch_share.serve"}
               ) <= _read("device_idle_share.serve", ctx) + 1e-9
    assert all(got[n] == 0.0 for n in COUNTS)
