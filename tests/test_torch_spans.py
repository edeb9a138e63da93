"""The port's spans (``repro_torch.spans``): a shared no-op while nothing
profiles; under ``torch.profiler`` on the CPU, the serving engine's phases
nested as ``PERF.md`` §3 lists them, and one ``moe.host_read`` inside each
``moe.dispatch`` for every host read ``dispatch_routed.host_syncs``
counts. The spans change no token the engine serves."""
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import init_serving_params
from repro_torch.models import moe as TM
from repro_torch.serve import ServeEngine
from repro_torch.spans import PREFIX, span

ARCH = "qwen2-moe-a2.7b"
PROMPTS = [[5, 17, 3, 9], [200, 1, 9, 77, 31, 4]]
MAX_SEQ = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops run as fast on one thread, and the suite's workers
    share the machine's cores: more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH, smoke=True).smoke(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    return cfg, init_serving_params(cfg, gen, "cpu")


def _spans(prof):
    """The port's spans of a profile: (name without the prefix, start,
    end), in order of start."""
    return sorted(((e.name[len(PREFIX):], e.time_range.start,
                    e.time_range.end) for e in prof.events()
                   if e.name.startswith(PREFIX)), key=lambda s: s[1])


def _inside(spans, outer):
    """The names of the spans inside ``outer`` (itself left out)."""
    _, a, b = outer
    return [n for n, s, e in spans if a <= s and e <= b
            and (s, e) != (a, b)]


def _serve(cfg, params, monkeypatch):
    """Two requests to completion, each prefill through the dispatch (its
    padded ``MAX_SEQ`` rows reach ``DISPATCH_MIN_ROWS``, as the serving
    cell's 4096 do), each decode step through the oracle."""
    monkeypatch.setattr(TM, "DISPATCH_MIN_ROWS", MAX_SEQ)
    eng = ServeEngine(cfg, params, max_batch=2, max_seq=MAX_SEQ,
                      device="cpu")
    return eng, [r.tokens for r in eng.run(PROMPTS, max_new=4)]


def test_span_is_one_shared_no_op_while_nothing_profiles():
    assert not torch.autograd._profiler_enabled()
    off = span("engine.decode")
    assert span("moe.dispatch", 7) is off
    with off:
        pass
    assert span("engine.prefill") is off


def test_engine_records_its_phases_nested(model, monkeypatch):
    cfg, params = model
    eng, plain = _serve(cfg, params, monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng, traced = _serve(cfg, params, monkeypatch)
    assert traced == plain
    spans = _spans(prof)
    prefills = [s for s in spans if s[0] == "engine.prefill"]
    decodes = [s for s in spans if s[0] == "engine.decode"]
    assert len(prefills) == len(PROMPTS) == len(eng.timings["prefill"])
    assert len(decodes) == eng._steps == len(eng.timings["decode"]) > 0
    layers = cfg.n_layers
    for p in prefills:
        inner = _inside(spans, p)
        assert sorted(set(inner)) == ["engine.sample", "engine.splice",
                                      "engine.upload", "model.prefill",
                                      "moe.dispatch", "moe.host_read"]
        assert [inner.count(n) for n in ("engine.upload", "model.prefill",
                                          "engine.splice", "engine.sample")
                ] == [1, 1, 1, 1]
        assert inner.count("moe.dispatch") == layers
        assert inner.count("moe.host_read") == layers
        model_span = next(s for s in spans if s[0] == "model.prefill"
                          and p[1] <= s[1] and s[2] <= p[2])
        assert _inside(spans, model_span).count("moe.dispatch") == layers
    for d in decodes:
        inner = _inside(spans, d)
        assert sorted(inner) == ["engine.sample", "engine.upload",
                                 "engine.upload", "model.decode"]
    outer = prefills + decodes
    assert all(any(o[1] <= s[1] and s[2] <= o[2] for o in outer)
               for s in spans if s not in outer)


def test_dispatch_reads_the_counts_once_inside_its_span(model):
    cfg, params = model
    p = {k[len("layers.0.ffn."):]: v for k, v in params.items()
         if k.startswith("layers.0.ffn.")}
    x = torch.randn((2, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    before = TM.dispatch_routed.host_syncs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            TM.moe_dispatch(cfg, p, x)
        TM.moe_dense_oracle(cfg, p, x)
    reads = TM.dispatch_routed.host_syncs - before
    spans = _spans(prof)
    dispatches = [s for s in spans if s[0] == "moe.dispatch"]
    assert reads == len(dispatches) == 3
    assert [_inside(spans, d) for d in dispatches] == [["moe.host_read"]] * 3
    assert sum(n == "moe.host_read" for n, _, _ in spans) == reads
