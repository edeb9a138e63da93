"""The port's benches and examples on the CPU, held to their JAX
counterparts: the kernel bench's plumbing and its gate, its paged decode
point against JAX's, the serving bench's decode steps and greedy tokens,
the checkpoint bench's state bytes, the simulated preemption rows, and the
two examples end to end."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(relpath):
    path = os.path.join(ROOT, relpath)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_jax_bench(name):
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(os.path.join(ROOT, "benchmarks"))


@pytest.fixture(scope="module")
def kbench():
    return _load("benchmarks_torch/bench_kernels_torch.py")


@pytest.fixture(scope="module")
def cpu_snapshot(kbench, tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "snap.json"
    assert kbench.main(["--device", "cpu", "--out", str(path)]) == 0
    return path


def test_kernel_bench_cpu_snapshot_runs_every_point(kbench, cpu_snapshot):
    snap = json.loads(cpu_snapshot.read_text())
    assert snap["device"] == "cpu" and snap["card"] == "cpu"
    assert set(snap["points"]) == {p.name for p in kbench.POINTS}
    for name, r in snap["points"].items():
        # on the CPU the wrappers are their plain versions
        assert r["max_err"] == 0 and all(r["exact"].values()), name
        assert r["frac_of_bound"] == pytest.approx(0.5), name
        assert r["bound_by"] in ("bytes", "operations")
        assert r["from_table"] is False
    assert snap["points"]["decode_b4h8s256d64"]["exact"] == \
        {"bit_equal_to_dense": True}


def _faulted(path, tmp_path, fault):
    snap = json.loads(path.read_text())
    fault(snap["points"])
    out = tmp_path / "faulted.json"
    out.write_text(json.dumps(snap))
    return out


@pytest.mark.parametrize("fault,rc", [
    (lambda p: None, 0),
    (lambda p: p["flash_serve_f32"].update(choice="splits=8"), 1),
    (lambda p: p["rmsnorm_512x768_bf16"].update(from_table=True), 1),
    (lambda p: p.pop("decode_b4h8s256d64"), 1),
    (lambda p: p.update(extra=dict(p["flash_serve_f32"])), 1),
])
def test_kernel_bench_check_exit_codes(kbench, cpu_snapshot, tmp_path,
                                       fault, rc):
    base = _faulted(cpu_snapshot, tmp_path, fault)
    assert kbench.main(["--device", "cpu", "--check", "--baseline",
                        str(base)]) == rc
    assert kbench.main(["--device", "cpu", "--check", "--baseline",
                        str(tmp_path / "missing.json")]) == 2


def test_kernel_bench_violations_of_one_point(kbench, cpu_snapshot):
    r = json.loads(cpu_snapshot.read_text())["points"]["flash_serve_f32"]
    assert kbench.violations("p", r) == []
    assert kbench.violations("p", dict(r, max_err=1e-4))
    assert kbench.violations("p", dict(r, frac_of_bound=1.06))
    assert kbench.violations("p", dict(r, exact={"sum_bit_equal": False}))


def test_kernel_bench_tune_plumbing_writes_a_table(kbench, tmp_path):
    """On the CPU every candidate reads the same fabricated time, so no
    choice beats the default rule and the table stays empty."""
    path = tmp_path / "table.json"
    assert kbench.main(["--device", "cpu", "--tune", "--table",
                        str(path)]) == 0
    assert json.loads(path.read_text()) == {"entries": {}, "version": 1}


@pytest.mark.parametrize("ms,outs,win,entry", [
    ({1: 2.0, 2: 1.0}, {1: [0.0], 2: [0.0]}, 2, True),    # faster, same values
    ({1: 2.0, 2: 1.0}, {1: [0.0], 2: [1e-7]}, 2, False),  # faster, other values
    ({1: 2.0, 2: 2.0}, {1: [0.0], 2: [0.0]}, 1, False),   # no faster
])
def test_kernel_bench_sweep_enters_only_faster_bit_equal_choices(
        kbench, ms, outs, win, entry):
    def build(c):
        return [(kbench._Fixed(ms[c]), (torch.tensor(outs[c]),))]
    assert kbench._sweep("p", [1, 2], 1, build, say=lambda _: None) == \
        (win, entry)


def test_kernel_bench_entry_points_name_the_entry(kbench):
    from repro_torch.kernels import autotune
    t = autotune.AutotuneTable()
    t.record("flash_attention", torch.float32, (1, 12, 512, 64), [2])
    t.record("rmsnorm", torch.bfloat16, (8, 768), [1])
    t.record("decode_attention", torch.float32, (4, 8, 256, 64), [64])
    for key, choice in t.entries.items():
        for point, want in kbench.entry_points(key, choice):
            r = kbench.run_point(point, torch.device("cpu"), t, timed=False)
            assert (r["choice"], r["from_table"]) == (want, True), key
            assert not kbench.violations(key, r)


def test_paged_decode_point_against_jax(kbench):
    """The bench's paged decode point on the inputs JAX's bench would build
    from the same numpy draws: pages and block tables bit-equal, the
    output bit-equal to the port's dense decode and within the JAX suite's
    f32 tolerance (3e-5) of JAX's ``paged_decode_attention``."""
    from repro.parallel.decode_attn import (PagedKVCache,
                                            paged_decode_attention,
                                            paged_write_kv)
    d = next(p for p in kbench.POINTS if p.kind == "decode").dims
    page = kbench.autotune.plan_decode_page(
        (d["B"], d["H"], d["S"], d["HD"]), d["dtype"])[0]
    bases, dense = kbench.DecodeKind(page).inputs(
        d, torch.device("cpu"), np.random.RandomState(kbench.SEED), page)
    out = kbench.paged_decode_attention(*bases)
    assert torch.equal(out, dense)

    rng = np.random.RandomState(kbench.SEED)
    B, H, S, HD, KV = d["B"], d["H"], d["S"], d["HD"], d["KV"]
    q, kc, vc, kn, vn = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, HD), (B, S, KV, HD), (B, S, KV, HD), (B, KV, HD), (B, KV, HD)))
    ln = jnp.asarray(d["lengths"], jnp.int32)
    cache = PagedKVCache(num_pages=2 * B * (S // page), page_size=page,
                         num_kv_heads=KV, head_dim=HD,
                         pages_per_seq=S // page, dtype=jnp.float32)
    for b in range(B):
        cache.reserve(b)
    bt = cache.block_tables(range(B))
    kp = cache.k_pages.at[bt.reshape(-1)].set(
        kc.reshape(B * (S // page), page, KV, HD))
    vp = cache.v_pages.at[bt.reshape(-1)].set(
        vc.reshape(B * (S // page), page, KV, HD))
    kp, vp = paged_write_kv(kp, vp, jnp.asarray(kn), jnp.asarray(vn), bt, ln)
    ref = np.asarray(paged_decode_attention(jnp.asarray(q), kp, vp, bt,
                                            ln + 1))
    np.testing.assert_array_equal(np.asarray(bt), bases[3].numpy())
    np.testing.assert_array_equal(np.asarray(kp), bases[1].numpy())
    np.testing.assert_array_equal(np.asarray(vp), bases[2].numpy())
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=0)


def _f32_caches(engine_cls, cast):
    """``engine_cls`` with its caches in f32: the JAX decode cannot write an
    f32 model's K/V into its bf16 cache (ROADMAP Queue 3), so both engines
    take f32 caches, as tests/test_torch_serve.py gives them."""
    class F32(engine_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            cast(self)
    return F32


def test_serving_bench_steps_tokens_and_slots_equal_jax(monkeypatch):
    from repro.configs import get_config as jax_get_config
    from repro.models import init_params as jax_init_params
    from repro.models import model_defs as jax_model_defs
    from repro_torch.configs import get_config
    from repro_torch.models import params_from_jax
    sbench = _load("benchmarks_torch/bench_serving_torch.py")
    jbench = _load_jax_bench("bench_serving")
    # the smoke config as the bench runs it: slot invariants
    out = sbench.run_bench(device="cpu")
    for eng, res, _ in out.values():
        assert len(res) == 12 and all(r.done for r in res)
        assert all(len(r.tokens) == 8 for r in res)
        assert all(s.request is None for s in eng._slots)
        assert int(eng.cache["lengths"].max()) == 0
    assert out["batched"][0]._steps <= out["sequential"][0]._steps
    assert len(sbench.rows(out, 12, 8)) == 6
    # the f32 smoke model on params bridged from JAX's: JAX's decode steps
    # and greedy tokens
    jcfg = jax_get_config("tacc-100m", smoke=True).smoke(dtype="float32")
    tcfg = get_config("tacc-100m", smoke=True).smoke(dtype="float32")
    jp = jax_init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))

    def jcast(e):
        e.cache = jax.tree.map(lambda a: a.astype(jnp.float32)
                               if a.dtype == jnp.bfloat16 else a, e.cache)

    def tcast(e):
        e.cache["layers"] = [{k: v.float() for k, v in c.items()}
                             for c in e.cache["layers"]]
    monkeypatch.setattr(jbench, "ServeEngine",
                        _f32_caches(jbench.ServeEngine, jcast))
    monkeypatch.setattr(sbench, "ServeEngine",
                        _f32_caches(sbench.ServeEngine, tcast))
    jout = jbench.run_bench(cfg=jcfg, params=jp)
    tout = sbench.run_bench(cfg=tcfg, params=tp, device="cpu")
    for name in ("batched", "sequential"):
        assert tout[name][0]._steps == jout[name][0]._steps == \
            out[name][0]._steps
        assert [r.tokens for r in tout[name][1]] == \
            [r.tokens for r in jout[name][1]]


def test_checkpoint_bench_state_bytes_equal_jax():
    pbench = _load("benchmarks_torch/bench_preemption_torch.py")
    jbench = _load_jax_bench("bench_preemption")
    n, ts, ta, tw, tr = pbench.measure_ckpt(64, "cpu")
    assert n == jbench.measure_ckpt(64)[0]
    assert min(ts, ta, tw, tr) >= 0


@pytest.mark.parametrize("engine", ["event", "tick"])
def test_simulated_preemption_rows_equal_jax(engine):
    pbench = _load("benchmarks_torch/bench_preemption_torch.py")
    jbench = _load_jax_bench("bench_preemption")
    ours = pbench.sim_preemption_penalty(engine, verbose=False)
    theirs = jbench.sim_preemption_penalty(engine)
    assert [r[:3] for r in ours] == [r[:3] for r in theirs]
    assert all(r[2] == 1 for r in ours)


def test_quickstart_example_trains_restores_and_serves():
    ex = _load("examples/quickstart_torch.py")
    out = ex.main(["--device", "cpu", "--steps", "12"])
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 12 and np.mean(losses[-3:]) < np.mean(losses[:3])
    assert out["restored_equal"] is True
    assert [len(r.tokens) for r in out["results"]] == [8, 8, 8]


def test_serve_batch_example_trains_and_serves_the_pattern():
    ex = _load("examples/serve_batch_torch.py")
    out = ex.main(["--device", "cpu", "--steps", "12"])
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])
    assert len(out["results"]) == 10
    assert all(len(r.tokens) == ex.NEW_TOKENS for r in out["results"])
    assert 0.0 <= out["accuracy"] <= 1.0 and out["decode_steps"] > 0
