"""The port's tuning table (``repro_torch/kernels/autotune.py``) against
JAX's (``repro/kernels/autotune.py``): the same keys and page fallbacks,
the default rules with an empty table at phase 3's shapes and every
config's widths, validation of hits a call cannot take, persistence, and
the committed table and kernel-bench snapshot agreeing with each other."""
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp

from repro.kernels import autotune as jax_autotune
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import autotune

# the wrappers' modules (the package exports functions of these names)
FA = importlib.import_module("repro_torch.kernels.flash_attention")
RMS = importlib.import_module("repro_torch.kernels.rmsnorm")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(ROOT, "BENCH_kernels_torch.json")
DTYPES = [(torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)]
H100_SMS = 132

# chip_smoke.py phase 3's flash shapes, q (B, S, H, D), and norm rows
# (N, D, offset in elements)
PHASE3_FLASH = [(1, 512, 12, 64), (1, 512, 12, 128), (16, 128, 12, 64),
                (2, 512, 12, 64), (2, 200, 12, 64), (8, 512, 12, 64),
                (1, 1, 12, 64), (2, 512, 12, 128), (1, 300, 12, 128),
                (3, 33, 12, 64), (4, 65, 12, 64), (3, 129, 12, 64),
                (1, 512, 128, 192), (3, 33, 2, 192), (4, 65, 2, 192)]
PHASE3_NORMS = [(512, 768, 0), (8, 768, 0), (2048, 768, 0), (1, 768, 0),
                (13, 768, 0), (8, 770, 0), (8, 768, 1), (8, 1536, 0),
                (8, 2048, 0), (8, 8192, 0), (8, 16384, 0), (8, 512, 0),
                (8, 5120, 0), (100, 384, 0), (8, 128, 0), (64, 64, 0),
                (2, 64, 0)]


def _config_widths():
    widths = set()
    for arch in list_archs():
        cfg = get_config(arch)
        widths.add(cfg.d_model)
        if cfg.mla is not None:
            widths.update((cfg.mla.q_lora_rank, cfg.mla.kv_lora_rank))
    return sorted(widths)


def _rows(n, d, dtype, offset=0):
    base = torch.zeros(offset + n * d, dtype=dtype)
    return base[offset:].view(n, d)


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_keys_and_buckets_equal_jax(dtype, jdtype):
    shapes = [(1, 2, 384, 64), (3, 5, 512, 128), (1000, 512), (1, 1),
              (4096, 1024), (7, 9, 129, 192), (16, 12, 128, 64), (8, 768),
              (2049, 5120), (1, 128, 512, 192), (4, 8, 256, 64)]
    for shape in shapes:
        assert autotune.shape_bucket(shape) == jax_autotune.shape_bucket(shape)
        for kernel in ("flash_attention", "rmsnorm", "decode_attention"):
            assert autotune.table_key(kernel, dtype, shape) == \
                jax_autotune.table_key(kernel, jdtype, shape)


def test_decode_pages_equal_jax():
    empty, jempty = autotune.AutotuneTable(), jax_autotune.AutotuneTable()
    t, jt = autotune.AutotuneTable(), jax_autotune.AutotuneTable()
    for S in (64, 96, 128, 192, 256, 384, 512, 100, 1000):
        shape = (4, 8, S, 64)
        assert autotune.decode_page_candidates(S) == \
            jax_autotune.decode_page_candidates(S)
        assert autotune.plan_decode_page(shape, torch.float32, empty) == \
            jax_autotune.plan_decode_page(shape, jnp.float32, jempty)
        t.record("decode_attention", torch.float32, shape, [64])
        jt.record("decode_attention", jnp.float32, shape, [64])
        assert autotune.plan_decode_page(shape, torch.float32, t) == \
            jax_autotune.plan_decode_page(shape, jnp.float32, jt)
    assert autotune.DECODE_DEFAULT_PAGE == jax_autotune.DECODE_DEFAULT_PAGE


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_empty_table_plans_are_the_default_rules(dtype):
    empty = autotune.AutotuneTable()
    for B, S, H, D in PHASE3_FLASH:
        for sms in (H100_SMS, 8):
            assert autotune.plan_key_splits(B, S, H, D, dtype, sms, empty) \
                == (FA.key_splits(B, S, H, dtype, sms), False)
    rows = [(n, d, off) for n, d, off in PHASE3_NORMS] + [
        (n, d, off) for d in _config_widths() for n in (1, 8, 13, 512, 2048)
        for off in (0, 1)]
    for n, d, off in rows:
        x = _rows(n, d, dtype, off)
        w = torch.ones(d)
        assert autotune.plan_rmsnorm_variant(x, w, table=empty) == \
            (RMS.pick_variant(x, w), False)
        assert autotune.plan_rmsnorm_variant(x, x, w, table=empty) == \
            (RMS.pick_variant(x, x, w), False)


def test_empty_table_returns_before_bucketing(monkeypatch):
    def refuse(*_):
        raise AssertionError("an empty table bucketed a shape")
    monkeypatch.setattr(autotune, "table_key", refuse)
    empty = autotune.AutotuneTable()
    x = _rows(8, 768, torch.bfloat16)
    assert autotune.plan_rmsnorm_variant(x, torch.ones(768), table=empty) \
        == (0, False)
    assert autotune.plan_key_splits(1, 512, 12, 64, torch.float32, H100_SMS,
                                    empty) == (4, False)
    with autotune.override(empty):
        assert autotune.plan_key_splits(1, 512, 12, 64, torch.float32,
                                        H100_SMS) == (4, False)


def test_hits_apply_where_the_call_takes_them():
    t = autotune.AutotuneTable()
    t.record("flash_attention", torch.float32, (1, 12, 512, 64), [8])
    t.record("rmsnorm", torch.bfloat16, (512, 768), [1])
    assert autotune.plan_key_splits(1, 512, 12, 64, torch.float32, H100_SMS,
                                    t) == (8, True)
    # the same bucket: S 300 rounds up to 512; 8 splits of ceil(300/64) = 5
    # tiles is past the limit, so the default rule applies
    assert autotune.plan_key_splits(1, 300, 12, 64, torch.float32, H100_SMS,
                                    t) == (4, False)
    assert autotune.plan_key_splits(1, 400, 12, 64, torch.float32, H100_SMS,
                                    t) == (4, False)
    x = _rows(512, 768, torch.bfloat16)
    assert autotune.plan_rmsnorm_variant(x, torch.ones(768), table=t) == \
        (1, True)
    # a base off 16 bytes takes neither 16-byte variant
    x_off = _rows(512, 768, torch.bfloat16, offset=1)
    assert autotune.plan_rmsnorm_variant(x_off, torch.ones(768), table=t) \
        == (2, False)


@pytest.mark.parametrize("key,shape,choice", [
    # splits below 1, past ceil(S/64), and in bf16, which has no split
    ("flash_attention", (1, 12, 512, 64), [0]),
    ("flash_attention", (1, 12, 512, 64), [9]),
    ("flash_attention", (1, 2, 128, 64), [4]),
    # the warp layout past 2048, any index past the variants, two values
    ("rmsnorm", (8, 4096), [0]),
    ("rmsnorm", (8, 768), [3]),
    ("rmsnorm", (8, 768), [1, 2]),
    # rows of 770 bf16 are 1540 bytes: no 16-byte variant takes them
    ("rmsnorm", (8, 770), [1]),
    ("decode_attention", (4, 8, 256, 64), [96]),
])
def test_a_hit_the_shape_cannot_take_gives_the_default(key, shape, choice):
    t = autotune.AutotuneTable()
    dtype = torch.bfloat16 if shape == (1, 2, 128, 64) or key == "rmsnorm" \
        else torch.float32
    t.record(key, dtype, shape, choice)
    empty = autotune.AutotuneTable()
    if key == "flash_attention":
        B, H, S, D = shape
        got = autotune.plan_key_splits(B, S, H, D, dtype, H100_SMS, t)
        want = autotune.plan_key_splits(B, S, H, D, dtype, H100_SMS, empty)
    elif key == "rmsnorm":
        x = _rows(*shape, dtype)
        got = autotune.plan_rmsnorm_variant(x, torch.ones(shape[1]), table=t)
        want = autotune.plan_rmsnorm_variant(x, torch.ones(shape[1]),
                                             table=empty)
    else:
        got = autotune.plan_decode_page(shape, dtype, t)
        want = autotune.plan_decode_page(shape, dtype, empty)
    assert got == want and got[1] is False


def test_plans_are_memoized_until_the_table_changes():
    t = autotune.AutotuneTable()
    t.record("rmsnorm", torch.bfloat16, (512, 768), [1])
    x, w = _rows(512, 768, torch.bfloat16), torch.ones(768)
    assert autotune.plan_rmsnorm_variant(x, w, table=t) == (1, True)
    assert ("rmsnorm", torch.bfloat16, (512, 768)) in t._memo
    t.record("rmsnorm", torch.bfloat16, (512, 768), [2])
    assert not t._memo
    assert autotune.plan_rmsnorm_variant(x, w, table=t) == (2, True)


def test_table_roundtrip_and_missing_file(tmp_path):
    t = autotune.AutotuneTable()
    t.record("flash_attention", torch.float32, (1, 12, 500, 64), [2])
    t.record("rmsnorm", torch.bfloat16, (1000, 768), [1])
    p = tmp_path / "table.json"
    t.save(str(p))
    data = json.loads(p.read_text())
    assert data["version"] == autotune.TABLE_VERSION
    loaded = autotune.AutotuneTable.load(str(p))
    assert loaded.entries == t.entries
    assert loaded.lookup("flash_attention", torch.float32,
                         (1, 9, 300, 64)) == (2,)
    assert loaded.lookup("rmsnorm", torch.bfloat16, (700, 768)) == (1,)
    assert loaded.lookup("rmsnorm", torch.float32, (700, 768)) is None
    assert autotune.AutotuneTable.load(str(tmp_path / "none.json")).entries \
        == {}
    # the same entries read by JAX's table under the same keys
    jt = jax_autotune.AutotuneTable.load(str(p))
    assert jt.lookup("rmsnorm", jnp.bfloat16, (700, 768)) == (1,)


def _bucket_shape(key):
    kernel, dtype, dims = key.split("|")
    return kernel, getattr(torch, dtype), [int(n) for n in dims.split("x")]


def test_committed_table_loads_and_each_entry_holds_at_its_bucket():
    table = autotune.AutotuneTable.load()
    with open(autotune.DEFAULT_TABLE_PATH) as f:
        assert json.load(f)["version"] == autotune.TABLE_VERSION
    for key, choice in table.entries.items():
        kernel, dtype, dims = _bucket_shape(key)
        assert autotune.table_key(kernel, dtype, dims) == key
        if kernel == "flash_attention":
            B, H, S, D = dims
            got = autotune.plan_key_splits(B, S, H, D, dtype, H100_SMS, table)
        elif kernel == "rmsnorm":
            x = _rows(*dims, dtype)
            got = autotune.plan_rmsnorm_variant(x, torch.ones(dims[1]),
                                                table=table)
        else:
            got = autotune.plan_decode_page(dims, dtype, table)
        assert got == (choice[0], True), key


def test_committed_snapshot_agrees_with_the_committed_table():
    """BENCH_kernels_torch.json, written on the card: every point within its
    tolerance and its bound, and its choice what the committed table plans
    at its shape on the card that wrote it."""
    with open(SNAPSHOT) as f:
        snap = json.load(f)
    assert snap["device"] == "cuda" and "H100" in snap["card"]
    table = autotune.AutotuneTable.load()
    assert snap["table_entries"] == len(table.entries)
    assert snap["points"]
    for name, r in snap["points"].items():
        assert r["max_err"] <= r["tol"], name
        assert all(r["exact"].values()), name
        assert 0 < r["frac_of_bound"] <= 1.05, name
        dtype = getattr(torch, r["dtype"])
        if r["kind"] == "flash":
            n, hit = autotune.plan_key_splits(
                r["B"], r["S"], r["H"], FA._kernel_head_dim(r["D"]), dtype,
                snap["sms"], table)
            want = f"splits={n}"
        elif r["kind"] in ("rmsnorm", "rmsnorm_residual"):
            v, hit = autotune.plan_rmsnorm_rows(
                r["N"], r["D"], dtype, r["D"] * dtype.itemsize % 16 == 0,
                table)
            want = RMS.VARIANTS[v]
        elif r["kind"] == "decode":
            page, hit = autotune.plan_decode_page(
                (r["B"], r["H"], r["S"], r["HD"]), dtype, table)
            want = f"page={page}"
        else:                               # the backwards keep their rules
            continue
        assert (r["choice"], r["from_table"]) == (want, hit), name


def test_widths_cover_every_config():
    assert set(_config_widths()) >= {768, 2048, 5120, 512, 1536, 16384}
    assert np.all(np.diff(_config_widths()) > 0)
