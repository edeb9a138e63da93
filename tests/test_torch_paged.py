"""The port's paged decode path (``repro_torch/parallel/decode_attn.py``)
against the reference's: each case of the paged half of
``tests/test_kernels_autotune.py`` on numpy-drawn inputs given to both
packages. Within the port, paged attention is bit-equal to dense attention
over the same contents; against JAX it holds the attention tolerances
(f32 3e-5, bf16 3e-2), and its block tables equal the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.parallel.decode_attn import PagedKVCache as RefPagedKVCache
from repro.parallel.decode_attn import gather_paged_kv as ref_gather
from repro.parallel.decode_attn import paged_decode_attention as ref_paged
from repro.parallel.decode_attn import paged_write_kv as ref_paged_write
from repro_torch.models.attention import decode_attention_ref, write_kv_cache
from repro_torch.parallel.decode_attn import (PagedKVCache, gather_paged_kv,
                                              paged_decode_attention,
                                              paged_write_kv)

TOL = {"float32": 3e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a), dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _paged_setup(B=4, H=8, S=256, HD=64, KV=4, page=64, seed=7):
    """numpy arrays: q, dense caches, one new k/v, lengths, a block table
    of interleaved non-identity page ids, and pools holding the caches."""
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    kn = rng.standard_normal((B, KV, HD)).astype(np.float32)
    vn = rng.standard_normal((B, KV, HD)).astype(np.float32)
    ln = np.asarray([37, 255, 128, 5][:B], np.int32)
    n = S // page
    ids = np.random.RandomState(0).permutation(2 * B * n)[:B * n]
    bt = ids.astype(np.int32).reshape(B, n)
    k_pages = np.zeros((2 * B * n, page, KV, HD), np.float32)
    v_pages = np.zeros_like(k_pages)
    k_pages[bt.reshape(-1)] = kc.reshape(B * n, page, KV, HD)
    v_pages[bt.reshape(-1)] = vc.reshape(B * n, page, KV, HD)
    return q, kc, vc, kn, vn, ln, bt, k_pages, v_pages


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_reconstructs_contiguous_cache(dtype):
    tdt, jdt = DTYPES[dtype]
    _, kc, vc, *_, bt, k_pages, v_pages = _paged_setup()
    k, v = gather_paged_kv(_t(k_pages, tdt), _t(v_pages, tdt),
                           _t(bt, torch.int32))
    assert k.is_contiguous() and v.is_contiguous()
    assert torch.equal(k, _t(kc, tdt)) and torch.equal(v, _t(vc, tdt))
    rk, rv = ref_gather(_j(k_pages, jdt), _j(v_pages, jdt),
                        _j(bt, jnp.int32))
    np.testing.assert_array_equal(_np(k), _np(rk))
    np.testing.assert_array_equal(_np(v), _np(rv))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_decode_matches_dense_bitwise_and_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    q, kc, vc, kn, vn, ln, bt, k_pages, v_pages = _paged_setup()
    lt = _t(ln, torch.int64)
    kc2, vc2 = write_kv_cache(_t(kc, tdt), _t(vc, tdt), _t(kn, tdt),
                              _t(vn, tdt), lt)
    o_dense = decode_attention_ref(_t(q, tdt), kc2, vc2, lt + 1)
    kp, vp = paged_write_kv(_t(k_pages, tdt), _t(v_pages, tdt), _t(kn, tdt),
                            _t(vn, tdt), _t(bt, torch.int32), lt)
    o = paged_decode_attention(_t(q, tdt), kp, vp, _t(bt, torch.int32),
                               lt + 1)
    assert o.dtype == tdt
    assert torch.equal(o, o_dense)
    rkp, rvp = ref_paged_write(_j(k_pages, jdt), _j(v_pages, jdt),
                               _j(kn, jdt), _j(vn, jdt), _j(bt, jnp.int32),
                               _j(ln, jnp.int32))
    np.testing.assert_array_equal(_np(kp), _np(rkp))
    np.testing.assert_array_equal(_np(vp), _np(rvp))
    o_ref = ref_paged(_j(q, jdt), rkp, rvp, _j(bt, jnp.int32),
                      _j(ln + 1, jnp.int32))
    np.testing.assert_allclose(_np(o), _np(o_ref), atol=TOL[dtype], rtol=0)


def test_paged_write_lands_in_the_right_page_slot():
    _, _, _, kn, vn, ln, bt, k_pages, v_pages = _paged_setup()
    page = k_pages.shape[1]
    kp, vp = paged_write_kv(_t(k_pages), _t(v_pages), _t(kn), _t(vn),
                            _t(bt, torch.int32), _t(ln, torch.int64))
    for b, pos in enumerate(ln):
        pid = int(bt[b, pos // page])
        np.testing.assert_array_equal(kp[pid, pos % page].numpy(), kn[b])
        np.testing.assert_array_equal(vp[pid, pos % page].numpy(), vn[b])
    # nothing else moved
    mask = np.ones(k_pages.shape[:2], bool)
    for b, pos in enumerate(ln):
        mask[bt[b, pos // page], pos % page] = False
    np.testing.assert_array_equal(kp.numpy()[mask], k_pages[mask])


@pytest.mark.parametrize("over", [0, 1, 64])
def test_paged_write_clamps_at_capacity(over):
    """A position at or past capacity lands in the last slot of the last
    page, as in the reference."""
    _, _, _, kn, vn, _, bt, k_pages, v_pages = _paged_setup()
    capacity = bt.shape[1] * k_pages.shape[1]
    ln = np.full(bt.shape[0], capacity - 1 + over, np.int32)
    kp, vp = paged_write_kv(_t(k_pages), _t(v_pages), _t(kn), _t(vn),
                            _t(bt, torch.int32), _t(ln, torch.int64))
    for b in range(bt.shape[0]):
        np.testing.assert_array_equal(kp[bt[b, -1], -1].numpy(), kn[b])
    rkp, rvp = ref_paged_write(_j(k_pages), _j(v_pages), _j(kn), _j(vn),
                               _j(bt, jnp.int32), _j(ln, jnp.int32))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(rkp))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(rvp))


def _drive(cls, **kw):
    c = cls(num_pages=8, page_size=64, num_kv_heads=2, head_dim=32,
            pages_per_seq=2, **kw)
    c.reserve("a")
    c.reserve("b")
    c.release("a")
    c.reserve("c")                # must reuse a's pages, LIFO
    return {s: r.tolist() for s, r in c.tables.items()}, c.free_pages


def test_paged_kv_cache_block_tables_equal_the_reference():
    t1, f1 = _drive(PagedKVCache, device="cpu")
    t2, f2 = _drive(PagedKVCache, device="cpu")
    tr, fr = _drive(RefPagedKVCache)
    assert t1 == t2 == tr and f1 == f2 == fr == 4
    assert t1["b"] == [2, 3]
    assert t1["c"] == [0, 1]
    c = PagedKVCache(num_pages=8, page_size=64, num_kv_heads=2, head_dim=32,
                     pages_per_seq=2, device="cpu")
    row = c.reserve("x")
    assert row.dtype == np.int32
    bt = c.block_tables(["x"])
    assert bt.dtype == torch.int32 and bt.device.type == "cpu"
    assert c.k_pages.dtype == torch.float32


def test_paged_kv_cache_exhaustion_and_double_reserve():
    c = PagedKVCache(num_pages=2, page_size=64, num_kv_heads=2, head_dim=32,
                     pages_per_seq=2, device="cpu")
    c.reserve("a")
    with pytest.raises(ValueError):
        c.reserve("a")
    with pytest.raises(RuntimeError, match="exhausted"):
        c.reserve("b")
    c.release("a")
    c.reserve("b")                 # pool recovered


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_cache_end_to_end_slot_lifecycle(dtype):
    """Admit / decode / retire / admit through PagedKVCache, each step held
    bit-equal to the port's dense cache and within tolerance of the
    reference's PagedKVCache, with the block tables equal to its."""
    tdt, jdt = DTYPES[dtype]
    B, H, S, HD, KV, page = 2, 4, 128, 32, 2, 64
    kw = dict(num_pages=3 * (S // page), page_size=page, num_kv_heads=KV,
              head_dim=HD, pages_per_seq=S // page)
    cache = PagedKVCache(dtype=tdt, device="cpu", **kw)
    ref = RefPagedKVCache(dtype=jdt, **kw)
    rng = np.random.RandomState(9)
    dense_k = torch.zeros((B, S, KV, HD), dtype=tdt)
    dense_v = torch.zeros_like(dense_k)
    seqs = ["s0", "s1"]
    for s in seqs:
        cache.reserve(s)
        ref.reserve(s)
    lengths = np.zeros(B, np.int32)
    for step in range(6):
        if step == 3:              # retire s0, admit s2 into its pages
            cache.release("s0")
            ref.release("s0")
            cache.reserve("s2")
            ref.reserve("s2")
            seqs = ["s2", "s1"]
            lengths[0] = 0
            dense_k[0].zero_()
            dense_v[0].zero_()
        assert {s: r.tolist() for s, r in cache.tables.items()} == \
            {s: r.tolist() for s, r in ref.tables.items()}
        q, kn, vn = (rng.standard_normal(sh).astype(np.float32)
                     for sh in ((B, H, HD), (B, KV, HD), (B, KV, HD)))
        lt = _t(lengths, torch.int64)
        cache.append(seqs, _t(kn, tdt), _t(vn, tdt), lt)
        write_kv_cache(dense_k, dense_v, _t(kn, tdt), _t(vn, tdt), lt)
        ref.append(seqs, _j(kn, jdt), _j(vn, jdt), _j(lengths, jnp.int32))
        lengths = lengths + 1
        lt = _t(lengths, torch.int64)
        o = cache.attend(seqs, _t(q, tdt), lt)
        assert torch.equal(o, decode_attention_ref(_t(q, tdt), dense_k,
                                                   dense_v, lt))
        o_ref = ref.attend(seqs, _j(q, jdt), _j(lengths, jnp.int32))
        np.testing.assert_allclose(_np(o), _np(o_ref), atol=TOL[dtype],
                                   rtol=0)
    assert cache.tables["s2"].tolist() == [0, 1]   # s0's pages, LIFO
    assert cache.free_pages == ref.free_pages == 2


def test_paged_attention_masks_stale_rows():
    """Bytes left in a reused page past a sequence's length do not reach
    its output: the same call over a pool of NaN-free junk and over a
    zeroed pool agree bit for bit."""
    q, kc, vc, kn, vn, ln, bt, k_pages, v_pages = _paged_setup()
    lt = _t(ln, torch.int64)
    page = k_pages.shape[1]
    clean_k, clean_v = _t(k_pages).clone(), _t(v_pages).clone()
    for b, n in enumerate(ln):
        for pos in range(n, bt.shape[1] * page):
            clean_k[bt[b, pos // page], pos % page] = 0
            clean_v[bt[b, pos // page], pos % page] = 0
    o_junk = paged_decode_attention(_t(q), _t(k_pages), _t(v_pages),
                                    _t(bt, torch.int32), lt)
    o_clean = paged_decode_attention(_t(q), clean_k, clean_v,
                                     _t(bt, torch.int32), lt)
    assert torch.equal(o_junk, o_clean)

