"""The port's kernel modules on the CPU: each wrapper, given CPU tensors,
computes its plain version, held here against the JAX package's Pallas
kernel (interpret mode) or its reference, on the same numpy inputs; the
plain backward versions against jax.vjp of the JAX functions whose XLA
gradient the backward kernels replace."""
import ctypes
import importlib
import importlib.util
import os
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_tpu
from repro.kernels.rmsnorm import rmsnorm_residual_tpu, rmsnorm_tpu
from repro.models.attention import flash_attention_xla, repeat_kv
from repro_torch.kernels import (build, flash_attention, flash_attention_plain,
                                 rmsnorm, rmsnorm_bwd_plain, rmsnorm_plain,
                                 rmsnorm_residual, rmsnorm_residual_bwd_plain,
                                 rmsnorm_residual_plain)

# tests/test_kernels.py's shapes, (B, H, S, D)
SHAPES = [(1, 2, 128, 64), (2, 4, 256, 128), (1, 1, 512, 128), (2, 2, 384, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32, 3e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    jd, td, _ = DTYPES[dtype]
    t = torch.from_numpy(a).to(td)
    return jnp.asarray(t.float().numpy()).astype(jd), t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_vs_pallas_interpret(shape, dtype, causal):
    B, H, S, D = shape
    rng = np.random.default_rng([*shape, len(dtype), causal])
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal((B, S, H, D), np.float32), dtype)
        for _ in range(3))
    bhsd = (0, 2, 1, 3)
    o_ref = flash_attention_tpu(qj.transpose(bhsd), kj.transpose(bhsd),
                                vj.transpose(bhsd), causal=causal,
                                interpret=True).transpose(bhsd)
    o = flash_attention_plain(qt, kt, vt, causal=causal)
    assert o.dtype == qt.dtype and o.shape == qt.shape
    np.testing.assert_allclose(_f32(o), _f32(o_ref), atol=DTYPES[dtype][2])
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(flash_attention(qt, kt, vt, causal=causal), o)


@jax.jit
def _xla_gqa(q, k, v, lengths):
    g = q.shape[2] // k.shape[2]
    return flash_attention_xla(q, repeat_kv(k, g), repeat_kv(v, g),
                               causal=True, lengths=lengths)


# (S, lengths); the last is chip_smoke.py's case of a ragged tile edge at a
# batch boundary
GQA_CASES = [(384, [384, 384]), (384, [1, 200]), (384, [130, 7]),
             (200, [200, 150])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,lengths", GQA_CASES,
                         ids=[f"lengths{i}" for i in range(len(GQA_CASES))])
def test_flash_plain_gqa_ragged_vs_xla(dtype, S, lengths):
    """GQA 3:1 with K/V at KV heads and a key-length mask, against the XLA
    path on repeated K/V."""
    B, H, KV, D = 2, 6, 2, 64
    rng = np.random.default_rng(len(dtype) + sum(lengths))
    qj, qt = _pair(rng.standard_normal((B, S, H, D), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, KV, D), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, KV, D), np.float32), dtype)
    lens = np.asarray(lengths, np.int32)
    o_ref = _xla_gqa(qj, kj, vj, jnp.asarray(lens))
    o = flash_attention(qt, kt, vt, causal=True,
                        lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(_f32(o), _f32(o_ref), atol=DTYPES[dtype][2])


def test_flash_plain_row_without_valid_key_averages_v():
    """lengths = 0 masks every key with -1e30: the row averages V."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 64),
                                                    np.float32))
               for _ in range(3))
    o = flash_attention_plain(q, k, v, causal=True,
                              lengths=torch.zeros(1, dtype=torch.int32))
    mean_v = v.mean(dim=1, keepdim=True).expand_as(v)
    np.testing.assert_allclose(o.numpy(), mean_v.numpy(), atol=1e-6)


# tests/test_kernels.py's shapes, then a row for the wide variant and one
# whose bytes are not a multiple of 16 (the scalar variant)
RMS_SHAPES = [(64, 256), (256, 512), (8, 128), (100, 384), (4, 8192), (5, 770)]


@pytest.mark.parametrize("N,D", RMS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_vs_pallas_interpret(N, D, dtype):
    rng = np.random.default_rng(N * D)
    xj, xt = _pair(rng.standard_normal((N, D), np.float32), dtype)
    w = rng.standard_normal((D,), np.float32)
    o_kernel = rmsnorm_tpu(xj, jnp.asarray(w), interpret=True)
    o_ref = ref.rmsnorm_ref(xj, jnp.asarray(w))
    o = rmsnorm_plain(xt, torch.from_numpy(w))
    assert o.dtype == xt.dtype
    np.testing.assert_allclose(_f32(o), _f32(o_kernel), atol=1e-5)
    np.testing.assert_allclose(_f32(o), _f32(o_ref), atol=1e-5)
    assert torch.equal(rmsnorm(xt, torch.from_numpy(w)), o)


@pytest.mark.parametrize("shape", [(64, 256), (2, 7, 768), (3, 8192), (5, 770)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_residual_plain_vs_ref(shape, dtype):
    rng = np.random.default_rng(11)
    xj, xt = _pair(rng.standard_normal(shape, np.float32), dtype)
    rj, rt = _pair(rng.standard_normal(shape, np.float32), dtype)
    w = rng.standard_normal((shape[-1],), np.float32)
    ry, rs = ref.rmsnorm_residual_ref(xj, rj, jnp.asarray(w))
    y, s = rmsnorm_residual_plain(xt, rt, torch.from_numpy(w))
    np.testing.assert_allclose(_f32(y), _f32(ry), atol=2e-2)
    # the sum is rounded to the input dtype exactly as the reference does
    np.testing.assert_array_equal(_f32(s), _f32(rs))
    y2, s2 = rmsnorm_residual(xt, rt, torch.from_numpy(w))
    assert torch.equal(y2, y) and torch.equal(s2, s)
    # and the fused result equals the unfused add-then-norm
    assert torch.equal(y, rmsnorm_plain(s, torch.from_numpy(w)))


@pytest.mark.parametrize("N,D", [(64, 256), (3, 8192), (5, 770)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_residual_plain_vs_pallas_interpret(N, D, dtype):
    """The sum is the Pallas kernel's, bit for bit. The normed output is
    within 1e-5 of it in f32; in bf16 the Pallas body norms the unrounded
    f32 sum, which the port does not (ROADMAP, K3's parity hazard), so it
    is held to the reference above instead."""
    rng = np.random.default_rng(N + D)
    xj, xt = _pair(rng.standard_normal((N, D), np.float32), dtype)
    rj, rt = _pair(rng.standard_normal((N, D), np.float32), dtype)
    w = rng.standard_normal((D,), np.float32)
    ky, ks = rmsnorm_residual_tpu(xj, rj, jnp.asarray(w), interpret=True)
    y, s = rmsnorm_residual_plain(xt, rt, torch.from_numpy(w))
    np.testing.assert_array_equal(_f32(s), _f32(ks))
    if dtype == "float32":
        np.testing.assert_allclose(_f32(y), _f32(ky), atol=1e-5)


def _rms_module():
    return importlib.import_module("repro_torch.kernels.rmsnorm")


# (dtype, D, x's offset in elements, w's offset, the variant)
VARIANT_CASES = [
    ("bfloat16", 768, 0, 0, "warp"), ("float32", 768, 0, 0, "warp"),
    ("bfloat16", 1536, 0, 0, "warp"), ("float32", 1536, 0, 0, "warp"),
    ("bfloat16", 2048, 0, 0, "warp"), ("float32", 2048, 0, 0, "warp"),
    ("bfloat16", 128, 0, 0, "warp"),
    ("bfloat16", 770, 0, 0, "scalar"), ("float32", 770, 0, 0, "scalar"),
    ("float32", 6, 0, 0, "scalar"),
    ("bfloat16", 768, 1, 0, "scalar"), ("float32", 768, 1, 0, "scalar"),
    ("bfloat16", 768, 0, 1, "scalar"),
    ("bfloat16", 8192, 0, 0, "wide"), ("bfloat16", 16384, 0, 0, "wide"),
    ("float32", 16384, 0, 0, "wide"), ("bfloat16", 2056, 0, 0, "wide"),
    ("bfloat16", 8190, 0, 0, "scalar"), ("float32", 8192, 1, 0, "scalar"),
    ("bfloat16", 16384, 0, 1, "scalar"),
]


@pytest.mark.parametrize("dtype,D,x_off,w_off,variant", VARIANT_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}{c[3]}-{c[4]}"
                              for c in VARIANT_CASES])
def test_rmsnorm_pick_variant(dtype, D, x_off, w_off, variant):
    """Where the row's bytes and every base are 16-byte aligned, the warp
    layout up to WARP_MAX_WIDTH and the wide one past it; else the scalar
    variant at any width (x at an offset of one element is 2 or 4 bytes
    off)."""
    rms = _rms_module()
    td = DTYPES[dtype][1]
    x = torch.zeros(x_off + 3 * D, dtype=td)[x_off:].view(3, D)
    w = torch.zeros(w_off + D)[w_off:]
    assert rms.VARIANTS[rms.pick_variant(x, w)] == variant
    # the residual joins the choice: an aligned x with an unaligned r
    r = torch.zeros(1 + 3 * D, dtype=td)[1:].view(3, D)
    assert rms.VARIANTS[rms.pick_variant(x, r, w)] == "scalar"


@pytest.mark.parametrize("D", [0, 16384 + 8, 32768])
def test_rmsnorm_pick_variant_refuses_widths_no_variant_takes(D):
    rms = _rms_module()
    with pytest.raises(ValueError, match="outside the kernels' widths"):
        rms.pick_variant(torch.zeros(2, D, dtype=torch.bfloat16))


def test_rmsnorm_width_constants_match_the_source():
    """The wrapper's width caps are the kernel source's, read from its
    text: the wrapper checks them without a call into the library."""
    rms = _rms_module()
    src = (build.CSRC / "rmsnorm.cu").read_text()
    consts = {m[0]: int(m[1]) for m in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kMaxWidth"] == rms.MAX_WIDTH == 16384
    assert consts["kWarpMaxWidth"] == rms.WARP_MAX_WIDTH
    # each thread of the widest row holds a whole number of 16-byte bf16
    # accesses, so the wide layout reaches MAX_WIDTH
    assert rms.MAX_WIDTH % (consts["kWideThreads"] * 8) == 0


class _Elsewhere(torch.Tensor):
    """A tensor that says it lies on a device the wrappers do not take."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(*shape):
    return torch.empty(*shape).as_subclass(_Elsewhere)


def test_wrappers_take_the_plain_path_for_cpu_tensors_only():
    """A tensor off the CPU never reaches a plain version: a CUDA tensor
    launches the kernel, a meta tensor (the dry run) gets the kernel's
    empty outputs and launches nothing, anything else raises."""
    q = _elsewhere(1, 64, 2, 64)
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        flash_attention(q, q[:, :, :1], q[:, :, :1])
    x, w = _elsewhere(4, 64), _elsewhere(64)
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        rmsnorm(x, w)
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        rmsnorm_residual(x, x, w)
    held = (flash_attention.launches, rmsnorm.launches,
            rmsnorm_residual.launches)
    q = torch.empty(1, 64, 2, 64, device="meta")
    x, w = torch.empty(4, 64, device="meta"), torch.empty(64, device="meta")
    assert flash_attention(q, q[:, :, :1], q[:, :, :1]).shape == q.shape
    assert rmsnorm(x, w).shape == x.shape
    assert [t.shape for t in rmsnorm_residual(x, x, w)] == [x.shape] * 2
    assert held == (flash_attention.launches, rmsnorm.launches,
                    rmsnorm_residual.launches)


def test_build_without_the_toolkit_raises_naming_nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    if shutil.which("nvcc") or os.path.exists(os.path.join(home, "bin",
                                                           "nvcc")):
        pytest.skip("nvcc is present; the refusal needs its absence")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    # the build key follows the source and the flags
    assert build.library_path("rmsnorm").name.startswith("rmsnorm-")
    assert build.library_path("rmsnorm") != build.library_path(
        "flash_attention")


@pytest.mark.parametrize("header", ["common.cuh", "detail/common.h"])
def test_build_key_follows_every_source_under_csrc(tmp_path, monkeypatch,
                                                   header):
    """On a copy of csrc/: adding or editing a header a source may include,
    or editing another source, changes the key; a file that is not a
    source does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    key = build.library_path("flash_attention")
    assert key.parent == build.BUILD_DIR
    (csrc / header).parent.mkdir(parents=True, exist_ok=True)
    (csrc / header).write_text("#pragma once\n")
    added = build.library_path("flash_attention")
    (csrc / header).write_text("#pragma once\n// edited\n")
    edited = build.library_path("flash_attention")
    assert len({key, added, edited}) == 3
    (csrc / "notes.txt").write_text("not a source\n")
    assert build.library_path("flash_attention") == edited
    rms = csrc / "rmsnorm.cu"
    rms.write_text(rms.read_text() + "\n")
    assert build.library_path("flash_attention") != edited


def test_flash_bf16_reads_strided_views_in_place():
    """The bf16 kernel's TMA reads project_qkv's k/v views of the fused
    projection as they are, by their strides; a tensor it cannot read (an
    unaligned base, a strided head dim) is copied first."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    kv = torch.zeros(2, 16, 2, 4, 64, dtype=torch.bfloat16)
    for t in (kv[:, :, 0], kv[:, :, 1]):
        same, strides = fa._in_place(t)
        assert same is t and strides == (16 * 2 * 4 * 64, 2 * 4 * 64, 64)
    # a dimension of size 1 gets the stride a contiguous tensor would have
    assert fa._strides(torch.zeros(1, 16, 1, 64).as_strided(
        (1, 16, 1, 64), (3, 64, 5, 1))) == (16 * 64, 64, 64)
    flat = torch.arange(1 + 16 * 4 * 64, dtype=torch.float32).bfloat16()
    for bad in (flat[1:].view(1, 16, 4, 64),                 # base 2 bytes off
                kv.view(2, 16, 4, 128)[..., ::2]):           # head dim stride 2
        copy, strides = fa._in_place(bad)
        assert copy is not bad and copy.is_contiguous()
        assert copy.data_ptr() % 16 == 0 and torch.equal(copy, bad)
        assert strides == fa._strides(copy)


# -- backward ---------------------------------------------------------------

@jax.jit
def _xla_gqa_vjp(q, k, v, lengths, do):
    """dq, dk, dv of the XLA path on repeated K/V: jax.grad sums the
    repeated heads' gradients back onto each KV head."""
    def f(q, k, v):
        g = q.shape[2] // k.shape[2]
        return flash_attention_xla(q, repeat_kv(k, g), repeat_kv(v, g),
                                   causal=True, lengths=lengths)
    return jax.vjp(f, q, k, v)[1](do)


@jax.jit
def _xla_full_vjp(q, k, v, lengths, do):
    def f(q, k, v):
        g = q.shape[2] // k.shape[2]
        return flash_attention_xla(q, repeat_kv(k, g), repeat_kv(v, g),
                                   causal=False, lengths=lengths)
    return jax.vjp(f, q, k, v)[1](do)


# (S, H, KV, D, causal, lengths): S 64, 128 and 200 with lengths (a 0
# among them: a row with no valid key), G = 1 and 3, causal and full,
# D = 64 and 128
BWD_CASES = [(64, 6, 2, 64, True, [64, 0]), (128, 3, 3, 128, True, None),
             (200, 6, 2, 64, True, [200, 137]),
             (200, 4, 4, 128, False, [0, 151])]


@pytest.mark.parametrize("S,H,KV,D,causal,lengths", BWD_CASES,
                         ids=[f"S{c[0]}-G{c[1] // c[2]}-D{c[3]}-"
                              f"{'causal' if c[4] else 'full'}"
                              for c in BWD_CASES])
def test_flash_bwd_plain_vs_jax_grad_and_torch_autograd(S, H, KV, D, causal,
                                                        lengths):
    """The plain backward (the kernels' formula, from the forward's o and
    lse) against jax.vjp of the XLA path and torch autograd of
    flash_attention_plain, in f32: within 3e-5 of each gradient's largest
    entry (the f32 attention bar, scaled: the sums run in another order);
    and the autograd function's CPU backward is the plain backward."""
    rng = np.random.default_rng(S + H + D)
    B = 2
    q, do = (rng.standard_normal((B, S, H, D), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, KV, D), np.float32) for _ in range(2))
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    ln = None if lens is None else torch.from_numpy(lens)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    o, lse = fa._plain_forward(tq, tk, tv, causal, ln)
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                         causal=causal, lengths=ln)
    jl = jnp.asarray(lens if lens is not None else np.full(B, S, np.int32))
    vjp = _xla_gqa_vjp if causal else _xla_full_vjp
    jgrads = vjp(*(jnp.asarray(a) for a in (q, k, v)), jl, jnp.asarray(do))
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    fa.flash_attention_plain(*leaves, causal=causal,
                             lengths=ln).backward(tdo)
    for name, g, jg, leaf in zip("qkv", grads, jgrads, leaves):
        assert g.shape == leaf.shape and g.dtype == torch.float32
        tol = 3e-5 * float(np.abs(np.asarray(jg)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=tol,
                                   err_msg=f"d{name} vs jax")
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=tol,
                                   err_msg=f"d{name} vs torch autograd")
    # through the autograd function, as the model calls it
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    flash_attention(*leaves, causal=causal, lengths=ln).backward(tdo)
    for g, leaf in zip(grads, leaves):
        assert torch.equal(leaf.grad, g)


def test_flash_bwd_plain_rounds_p_for_dv_only():
    """In bf16, dV takes P rounded to v.dtype (the forward's cast passes
    the cotangent through) and the softmax gradient P in f32: the plain
    backward equals torch autograd of flash_attention_plain, which rounds
    p in the same place, to bf16 rounding of the outputs."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 40, 2, 64),
                                                        np.float32)
                                    ).bfloat16() for _ in range(4))
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    o, lse = fa._plain_forward(q, k, v, True, None)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention_plain(*leaves).backward(do)
    for g, leaf in zip((dq, dk, dv), leaves):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(g), _f32(leaf.grad), atol=3e-2)


def _chip_smoke():
    """chip_smoke.py as a module: the backward kernels' bar
    (``grad_within_bar``) is its own."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_bars", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("grad", ["dq", "dk"])
def test_flash_bwd_split_ds_meets_the_bar_one_bf16_ds_does_not(grad):
    """The premise of the tensor-core backward: dQ = dS K and dK = dS^T Q
    take dS as bf16 operands. Emulated in f32 at a small causal GQA shape
    with lengths, dS rounded once to bf16 misses phase 7's bar (1 bf16 ulp
    + 2e-5 of max|ref|) against the plain backward by more than 10x, and
    dS as two bf16 terms (hi = bf16(dS), lo = bf16(dS - hi)), each product
    summed in f32, meets it with room to spare."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    within_bar = _chip_smoke().grad_within_bar
    B, S, H, KV, D = 2, 96, 6, 2, 64
    G = H // KV
    rng = np.random.default_rng(15)
    q, do = (torch.from_numpy(rng.standard_normal((B, S, H, D), np.float32))
             .bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, KV, D), np.float32))
            .bfloat16() for _ in range(2))
    ln = torch.tensor([96, 50], dtype=torch.int32)
    o, lse = fa._plain_forward(q, k, v, True, ln)
    ref = dict(zip(("dq", "dk"), fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, lengths=ln)[:2]))
    # dS in f32 as the kernels form it: P from lse, Delta = rowsum(dO o)
    s, mask = fa._scores(q, k, True, ln)
    p = torch.exp(s - lse[..., None])
    dof = do.float().transpose(1, 2)
    kf, vf = (t.float().repeat_interleave(G, dim=2).transpose(1, 2)
              for t in (k, v))
    delta = (dof * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    ds = torch.where(mask, p * (dof @ vf.transpose(-1, -2) - delta), 0.0)
    hi = ds.bfloat16().float()
    lo = (ds - hi).bfloat16().float()

    def grads(d):
        dq = (d.double() @ kf.double()).transpose(1, 2) / np.sqrt(D)
        dk = (d.transpose(-1, -2).double() @ q.double().transpose(1, 2))
        dk = dk.reshape(B, KV, G, S, D).sum(2).transpose(1, 2) / np.sqrt(D)
        return {"dq": dq.float().bfloat16(), "dk": dk.float().bfloat16()}

    ok_one, _, need_one = within_bar(grads(hi)[grad], ref[grad])
    ok_split, bar, need_split = within_bar(grads(hi + lo)[grad], ref[grad])
    assert bar == "1 bf16 ulp + 2e-05 max|ref|"
    assert not ok_one and need_one > 10 * 2e-5
    assert ok_split and need_split < 2e-5 / 10


def test_flash_bwd_bf16_reads_strided_views_in_place():
    """The bf16 backward takes project_qkv's k/v views of the fused
    projection, and q and dO as transposed views, as they are, with the
    strides the C entries are given; it copies only what TMA cannot read
    (a base off 16 bytes); in f32 every input becomes contiguous."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    B, S, H, KV, D = 2, 16, 6, 2, 64
    kv = torch.zeros(B, S, 2, KV, D, dtype=torch.bfloat16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    q, do = (torch.zeros(B, H, S, D, dtype=torch.bfloat16).transpose(1, 2)
             for _ in range(2))
    o = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    lse = torch.zeros(B, H, S)
    taken = fa._bwd_inputs(q, k, v, o, do, lse)
    assert all(t is u for t, u in zip(taken, (q, k, v, o, do, lse)))
    assert list(fa._stride_array(q, k, v, o, do)) == [
        H * S * D, D, S * D, S * 2 * KV * D, 2 * KV * D, D,
        S * 2 * KV * D, 2 * KV * D, D, S * H * D, H * D, D,
        H * S * D, D, S * D]
    flat = torch.zeros(1 + B * S * H * D, dtype=torch.bfloat16)
    off = flat[1:].view(B, S, H, D)                     # base 2 bytes off
    taken = fa._bwd_inputs(q, k, v, off, do, lse)
    assert taken[3] is not off and taken[3].is_contiguous()
    assert torch.equal(taken[3], off)
    f32 = [t.float() for t in (q, k, v, o, do)]
    taken = fa._bwd_inputs(*f32, lse)
    assert all(t.is_contiguous() for t in taken)
    assert all(torch.equal(t, u) for t, u in zip(taken, f32))


@pytest.mark.parametrize("D", [16, 40, 96])
def test_flash_small_head_dims_run_padded_with_their_own_scale(monkeypatch,
                                                               D):
    """A head dim the kernels are not built for (the smoke configs' 16)
    reaches them zero-padded to the next built one, with the softmax scale
    of the true head dim, and comes back sliced: the kernels, emulated here
    by the plain functions at the scale they are given, must see 64 or 128
    and the result must be the plain function of the unpadded inputs (f32,
    rel 1e-6)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    seen = []

    def scaled(q, scale):            # the plain path's 1/sqrt(D) -> scale
        seen.append(q.shape[-1])
        return q * (scale * np.sqrt(q.shape[-1]))

    def forward_at(q, k, v, causal, lengths, want_lse, scale):
        return fa._plain_forward(scaled(q, scale), k, v, causal, lengths)

    def bwd_dq(q, k, v, o, lse, do, *, causal, lengths, scale):
        dq = fa.flash_attention_bwd_plain(scaled(q, scale), k, v, o, lse, do,
                                          causal=causal, lengths=lengths)[0]
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2)
        return dq * (scale * np.sqrt(q.shape[-1])), delta

    def bwd_dkdv(q, k, v, do, lse, delta, *, causal, lengths, scale):
        o = forward_at(q, k, v, causal, lengths, True, scale)[0]
        return fa.flash_attention_bwd_plain(scaled(q, scale), k, v, o, lse,
                                            do, causal=causal,
                                            lengths=lengths)[1:]

    monkeypatch.setattr(fa, "_forward_at", forward_at)
    monkeypatch.setattr(fa, "flash_bwd_dq", bwd_dq)
    monkeypatch.setattr(fa, "flash_bwd_dkdv", bwd_dkdv)
    rng = np.random.default_rng(D)
    B, S, H, KV = 2, 24, 4, 2
    q, do = (torch.from_numpy(rng.standard_normal((B, S, H, D), np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, KV, D), np.float32))
            for _ in range(2))
    lengths = torch.tensor([S, 17], dtype=torch.int32)
    o, lse = fa._forward(q, k, v, True, lengths, True)
    ref_o, ref_lse = fa._plain_forward(q, k, v, True, lengths)
    assert o.shape == q.shape and o.is_contiguous()
    torch.testing.assert_close(o, ref_o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-6, atol=1e-6)
    got = fa._kernel_bwd(q, k, v, o, lse, do, True, lengths)
    want = fa.flash_attention_bwd_plain(q, k, v, ref_o, ref_lse, do,
                                        causal=True, lengths=lengths)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.is_contiguous(), name
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)
    assert set(seen) == {64 if D <= 64 else 128}


def test_flash_head_dims_match_the_source():
    """The wrapper's head dims are the kernel source's instantiations, read
    from its text: the forward entries at 64, 128 and 192 (MLA's q/k
    width) in both dtypes, the bf16 backward ones at 64, 128 and 192, the
    f32 backward ones at 64 and 128."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    src = (build.CSRC / "flash_attention.cu").read_text()

    def dims(pattern):
        return tuple(sorted({int(d) for d in re.findall(pattern, src)}))

    assert fa.HEAD_DIMS == (64, 128, 192)
    assert dims(r"launch_wgmma<(\d+)>\(") == fa.HEAD_DIMS
    assert dims(r"launch_fwd_f32<(\d+), (?:true|false)>\(") == fa.HEAD_DIMS
    bf16, f32 = fa.BWD_HEAD_DIMS[torch.bfloat16], fa.BWD_HEAD_DIMS[torch.float32]
    assert bf16 == (64, 128, 192) and f32 == (64, 128)
    for kind in ("dq", "dkdv"):
        assert dims(rf"launch_bwd_{kind}_wgmma<(\d+)>\(") == bf16
        assert dims(rf"launch_bwd_{kind}_f32<(\d+)>\(") == f32
    assert "(D == 64 || D == 128 || (D == 192 && dtype == 1))" in \
        src[src.index("bool bwd_ok("):]


@pytest.mark.parametrize("D", [160, 192])
def test_flash_bwd_kernels_refuse_head_dim_192_naming_the_roadmap(D):
    """In f32 a head dim the forward runs at 192 has no backward kernel
    (bf16 has one): the kernel path raises, naming the ROADMAP item, before
    any launch; the plain backward (CPU tensors) serves every head dim."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rng = np.random.default_rng(D)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 8, 2, D),
                                                        np.float32))
                   for _ in range(4))
    o, lse = fa._plain_forward(q, k, v, True, None)
    with pytest.raises(NotImplementedError, match="R9"):
        fa._kernel_bwd(q, k, v, o, lse, do, True, None)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert dq.shape == q.shape and torch.isfinite(dq).all()


@pytest.mark.parametrize("entry", ["flash_attention_fwd",
                                   "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkdv"])
def test_flash_entry_signatures_match_the_source(entry):
    """ctypes passes as many arguments as the C entry takes, each pointer
    as a pointer: a mismatch would only show as a fault on the card."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    src = (build.CSRC / "flash_attention.cu").read_text()
    params = re.search(rf"\nint {entry}\(([^)]*)\)", src).group(1)
    params = [" ".join(p.split()) for p in params.split(",")]
    argtypes = fa._SIGNATURES[entry]
    assert len(params) == len(argtypes)
    for p, a in zip(params, argtypes):
        assert ("*" in p) == (a is not ctypes.c_int and a is not
                              ctypes.c_float), (p, a)


@jax.jit
def _rms_vjp(x, w, dy):
    return jax.vjp(lambda x, w: ref.rmsnorm_ref(x, w), x, w)[1](dy)


@jax.jit
def _unfused_vjp(x, r, w, dy, ds):
    """The model's unfused x + y; norm (transformer.py:187-189)."""
    def f(x, r, w):
        s = x + r
        return ref.rmsnorm_ref(s, w), s
    return jax.vjp(f, x, r, w)[1]((dy, ds))


@pytest.mark.parametrize("shape", [(64, 256), (2, 7, 768), (3, 8192),
                                   (5, 770)])
def test_rmsnorm_bwd_plain_vs_jax_grad(shape):
    """dx and dw of the plain backward against jax.vjp of rmsnorm_ref, and
    the autograd function's CPU backward equal to it; f32, within 1e-5 of
    each gradient's largest entry (the rmsnorm bar, scaled)."""
    rng = np.random.default_rng(shape[-1])
    x, dy = (rng.standard_normal(shape, np.float32) for _ in range(2))
    w = rng.standard_normal(shape[-1:], np.float32)
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    dx, dw = rmsnorm_bwd_plain(tx, tw, tdy)
    jdx, jdw = _rms_vjp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy))
    for g, jg in ((dx, jdx), (dw, jdw)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg,
                                   atol=1e-5 * float(np.abs(jg).max()))
    lx, lw = tx.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    rmsnorm(lx, lw).backward(tdy)
    assert torch.equal(lx.grad, dx) and torch.equal(lw.grad, dw)


@pytest.mark.parametrize("shape", [(64, 256), (2, 7, 768), (5, 770)])
def test_rmsnorm_residual_bwd_plain_vs_jax_grad_of_unfused(shape):
    """dt (the gradient of both x and r) and dw against jax.vjp of the
    unfused x + y; norm, with cotangents on both outputs; f32 within 1e-5
    of each gradient's largest entry. In bf16 JAX adds the two cotangents
    in bf16 and the port in f32 before one rounding, so they may differ by
    one bf16 ulp: compared in f32 here."""
    rng = np.random.default_rng(len(shape) + shape[-1])
    x, r, dy, ds = (rng.standard_normal(shape, np.float32) for _ in range(4))
    w = rng.standard_normal(shape[-1:], np.float32)
    tx, tr, tw, tdy, tds = (torch.from_numpy(a) for a in (x, r, w, dy, ds))
    s = tx + tr
    dt, dw = rmsnorm_residual_bwd_plain(s, tw, tdy, tds)
    jdx, jdr, jdw = _unfused_vjp(*(jnp.asarray(a) for a in (x, r, w, dy, ds)))
    for g, jg in ((dt, jdx), (dt, jdr), (dw, jdw)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg,
                                   atol=1e-5 * float(np.abs(jg).max()))
    leaves = [t.clone().requires_grad_(True) for t in (tx, tr, tw)]
    y, s2 = rmsnorm_residual(*leaves)
    torch.autograd.backward((y, s2), (tdy, tds))
    assert torch.equal(leaves[0].grad, dt) and torch.equal(leaves[1].grad, dt)
    assert torch.equal(leaves[2].grad, dw)


def test_backward_wrappers_refuse_other_devices():
    """The backward kernels' wrappers, like the forward ones, launch on
    CUDA tensors, give empty outputs on meta ones or raise; they never
    compute a plain version off the CPU."""
    q = _elsewhere(1, 64, 2, 64)
    lse = _elsewhere(1, 2, 64)
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        fa.flash_bwd_dq(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        fa.flash_attention_bwd(q, q, q, q, lse, q)
    x, w = _elsewhere(4, 64), _elsewhere(64)
    rms = _rms_module()
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        rms.rmsnorm_bwd(x, w, x)
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        rms.rmsnorm_residual_bwd(x, w, x, x)
    q = torch.empty(1, 64, 2, 64, device="meta")
    lse = torch.empty(1, 2, 64, device="meta")
    assert [t.shape for t in fa.flash_attention_bwd(q, q, q, q, lse, q)
            ] == [q.shape] * 3
    x, w = torch.empty(4, 64, device="meta"), torch.empty(64, device="meta")
    dx, dw = rms.rmsnorm_residual_bwd(x, w, x, x)
    assert (dx.shape, dw.shape, dw.dtype) == (x.shape, w.shape,
                                              torch.float32)


@pytest.mark.parametrize("rows,variant,blocks", [
    (1, 0, 1), (13, 0, 4), (2048, 0, 264), (1055, 0, 264), (5, 1, 5),
    (300, 2, 264)])
def test_rmsnorm_bwd_blocks_and_source_constants(rows, variant, blocks):
    """A backward launch takes a block per 4 rows (warp layout) or per row,
    at most BWD_BLOCKS; those constants, and dw's reducers and lanes, are
    the source's. Fewer reducers than half an H100's 132 SMs wait at once,
    so the blocks they wait for always find an SM."""
    rms = _rms_module()
    assert rms.bwd_blocks(rows, variant) == blocks
    src = (build.CSRC / "rmsnorm.cu").read_text()
    consts = {m[0]: int(m[1]) for m in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kBwdBlocks"] == rms.BWD_BLOCKS
    assert consts["kRowsPerBlock"] == rms.ROWS_PER_BLOCK
    assert consts["kReducers"] == rms.REDUCERS < 132 // 2
    assert consts["kReduceLanes"] == rms.REDUCE_LANES
    # the lanes of one column fill a warp-layout block by whole columns
    assert (rms.ROWS_PER_BLOCK * 32) % rms.REDUCE_LANES == 0


@pytest.mark.parametrize("entry", ["rmsnorm_fwd", "rmsnorm_residual_fwd",
                                   "rmsnorm_bwd", "rmsnorm_residual_bwd",
                                   "rmsnorm_capture_id", "rmsnorm_empty"])
def test_rmsnorm_entry_signatures_match_the_source(entry):
    """ctypes passes as many arguments as each C entry of rmsnorm.cu takes,
    each pointer as a pointer."""
    rms = _rms_module()
    src = (build.CSRC / "rmsnorm.cu").read_text()
    params = re.search(rf"\nint {entry}\(([^)]*)\)", src).group(1)
    params = [" ".join(p.split()) for p in params.split(",")]
    argtypes = rms._SIGNATURES[entry]
    assert len(params) == len(argtypes)
    for p, a in zip(params, argtypes):
        assert ("*" in p) == (a is not ctypes.c_int and a is not
                              ctypes.c_float), (p, a)


def _dw_in_kernel_order(x, dy, eps, lanes, reducers):
    """dw as K2b's launch sums it, in f32 (numpy): each warp of 4 adds
    dy x r over its rows (row b*4 + w, then every 4*blocks-th) in order,
    each block adds its 4 warps in order into its partial row, and each of
    ``reducers`` blocks takes a slice of the columns, where lane j of a
    column adds partial rows j, j + lanes, ... in order and then the lanes
    are added in order."""
    N, D = x.shape
    xf = x.astype(np.float32)
    r = (1.0 / np.sqrt((xf * xf).mean(-1, dtype=np.float32)
                       + np.float32(eps))).astype(np.float32)
    contrib = (dy.astype(np.float32) * xf) * r[:, None]
    nb = max(1, min(-(-N // 4), 264))
    warp_sums = np.zeros((nb, 4, D), np.float32)
    for row in range(N):                    # each warp's rows, in order
        w = row % (4 * nb)
        warp_sums[w // 4, w % 4] += contrib[row]
    partial = np.zeros((nb, D), np.float32)
    for w in range(4):
        partial += warp_sums[:, w]
    dw = np.zeros(D, np.float32)
    per = -(-D // reducers)
    for c0 in range(0, D, per):             # one reducer's slice
        cols = slice(c0, min(D, c0 + per))
        lane_sums = []
        for j in range(lanes):
            rows = partial[j::lanes, cols]
            acc = rows[0].copy() if len(rows) else np.zeros_like(dw[cols])
            for row in rows[1:]:
                acc += row
            lane_sums.append(acc)
        total = lane_sums[0].copy()
        for acc in lane_sums[1:]:
            total += acc
        dw[cols] = total
    return dw


@pytest.mark.parametrize("N,D", [(2048, 768), (1100, 256), (13, 768)])
def test_rmsnorm_dw_kernel_order_meets_the_bar_and_repeats(N, D):
    """The fused backward's order of dw's sums (per-warp rows, the block's
    warps, then REDUCE_LANES lanes of every REDUCE_LANES-th partial row and
    the lanes in order) is within chip_smoke.py's 1e-5 max|dw| of the plain
    backward, is the same bits run to run, and does not depend on how many
    blocks reduce (each column's order is fixed by the code)."""
    rms = _rms_module()
    rng = np.random.default_rng(N + D)
    x, dy = (rng.standard_normal((N, D), np.float32) for _ in range(2))
    w = rng.standard_normal(D, np.float32)
    _, ref = rms.rmsnorm_bwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(dy))
    ref = ref.numpy()
    got = _dw_in_kernel_order(x, dy, 1e-5, rms.REDUCE_LANES, rms.REDUCERS)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))
    assert np.array_equal(got, _dw_in_kernel_order(
        x, dy, 1e-5, rms.REDUCE_LANES, rms.REDUCERS))
    for reducers in (1, 7):
        assert np.array_equal(got, _dw_in_kernel_order(
            x, dy, 1e-5, rms.REDUCE_LANES, reducers))


def _fma_f32(a, b, c):
    """fmaf on float32 arrays: the product exact in float64, one rounding
    of the sum (a float64 sum then a float32 rounding: two roundings,
    which differ from one only at rare ties)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


@pytest.mark.parametrize("S,H,KV,D,causal,lengths", BWD_CASES,
                         ids=[f"S{c[0]}-G{c[1] // c[2]}-D{c[3]}-"
                              f"{'causal' if c[4] else 'full'}"
                              for c in BWD_CASES])
def test_flash_bwd_f32_kernel_order_vs_jax_grad(S, H, KV, D, causal,
                                                lengths):
    """K1b f32's order of accumulation, emulated in float32 with fused
    multiply-adds: dQ adds dS K over keys in order, dK and dV add dS^T Q
    and P^T dO over the query heads of their KV head in order (g = 0, 1,
    ...), each over its queries in order, one accumulator per (key,
    column) in the block that owns the key. Held against jax.vjp of the
    XLA path at chip_smoke.py's f32 bar, 2e-5 of max(|ref|, 1)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rng = np.random.default_rng(S + H + D + 1)
    B, G = 2, H // KV
    q, do = (rng.standard_normal((B, S, H, D), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, KV, D), np.float32) for _ in range(2))
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    ln = None if lens is None else torch.from_numpy(lens)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa._plain_forward(tq, tk, tv, causal, ln)
    # P and dS (B, H, S, S) as the kernels form them, rounded to f32
    s, mask = fa._scores(tq, tk, causal, ln)
    if ln is not None:
        empty = (ln <= 0)[:, None, None, None]
        s = torch.where(mask, s, torch.where(empty, 0.0, fa.NEG_INF))
    p = torch.exp(s - lse[..., None])
    dof = tdo.transpose(1, 2)
    vf = tv.repeat_interleave(G, dim=2).transpose(1, 2)
    delta = (dof * o.transpose(1, 2)).sum(-1, keepdim=True)
    ds = torch.where(mask, p * (dof @ vf.transpose(-1, -2) - delta), 0.0)
    p, ds = p.numpy(), ds.numpy()
    scale = np.float32(1.0 / np.sqrt(D))
    dq = np.zeros((B, H, S, D), np.float32)
    kh = np.repeat(k, G, axis=2).transpose(0, 2, 1, 3)     # (B, H, S, D)
    for key in range(S):
        dq = _fma_f32(ds[..., :, key:key + 1], kh[:, :, key:key + 1, :], dq)
    dk = np.zeros((B, KV, S, D), np.float32)
    dv = np.zeros((B, KV, S, D), np.float32)
    qh = q.transpose(0, 2, 1, 3).reshape(B, KV, G, S, D)
    doh = do.transpose(0, 2, 1, 3).reshape(B, KV, G, S, D)
    pg = p.reshape(B, KV, G, S, S)
    dsg = ds.reshape(B, KV, G, S, S)
    for g in range(G):
        for qi in range(S):
            dk = _fma_f32(dsg[:, :, g, qi, :, None], qh[:, :, g, qi, None, :],
                          dk)
            dv = _fma_f32(pg[:, :, g, qi, :, None], doh[:, :, g, qi, None, :],
                          dv)
    got = {"q": (dq * scale).transpose(0, 2, 1, 3),
           "k": (dk * scale).transpose(0, 2, 1, 3),
           "v": dv.transpose(0, 2, 1, 3)}
    jl = jnp.asarray(lens if lens is not None else np.full(B, S, np.int32))
    vjp = _xla_gqa_vjp if causal else _xla_full_vjp
    jgrads = vjp(*(jnp.asarray(a) for a in (q, k, v)), jl, jnp.asarray(do))
    for name, jg in zip("qkv", jgrads):
        jg = np.asarray(jg)
        bar = 2e-5 * max(float(np.abs(jg).max()), 1.0)
        np.testing.assert_allclose(got[name], jg, rtol=0, atol=bar,
                                   err_msg=f"d{name}")


# -- K1 f32 forward ----------------------------------------------------------

def test_flash_f32_reads_strided_views_in_place():
    """The f32 forward, like the bf16 one, takes project_qkv's k/v views of
    the fused projection as they are, with their strides: 16-byte cp.async
    needs a 16-byte aligned base and strides of 4 floats. A base 4 bytes
    off, a head dim of stride 2 and a head stride of 66 floats are copied
    first."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    kv = torch.zeros(2, 16, 2, 4, 64)
    for t in (kv[:, :, 0], kv[:, :, 1]):
        same, strides = fa._in_place(t)
        assert same is t and strides == (16 * 2 * 4 * 64, 2 * 4 * 64, 64)
    assert list(fa._stride_array(kv[:, :, 0], kv[:, :, 1])) == [
        16 * 2 * 4 * 64, 2 * 4 * 64, 64] * 2
    flat = torch.arange(1 + 16 * 4 * 64, dtype=torch.float32)
    wide = torch.zeros(1, 16, 4, 66)
    for bad in (flat[1:].view(1, 16, 4, 64),                 # base 4 bytes off
                kv.view(2, 16, 4, 128)[..., ::2],            # head dim stride 2
                wide[..., :64]):                             # head stride 66
        copy, strides = fa._in_place(bad)
        assert copy is not bad and copy.is_contiguous()
        assert copy.data_ptr() % 16 == 0 and torch.equal(copy, bad)
        assert strides == fa._strides(copy)


@pytest.mark.parametrize("B,S,H,dtype,splits", [
    (1, 512, 12, torch.float32, 4),       # serving: 96 q tiles < 132 SMs
    (16, 128, 12, torch.float32, 1),      # training: 384 q tiles
    (1, 512, 12, torch.bfloat16, 1),      # bf16 never splits
    (2, 33, 12, torch.float32, 4)])
def test_flash_f32_key_splits_fill_the_card(B, S, H, dtype, splits):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    assert fa.key_splits(B, S, H, dtype, 132) == splits


def _f32_fwd_in_kernel_order(q, k, v, lengths, causal, splits):
    """(o, lse) of flash_fwd_f32 in its order of sums, in float32 with fused
    multiply-adds: per 64-row q tile, its k tiles in ``splits`` runs of
    consecutive tiles; per run, per 64-key tile, the scores (a fused
    multiply-add chain over d, times scale log2(e)), the running max, p =
    exp2(s - m), each of the 8 key lanes' share of the denominator
    (l = l corr + its 8 p in order), acc = acc corr, then P V over the
    tile's keys in order; the 8 shares summed by a butterfly; with several
    runs, their o and denominators merged in run order."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kh = np.repeat(k, G, axis=2).transpose(0, 2, 1, 3)       # (B, H, S, D)
    vh = np.repeat(v, G, axis=2).transpose(0, 2, 1, 3)
    qh = q.transpose(0, 2, 1, 3)
    dot = np.zeros((B, H, S, S), np.float32)
    for d in range(D):
        dot = _fma_f32(qh[..., :, None, d], kh[..., None, :, d], dot)
    scale2 = np.float32(np.float32(1.0 / np.sqrt(D)) * np.float32(np.log2(np.e)))
    o = np.zeros((B, H, S, D), np.float32)
    lse = np.zeros((B, H, S), np.float32)
    kpos = np.arange(S)
    for b in range(B):
        n = S if lengths is None else int(lengths[b])
        for q0 in range(0, S, 64):
            rows = np.arange(q0, min(q0 + 64, S))
            kend = min(S, q0 + 64) if causal else S
            kend = min(kend, n) if n > 0 else S
            nk = -(-kend // 64)
            runs = []
            for p in range(splits):
                m = np.full((H, len(rows)), -1e30, np.float32)
                lane = np.zeros((H, len(rows), 8), np.float32)
                acc = np.zeros((H, len(rows), D), np.float32)
                for j in range(p * nk // splits, (p + 1) * nk // splits):
                    keys = np.arange(j * 64, j * 64 + 64)
                    ok = (keys[None, :] < n) & ((not causal) | (
                        keys[None, :] <= rows[:, None]))
                    kk = np.minimum(keys, S - 1)
                    s = np.where(ok, dot[b][:, rows][:, :, kk] * scale2,
                                 np.float32(-1e30)).astype(np.float32)
                    s = np.where(keys >= S, np.float32(-np.inf), s)
                    mx = np.maximum(m, s.max(-1))
                    corr = np.exp2(m - mx)
                    pr = np.exp2(s - mx[..., None]).astype(np.float32)
                    share = np.zeros_like(lane)
                    for c in range(8):
                        share = share + pr[..., c::8]
                    lane = _fma_f32(lane, corr[..., None], share)
                    m = mx
                    acc = acc * corr[..., None]
                    vt = np.where((keys < S)[:, None], vh[b][:, kk], 0)
                    for t in range(64):
                        acc = _fma_f32(pr[..., t:t + 1], vt[:, None, t], acc)
                l = ((lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3])
                     ) + ((lane[..., 4] + lane[..., 5]) + (lane[..., 6]
                                                          + lane[..., 7]))
                runs.append((m, l, acc))
            if splits == 1:
                m, l, acc = runs[0]
            else:
                m = np.max([r[0] for r in runs], axis=0)
                l = np.zeros_like(runs[0][1])
                acc = np.zeros_like(runs[0][2])
                for mp, lp, ap in runs:
                    cp = np.exp2(mp - m)
                    l = _fma_f32(lp, cp, l)
                    acc = _fma_f32(ap, cp[..., None], acc)
            o[b][:, rows] = acc / np.maximum(l, np.float32(1e-30))[..., None]
            lse[b][:, rows] = (np.where(m <= -1e30, np.float32(0),
                                        m * np.float32(np.log(2)))
                               + np.log(l)).astype(np.float32)
    return o.transpose(0, 2, 1, 3), lse


@jax.jit
def _xla_gqa_full(q, k, v, lengths):
    g = q.shape[2] // k.shape[2]
    return flash_attention_xla(q, repeat_kv(k, g), repeat_kv(v, g),
                               causal=False, lengths=lengths)


# (S, H, KV, D, causal, lengths): ragged tiles past 64 and 128, a row with
# no valid key, G = 1 and 3, causal and full, D = 64 and 128
FWD_CASES = [(65, 6, 2, 64, True, [65, 0]), (200, 6, 2, 64, True, [0, 137]),
             (129, 4, 4, 128, False, [0, 100]), (128, 3, 3, 64, True, None)]


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("S,H,KV,D,causal,lengths", FWD_CASES,
                         ids=[f"S{c[0]}-G{c[1] // c[2]}-D{c[3]}-"
                              f"{'causal' if c[4] else 'full'}"
                              for c in FWD_CASES])
def test_flash_fwd_f32_kernel_order_vs_jax(S, H, KV, D, causal, lengths,
                                           splits):
    """K1 f32's order of sums (:func:`_f32_fwd_in_kernel_order`), whole and
    with each q tile's keys split over 4 blocks, against the XLA path on
    repeated K/V at the f32 bar (3e-5), and against the Pallas kernel in
    interpret mode where it applies (no lengths, H = KV); its lse against
    the plain forward's at phase 7's bar (1e-4 of max(|lse|, 1))."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rng = np.random.default_rng(S + H + D + 7)
    B = 2
    q = rng.standard_normal((B, S, H, D), np.float32)
    k, v = (rng.standard_normal((B, S, KV, D), np.float32) for _ in range(2))
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    o, lse = _f32_fwd_in_kernel_order(q, k, v, lens, causal, splits)
    jl = jnp.asarray(lens if lens is not None else np.full(B, S, np.int32))
    xla = _xla_gqa if causal else _xla_gqa_full
    ref_o = np.asarray(xla(*(jnp.asarray(a) for a in (q, k, v)), jl))
    np.testing.assert_allclose(o, ref_o, rtol=0, atol=3e-5)
    if lens is None and H == KV:
        bhsd = (0, 2, 1, 3)
        tpu = flash_attention_tpu(*(jnp.asarray(a.transpose(bhsd))
                                    for a in (q, k, v)), causal=causal,
                                  interpret=True)
        np.testing.assert_allclose(o, np.asarray(tpu).transpose(bhsd),
                                   rtol=0, atol=3e-5)
    _, ref_lse = fa._plain_forward(
        *(torch.from_numpy(a) for a in (q, k, v)), causal,
        None if lens is None else torch.from_numpy(lens))
    bar = 1e-4 * max(float(ref_lse.abs().max()), 1.0)
    np.testing.assert_allclose(lse, ref_lse.numpy(), rtol=0, atol=bar)


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_113flash_fwd_f32ILi64ELb0EEEvPKfNS_10RowStridesE",
     "flash_fwd_f32<float, 64>"),
    ("_ZN12_GLOBAL__N_113flash_fwd_f32ILi64ELb1EEEvPKfNS_10RowStridesE",
     "flash_fwd_f32<float, 64, split>"),
    ("_ZN12_GLOBAL__N_119flash_fwd_f32_mergeILi128EEEvPKfiPfS3_iii",
     "flash_fwd_f32_merge<float, 128>"),
    ("_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi64EEEv14CUtensorMap_st",
     "flash_fwd_wgmma<bf16, 64>"),
    ("_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi192EEEv14CUtensorMap_st",
     "flash_fwd_wgmma<bf16, 192>"),
    ("_ZN12_GLOBAL__N_113flash_fwd_f32ILi192ELb1EEEvPKfNS_10RowStridesE",
     "flash_fwd_f32<float, 192, split>"),
    ("_ZN12_GLOBAL__N_116flash_bwd_dq_f32ILi128EEEvPKfS2_",
     "flash_bwd_dq_f32<float, 128>")])
def test_chip_smoke_names_every_flash_kernel(mangled, name):
    """chip_smoke.py reads ptxas's report and the SASS by these names; its
    spill checks look for the f32 forward's."""
    assert _chip_smoke().kernel_name(mangled) == name
