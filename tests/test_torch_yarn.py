"""YaRN in the port (``models/layers.py``, ``models/mla.py``): DeepSeek-V2-
Lite's correction range, frequencies and scales against the constants its
published ``rope_scaling`` gives; the flash attention's ``scale`` forward
and backward against PyTorch's SDPA at the same scale; and RoPE and MLA's
softmax scale bit-equal to the unscaled ones with YaRN off."""
import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import LayerSpec, MLAConfig, ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import mla

# DeepSeek-V2-Lite (huggingface.co/deepseek-ai/DeepSeek-V2-Lite, config.json)
LITE = ModelConfig(
    name="deepseek-v2-lite", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=10944, vocab_size=102400,
    rope_theta=10000, norm_eps=1e-6,
    prelayers=(LayerSpec("mla", "dense"),), period=(LayerSpec("mla", "moe"),),
    mla=MLAConfig(q_lora_rank=0), rope_scaling="yarn", rope_factor=40,
    rope_original_max_positions=4096, yarn_beta_fast=32, yarn_beta_slow=1,
    yarn_mscale=0.707, yarn_mscale_all_dim=0.707)
OFF = dataclasses.replace(LITE, rope_scaling="none")


def _plain_rope(x, positions, theta):
    """``apply_rope`` as it was before YaRN: split halves, f32 angles."""
    hd = x.shape[-1]
    freqs = 1.0 / (float(theta) ** (torch.arange(
        0, hd, 2, dtype=torch.float32) / hd))
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def test_deepseek_v2_lite_constants():
    """low 10, high 23 over the 64 rope dims; the dims below low keep their
    frequency, those from high on turn 40 times slower, the 13 between
    blend by the ramp; cos/sin scaled by exactly 1; mscale 1.2608038 and
    the softmax scale 0.1147214 (against 1/sqrt(192) = 0.0721688)."""
    assert L.yarn_range(LITE, 64) == (10, 23)
    f0 = L.rope_freqs(64, 10000)
    f, factor = L.rope_table(LITE, 64, "cpu")
    assert factor == 1.0
    assert torch.equal(f[:11], f0[:11])
    torch.testing.assert_close(f[23:], f0[23:] / 40, rtol=1e-6, atol=0)
    ramp = (torch.arange(11, 23, dtype=torch.float32) - 10) / 13
    torch.testing.assert_close(f[11:23], f0[11:23] / 40 * ramp
                               + f0[11:23] * (1 - ramp), rtol=1e-6, atol=0)
    assert (f != f0).sum() == 21
    assert L.yarn_mscale(40, 0.707) == pytest.approx(1.2608038, abs=1e-7)
    assert L.yarn_mscale(40, 0.707) / L.yarn_mscale(40, 0.707) == 1.0
    assert mla.softmax_scale(LITE) == pytest.approx(0.1147214, abs=1e-7)
    assert mla.softmax_scale(OFF) == 1.0 / math.sqrt(192)
    # cos/sin scaled by exactly 1: the rotation is the plain one's at
    # YaRN's frequencies
    x = torch.randn(3, 5, 2, 64)
    pos = torch.tensor([[0, 1, 4095, 4096, 16383]] * 3)
    ang = pos[..., None].float() * f
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, -1)
    assert torch.equal(L.apply_rope(x, pos, LITE), torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1))


def test_mscale_ratio_scales_cos_and_sin():
    cfg = dataclasses.replace(LITE, yarn_mscale=1.0)
    x, pos = torch.randn(2, 7, 3, 64), torch.arange(7)[None].expand(2, 7)
    ratio = L.yarn_mscale(40, 1.0) / L.yarn_mscale(40, 0.707)
    torch.testing.assert_close(L.apply_rope(x, pos, cfg),
                               L.apply_rope(x, pos, LITE) * ratio,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_yarn_off_is_bit_equal_to_plain_rope(dtype):
    x = torch.randn(2, 9, 4, 64).to(dtype)
    pos = torch.arange(9)[None].expand(2, 9) * 500
    want = _plain_rope(x, pos, 10000)
    assert torch.equal(L.apply_rope(x, pos, 10000), want)
    assert torch.equal(L.apply_rope(x, pos, OFF), want)
    for arch in list_archs():
        cfg = get_config(arch)
        assert cfg.rope_scaling == "none", arch
        if cfg.mla is not None:
            m = cfg.mla
            assert mla.softmax_scale(cfg) == 1.0 / math.sqrt(
                m.qk_nope_head_dim + m.qk_rope_head_dim)


def test_the_yarn_table_is_built_once_and_serves_training_too():
    """Built on the first call, under the engine's inference mode, and the
    same tensor after; a training step's rotation then takes gradients
    through it."""
    cfg = dataclasses.replace(LITE, rope_factor=8.0)
    x = torch.randn(2, 5, 3, 64, requires_grad=True)
    pos = torch.arange(5)[None].expand(2, 5)
    with torch.inference_mode():
        first = L.apply_rope(x.detach(), pos, cfg)
        table = L.rope_table(cfg, 64, "cpu")[0]
    assert L.rope_table(cfg, 64, torch.device("cpu"))[0] is table
    assert not table.is_inference()
    out = L.apply_rope(x, pos, cfg)
    assert torch.equal(out.detach(), first)
    (g,) = torch.autograd.grad(out.square().sum(), x)
    assert torch.isfinite(g).all()


def test_an_unknown_scaling_is_refused():
    with pytest.raises(ValueError, match="rope_scaling"):
        dataclasses.replace(LITE, rope_scaling="linear")
    with pytest.raises(ValueError, match="yarn"):
        dataclasses.replace(LITE, rope_original_max_positions=0)


@pytest.mark.parametrize("D,scale", [(24, 0.1147214), (64, 0.3),
                                     (64, None)])
def test_flash_attention_scale_against_sdpa(D, scale):
    """Forward and the three gradients against SDPA at the same scale,
    in float32 with grouped heads: on the CPU the plain path, whose scale
    the card's wrappers pass to the kernels as they are."""
    g = torch.Generator().manual_seed(D)
    q = torch.randn(2, 33, 4, D, generator=g, requires_grad=True)
    k = torch.randn(2, 33, 2, D, generator=g, requires_grad=True)
    v = torch.randn(2, 33, 2, D, generator=g, requires_grad=True)
    do = torch.randn(2, 33, 4, D, generator=g)
    o = flash_attention(q, k, v, causal=True, scale=scale)
    grads = torch.autograd.grad(o, (q, k, v), do)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    ref = F.scaled_dot_product_attention(
        qs, ks.repeat_interleave(2, 1), vs.repeat_interleave(2, 1),
        is_causal=True, scale=scale).transpose(1, 2)
    want = torch.autograd.grad(ref, (q, k, v), do)
    torch.testing.assert_close(o, ref, rtol=1e-5, atol=1e-5)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-4)
