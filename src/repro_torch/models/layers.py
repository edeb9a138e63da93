"""Shared primitive layers: norms, positional embeddings, dense FFN,
embeddings. Port of ``repro/models/layers.py``.

Plain functions over (config, params, inputs), named as in JAX. ``p`` is any
mapping of parameter name to tensor (an ``nn.ParameterDict`` in the model).
Weights are ``(in, out)`` and applied as ``x @ w``.

Tensor parallelism over the mesh's ``model`` axis (what GSPMD derives from
the reference's ``param_specs``, written out): the embedding split over the
vocab (each rank looks up the ids in its rows, a psum adds them), the
unembedding giving each rank its vocab's logits, and the dense FFN
column-parallel into the hidden and row-parallel out of it, with
``pvary`` where a value the ranks share enters their own computation and
``psum`` where their partial results meet (``parallel/collectives.py``).
"""
from __future__ import annotations

import functools
import math
from typing import Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.bf16x3 import split_bf16x3
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.params import TP_AXIS
from repro_torch.parallel.collectives import psum, pvary


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def embed_scale(cfg: ModelConfig) -> float:
    """``cfg.embedding_multiplier`` rounded to the compute dtype, as the
    reference applies it; a Python scalar, so no host-to-device copy."""
    return torch.tensor(cfg.embedding_multiplier,
                        dtype=dtype_of(cfg.dtype)).item()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def apply_norm(cfg: ModelConfig, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm (through the rmsnorm kernel) or LayerNorm, in f32, cast back
    to the input dtype."""
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"], cfg.norm_eps)
    xf = x.float()
    xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    return (y + p["bias"].float()).to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
                  ) -> torch.Tensor:
    """Per-head qk-norm (no mean subtraction)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary / sinusoidal position embeddings
# ---------------------------------------------------------------------------

def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 * mscale * ln(factor) + 1`` for a
    factor above 1, else 1 (DeepSeek-V2's ``yarn_get_mscale``)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_range(cfg: ModelConfig, head_dim: int) -> tuple:
    """(low, high): the rotary dims below ``low`` keep their frequency, those
    above ``high`` take it divided by the factor; ``dim(r)``, the dim that
    turns ``r`` times over the original context, is
    ``d ln(L0 / (2 pi r)) / (2 ln theta)``, and low = floor(dim(beta_fast)),
    high = ceil(dim(beta_slow)), within [0, d - 1]."""
    def dim(rotations: float) -> float:
        return (head_dim * math.log(cfg.rope_original_max_positions
                                    / (rotations * 2 * math.pi))
                / (2 * math.log(cfg.rope_theta)))
    return (max(math.floor(dim(cfg.yarn_beta_fast)), 0),
            min(math.ceil(dim(cfg.yarn_beta_slow)), head_dim - 1))


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (float(theta) ** exps)


def rope_table(cfg: ModelConfig, head_dim: int, device
               ) -> Tuple[torch.Tensor, float]:
    """``cfg``'s rotary frequencies at ``head_dim`` on ``device`` and the
    factor on cos and sin: :func:`rope_freqs` and 1, or, where
    ``rope_scaling`` is "yarn", f_i / s * ramp_i + f_i * (1 - ramp_i),
    ramp_i = clamp((i - low) / (high - low), 0, 1) (:func:`yarn_range`),
    and mscale(yarn_mscale) / mscale(yarn_mscale_all_dim)."""
    if cfg.rope_scaling != "yarn":
        return rope_freqs(head_dim, cfg.rope_theta, device), 1.0
    return _yarn_table(cfg, head_dim, torch.device(device))


@functools.lru_cache(maxsize=None)
def _yarn_table(cfg: ModelConfig, head_dim: int, device: torch.device
                ) -> Tuple[torch.Tensor, float]:
    """YaRN's table, a constant of the config: built once for each config,
    head dim and device, outside any inference mode so that training may
    use it after serving."""
    low, high = yarn_range(cfg, head_dim)
    with torch.inference_mode(False), torch.no_grad():
        freqs = rope_freqs(head_dim, cfg.rope_theta, device)
        ramp = ((torch.arange(head_dim // 2, dtype=torch.float32,
                              device=device) - low)
                / (high - low if high > low else 0.001)).clamp(0.0, 1.0)
        freqs = freqs / cfg.rope_factor * ramp + freqs * (1.0 - ramp)
    return freqs, (yarn_mscale(cfg.rope_factor, cfg.yarn_mscale)
                   / yarn_mscale(cfg.rope_factor, cfg.yarn_mscale_all_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               rope: Union[float, ModelConfig]) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).
    Split-half rotation with the angles in f32. ``rope`` is the base theta,
    or a config, rotated at its :func:`rope_table`."""
    if isinstance(rope, ModelConfig):
        freqs, f = rope_table(rope, x.shape[-1], x.device)
    else:
        freqs, f = rope_freqs(x.shape[-1], rope, x.device), 1.0
    angles = positions[..., None].float() * freqs        # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    if f != 1.0:
        cos, sin = cos * f, sin * f
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sincos_pos_emb(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Classic transformer sinusoidal embedding; positions (..., seq)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Dense (SwiGLU / GELU) FFN
# ---------------------------------------------------------------------------

def ffn_hidden(cfg: ModelConfig, p: Mapping, x: torch.Tensor
               ) -> torch.Tensor:
    """The FFN's hidden activations: SwiGLU of [gate | up], or GELU."""
    dt = x.dtype
    gu = x @ p["w_in"].to(dt)
    if "b_in" in p:
        gu = gu + p["b_in"].to(dt)
    if cfg.ffn_gated:
        g, u = gu.chunk(2, dim=-1)
        return F.silu(g) * u
    return F.gelu(gu, approximate="tanh")    # jax.nn.gelu's default form


def apply_ffn(cfg: ModelConfig, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    y = ffn_hidden(cfg, p, x) @ p["w_out"].to(dt)
    if "b_out" in p:
        y = y + p["b_out"].to(dt)
    return y


def row_parallel(h: torch.Tensor, w: torch.Tensor, mesh,
                 axis: str = TP_AXIS) -> torch.Tensor:
    """``h @ w`` where each rank holds its part of the contraction (its
    heads or hidden units): each rank's partial product in f32 (products
    of two h.dtype values are exact there), the partials summed, and the
    sum rounded once to h.dtype, as the single device's product is. Bf16
    partials rounded apart move the mesh step's gradients several times
    further from the single process's (``tools/mesh_grad_cosines.py``)."""
    return psum(h.float() @ w.to(h.dtype).float(), axis, mesh).to(h.dtype)


def tp_apply_ffn(cfg: ModelConfig, p: Mapping, x: torch.Tensor, mesh,
                 d_ff: Optional[int] = None, axis: str = TP_AXIS
                 ) -> torch.Tensor:
    """:func:`apply_ffn` over ``axis``: ``w_in`` (and ``b_in``) hold this
    rank's part of the ``d_ff`` hidden units (``cfg.d_ff`` by default; a
    gated FFN's stored grouped, [its gate | its up],
    ``params.grouped_columns``), ``w_out`` their rows; the partial outputs
    are summed (:func:`row_parallel`), then ``b_out`` added once. ``x`` is
    the same on every rank."""
    n = mesh.size(mesh.live((axis,)))
    d_ff = d_ff or cfg.d_ff
    if p["w_out"].shape[0] * n != d_ff:
        raise NotImplementedError(
            f"{cfg.name}: an FFN hidden of {d_ff} does not split over {n} "
            f"ranks")
    h = ffn_hidden(cfg, p, pvary(x, axis, mesh))
    y = row_parallel(h, p["w_out"], mesh, axis)
    if "b_out" in p:
        y = y + p["b_out"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def lookup(p: Mapping, tokens: torch.Tensor, dt: torch.dtype, mesh=None,
           axis: str = TP_AXIS) -> torch.Tensor:
    """``p["tok"][tokens]`` in ``dt`` (gather, then cast: same values).
    Over a live ``axis`` ``tok`` holds this rank's vocab rows: each rank
    looks up the ids in its range, zeroes the rest, and a psum adds them
    (one nonzero a row, so the sum is exact)."""
    if mesh is None or not mesh.live((axis,)):
        return p["tok"][tokens].to(dt)
    w = p["tok"]
    local = tokens - mesh.axis_index(mesh.live((axis,))) * w.shape[0]
    inside = (local >= 0) & (local < w.shape[0])
    x = w[local.clamp(0, w.shape[0] - 1)].to(dt)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=dt,
                                                       device=x.device))
    return psum(x, axis, mesh)


def embed_tokens(cfg: ModelConfig, p: Mapping, tokens: Optional[torch.Tensor],
                 extra_embeds: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None, mesh=None
                 ) -> torch.Tensor:
    """The input embeddings; with ``mesh``, ``tok`` split over the vocab
    (:func:`lookup`)."""
    dt = dtype_of(cfg.dtype)
    if cfg.input_mode == "embeds":
        # modality stub: the token slot carries precomputed frame embeddings
        x = extra_embeds.to(dt) @ p["frame_proj"].to(dt)
    else:
        x = lookup(p, tokens, dt, mesh)
        if cfg.input_mode == "tokens+vision" and extra_embeds is not None:
            v = extra_embeds.to(dt) @ p["vision_proj"].to(dt)
            x = torch.cat([v, x], dim=1)
    x = x * embed_scale(cfg)
    if cfg.pos_emb == "sincos":
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = x + sincos_pos_emb(positions, cfg.d_model).to(dt)
    return x


# device types whose ``aten::mm.dtype`` takes bf16 operands to an f32
# result: the card's, and meta, which stands for the card in the dry run
TENSOR_CORE_DEVICES = ("cuda", "meta")
# vocab columns of the cotangent split at a time: a block's bf16 terms,
# (N, 3, VOCAB_BLOCK), are all of the split that exists at once (201 MB
# at internlm2-1.8b's microbatch of 16,384 tokens, where the whole
# cotangent's would be 9.1 GB). dx contracts a block's 3 x VOCAB_BLOCK
# products in one GEMM, lo and mid first, so the block also sets how many
# hi products one of dx's accumulators sums.
VOCAB_BLOCK = 2048
# dw's hi products, cut over the tokens into runs this long, one
# tensor-core accumulator a run, the runs added in f32. The tensor cores
# truncate as they accumulate, so their f32 sum drifts toward zero with
# its length: on an H100 at internlm2-1.8b's microbatch, dw's elements
# summed over 3 x 16,384 products in one GEMM came out 36 times further
# from f64 than the f32 product's; with dw's hi term in runs of 2,048 and
# 2,048-column blocks, dx and dw have 1.06 times as many bf16 values off
# the f64 result's rounding as the f32 product's (PERF.md §6). dw's lo and
# mid terms are each summed over all the tokens in one GEMM (one GEMM for
# both): they are about 2**-16 and 2**-8 of hi's size, so their drift
# stays below the result's rounding. The forward's run is d_model, whole.
TC_RUN = 2048


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 matrices (or stacks of them), summed and
    returned in f32: one tensor-core GEMM on the card; on the CPU, which
    has no kernel for it, the f32 product of the upcast operands (the
    same exact products, summed in another order)."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    if a.dim() == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.mm(a, b, out_dtype=torch.float32)


def _in_runs(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``h.T @ x`` of bf16 h (N, C) and x (N, D) in f32, each run of
    ``TC_RUN`` tokens one tensor-core product (one batched GEMM for the
    whole runs), the runs added in f32."""
    N, C = h.shape
    whole = N - N % TC_RUN
    out = None
    if whole:
        runs = whole // TC_RUN
        out = _product(h[:whole].view(runs, TC_RUN, C).transpose(1, 2),
                       x[:whole].view(runs, TC_RUN, -1)).sum(0)
    if whole < N:
        tail = _product(h[whole:].T, x[whole:])
        out = tail if out is None else out.add_(tail)
    return out


class UnembedProduct(torch.autograd.Function):
    """f32 logits ``x @ w.T`` of bf16 x (N, D) and w (V, D) on tensor
    cores: the forward one GEMM with f32 accumulation (the reference's
    einsum with ``preferred_element_type=float32``). The backward takes
    the f32 cotangent as three exact bf16 terms (:func:`split_bf16x3`,
    ascending: lo, mid, hi), ``VOCAB_BLOCK`` vocab columns at a time: the
    block's part of dx in one GEMM over [lo | mid | hi], summed over the
    blocks in f32; its rows of dw as the lo and mid terms' products in one
    GEMM and the hi term's in runs of ``TC_RUN`` tokens, added in f32,
    (lo + mid) + hi. dx and dw come back in x's and w's dtypes, as
    autograd returns the f32 product's. x and w are kept for the backward
    as they came."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return _product(x, w.T)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        N, V = g.shape
        dx = None
        dw = torch.empty_like(w)
        for v in range(0, V, VOCAB_BLOCK):
            parts = split_bf16x3(g[:, v:v + VOCAB_BLOCK])    # (N, 3, C)
            C = parts.shape[2]
            dx_v = _product(parts.view(N, 3 * C), w[v:v + C].repeat(3, 1))
            dx = dx_v if dx is None else dx.add_(dx_v)
            low = _product(parts[:, :2].reshape(N, 2 * C).T, x)
            dw[v:v + C] = _in_runs(parts[:, 2], x).add_(
                low[:C].add_(low[C:]))
        return dx.to(x.dtype), dw


def unembed_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:class:`UnembedProduct` over x's last dim: f32 logits (..., V);
    ``unembed_product.calls`` counts the calls."""
    unembed_product.calls += 1
    logits = UnembedProduct.apply(x.reshape(-1, x.shape[-1]), w)
    return logits.view(*x.shape[:-1], w.shape[0])


unembed_product.calls = 0


def unembed(cfg: ModelConfig, p: Mapping, x: torch.Tensor, mesh=None
            ) -> torch.Tensor:
    """f32 logits of x against the (tied or separate) unembedding; with
    ``mesh``, the weight holds this rank's vocab rows and so do the logits
    (``train.loss.cross_entropy`` takes them so). A bf16 x on the card
    (or meta) goes through :func:`unembed_product`; any other x takes the
    f32 product of the upcast operands (``unembed.f32_calls`` counts those
    calls): an f16 one too, whose weight a bf16 term of the cotangent
    cannot meet in one exact product."""
    w = p["tok"] if cfg.tie_embeddings else p["unembed"]
    if mesh is not None:
        x = pvary(x, TP_AXIS, mesh)
    if x.dtype == torch.bfloat16 and x.device.type in TENSOR_CORE_DEVICES:
        logits = unembed_product(x, w.to(x.dtype))
    else:
        unembed.f32_calls += 1
        # products of two x.dtype values are exact in f32: this is the
        # reference's x.dtype einsum with f32 accumulation
        logits = x.float() @ w.to(x.dtype).float().T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


unembed.f32_calls = 0
