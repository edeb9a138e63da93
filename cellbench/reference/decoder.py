"""Plain PyTorch reference of the decoder-only transformers the benchmark
runs: RMSNorm, RoPE (split halves), grouped-query causal attention with
optional q/k/v biases in every layer, a SwiGLU FFN or a mixture of experts
(softmax router, top-k, optional renormalisation, a shared SwiGLU block)
by each layer's spec, a final RMSNorm and an untied unembedding.

It follows the published architectures (InternLM2, Qwen2-MoE) in float32,
with no kernel, cache or batching, and reads a configuration file's
``model`` section. Departures from the published models are those the
configuration file lists. It imports nothing of the program; its
model-independent parts, and what the harness calls on every reference
module (``exact``, ``f32_mm``, ``fp8_mm``), are ``parts.py``'s, and the
weights are read as that file says.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from . import parts
from .parts import (MatMul, Params, exact, experts,  # noqa: F401
                    f32_mm, fp8_mm, layer_specs, lm_loss, rms_norm, swiglu)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd): rotate the two halves of each head by the position's
    angles (the Llama / Qwen2 / InternLM2 convention)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m: Dict, p: Params, pre: str, h: torch.Tensor,
              mm: MatMul) -> torch.Tensor:
    """Causal grouped-query self-attention of one sequence h (S, D)."""
    S = h.shape[0]
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = mm(h, p[pre + "wq"])
    kv = mm(h, p[pre + "wkv"])
    if m.get("qkv_bias"):
        q = q + p[pre + "bq"].float()
        kv = kv + p[pre + "bkv"].float()
    q = q.view(S, H, hd)
    k, v = kv.view(S, 2, KV, hd).unbind(1)
    pos = torch.arange(S, device=h.device)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(S, H * hd), p[pre + "wo"])


def hidden(m: Dict, p: Params, tokens: torch.Tensor,
           mm: MatMul = f32_mm) -> torch.Tensor:
    """The final normed hidden states (S, D) of one sequence of token ids."""
    eps = m["norm_eps"]
    x = p["embed.tok"][tokens].float()
    for i, spec in enumerate(layer_specs(m)):
        if spec.mixer != "attn" or spec.ffn not in ("dense", "moe") \
                or spec.parallel:
            raise ValueError(f"the decoder reference computes attention "
                             f"then a dense or MoE FFN, not {spec}")
        pre = f"layers.{i}."
        h = rms_norm(x, p[pre + "mixer_norm.scale"], eps)
        x = x + attention(m, p, pre + "mixer.", h, mm)
        h = rms_norm(x, p[pre + "ffn_norm.scale"], eps)
        if spec.ffn == "moe":
            x = x + experts(m, p, pre + "ffn.", h, mm)
        else:
            x = x + swiglu(h, p[pre + "ffn.w_in"], p[pre + "ffn.w_out"], mm)
    return rms_norm(x, p["out_norm.scale"], eps)


def logits(m: Dict, p: Params, tokens: torch.Tensor,
           positions: Optional[Sequence[int]] = None,
           mm: MatMul = f32_mm) -> torch.Tensor:
    """float32 logits (len(positions), V) of one sequence (every position
    when None): the logits predicting the token after each."""
    x = hidden(m, p, tokens, mm)
    if positions is not None:
        x = x[torch.as_tensor(list(positions), device=x.device)]
    return mm(x, p["embed.unembed"].T)


def loss(m: Dict, p: Params, tokens: torch.Tensor, labels: torch.Tensor,
         z_loss: float, mm: MatMul = f32_mm) -> torch.Tensor:
    """``parts.lm_loss`` of one sequence's logits."""
    return lm_loss(logits(m, p, tokens, mm=mm), labels, z_loss)


def train(m: Dict, p: Dict[str, torch.Tensor], batches, opt: Dict,
          z_loss: float, mm: MatMul = f32_mm):
    """``parts.train`` on this module's :func:`loss`."""
    return parts.train(loss, m, p, batches, opt, z_loss, mm)
