"""Plain PyTorch reference of DeepSeek-V2 (the Lite model, and any
configuration laid out as it is): RMSNorm, multi-head latent attention in
its naive form, a dense SwiGLU FFN in the leading layers and a mixture of
experts (softmax router, greedy top-k, no renormalisation, a shared SwiGLU
block) after them, by each layer's spec, a final RMSNorm and an untied
unembedding.

Multi-head latent attention, as DeepSeek-V2's paper (arXiv:2405.04434,
section 2.1) writes it, for one sequence h (S, D):

- queries q = h W_q (or, with a query rank, RMSNorm(h W_dq) W_uq), each
  head's split into dn "nope" and dr rope dims;
- the latent c = RMSNorm(h W_dkv) (S, R) and one rope key h W_kr (S, dr)
  shared by every head;
- every head's key [c W_uk | rope(h W_kr)] and value c W_uv rebuilt from
  the latent (W_ukv holds [W_uk | W_uv] per head);
- causal softmax attention at scale (dn + dr)^-1/2, times mscale^2 under
  YaRN, then W_o.

RoPE rotates the rope dims in two halves (the port's order; the published
checkpoint stores them interleaved, a relabelling of W_q's and W_kr's rope
columns on random weights), at YaRN's frequencies where the ``model``
section says ``rope_scaling: "yarn"``: with factor s, original context L0
and the rope dims d, dim(r) = d ln(L0 / (2 pi r)) / (2 ln theta), low =
floor(dim(beta_fast)), high = ceil(dim(beta_slow)), each frequency f_i =
theta^(-2i/d) blended as f_i / s * ramp_i + f_i (1 - ramp_i) with ramp_i =
clamp((i - low) / (high - low), 0, 1), and cos and sin times mscale(s,
yarn_mscale) / mscale(s, yarn_mscale_all_dim), mscale(s, m) = 0.1 m ln s +
1 (DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``).

Everything is float32 (the angles float64), with no kernel, cache,
padding or batching; the causal attention takes its queries in blocks of
:data:`Q_BLOCK`, each against the keys up to its last, so that a 16k-token
sequence fits beside the model's weights. It imports nothing of the
program; its model-independent parts, and what the harness calls on every
reference module (``exact``, ``f32_mm``, ``fp8_mm``), are ``parts.py``'s,
and the weights are read as that file says.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import parts
from .parts import (MatMul, Params, exact, experts,  # noqa: F401
                    f32_mm, fp8_mm, layer_specs, lm_loss, rms_norm, swiglu)

# queries one block of the causal attention takes: its scores, (heads,
# Q_BLOCK, keys) in float32, are 2.1 GB at 16 heads and 16,384 keys
Q_BLOCK = 2048


def mscale(factor: float, m: float) -> float:
    """YaRN's attention factor 0.1 m ln(factor) + 1, for a factor above 1."""
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn(m: Dict) -> bool:
    return m.get("rope_scaling", "none") == "yarn"


def rope_freqs(m: Dict, d: int) -> torch.Tensor:
    """The d / 2 rotary frequencies of d rope dims, float64, YaRN's where
    the model section asks for it."""
    theta = float(m["rope_theta"])
    i = torch.arange(d // 2, dtype=torch.float64)
    f = theta ** (-2.0 * i / d)
    if not yarn(m):
        return f

    def dim(rotations: float) -> float:
        return (d * math.log(m["rope_original_max_positions"]
                             / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(dim(m["yarn_beta_fast"])), 0)
    high = min(math.ceil(dim(m["yarn_beta_slow"])), d - 1)
    ramp = ((i - low) / max(high - low, 0.001)).clamp(0.0, 1.0)
    return f / m["rope_factor"] * ramp + f * (1.0 - ramp)


def rope_tables(m: Dict, S: int, d: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (S, 1, d / 2) at positions 0 .. S - 1, float32."""
    ang = torch.arange(S, dtype=torch.float64)[:, None] * rope_freqs(m, d)
    scale = 1.0
    if yarn(m):
        scale = (mscale(m["rope_factor"], m["yarn_mscale"])
                 / mscale(m["rope_factor"], m["yarn_mscale_all_dim"]))
    return ((torch.cos(ang) * scale).float().to(device)[:, None, :],
            (torch.sin(ang) * scale).float().to(device)[:, None, :])


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """x (S, heads, d): the two halves rotated by each position's angles."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_scale(m: Dict) -> float:
    a = m["mla"]
    scale = (a["qk_nope_head_dim"] + a["qk_rope_head_dim"]) ** -0.5
    if yarn(m):
        scale *= mscale(m["rope_factor"], m["yarn_mscale_all_dim"]) ** 2
    return scale


def causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: float) -> torch.Tensor:
    """Causal softmax attention of q, k (S, H, dq) and v (S, H, dv), the
    queries in blocks of :data:`Q_BLOCK`."""
    S = q.shape[0]
    out = []
    for a in range(0, S, Q_BLOCK):
        b = min(a + Q_BLOCK, S)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        pos = torch.arange(b, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[a:b, None], float("-inf"))
        out.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v[:b]))
        del s
    return torch.cat(out)


def attention(m: Dict, p: Params, pre: str, h: torch.Tensor,
              mm: MatMul) -> torch.Tensor:
    """Multi-head latent attention of one sequence h (S, D), naive form."""
    S, D = h.shape
    a, H, eps = m["mla"], m["n_heads"], m["norm_eps"]
    dn, dr, dv = a["qk_nope_head_dim"], a["qk_rope_head_dim"], a["v_head_dim"]
    R, QR = a["kv_lora_rank"], a.get("q_lora_rank") or 0
    if QR:
        cq = rms_norm(mm(h, p[pre + "w_dq"]), p[pre + "q_norm"], eps)
        q = mm(cq, p[pre + "w_uq"].reshape(QR, H * (dn + dr)))
    else:
        q = mm(h, p[pre + "w_q"].reshape(D, H * (dn + dr)))
    q = q.view(S, H, dn + dr)
    c = rms_norm(mm(h, p[pre + "w_dkv"]), p[pre + "kv_norm"], eps)
    kv = mm(c, p[pre + "w_ukv"].reshape(R, H * (dn + dv))).view(S, H, dn + dv)
    cos, sin = rope_tables(m, S, dr, h.device)
    kr = rope(mm(h, p[pre + "w_kr"])[:, None, :], cos, sin)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cos, sin)], -1)
    k = torch.cat([kv[..., :dn], kr.expand(S, H, dr)], -1)
    o = causal(q, k, kv[..., dn:], softmax_scale(m))
    return mm(o.reshape(S, H * dv), p[pre + "w_o"].reshape(H * dv, D))


def hidden(m: Dict, p: Params, tokens: torch.Tensor,
           mm: MatMul = f32_mm) -> torch.Tensor:
    """The final normed hidden states (S, D) of one sequence of token ids."""
    eps = m["norm_eps"]
    x = p["embed.tok"][tokens].float()
    for i, spec in enumerate(layer_specs(m)):
        if spec.mixer != "mla" or spec.ffn not in ("dense", "moe") \
                or spec.parallel:
            raise ValueError(f"the DeepSeek-V2 reference computes latent "
                             f"attention then a dense or MoE FFN, not {spec}")
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
