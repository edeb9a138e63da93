"""Model assembly: ``Block``, ``Transformer``, train/prefill/decode.

Port of ``repro/models/transformer.py`` for dense attention + dense FFN
layers. The JAX stack scans over period parameters stacked on a leading
axis; here every layer is its own :class:`Block` in an ``nn.ModuleList``.
The mixer norms and ``out_norm`` go through the rmsnorm kernel, and the
residual add before each FFN norm goes through the fused
rmsnorm_residual kernel (the sum is rounded to the activation dtype first,
so the fused path equals the unfused reference).

For training, ``Transformer(..., trainable=True)`` holds f32 master
parameters that need gradients (matrices are cast to ``cfg.dtype`` at each
use, as for serving), and ``train_logits(..., remat="full")``, the JAX
default, runs each :class:`Block` under ``torch.utils.checkpoint``: its
activations are recomputed in the backward, so every forward kernel runs
twice per step. The kernels' backward passes come from their autograd
functions (``kernels/flash_attention.py``, ``kernels/rmsnorm.py``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.rmsnorm import rmsnorm_residual
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.params import check_spec, model_defs

Cache = Dict[str, torch.Tensor]


REMAT = ("full", "none")


def _param_dict(params: Mapping[str, torch.Tensor], prefix: str,
                device: torch.device, trainable: bool = False
                ) -> nn.ParameterDict:
    """The leaves ``<prefix>.<name>`` as a ParameterDict keyed by name. The
    parameters share storage with ``params`` where those already lie on
    ``device``, so an in-place update of ``params`` is seen here."""
    n = len(prefix) + 1
    return nn.ParameterDict({
        k[n:]: nn.Parameter(v.detach().to(device), requires_grad=trainable)
        for k, v in params.items()
        if k.startswith(prefix + ".") and "." not in k[n:]})


class Block(nn.Module):
    """One dense layer: mixer norm, attention, FFN norm, FFN."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 params: Mapping[str, torch.Tensor], prefix: str,
                 device: torch.device, trainable: bool = False):
        super().__init__()
        check_spec(spec)
        self.cfg, self.spec = cfg, spec
        for sub in ("mixer_norm", "mixer", "ffn_norm", "ffn"):
            pd = _param_dict(params, f"{prefix}.{sub}", device, trainable)
            if len(pd):
                setattr(self, sub, pd)

    def _ffn(self, x: torch.Tensor, y_mix: torch.Tensor) -> torch.Tensor:
        """x + y_mix, then the FFN on its norm, added back."""
        cfg = self.cfg
        if self.spec.ffn == "none":
            return x + y_mix
        if cfg.norm == "rmsnorm":
            h, x = rmsnorm_residual(x, y_mix, self.ffn_norm["scale"],
                                    cfg.norm_eps)
        else:
            x = x + y_mix
            h = L.apply_norm(cfg, self.ffn_norm, x)
        return x + L.apply_ffn(cfg, self.ffn, h)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                lengths: Optional[torch.Tensor], want_cache: bool
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """One layer over a whole sequence. Returns (x, cache or None)."""
        h = L.apply_norm(self.cfg, self.mixer_norm, x)
        y_mix, (k, v) = A.self_attention(self.cfg, self.mixer, h, positions,
                                         lengths=lengths)
        cache = None
        if want_cache:
            cache = {"k": k.to(torch.bfloat16).contiguous(),
                     "v": v.to(torch.bfloat16).contiguous()}
        return self._ffn(x, y_mix), cache

    def decode(self, x: torch.Tensor, cache: Cache, lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache]:
        """One layer, one decode token. Updates ``cache`` in place."""
        h = L.apply_norm(self.cfg, self.mixer_norm, x)
        y_mix, cache = A.decode_self_attention(self.cfg, self.mixer, h, cache,
                                               lengths)
        return self._ffn(x, y_mix), cache


class Transformer(nn.Module):
    """The model, holding ``params`` (a state dict named as
    :func:`~repro_torch.models.params.model_defs`) on ``device``; with
    ``trainable`` the parameters need gradients (serving builds them
    without)."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                 *, device: DeviceLike = "cuda", trainable: bool = False):
        super().__init__()
        dev = resolve_device(device)
        expected = set(model_defs(cfg))
        if set(params) != expected:
            raise ValueError(
                f"params do not match {cfg.name}: missing "
                f"{sorted(expected - set(params))}, unexpected "
                f"{sorted(set(params) - expected)}")
        self.cfg = cfg
        self.embed = _param_dict(params, "embed", dev, trainable)
        self.out_norm = _param_dict(params, "out_norm", dev, trainable)
        self.layers = nn.ModuleList(
            Block(cfg, spec, params, f"layers.{i}", dev, trainable)
            for i, spec in enumerate(cfg.layer_specs))

    def forward(self, batch: Mapping[str, torch.Tensor], *,
                lengths: Optional[torch.Tensor] = None,
                want_cache: bool = False, remat: str = "none"
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Full-sequence forward. Returns (hidden (B,S,D), caches or None).
        ``remat="full"`` checkpoints each block when a graph is being
        built (``torch.utils.checkpoint``, non-reentrant)."""
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        cfg = self.cfg
        extra = batch.get("vision_embeds", batch.get("frame_embeds"))
        x = L.embed_tokens(cfg, self.embed, batch.get("tokens"), extra)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        remat = remat == "full" and torch.is_grad_enabled() and not want_cache
        caches: List[Optional[Cache]] = []
        for block in self.layers:
            if remat:
                x = checkpoint(lambda x, block=block: block(
                    x, positions, lengths, False)[0], x, use_reentrant=False)
                c = None
            else:
                x, c = block(x, positions, lengths, want_cache)
            caches.append(c)
        x = L.apply_norm(cfg, self.out_norm, x)
        return x, ({"layers": caches} if want_cache else None)


def cast_for_compute(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                     device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """``params`` on ``device`` with every matrix in ``cfg.dtype``; vectors
    (norm scales, biases) keep their dtype. Every use site casts matrices to
    ``cfg.dtype`` first, so a model on these params computes the same."""
    dev = resolve_device(device)
    dt = L.dtype_of(cfg.dtype)
    return {k: v.to(dev, dt if v.dim() >= 2 else v.dtype)
            for k, v in params.items()}


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = "cuda") -> Dict:
    """bf16 K/V caches (B, s_max, KV, HD) per layer, and zero lengths."""
    dev = resolve_device(device)
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    for spec in cfg.layer_specs:
        check_spec(spec)
    return {"layers": [{"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                        "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}
                       for _ in cfg.layer_specs],
            "lengths": torch.zeros(batch, dtype=torch.int32, device=dev)}


def train_logits(model: Transformer, batch: Mapping[str, torch.Tensor], *,
                 remat: str = "full") -> torch.Tensor:
    """f32 logits (B, S, V) of a full-sequence forward; differentiable when
    the model is trainable. ``remat`` as JAX's ``RunFlags.remat``."""
    x, _ = model(batch, remat=remat)
    return L.unembed(model.cfg, model.embed, x)


def prefill(model: Transformer, batch: Mapping[str, torch.Tensor],
            lengths: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Prompt ingestion. lengths: (B,) int32. Returns (logits at position
    lengths - 1 (B, V), cache)."""
    x, caches = model(batch, lengths=lengths, want_cache=True)
    B, S = x.shape[:2]
    idx = torch.clamp(lengths - 1, 0, S - 1).long()
    last = x[torch.arange(B, device=x.device), idx]
    caches["lengths"] = lengths
    return L.unembed(model.cfg, model.embed, last), caches


def decode_step(model: Transformer, cache: Dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """One token for every sequence. tokens: (B,) or (B, 1) (or (B, 1, D)
    frame embeds for input_mode=embeds). The K/V caches are updated in place;
    returns (logits (B, V), cache with lengths + 1)."""
    cfg = model.cfg
    dt = L.dtype_of(cfg.dtype)
    lengths = cache["lengths"]
    if cfg.input_mode == "embeds":
        x = tokens.to(dt) @ model.embed["frame_proj"].to(dt)
    else:
        tok = tokens if tokens.dim() == 2 else tokens[:, None]
        x = model.embed["tok"][tok].to(dt)
        x = x * L.embed_scale(cfg)
    if cfg.pos_emb == "sincos":
        x = x + L.sincos_pos_emb(lengths[:, None], cfg.d_model).to(dt)
    new_layers = []
    for block, c in zip(model.layers, cache["layers"]):
        x, c = block.decode(x, c, lengths)
        new_layers.append(c)
    x = L.apply_norm(cfg, model.out_norm, x)
    logits = L.unembed(cfg, model.embed, x[:, 0])
    return logits, {"layers": new_layers, "lengths": lengths + 1}
