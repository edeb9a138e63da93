"""Model assembly: ``Block``, ``Transformer``, train/prefill/decode.

Port of ``repro/models/transformer.py`` for attention and MLA layers with a
dense, MoE or no FFN, in sequence or in parallel (Cohere-style: attention
and FFN on one norm, both added to the residual). An attention layer caches
K/V, an MLA layer its latent and rope key (``models/mla.py``). The JAX
stack scans over period parameters stacked on a leading axis; here every
layer is its own :class:`Block` in an ``nn.ModuleList``. The RMSNorm mixer
norms and ``out_norm`` go through the rmsnorm kernel, and the residual add
before each FFN norm goes through the fused rmsnorm_residual kernel (the
sum is rounded to the activation dtype first, so the fused path equals the
unfused reference). A full-sequence forward also returns the MoE layers'
aux losses summed over layers under ``AUX_KEYS`` (None without a MoE
layer), as the reference's ``_add_aux`` does.

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
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.params import check_spec, compute_dtype, model_defs

Cache = Dict[str, torch.Tensor]
Aux = Dict[str, torch.Tensor]

AUX_KEYS = ("moe_load_balance", "moe_router_z")


REMAT = ("full", "none")

# per mixer: its sequence pass, its decode step, and the cache entries the
# sequence pass returns, in order
MIXERS = {"attn": (A.self_attention, A.decode_self_attention, ("k", "v")),
          "mla": (MLA.mla_self_attention, MLA.mla_decode_attention,
                  ("ckv", "kr"))}


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
    """One layer: mixer norm, attention or MLA (``spec.mixer``), then a
    dense or MoE FFN on its own norm after the residual add, or
    (``spec.parallel``) on the mixer norm's output beside the mixer."""

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

    def _apply_ffn(self, h: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[Aux]]:
        if self.spec.ffn == "moe":
            return MOE.moe_apply(self.cfg, self.ffn, h)
        return L.apply_ffn(self.cfg, self.ffn, h), None

    def _ffn(self, x: torch.Tensor, h: torch.Tensor, y_mix: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[Aux]]:
        """The residual adds and the FFN after the mixer, whose input was
        ``h`` and output ``y_mix``. Returns (x, the MoE aux or None)."""
        cfg = self.cfg
        if self.spec.ffn == "none":
            return x + y_mix, None
        if self.spec.parallel:
            y_ffn, aux = self._apply_ffn(h)
            return x + y_mix + y_ffn, aux
        if cfg.norm == "rmsnorm":
            h, x = rmsnorm_residual(x, y_mix, self.ffn_norm["scale"],
                                    cfg.norm_eps)
        else:
            x = x + y_mix
            h = L.apply_norm(cfg, self.ffn_norm, x)
        y_ffn, aux = self._apply_ffn(h)
        return x + y_ffn, aux

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                lengths: Optional[torch.Tensor], want_cache: bool
                ) -> Tuple[torch.Tensor, Optional[Cache], Optional[Aux]]:
        """One layer over a whole sequence. Returns (x, cache or None, the
        MoE aux or None)."""
        h = L.apply_norm(self.cfg, self.mixer_norm, x)
        seq, _, keys = MIXERS[self.spec.mixer]
        y_mix, kv = seq(self.cfg, self.mixer, h, positions, lengths=lengths)
        cache = None
        if want_cache:
            cache = {name: t.to(torch.bfloat16).contiguous()
                     for name, t in zip(keys, kv)}
        x, aux = self._ffn(x, h, y_mix)
        return x, cache, aux

    def decode(self, x: torch.Tensor, cache: Cache, lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache]:
        """One layer, one decode token. Updates ``cache`` in place."""
        h = L.apply_norm(self.cfg, self.mixer_norm, x)
        decode = MIXERS[self.spec.mixer][1]
        y_mix, cache = decode(self.cfg, self.mixer, h, cache, lengths)
        return self._ffn(x, h, y_mix)[0], cache


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
                ) -> Tuple[torch.Tensor, Optional[Dict], Optional[Aux]]:
        """Full-sequence forward. Returns (hidden (B,S,D), caches or None,
        the aux losses summed over the MoE layers or None without one).
        ``remat="full"`` checkpoints
        each block when a graph is being built (``torch.utils.checkpoint``,
        non-reentrant)."""
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        cfg = self.cfg
        extra = batch.get("vision_embeds", batch.get("frame_embeds"))
        x = L.embed_tokens(cfg, self.embed, batch.get("tokens"), extra)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        remat = remat == "full" and torch.is_grad_enabled() and not want_cache
        caches: List[Optional[Cache]] = []
        aux: Optional[Aux] = None
        for block in self.layers:
            if remat:
                x, a = checkpoint(lambda x, block=block: block(
                    x, positions, lengths, False)[::2], x, use_reentrant=False)
                c = None
            else:
                x, c, a = block(x, positions, lengths, want_cache)
            caches.append(c)
            if a is not None:
                aux = a if aux is None else {k: aux[k] + a[k]
                                             for k in AUX_KEYS}
        x = L.apply_norm(cfg, self.out_norm, x)
        return x, ({"layers": caches} if want_cache else None), aux


def cast_for_compute(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                     device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """``params`` on ``device`` with every matrix in ``cfg.dtype`` but the
    MoE router; vectors (norm scales, biases) keep their dtype
    (``params.compute_dtype``). Every use site casts matrices to
    ``cfg.dtype`` first and the router to f32, so a model on these params
    computes the same."""
    dev = resolve_device(device)
    return {k: v.to(dev, compute_dtype(cfg, k, v)) for k, v in params.items()}


def layer_cache_shapes(cfg: ModelConfig, spec: LayerSpec, batch: int,
                       s_max: int) -> Dict[str, Tuple[int, ...]]:
    """One layer's cache entries and shapes (``repro`` ``layer_cache``):
    K/V (B, s_max, KV, HD) for attention, the latent (B, s_max, R) and the
    rope key (B, s_max, dr) for MLA."""
    check_spec(spec)
    if spec.mixer == "mla":
        m = cfg.mla
        shapes = ((batch, s_max, m.kv_lora_rank),
                  (batch, s_max, m.qk_rope_head_dim))
    else:
        shapes = ((batch, s_max, cfg.n_kv_heads, cfg.head_dim),) * 2
    return dict(zip(MIXERS[spec.mixer][2], shapes))


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = "cuda") -> Dict:
    """bf16 caches per layer (:func:`layer_cache_shapes`), and zero
    lengths."""
    dev = resolve_device(device)
    layers = [{k: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
               for k, shape in layer_cache_shapes(cfg, spec, batch,
                                                  s_max).items()}
              for spec in cfg.layer_specs]
    return {"layers": layers,
            "lengths": torch.zeros(batch, dtype=torch.int32, device=dev)}


def train_logits(model: Transformer, batch: Mapping[str, torch.Tensor], *,
                 remat: str = "full") -> Tuple[torch.Tensor, Optional[Aux]]:
    """f32 logits (B, S, V) of a full-sequence forward and the aux losses
    under ``AUX_KEYS`` (None without a MoE layer); differentiable when the
    model is trainable.
    ``remat`` as JAX's ``RunFlags.remat``."""
    x, _, aux = model(batch, remat=remat)
    return L.unembed(model.cfg, model.embed, x), aux


def prefill(model: Transformer, batch: Mapping[str, torch.Tensor],
            lengths: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Prompt ingestion. lengths: (B,) int32. Returns (logits at position
    lengths - 1 (B, V), cache)."""
    x, caches, _ = model(batch, lengths=lengths, want_cache=True)
    B, S = x.shape[:2]
    idx = torch.clamp(lengths - 1, 0, S - 1).long()
    last = x[torch.arange(B, device=x.device), idx]
    caches["lengths"] = lengths
    return L.unembed(model.cfg, model.embed, last), caches


def decode_step(model: Transformer, cache: Dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """One token for every sequence. tokens: (B,) or (B, 1) (or (B, 1, D)
    frame embeds for input_mode=embeds). The caches are updated in place;
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
