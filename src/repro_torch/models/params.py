"""Parameter definitions, initialisation and the bridge from JAX params.

The port names parameters by dotted paths that equal the JAX pytree's leaf
paths with the stacked period unstacked: ``embed.tok``, ``out_norm.scale``
and, per layer, ``layers.<i>.mixer.wq`` and so on. Weights keep JAX's
``(in, out)`` layout, so the bridge is a plain copy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class ParamDef:
    """Shape and initialiser of one parameter (``repro/models/params.py``
    without the sharding axes)."""
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones | embed
    scale: float = 1.0                   # stddev multiplier for normal/embed


def norm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    out = {"scale": ParamDef((cfg.d_model,), init="ones")}
    if cfg.norm == "layernorm":
        out["bias"] = ParamDef((cfg.d_model,), init="zeros")
    return out


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    H, KV, HD, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    out = {"wq": ParamDef((D, H * HD)),
           "wkv": ParamDef((D, 2 * KV * HD)),
           "wo": ParamDef((H * HD, D))}
    if cfg.use_bias or cfg.qkv_bias:
        out["bq"] = ParamDef((H * HD,), init="zeros")
        out["bkv"] = ParamDef((2 * KV * HD,), init="zeros")
    if cfg.use_bias:
        out["bo"] = ParamDef((D,), init="zeros")
    if cfg.qk_norm:
        out["q_norm"] = ParamDef((HD,), init="ones")
        out["k_norm"] = ParamDef((HD,), init="ones")
    return out


def ffn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    width = 2 * cfg.d_ff if cfg.ffn_gated else cfg.d_ff
    out = {"w_in": ParamDef((cfg.d_model, width)),
           "w_out": ParamDef((cfg.d_ff, cfg.d_model))}
    if cfg.use_bias:
        out["b_in"] = ParamDef((width,), init="zeros")
        out["b_out"] = ParamDef((cfg.d_model,), init="zeros")
    return out


def embed_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    V, D = cfg.vocab_size, cfg.d_model
    out = {"tok": ParamDef((V, D), init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDef((V, D), init="embed", scale=0.02)
    if cfg.input_mode == "tokens+vision":
        out["vision_proj"] = ParamDef((D, D))
    if cfg.input_mode == "embeds":
        out["frame_proj"] = ParamDef((D, D))
    return out


def check_spec(spec: LayerSpec) -> None:
    """The port runs dense attention + dense FFN layers only, for now."""
    if spec.mixer != "attn":
        raise NotImplementedError(
            f"mixer '{spec.mixer}' is not ported yet (ROADMAP Queue 1, "
            f"items 13-14: MLA, Mamba, xLSTM)")
    if spec.ffn == "moe":
        raise NotImplementedError(
            "MoE FFN is not ported yet (ROADMAP Queue 1, item 12)")
    if spec.parallel:
        raise NotImplementedError(
            "parallel attention + FFN is not ported yet (ROADMAP Queue 1, "
            "item 14)")


def layer_defs(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Dict[str, ParamDef]]:
    check_spec(spec)
    out = {"mixer_norm": norm_defs(cfg), "mixer": attn_defs(cfg)}
    if spec.ffn != "none":
        out["ffn_norm"] = norm_defs(cfg)
        out["ffn"] = ffn_defs(cfg)
    return out


def model_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """Flat ``{dotted name: ParamDef}`` in the JAX pytree's leaf order."""
    out: Dict[str, ParamDef] = {}
    for group, defs in (("embed", embed_defs(cfg)),
                        ("out_norm", norm_defs(cfg))):
        out.update({f"{group}.{k}": d for k, d in defs.items()})
    for i, spec in enumerate(cfg.layer_specs):
        for sub, defs in layer_defs(cfg, spec).items():
            out.update({f"layers.{i}.{sub}.{k}": d for k, d in defs.items()})
    return out


def _fan_in(d: ParamDef) -> int:
    # last dim is fan-out; everything before it is fan-in
    if len(d.shape) <= 1:
        return max(d.shape[0] if d.shape else 1, 1)
    return max(math.prod(d.shape[:-1]), 1)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Random f32 params with ``repro.models.params.init_one``'s scales.

    The values differ from ``jax.random``'s; the shapes and distributions
    are the same. ``generator`` must live on ``device``.
    """
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, d in model_defs(cfg).items():
        if d.init == "zeros":
            t = torch.zeros(d.shape, device=dev)
        elif d.init == "ones":
            t = torch.ones(d.shape, device=dev)
        else:
            std = d.scale if d.init == "embed" else d.scale / math.sqrt(_fan_in(d))
            t = torch.randn(d.shape, generator=generator, device=dev) * std
        out[name] = t
    return out


def _as_tensor(a: Any) -> torch.Tensor:
    """numpy (bfloat16 included, without ml_dtypes) or torch -> CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags.writeable:        # device_get views are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _as_tensors(tree: Any) -> Any:
    """Every leaf of a pytree of dicts, tuples and lists as a tensor."""
    if isinstance(tree, Mapping):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_as_tensors(v) for v in tree)
    return _as_tensor(tree)


def params_from_jax(cfg: ModelConfig, tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy or torch leaves) -> port state dict.

    ``tree["period"][j][...][i]`` becomes layer ``len(prelayers) +
    i * len(period) + j``. Values are copied bit for bit; dtypes are kept.
    """
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, sub: Mapping, index=None) -> None:
        for k, v in sub.items():
            if isinstance(v, Mapping):
                put(f"{prefix}.{k}", v, index)
            else:
                out[f"{prefix}.{k}"] = v if index is None else v[index]

    tree = _as_tensors(tree)
    put("embed", tree["embed"])
    put("out_norm", tree["out_norm"])
    n_pre = len(cfg.prelayers)
    for i, layer in enumerate(tree.get("prelayers", ())):
        put(f"layers.{i}", layer)
    period = len(cfg.period)
    for j, layer in enumerate(tree["period"]):
        for i in range(cfg.n_periods):
            put(f"layers.{n_pre + i * period + j}", layer, i)
    expected = model_defs(cfg)
    if set(out) != set(expected):
        raise ValueError(
            f"JAX params do not match {cfg.name}: missing "
            f"{sorted(set(expected) - set(out))}, unexpected "
            f"{sorted(set(out) - set(expected))}")
    for name, d in expected.items():
        if tuple(out[name].shape) != d.shape:
            raise ValueError(f"{name}: shape {tuple(out[name].shape)} != "
                             f"{d.shape}")
    return {name: out[name] for name in expected}
