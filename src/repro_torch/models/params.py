"""Parameter definitions, initialisation and the bridges to and from JAX's
tree layout.

The port names parameters by dotted paths that equal the JAX pytree's leaf
paths with the stacked period unstacked: ``embed.tok``, ``out_norm.scale``
and, per layer, ``layers.<i>.mixer.wq`` and so on. Weights keep JAX's
``(in, out)`` layout, so each bridge is a plain copy: ``params_from_jax``
unstacks, ``params_to_jax`` stacks again, and ``state_to_jax`` /
``state_from_jax`` carry a whole train state, which is how checkpoints are
written (a torch-saved state restores into JAX).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig
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


def ffn_defs(cfg: ModelConfig, d_ff: Optional[int] = None
             ) -> Dict[str, ParamDef]:
    d_ff = d_ff or cfg.d_ff
    width = 2 * d_ff if cfg.ffn_gated else d_ff
    out = {"w_in": ParamDef((cfg.d_model, width)),
           "w_out": ParamDef((d_ff, cfg.d_model))}
    if cfg.use_bias:
        out["b_in"] = ParamDef((width,), init="zeros")
        out["b_out"] = ParamDef((cfg.d_model,), init="zeros")
    return out


def padded_experts(moe: MoEConfig) -> int:
    """Routed experts after padding (``pad_to``); the padded ones are never
    routed to (their logits are -1e30)."""
    return max(moe.pad_to, moe.n_experts)


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The router (f32 in every compute copy), the routed experts' stacked
    SwiGLU weights and the shared block (``repro/models/moe.py``)."""
    moe = cfg.moe
    E, D, F = padded_experts(moe), cfg.d_model, moe.d_ff_expert
    out = {"router": ParamDef((D, E), scale=1.0),
           "w_in": ParamDef((E, D, 2 * F)),
           "w_out": ParamDef((E, F, D))}
    if moe.n_shared:
        out.update({f"shared_{k}": d for k, d in
                    ffn_defs(cfg, d_ff=moe.d_ff_shared).items()})
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


def mla_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """Multi-head latent attention (``repro/models/mla.py``): the shared
    down-projections to the KV latent and the rope key, the latent's
    up-projection to every head's no-rope key and value, the output
    projection, and the query's low-rank pair (or one ``w_q`` without
    ``q_lora_rank``)."""
    m = cfg.mla
    H, D = cfg.n_heads, cfg.d_model
    dn, dr, dv, R, QR = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                         m.v_head_dim, m.kv_lora_rank, m.q_lora_rank)
    out = {"w_dkv": ParamDef((D, R)),
           "w_kr": ParamDef((D, dr)),
           "w_ukv": ParamDef((R, H, dn + dv)),
           "kv_norm": ParamDef((R,), init="ones"),
           "w_o": ParamDef((H, dv, D))}
    if QR:
        out["w_dq"] = ParamDef((D, QR))
        out["q_norm"] = ParamDef((QR,), init="ones")
        out["w_uq"] = ParamDef((QR, H, dn + dr))
    else:
        out["w_q"] = ParamDef((D, H, dn + dr))
    return out


MIXER_DEFS = {"attn": attn_defs, "mla": mla_defs}


def check_spec(spec: LayerSpec) -> None:
    """The port runs attention and MLA layers, with a dense, MoE or no FFN,
    in sequence or in parallel; the recurrent mixers wait."""
    if spec.mixer not in MIXER_DEFS:
        raise NotImplementedError(
            f"mixer '{spec.mixer}' is not ported yet (ROADMAP Queue 1, "
            f"item 14: Mamba, xLSTM)")


def layer_defs(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Dict[str, ParamDef]]:
    check_spec(spec)
    out = {"mixer_norm": norm_defs(cfg), "mixer": MIXER_DEFS[spec.mixer](cfg)}
    if spec.ffn != "none":
        if not spec.parallel:          # a parallel block shares one norm
            out["ffn_norm"] = norm_defs(cfg)
        out["ffn"] = moe_defs(cfg) if spec.ffn == "moe" else ffn_defs(cfg)
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
    # last dim is fan-out; everything before it is fan-in (the reference's
    # rule less its stacked "layers" axis, which the port does not have:
    # w_ukv (R, H, dn + dv) takes R H)
    if len(d.shape) <= 1:
        return max(d.shape[0] if d.shape else 1, 1)
    return max(math.prod(d.shape[:-1]), 1)


# a leaf of more elements is drawn in slices along its first axis, one
# after the other from the generator, each scaled and cast into the leaf
# before the next: a draw holds one slice in f32 beside the leaf (a
# deepseek-v2 expert stack is 2.5e9 elements, 10 GB in f32)
DRAW_SLICE = 1 << 27


def _draw(cfg: ModelConfig, generator: torch.Generator, dev: torch.device,
          cast: bool = False) -> Iterator[Tuple[str, torch.Tensor]]:
    """Each leaf in turn, drawn in f32 from ``generator``, in f32 or with
    ``cast`` in its :func:`compute_dtype`."""
    for name, d in model_defs(cfg).items():
        if d.init in ("zeros", "ones"):
            t = torch.full(d.shape, float(d.init == "ones"), device=dev)
            yield name, t.to(compute_dtype(cfg, name, t)) if cast else t
            continue
        std = d.scale if d.init == "embed" else d.scale / math.sqrt(_fan_in(d))
        rows = max(1, DRAW_SLICE // max(math.prod(d.shape[1:]), 1))
        out = None
        for i in range(0, d.shape[0], rows):
            part = torch.randn((min(rows, d.shape[0] - i),) + d.shape[1:],
                               generator=generator, device=dev).mul_(std)
            if rows >= d.shape[0]:                  # one slice: the leaf
                out = part.to(compute_dtype(cfg, name, part)) if cast else part
                break
            if out is None:
                out = torch.empty(d.shape, device=dev, dtype=compute_dtype(
                    cfg, name, part) if cast else part.dtype)
            out[i:i + len(part)] = part
        yield name, out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Random f32 params with ``repro.models.params.init_one``'s scales.

    The values differ from ``jax.random``'s; the shapes and distributions
    are the same. ``generator`` must live on ``device``.
    """
    return dict(_draw(cfg, generator, resolve_device(device)))


# leaves that keep f32 in the compute copy: the MoE router, as the
# reference's early cast leaves it (``_PRECAST_EXCLUDE``,
# repro/models/transformer.py), since top-k on bf16 logits can pick other
# experts than on f32 ones
KEEP_F32 = ("router",)


def compute_dtype(cfg: ModelConfig, name: str, t: torch.Tensor
                  ) -> torch.dtype:
    """The dtype leaf ``name`` takes in the compute copy: ``cfg.dtype`` for a
    matrix, its own for a vector (norm scales, biases) and the router."""
    if t.dim() >= 2 and name.rsplit(".", 1)[-1] not in KEEP_F32:
        return getattr(torch, cfg.dtype)
    return t.dtype


def init_serving_params(cfg: ModelConfig, generator: torch.Generator,
                        device: DeviceLike = "cuda"
                        ) -> Dict[str, torch.Tensor]:
    """The compute copy of :func:`init_params`'s draw, equal to
    ``cast_for_compute(cfg, init_params(cfg, generator, device))`` from a
    generator in the same state, but each leaf cast as soon as it is
    drawn: the f32 model is never held whole (qwen2-moe-a2.7b's is 60.6 GB,
    its bf16 copy 30.3 GB)."""
    return dict(_draw(cfg, generator, resolve_device(device), cast=True))


def _as_tensor(a: Any) -> torch.Tensor:
    """numpy (bfloat16 included, without ml_dtypes) or torch -> CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    # device_get views are read-only; copy(order="C") keeps a 0-d leaf 0-d
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = a.copy(order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


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


def params_to_jax(cfg: ModelConfig, params: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Any]:
    """Port state dict -> JAX params pytree; the inverse of
    :func:`params_from_jax`.

    Layer ``len(prelayers) + i * len(period) + j`` becomes
    ``tree["period"][j][...][i]`` (stacked along a new axis 0), the
    prelayers a tuple of dicts, and every dict has its keys in sorted order,
    as ``jax.tree`` rebuilds them, so the checkpoint skeleton equals one
    JAX writes. Stacked leaves are new tensors on the params' device; the
    others are the given tensors.
    """
    expected = model_defs(cfg)
    if set(params) != set(expected):
        raise ValueError(
            f"params do not match {cfg.name}: missing "
            f"{sorted(set(expected) - set(params))}, unexpected "
            f"{sorted(set(params) - set(expected))}")

    def nest(prefix: str, stack: Optional[list] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name in expected:
            if not name.startswith(prefix + "."):
                continue
            node = out
            *path, leaf = name[len(prefix) + 1:].split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = (params[name] if stack is None else torch.stack(
                [params[f"{p}.{name[len(prefix) + 1:]}"] for p in stack]))
        return _sorted(out)

    n_pre, period = len(cfg.prelayers), len(cfg.period)
    tree = {"embed": nest("embed"), "out_norm": nest("out_norm"),
            "prelayers": tuple(nest(f"layers.{i}") for i in range(n_pre)),
            "period": tuple(
                nest(f"layers.{n_pre + j}",
                     [f"layers.{n_pre + i * period + j}"
                      for i in range(cfg.n_periods)])
                for j in range(period))}
    return _sorted(tree)


def _sorted(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def state_to_jax(cfg: ModelConfig, state: Mapping) -> Dict[str, Any]:
    """The port's train state ``{"params", "opt": {"m", "v", "step"}}`` in
    JAX's layout, as a JAX train step returns it: params, m and v through
    :func:`params_to_jax`, ``step`` the int32 scalar as it is, every dict's
    keys sorted."""
    opt = state["opt"]
    return {"opt": {"m": params_to_jax(cfg, opt["m"]),
                    "step": opt["step"],
                    "v": params_to_jax(cfg, opt["v"])},
            "params": params_to_jax(cfg, state["params"])}


def state_from_jax(cfg: ModelConfig, tree: Mapping,
                   device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A train state in JAX's layout (numpy or torch leaves, e.g. a restored
    checkpoint) -> the port's train state on ``device``. Every leaf is a
    tensor of its own (no view into a stacked leaf); dtypes are kept and
    ``step`` is an int32 scalar."""
    dev = resolve_device(device)

    def own(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.to(dev, copy=True) for k, v in flat.items()}

    opt = tree["opt"]
    step = _as_tensor(opt["step"])
    if step.dim() != 0 or step.dtype != torch.int32:
        raise ValueError(f"opt.step must be an int32 scalar, got "
                         f"{step.dtype} of shape {tuple(step.shape)}")
    return {"params": own(params_from_jax(cfg, tree["params"])),
            "opt": {"m": own(params_from_jax(cfg, opt["m"])),
                    "v": own(params_from_jax(cfg, opt["v"])),
                    "step": step.to(dev, copy=True)}}
