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
from typing import (Any, Dict, FrozenSet, Iterable, Iterator, Mapping,
                    Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import (Spec, block_range, block_slices,
                                           entry_axes, local_shard, spec_axes)


@dataclass(frozen=True)
class ParamDef:
    """Shape, logical axes and initialiser of one parameter
    (``repro/models/params.py``; the dtype is f32 throughout)."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis per dim (None: replicated)
    init: str = "normal"                 # normal | zeros | ones | ssm_a | embed
    scale: float = 1.0                   # stddev multiplier for normal/embed

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def norm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    out = {"scale": ParamDef((cfg.d_model,), ("norm",), init="ones")}
    if cfg.norm == "layernorm":
        out["bias"] = ParamDef((cfg.d_model,), ("norm",), init="zeros")
    return out


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    H, KV, HD, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    out = {"wq": ParamDef((D, H * HD), ("embed", "heads")),
           "wkv": ParamDef((D, 2 * KV * HD), ("embed", "kv_heads")),
           "wo": ParamDef((H * HD, D), ("heads", "embed"))}
    if cfg.use_bias or cfg.qkv_bias:
        out["bq"] = ParamDef((H * HD,), ("heads",), init="zeros")
        out["bkv"] = ParamDef((2 * KV * HD,), ("kv_heads",), init="zeros")
    if cfg.use_bias:
        out["bo"] = ParamDef((D,), ("embed_nofsdp",), init="zeros")
    if cfg.qk_norm:
        out["q_norm"] = ParamDef((HD,), ("head_dim",), init="ones")
        out["k_norm"] = ParamDef((HD,), ("head_dim",), init="ones")
    return out


def ffn_defs(cfg: ModelConfig, d_ff: Optional[int] = None
             ) -> Dict[str, ParamDef]:
    d_ff = d_ff or cfg.d_ff
    width = 2 * d_ff if cfg.ffn_gated else d_ff
    out = {"w_in": ParamDef((cfg.d_model, width), ("embed", "mlp")),
           "w_out": ParamDef((d_ff, cfg.d_model), ("mlp", "embed"))}
    if cfg.use_bias:
        out["b_in"] = ParamDef((width,), ("mlp",), init="zeros")
        out["b_out"] = ParamDef((cfg.d_model,), ("embed_nofsdp",),
                                init="zeros")
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
    out = {"router": ParamDef((D, E), (None, "experts"), scale=1.0),
           "w_in": ParamDef((E, D, 2 * F), ("experts", "embed", "mlp")),
           "w_out": ParamDef((E, F, D), ("experts", "mlp", "embed"))}
    if moe.n_shared:
        out.update({f"shared_{k}": d for k, d in
                    ffn_defs(cfg, d_ff=moe.d_ff_shared).items()})
    return out


def embed_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    V, D = cfg.vocab_size, cfg.d_model
    out = {"tok": ParamDef((V, D), ("vocab", "embed_nofsdp"), init="embed",
                           scale=0.02)}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDef((V, D), ("vocab", "embed_nofsdp"),
                                  init="embed", scale=0.02)
    if cfg.input_mode == "tokens+vision":
        out["vision_proj"] = ParamDef((D, D), ("embed", None))
    if cfg.input_mode == "embeds":
        out["frame_proj"] = ParamDef((D, D), ("embed", None))
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
    out = {"w_dkv": ParamDef((D, R), ("embed", "lora")),
           "w_kr": ParamDef((D, dr), ("embed", None)),
           "w_ukv": ParamDef((R, H, dn + dv), ("lora", "heads", None)),
           "kv_norm": ParamDef((R,), ("norm",), init="ones"),
           "w_o": ParamDef((H, dv, D), ("heads", None, "embed"))}
    if QR:
        out["w_dq"] = ParamDef((D, QR), ("embed", "lora"))
        out["q_norm"] = ParamDef((QR,), ("norm",), init="ones")
        out["w_uq"] = ParamDef((QR, H, dn + dr), ("lora", "heads", None))
    else:
        out["w_q"] = ParamDef((D, H, dn + dr), ("embed", "heads", None))
    return out


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, d_state, d_conv, dt_rank) of a Mamba layer."""
    m = cfg.mamba
    return (m.expand * cfg.d_model, m.d_state, m.d_conv,
            m.resolved_dt_rank(cfg.d_model))


def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The S6 mixer (``repro/models/mamba.py``): the in-projection to u and
    the gate z, the depthwise causal conv, the x-projection to dt's low
    rank, B and C, dt's up-projection, A as log(-A) and the skip."""
    D = cfg.d_model
    di, ds, dc, dtr = mamba_dims(cfg)
    return {"w_in": ParamDef((D, 2 * di), ("embed", "dinner")),
            "conv_w": ParamDef((di, dc), ("dinner", "conv"), scale=1.0),
            "conv_b": ParamDef((di,), ("dinner",), init="zeros"),
            "x_proj": ParamDef((di, dtr + 2 * ds), ("dinner", None)),
            "dt_w": ParamDef((dtr, di), ("lora", "dinner")),
            "dt_b": ParamDef((di,), ("dinner",), init="ones", scale=1.0),
            "a_log": ParamDef((di, ds), ("dinner", "state"), init="ssm_a"),
            "d_skip": ParamDef((di,), ("dinner",), init="ones"),
            "w_out": ParamDef((di, D), ("dinner", "embed"))}


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, head dim) of an mLSTM layer."""
    x = cfg.xlstm
    di = x.expand * cfg.d_model
    return di, x.n_heads, di // x.n_heads


def slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(heads, head dim) of an sLSTM layer."""
    return cfg.xlstm.n_heads, cfg.d_model // cfg.xlstm.n_heads


def mlstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The matrix-memory mixer (``repro/models/xlstm.py``). ``b_f`` is
    ones: a ones leaf ignores its scale, as in the reference."""
    D = cfg.d_model
    di, nh, _ = mlstm_dims(cfg)
    dc = cfg.xlstm.conv_width
    return {"w_up": ParamDef((D, 2 * di), ("embed", "dinner")),
            "conv_w": ParamDef((di, dc), ("dinner", "conv"), scale=1.0),
            "conv_b": ParamDef((di,), ("dinner",), init="zeros"),
            "wq": ParamDef((di, di), ("dinner", None)),
            "wk": ParamDef((di, di), ("dinner", None)),
            "wv": ParamDef((di, di), ("dinner", None)),
            "w_i": ParamDef((di, nh), ("dinner", None), scale=0.1),
            "b_i": ParamDef((nh,), (None,), init="zeros"),
            "w_f": ParamDef((di, nh), ("dinner", None), scale=0.1),
            "b_f": ParamDef((nh,), (None,), init="ones", scale=3.0),
            "w_down": ParamDef((di, D), ("dinner", "embed")),
            "skip_scale": ParamDef((di,), ("dinner",), init="ones")}


def slstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The scalar-memory mixer: per gate an input matrix, a block-diagonal
    recurrent matrix per head and a bias (``b_f`` ones), then ``w_out``."""
    D = cfg.d_model
    nh, dh = slstm_dims(cfg)
    out = {"w_out": ParamDef((D, D), ("embed", None))}
    for g in ("z", "i", "f", "o"):
        out[f"w_{g}"] = ParamDef((D, D), ("embed", "dinner"))
        out[f"r_{g}"] = ParamDef((nh, dh, dh), (None, "dinner", None),
                                 scale=0.5)
        out[f"b_{g}"] = ParamDef((D,), ("dinner",),
                                 init="ones" if g == "f" else "zeros",
                                 scale=2.0)
    return out


MIXER_DEFS = {"attn": attn_defs, "mla": mla_defs, "mamba": mamba_defs,
              "mlstm": mlstm_defs, "slstm": slstm_defs}


def check_spec(spec: LayerSpec) -> None:
    """The port runs every mixer of the reference (attention, MLA, Mamba,
    mLSTM, sLSTM), with a dense, MoE or no FFN, in sequence or in
    parallel."""
    if spec.mixer not in MIXER_DEFS:
        raise ValueError(f"unknown mixer '{spec.mixer}'; the mixers are "
                         f"{sorted(MIXER_DEFS)}")


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


# ---------------------------------------------------------------------------
# Sharding rules: logical axis -> mesh axis (or tuple of mesh axes)
# ---------------------------------------------------------------------------

AxisName = Union[str, Tuple[str, ...], None]

# for the ("pod", "data", "model") mesh: FSDP (ZeRO-3) over data on the
# embed dim of weight matrices, Megatron TP over model on heads / FFN hidden
# / experts / vocab; the reference's stacked "layers" axis is never sharded
DEFAULT_RULES: Dict[str, AxisName] = {
    "layers": None,
    "vocab": "model",
    "embed": "data",            # FSDP shard of the d_model dim of matrices
    "embed_nofsdp": None,
    "heads": "model",
    "kv_heads": "model",        # falls back to replicated when not divisible
    "head_dim": None,
    "mlp": "model",
    "experts": "model",         # EP
    "dinner": "model",          # mamba / xlstm inner dim
    "state": None,
    "lora": None,
    "conv": None,
    "norm": None,
}

# FSDP over the pod axis too (ZeRO across pods)
POD_FSDP_RULES = dict(DEFAULT_RULES, embed=("pod", "data"))


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: Mapping[str, AxisName], shape: Sequence[int],
                    mesh_axis_sizes: Mapping[str, int]) -> Spec:
    """Logical axes -> a spec, each dimension left whole where its mesh axes
    are absent, used by an earlier dimension, or do not divide it."""
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        mesh_axis = None if name is None else rules.get(name)
        if mesh_axis is None:
            out.append(None)
            continue
        parts = (mesh_axis,) if isinstance(mesh_axis, str) else tuple(mesh_axis)
        parts = tuple(p for p in parts
                      if p in mesh_axis_sizes and p not in used)
        total = math.prod(mesh_axis_sizes[p] for p in parts) if parts else 1
        if not parts or dim % total != 0:
            out.append(None)
            continue
        used.update(parts)
        out.append(parts[0] if len(parts) == 1 else parts)
    return tuple(out)


def param_specs(defs: Mapping[str, ParamDef], mesh,
                rules: Optional[Mapping[str, AxisName]] = None
                ) -> Dict[str, Spec]:
    """``{name: spec}`` for a flat ``{name: ParamDef}`` on ``mesh`` (anything
    with ``axis_names`` and ``axis_sizes``)."""
    rules = DEFAULT_RULES if rules is None else rules
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    return {k: logical_to_spec(d.axes, rules, d.shape, sizes)
            for k, d in defs.items()}


def serving_plan(cfg: ModelConfig, mesh, ep_axis: str = "model"
                 ) -> Dict[str, Spec]:
    """The layout a rank holds to serve with ``moe_ep``: each MoE layer's
    ``w_in``/``w_out`` split along the experts (axis 0) over ``ep_axis``, as
    its ``shard_map`` hands them to each rank (``P(ep_axis, None, None)``),
    when the axis has more than one rank and divides the padded experts;
    every other leaf whole (``()``).

    The recurrent mixers' ``dinner`` leaves stay whole here, where
    ``DEFAULT_RULES`` split them over ``model``: on a live ``model`` axis
    the Mamba and mLSTM mixers, whose state cache splits d_inner
    (``parallel.sharding.cache_specs``), compute on this rank's block cut
    from the whole leaves at first use (:func:`tp_block`), and the sLSTM,
    whose state is whole on every rank, runs whole. Their weights are a
    small share of a served model (jamba's Mamba layer, 0.42e9 of its
    2.1e9 parameters a layer with its FFN), and the serving draw keeps
    its axis-0 cut."""
    n = dict(zip(mesh.axis_names, mesh.axis_sizes)).get(ep_axis, 1)
    out: Dict[str, Spec] = {}
    for k, d in model_defs(cfg).items():
        split = (d.axes[:1] == ("experts",) and n > 1
                 and d.shape[0] % n == 0)
        out[k] = (ep_axis,) + (None,) * (len(d.shape) - 1) if split else ()
    return out


# the mesh axis of tensor parallelism: every rule that splits heads, the FFN
# hidden, experts or the vocab names it
TP_AXIS = "model"


def train_plan(cfg: ModelConfig, mesh,
               rules: Optional[Mapping[str, AxisName]] = None
               ) -> Dict[str, Spec]:
    """The layout a rank holds to train on ``mesh``: every leaf under
    :func:`param_specs` with ``rules`` (by default :data:`DEFAULT_RULES`:
    FSDP over ``data`` on the embed dim of matrices, TP over ``model``;
    :data:`POD_FSDP_RULES` adds ``pod`` to the FSDP axes), as JAX's
    ``state_shardings`` places params and both AdamW moments. A leaf whose
    last dim is two halves (:func:`halves`) is stored grouped: see
    :func:`grouped_columns`."""
    return param_specs(model_defs(cfg), mesh, rules)


def tp_split(plan: Mapping[str, Spec], prefix: str, names: Iterable[str],
             mesh) -> FrozenSet[str]:
    """The ``names`` whose leaf ``<prefix>.<name>`` the training ``plan``
    splits over a live :data:`TP_AXIS`: the leaves a rank holds only its
    part of (its heads, hidden units, experts' router columns) and must
    gather or compute on as a part, where the others it holds whole."""
    return frozenset(k for k in names if TP_AXIS in mesh.live(
        spec_axes(plan[f"{prefix}.{k}"])))


def halves(cfg: ModelConfig, name: str) -> int:
    """For a leaf whose last dim is two halves the model reads apart
    (attention's fused ``wkv``/``bkv`` as (2, KV, HD), a gated FFN's
    ``w_in``/``b_in`` as [gate | up], the shared expert's too, Mamba's
    ``w_in`` and the mLSTM's ``w_up`` as [u | z]), the width of a unit of
    one half a rank must hold whole (a head, a hidden unit, a channel); 0
    for any other leaf."""
    sub, leaf = name.split(".")[-2:]
    if sub == "mixer" and leaf in ("wkv", "bkv"):
        return cfg.head_dim
    if sub == "mixer" and leaf in ("w_in", "w_up"):
        return 1
    if sub == "ffn" and cfg.ffn_gated and leaf in (
            "w_in", "b_in", "shared_w_in", "shared_b_in"):
        return 1
    return 0


def grouped_columns(cfg: ModelConfig, name: str, shape: Sequence[int],
                    spec: Spec, mesh) -> Optional[torch.Tensor]:
    """The column order of a leaf of ``shape`` stored grouped, or None.
    JAX's spec cuts the last dim of a :func:`halves` leaf into n contiguous
    blocks, so at n = 2 rank 0 would hold every K column and rank 1 every
    V column. Where each half splits into n whole units, the leaf's columns
    are stored in this order instead: rank r's block is [its part of the
    first half | its part of the second], which it reads as the whole leaf
    of its heads or hidden units; :func:`unshard_leaf` restores JAX's
    order. Where the units do not split (2 KV heads over 4 ranks), the
    block is JAX's and the model gathers the leaf at use."""
    unit = halves(cfg, name)
    if not unit or len(spec) != len(shape):
        return None
    n = mesh.size(entry_axes(spec[-1]))
    half = shape[-1] // 2
    if n <= 1 or half % (n * unit):
        return None
    per = half // n
    return torch.cat([torch.arange(r * per, (r + 1) * per) + h * half
                      for r in range(n) for h in (0, 1)])


def tp_block(cfg: ModelConfig, prefix: str, p: Mapping[str, torch.Tensor],
             mesh) -> Dict[str, torch.Tensor]:
    """This rank's block over :data:`TP_AXIS` of each whole leaf
    ``<prefix>.<name>`` of ``p``, as :func:`train_plan` splits it over
    that axis (in :func:`grouped_columns`' order): what a tensor-parallel
    mixer computes with when the leaves are held whole (serving)."""
    plan = train_plan(cfg, mesh)
    out = {}
    for k, v in p.items():
        spec = tuple(e if TP_AXIS in entry_axes(e) else None
                     for e in plan[f"{prefix}.{k}"])
        out[k] = shard_leaf(cfg, f"{prefix}.{k}", v, spec, mesh)
    return out


def shard_leaf(cfg: ModelConfig, name: str, t: torch.Tensor, spec: Spec,
               mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` under ``spec``, in the
    grouped column order where :func:`grouped_columns` gives one."""
    cols = grouped_columns(cfg, name, t.shape, spec, mesh)
    if cols is not None:
        t = t[..., cols.to(t.device)]
    return local_shard(t, spec, mesh)


def unshard_leaf(cfg: ModelConfig, name: str, block: torch.Tensor,
                 spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf in JAX's layout from every rank's ``block`` (a
    collective: every rank of the mesh calls it, and each gets the whole
    leaf)."""
    from repro_torch.parallel.collectives import all_gather
    whole = block.detach()
    for d, e in enumerate(spec):
        whole = all_gather(whole, entry_axes(e), mesh, dim=d)
    cols = grouped_columns(cfg, name, whole.shape, spec, mesh)
    if cols is not None:
        whole = whole[..., torch.argsort(cols).to(whole.device)]
    return whole


def _rows(name: str, d: ParamDef, shard) -> Optional[Tuple[int, int]]:
    """This rank's [start, stop) along axis 0 of leaf ``name`` under
    ``shard`` = (mesh, plan), or None to keep the leaf whole."""
    if shard is None:
        return None
    mesh, plan = shard[:2]
    spec = plan[name]
    if not spec or all(e is None for e in spec):
        return None
    return block_range(d.shape[0], spec[0], mesh)


def shard_params(cfg: ModelConfig, params: Mapping[str, torch.Tensor], mesh,
                 plan: Mapping[str, Spec]) -> Dict[str, torch.Tensor]:
    """This rank's params under ``plan`` (:func:`serving_plan`): each leaf's
    block, the whole leaf where the plan splits nothing."""
    if set(plan) != set(params):
        raise ValueError(f"the plan does not name {cfg.name}'s params")
    return {k: local_shard(v, plan[k], mesh) for k, v in params.items()}


def param_count(defs: Mapping[str, ParamDef]) -> int:
    """Parameters in a flat ``{name: ParamDef}`` (``repro/models/params.py``
    ``param_count``)."""
    return sum(math.prod(d.shape) for d in defs.values())


def abstract_params(defs: Mapping[str, ParamDef], *, mesh=None,
                    plan: Optional[Mapping[str, Spec]] = None
                    ) -> Dict[str, torch.Tensor]:
    """``{name: f32 tensor on the meta device}``: each leaf's shape, or with
    ``mesh`` and ``plan`` this rank's block of it (``block_slices``), for
    the dry run (nothing is allocated)."""
    out = {}
    for k, d in defs.items():
        shape = d.shape
        if plan is not None:
            shape = tuple(sl.stop - sl.start for sl in
                          block_slices(d.shape, plan[k], mesh))
        out[k] = torch.empty(shape, dtype=torch.float32, device="meta")
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
          cast: bool = False, shard=None
          ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Each leaf in turn, drawn in f32 from ``generator``, in f32 or with
    ``cast`` in its :func:`compute_dtype`. With ``shard`` = (mesh, plan),
    every slice is drawn as without it, and only this rank's block of a
    leaf the plan splits is kept: its rows of axis 0 and, for a training
    plan (``shard`` = (mesh, plan, True)), its block of the other dims in
    :func:`grouped_columns`' order."""
    train = shard is not None and len(shard) > 2
    for name, d in model_defs(cfg).items():
        vector = train and len(d.shape) == 1      # drawn whole, then cut
        keep = None if vector else _rows(name, d, shard)
        lo, hi = keep if keep else (0, d.shape[0])
        rest = lambda t: t                                  # noqa: E731
        if train:
            mesh, plan = shard[:2]
            cols = grouped_columns(cfg, name, d.shape, plan[name], mesh)
            sl = (slice(None),) + block_slices(d.shape, plan[name],
                                                mesh)[1:]

            def rest(t, name=name, cols=cols, sl=sl):
                if vector:
                    return shard_leaf(cfg, name, t, plan[name], mesh)
                if cols is not None:
                    t = t[..., cols.to(t.device)]
                return t[sl]
        if d.init in ("zeros", "ones", "ssm_a"):      # nothing drawn
            shape = (hi - lo,) + d.shape[1:]
            if d.init == "ssm_a":     # log(-A), A = -(1 .. d_state) a row
                t = torch.log(torch.arange(1, d.shape[-1] + 1,
                                           dtype=torch.float32, device=dev)
                              ).expand(shape).contiguous()
            else:
                t = torch.full(shape, float(d.init == "ones"), device=dev)
            t = rest(t).contiguous()
            yield name, t.to(compute_dtype(cfg, name, t)) if cast else t
            continue
        std = d.scale if d.init == "embed" else d.scale / math.sqrt(_fan_in(d))
        rows = max(1, DRAW_SLICE // max(math.prod(d.shape[1:]), 1))
        out = None
        for i in range(0, d.shape[0], rows):
            part = torch.randn((min(rows, d.shape[0] - i),) + d.shape[1:],
                               generator=generator, device=dev).mul_(std)
            if rows >= d.shape[0] and not keep:     # one slice: the leaf
                part = rest(part).contiguous()
                out = part.to(compute_dtype(cfg, name, part)) if cast else part
                break
            a, b = max(i, lo), min(i + len(part), hi)
            part = rest(part[a - i:b - i]) if a < b else None
            if out is None:
                probe = rest(torch.empty((0,) + d.shape[1:], device=dev))
                out = torch.empty((hi - lo,) + probe.shape[1:], device=dev,
                                  dtype=compute_dtype(cfg, name, probe)
                                  if cast else probe.dtype)
            if part is not None:
                out[a - lo:b - lo] = part
        yield name, out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda", *, mesh=None,
                plan: Optional[Mapping[str, Spec]] = None
                ) -> Dict[str, torch.Tensor]:
    """Random f32 params with ``repro.models.params.init_one``'s scales.

    The values differ from ``jax.random``'s; the shapes and distributions
    are the same. ``generator`` must live on ``device``. With ``mesh`` and
    a training ``plan`` (:func:`train_plan`), every leaf is drawn as
    without them and this rank keeps its block (:func:`shard_leaf`), so
    the ranks' blocks make up the same params.
    """
    shard = None if mesh is None else (mesh, plan, True)
    return dict(_draw(cfg, generator, resolve_device(device), shard=shard))


# leaves that keep f32 in the compute copy, since the reference reads each
# with ``.astype(jnp.float32)`` from f32 params: the MoE router (top-k on
# bf16 logits can pick other experts than on f32 ones), Mamba's A and dt
# projection (under exp and softplus; the reference's early cast leaves
# these three, ``_PRECAST_EXCLUDE`` in repro/models/transformer.py) and
# the sLSTM's recurrent matrices, which feed an f32 recurrence at every step
KEEP_F32 = ("router", "a_log", "dt_w", "r_z", "r_i", "r_f", "r_o")


def compute_dtype(cfg: ModelConfig, name: str, t: torch.Tensor
                  ) -> torch.dtype:
    """The dtype leaf ``name`` takes in the compute copy: ``cfg.dtype`` for a
    matrix, its own for a vector (norm scales, biases) and a ``KEEP_F32``
    leaf."""
    if t.dim() >= 2 and name.rsplit(".", 1)[-1] not in KEEP_F32:
        return getattr(torch, cfg.dtype)
    return t.dtype


def init_serving_params(cfg: ModelConfig, generator: torch.Generator,
                        device: DeviceLike = "cuda", *, shard=None
                        ) -> Dict[str, torch.Tensor]:
    """The compute copy of :func:`init_params`'s draw, equal to
    ``cast_for_compute(cfg, init_params(cfg, generator, device))`` from a
    generator in the same state, but each leaf cast as soon as it is
    drawn: the f32 model is never held whole (qwen2-moe-a2.7b's is 60.6 GB,
    its bf16 copy 30.3 GB). With ``shard`` = (mesh, plan), each rank keeps
    only its block of the leaves the plan (:func:`serving_plan`) splits,
    equal to :func:`shard_params` of the whole draw, so no rank holds the
    whole model."""
    return dict(_draw(cfg, generator, resolve_device(device), cast=True,
                      shard=shard))


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


def _state_map(state: Mapping, fn) -> Dict[str, Any]:
    """``fn(name, leaf)`` over params, m and v; ``step`` as it is."""
    opt = state["opt"]
    return {"params": {k: fn(k, v) for k, v in state["params"].items()},
            "opt": {"m": {k: fn(k, v) for k, v in opt["m"].items()},
                    "v": {k: fn(k, v) for k, v in opt["v"].items()},
                    "step": opt["step"]}}


def state_to_jax(cfg: ModelConfig, state: Mapping, *, mesh=None
                 ) -> Dict[str, Any]:
    """The port's train state ``{"params", "opt": {"m", "v", "step"}}`` in
    JAX's layout, as a JAX train step returns it: params, m and v through
    :func:`params_to_jax`, ``step`` the int32 scalar as it is, every dict's
    keys sorted. With ``mesh``, ``state`` holds this rank's blocks under
    :func:`train_plan`: every leaf is gathered whole in JAX's column order
    first (a collective every rank calls; each gets the whole state)."""
    if mesh is not None:
        plan = train_plan(cfg, mesh)
        state = _state_map(state, lambda k, v: unshard_leaf(
            cfg, k, v, plan[k], mesh))
    opt = state["opt"]
    return {"opt": {"m": params_to_jax(cfg, opt["m"]),
                    "step": opt["step"],
                    "v": params_to_jax(cfg, opt["v"])},
            "params": params_to_jax(cfg, state["params"])}


def state_from_jax(cfg: ModelConfig, tree: Mapping,
                   device: DeviceLike = "cuda", *, mesh=None
                   ) -> Dict[str, Any]:
    """A train state in JAX's layout (numpy or torch leaves, e.g. a restored
    checkpoint) -> the port's train state on ``device``. Every leaf is a
    tensor of its own (no view into a stacked leaf); dtypes are kept and
    ``step`` is an int32 scalar. With ``mesh``, each leaf is this rank's
    block under :func:`train_plan` (the counterpart of the reference's
    ``Checkpointer.restore(shardings=...)``)."""
    dev = resolve_device(device)
    plan = None if mesh is None else train_plan(cfg, mesh)

    def own(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if plan is not None:
            flat = {k: shard_leaf(cfg, k, v, plan[k], mesh)
                    for k, v in flat.items()}
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
