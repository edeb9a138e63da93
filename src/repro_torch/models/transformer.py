"""Model assembly: ``Block``, ``Transformer``, train/prefill/decode.

Port of ``repro/models/transformer.py`` for every mixer (attention, MLA,
Mamba, mLSTM, sLSTM) with a dense, MoE or no FFN, in sequence or in
parallel (Cohere-style: mixer and FFN on one norm, both added to the
residual). An attention layer caches K/V, an MLA layer its latent and rope
key (``models/mla.py``), both in bf16; a recurrent layer its state in the
dtypes of its own ``*_init_cache`` (``models/mamba.py``,
``models/xlstm.py``), which its sequence pass computes only when a cache
is wanted. The JAX
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

Over a mesh of ranks (``launch/mesh.py``), ``prefill``, ``decode_step``
and ``train_logits`` take the reference's :class:`RunFlags` and the mesh:
with ``distributed`` every MoE FFN runs ``moe_ep`` with its experts split
over ``ep_axis``, and with ``decode_seq_axes`` every attention and MLA
decode attends over this rank's slice of the cache along the sequence.
Everything else runs whole on every rank.

To train on a mesh, the model holds this rank's blocks under a training
plan (``params.train_plan``, ``Transformer(..., plan=)``): FSDP over the
batch axes and tensor parallelism over ``model``, GSPMD's partitioning of
the reference's step written out. Each block casts its FSDP leaves to
their compute dtype and gathers them before its forward, inside the remat
region, so the backward gathers them again and the gathered copy is not
kept; the gathers' backward sums the gradients over the ranks and leaves
each its block, in f32. On a live ``model`` axis the embedding, the
unembedding, every mixer (``TP_MIXERS``: attention, MLA, Mamba, mLSTM,
sLSTM), the dense FFN and the MoE run tensor-parallel
(``models/layers.py``, ``models/attention.py``, ``models/mla.py``,
``models/mamba.py``, ``models/xlstm.py``, ``moe_ep``); a mixer whose
leaves the plan keeps whole (a dim ``model`` does not divide) computes on
them whole.

Serving over a mesh (no plan) keeps every leaf whole, as
``params.serving_plan`` does, but for the MoE experts. On a live
``model`` axis the mixers whose cache ``parallel.sharding.cache_specs``
splits along d_inner (``SPLIT_STATE``: Mamba, mLSTM) compute on this
rank's block of their leaves, cut from the whole ones once
(``params.tp_block``), with their state cache in that block; a prefill's
cache is gathered whole, as the attention caches come whole from a
prefill, and the engine keeps each rank's block.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.rmsnorm import rmsnorm_residual
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as XL
from repro_torch.models.params import (TP_AXIS, check_spec, compute_dtype,
                                       model_defs, tp_block, tp_split)
from repro_torch.parallel.collectives import all_gather
from repro_torch.parallel.sharding import entry_axes, layer_cache_specs

Cache = Dict[str, torch.Tensor]
Aux = Dict[str, torch.Tensor]

AUX_KEYS = ("moe_load_balance", "moe_router_z")


REMAT = ("full", "none")


@dataclass(frozen=True)
class RunFlags:
    """The distribution options of the reference's ``RunFlags``
    (``repro/models/transformer.py``): ``distributed`` runs the MoE FFNs
    expert-parallel over ``ep_axis``, with tokens split over
    ``token_axes`` (also the decode's batch axes); ``decode_seq_axes``
    shards the decode caches along the sequence (``()``: whole);
    ``moe_combine`` is ``moe_ep``'s combine; ``mla_absorbed`` decodes MLA
    in the latent space. ``remat`` is ``train_logits``' argument here;
    ``backend``, ``act_spec``, ``cast_params_early``, ``mamba_chunks`` and
    ``unroll_layers`` steer the reference's XLA compilation and have no
    counterpart."""
    distributed: bool = False
    ep_axis: str = "model"
    token_axes: Tuple[str, ...] = ("data",)
    decode_seq_axes: Tuple[str, ...] = ()
    moe_combine: str = "psum"
    mla_absorbed: bool = True


def _kv_seq(fn, keys: Tuple[str, str]):
    """An attention-like sequence pass, ``fn(...) -> (y, (two tensors))``,
    as a mixer's: (y, the two cached in bf16 under ``keys``, or None)."""
    def seq(cfg, p, x, positions, *, lengths=None, want_cache=False):
        y, kv = fn(cfg, p, x, positions, lengths=lengths)
        if not want_cache:
            return y, None
        return y, {k: t.to(torch.bfloat16).contiguous()
                   for k, t in zip(keys, kv)}
    return seq


def _kv_cache(cfg, batch, s_max, device):
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {k: torch.zeros(shape, dtype=torch.bfloat16, device=device)
            for k in ("k", "v")}


def _mla_cache(cfg, batch, s_max, device):
    m, bf16 = cfg.mla, dict(dtype=torch.bfloat16, device=device)
    return {"ckv": torch.zeros(batch, s_max, m.kv_lora_rank, **bf16),
            "kr": torch.zeros(batch, s_max, m.qk_rope_head_dim, **bf16)}


def _state_cache(fn):
    """A recurrent layer's empty cache, which holds no sequence axis."""
    return lambda cfg, batch, s_max, device: fn(cfg, batch, device)


# per mixer: its sequence pass ``(cfg, p, x, positions, *, lengths,
# want_cache) -> (y, cache or None)``, its decode step ``(cfg, p, x, cache,
# lengths) -> (y, cache)`` and its empty cache ``(cfg, batch, s_max,
# device)`` (the reference's ``layer_cache``); a recurrent mixer takes
# and ignores ``positions`` and the decode's ``lengths`` (its state is
# its position) and holds no sequence axis
MIXERS = {
    "attn": (_kv_seq(A.self_attention, ("k", "v")), A.decode_self_attention,
             _kv_cache),
    "mla": (_kv_seq(MLA.mla_self_attention, ("ckv", "kr")),
            MLA.mla_decode_attention, _mla_cache),
    "mamba": (MB.mamba_mixer, MB.mamba_decode,
              _state_cache(MB.mamba_init_cache)),
    "mlstm": (XL.mlstm_mixer, XL.mlstm_decode,
              _state_cache(XL.mlstm_init_cache)),
    "slstm": (XL.slstm_mixer, XL.slstm_decode,
              _state_cache(XL.slstm_init_cache)),
}

# per mixer, its sequence pass under a training plan on a live ``model``
# axis: ``(cfg, p, x, positions, *, lengths, mesh, tp_split) -> y``, on
# this rank's blocks where the plan splits them (``tp_split``)
TP_MIXERS = {"attn": A.tp_self_attention, "mla": MLA.tp_mla_self_attention,
             "mamba": MB.tp_mamba_mixer, "mlstm": XL.tp_mlstm_mixer,
             "slstm": XL.tp_slstm_mixer}

# the mixers whose serving state splits d_inner over ``model``
# (``parallel.sharding.cache_specs``), and so compute on their block of it
SPLIT_STATE = ("mamba", "mlstm")


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


def fsdp_gather(cfg: ModelConfig, pd: Mapping[str, torch.Tensor],
                prefix: str, plan: Mapping, mesh) -> Dict[str, torch.Tensor]:
    """The leaves ``<prefix>.<name>`` of ``pd`` as a rank computes with them
    under a training ``plan``: each one split over axes other than
    ``model`` cast to its compute dtype, then gathered over them (the
    gather's backward sums the gradient over those ranks in f32 and keeps
    this rank's block); the rest as held."""
    out = {}
    for k, v in pd.items():
        name = f"{prefix}.{k}"
        for d, e in enumerate(plan[name]):
            axes = mesh.live(a for a in entry_axes(e) if a != TP_AXIS)
            if not axes:
                continue
            if TP_AXIS in mesh.live(entry_axes(e)):
                raise NotImplementedError(f"{name}: dim {d} split over "
                                          f"{e}")
            v = all_gather(v, axes, mesh, dim=d,
                           dtype=compute_dtype(cfg, name, v))
        out[k] = v
    return out


SUBS = ("mixer_norm", "mixer", "ffn_norm", "ffn")


class Block(nn.Module):
    """One layer: mixer norm, the mixer (``spec.mixer``), then a dense or
    MoE FFN on its own norm after the residual add, or (``spec.parallel``)
    on the mixer norm's output beside the mixer, or none. Under a training
    ``plan`` its parameters are this rank's blocks (module docstring)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 params: Mapping[str, torch.Tensor], prefix: str,
                 device: torch.device, trainable: bool = False,
                 plan: Optional[Mapping] = None):
        super().__init__()
        check_spec(spec)
        self.cfg, self.spec, self.prefix, self.plan = cfg, spec, prefix, plan
        self._served: Optional[Tuple[object, Dict[str, torch.Tensor]]] = None
        for sub in SUBS:
            pd = _param_dict(params, f"{prefix}.{sub}", device, trainable)
            if len(pd):
                setattr(self, sub, pd)

    def _use(self, mesh) -> Dict[str, Mapping]:
        """Each part's parameters as the layer computes with them."""
        subs = {s: getattr(self, s) for s in SUBS if hasattr(self, s)}
        if self.plan is None:
            return subs
        return {s: fsdp_gather(self.cfg, pd, f"{self.prefix}.{s}",
                               self.plan, mesh) for s, pd in subs.items()}

    def _tp(self, mesh) -> bool:
        return self.plan is not None and bool(mesh.live((TP_AXIS,)))

    def _tp_split(self, sub: str, mesh) -> FrozenSet[str]:
        """The leaves of part ``sub`` its plan splits over a live
        ``model`` axis (``params.tp_split``)."""
        if not self._tp(mesh):
            return frozenset()
        return tp_split(self.plan, f"{self.prefix}.{sub}",
                        getattr(self, sub), mesh)

    def _split_state(self, mesh) -> bool:
        """Serving (no plan) on a live ``model`` axis a mixer whose state
        splits d_inner (``SPLIT_STATE``)."""
        return (self.plan is None and mesh is not None
                and bool(mesh.live((TP_AXIS,)))
                and self.spec.mixer in SPLIT_STATE)

    def _mixer_block(self, mesh) -> Dict[str, torch.Tensor]:
        """This rank's block of the mixer's whole leaves over ``model``
        (``params.tp_block``), cut once per mesh."""
        if self._served is None or self._served[0] is not mesh:
            self._served = (mesh, tp_block(
                self.cfg, f"{self.prefix}.mixer", self.mixer, mesh))
        return self._served[1]

    def _whole_cache(self, cache: Cache, flags: RunFlags, mesh) -> Cache:
        """A prefill cache of this rank's block of d_inner, gathered whole
        along each dim ``cache_specs`` splits over ``model``."""
        specs = layer_cache_specs(self.cfg, self.spec, flags.token_axes,
                                  flags.decode_seq_axes)
        out = {}
        for k, t in cache.items():
            for d, e in enumerate(specs[k]):
                if TP_AXIS in entry_axes(e):
                    t = all_gather(t, TP_AXIS, mesh, dim=d)
            out[k] = t
        return out

    def _apply_ffn(self, p: Mapping, h: torch.Tensor, flags: RunFlags, mesh
                   ) -> Tuple[torch.Tensor, Optional[Aux]]:
        if self.spec.ffn == "moe":
            # blocks of a training plan go through moe_ep, which takes them
            return MOE.moe_apply(
                self.cfg, p["ffn"], h,
                distributed=flags.distributed or self.plan is not None,
                ep_axis=flags.ep_axis, token_axes=flags.token_axes,
                combine=flags.moe_combine, mesh=mesh,
                tp_split=self._tp_split("ffn", mesh))
        if self._tp(mesh):
            return L.tp_apply_ffn(self.cfg, p["ffn"], h, mesh), None
        return L.apply_ffn(self.cfg, p["ffn"], h), None

    def _ffn(self, p: Mapping, x: torch.Tensor, h: torch.Tensor,
             y_mix: torch.Tensor, flags: RunFlags, mesh
             ) -> Tuple[torch.Tensor, Optional[Aux]]:
        """The residual adds and the FFN after the mixer, whose input was
        ``h`` and output ``y_mix``. Returns (x, the MoE aux or None)."""
        cfg = self.cfg
        if self.spec.ffn == "none":
            return x + y_mix, None
        if self.spec.parallel:
            y_ffn, aux = self._apply_ffn(p, h, flags, mesh)
            return x + y_mix + y_ffn, aux
        if cfg.norm == "rmsnorm":
            h, x = rmsnorm_residual(x, y_mix, p["ffn_norm"]["scale"],
                                    cfg.norm_eps)
        else:
            x = x + y_mix
            h = L.apply_norm(cfg, p["ffn_norm"], x)
        y_ffn, aux = self._apply_ffn(p, h, flags, mesh)
        return x + y_ffn, aux

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                lengths: Optional[torch.Tensor], want_cache: bool,
                flags: RunFlags = RunFlags(), mesh=None
                ) -> Tuple[torch.Tensor, Optional[Cache], Optional[Aux]]:
        """One layer over a whole sequence. Returns (x, cache or None, the
        MoE aux or None)."""
        p = self._use(mesh)
        h = L.apply_norm(self.cfg, p["mixer_norm"], x)
        if self._tp(mesh):
            if want_cache:
                raise NotImplementedError("a training plan keeps no cache")
            y_mix = TP_MIXERS[self.spec.mixer](
                self.cfg, p["mixer"], h, positions, lengths=lengths,
                mesh=mesh, tp_split=self._tp_split("mixer", mesh))
            cache = None
        elif self._split_state(mesh):
            y_mix, cache = MIXERS[self.spec.mixer][0](
                self.cfg, self._mixer_block(mesh), h, positions,
                lengths=lengths, want_cache=want_cache, mesh=mesh)
            if cache is not None:
                cache = self._whole_cache(cache, flags, mesh)
        else:
            y_mix, cache = MIXERS[self.spec.mixer][0](
                self.cfg, p["mixer"], h, positions, lengths=lengths,
                want_cache=want_cache)
        x, aux = self._ffn(p, x, h, y_mix, flags, mesh)
        return x, cache, aux

    def decode(self, x: torch.Tensor, cache: Cache, lengths: torch.Tensor,
               flags: RunFlags = RunFlags(), mesh=None
               ) -> Tuple[torch.Tensor, Cache]:
        """One layer, one decode token. Updates ``cache`` in place; an
        attention or MLA cache is this rank's slice of the sequence when
        ``flags.decode_seq_axes`` split it, a Mamba or mLSTM state cache
        its block of d_inner on a live ``model`` axis."""
        if self.plan is not None:
            raise NotImplementedError("a training plan does not decode")
        p = self._use(mesh)
        h = L.apply_norm(self.cfg, p["mixer_norm"], x)
        decode = MIXERS[self.spec.mixer][1]
        kw, mixer = {}, p["mixer"]
        if self.spec.mixer in ("attn", "mla"):
            kw = dict(seq_axes=flags.decode_seq_axes or None,
                      batch_axes=flags.token_axes, mesh=mesh)
        if self.spec.mixer == "mla":
            kw["absorbed"] = flags.mla_absorbed
        if self._split_state(mesh):
            kw, mixer = dict(mesh=mesh), self._mixer_block(mesh)
        y_mix, cache = decode(self.cfg, mixer, h, cache, lengths, **kw)
        return self._ffn(p, x, h, y_mix, flags, mesh)[0], cache


class Transformer(nn.Module):
    """The model, holding ``params`` (a state dict named as
    :func:`~repro_torch.models.params.model_defs`) on ``device``; with
    ``trainable`` the parameters need gradients (serving builds them
    without)."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                 *, device: DeviceLike = "cuda", trainable: bool = False,
                 plan: Optional[Mapping] = None):
        super().__init__()
        dev = resolve_device(device)
        expected = set(model_defs(cfg))
        if set(params) != expected:
            raise ValueError(
                f"params do not match {cfg.name}: missing "
                f"{sorted(expected - set(params))}, unexpected "
                f"{sorted(set(params) - expected)}")
        self.cfg, self.plan = cfg, plan
        self.embed = _param_dict(params, "embed", dev, trainable)
        self.out_norm = _param_dict(params, "out_norm", dev, trainable)
        self.layers = nn.ModuleList(
            Block(cfg, spec, params, f"layers.{i}", dev, trainable, plan)
            for i, spec in enumerate(cfg.layer_specs))

    def tp_mesh(self, mesh):
        """``mesh`` when this model's blocks split the vocab and heads over
        its live ``model`` axis, else None."""
        if self.plan is None or mesh is None or not mesh.live((TP_AXIS,)):
            return None
        return mesh

    def forward(self, batch: Mapping[str, torch.Tensor], *,
                lengths: Optional[torch.Tensor] = None,
                want_cache: bool = False, remat: str = "none",
                flags: RunFlags = RunFlags(), mesh=None
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
        embed = (self.embed if self.plan is None else
                 fsdp_gather(cfg, self.embed, "embed", self.plan, mesh))
        x = L.embed_tokens(cfg, embed, batch.get("tokens"), extra,
                           mesh=self.tp_mesh(mesh))
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        remat = remat == "full" and torch.is_grad_enabled() and not want_cache
        caches: List[Optional[Cache]] = []
        aux: Optional[Aux] = None
        for block in self.layers:
            if remat:
                x, a = checkpoint(lambda x, block=block: block(
                    x, positions, lengths, False, flags, mesh)[::2], x,
                    use_reentrant=False)
                c = None
            else:
                x, c, a = block(x, positions, lengths, want_cache, flags,
                                mesh)
            caches.append(c)
            if a is not None:
                aux = a if aux is None else {k: aux[k] + a[k]
                                             for k in AUX_KEYS}
        x = L.apply_norm(cfg, self.out_norm, x)
        return x, ({"layers": caches} if want_cache else None), aux


def cast_for_compute(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                     device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """``params`` on ``device`` with every matrix in ``cfg.dtype`` but the
    ``params.KEEP_F32`` leaves; vectors (norm scales, biases) keep their
    dtype (``params.compute_dtype``). Every use site casts matrices to
    ``cfg.dtype`` first and those leaves to f32, so a model on these params
    computes the same."""
    dev = resolve_device(device)
    return {k: v.to(dev, compute_dtype(cfg, k, v)) for k, v in params.items()}


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = "cuda") -> Dict:
    """Every layer's empty cache, made by its mixer (``MIXERS``): K/V and
    MLA's latent in bf16 over ``s_max`` positions, a recurrent layer's
    state in its own dtypes; and zero lengths."""
    dev = resolve_device(device)
    layers = []
    for spec in cfg.layer_specs:
        check_spec(spec)
        layers.append(MIXERS[spec.mixer][2](cfg, batch, s_max, dev))
    return {"layers": layers,
            "lengths": torch.zeros(batch, dtype=torch.int32, device=dev)}


def train_logits(model: Transformer, batch: Mapping[str, torch.Tensor], *,
                 remat: str = "full", flags: RunFlags = RunFlags(),
                 mesh=None) -> Tuple[torch.Tensor, Optional[Aux]]:
    """f32 logits (B, S, V) of a full-sequence forward and the aux losses
    under ``AUX_KEYS`` (None without a MoE layer); differentiable when the
    model is trainable. ``remat`` as JAX's ``RunFlags.remat``; ``flags``
    and ``mesh`` reach every block, under remat too. Under a training
    plan on a live ``model`` axis the logits are this rank's vocab
    columns (B, S, V / n)."""
    x, _, aux = model(batch, remat=remat, flags=flags, mesh=mesh)
    return L.unembed(model.cfg, model.embed, x, mesh=model.tp_mesh(mesh)), aux


def prefill(model: Transformer, batch: Mapping[str, torch.Tensor],
            lengths: torch.Tensor, *, flags: RunFlags = RunFlags(), mesh=None
            ) -> Tuple[torch.Tensor, Dict]:
    """Prompt ingestion. lengths: (B,) int32. Returns (logits at position
    lengths - 1 (B, V), the whole cache)."""
    x, caches, _ = model(batch, lengths=lengths, want_cache=True,
                         flags=flags, mesh=mesh)
    B, S = x.shape[:2]
    idx = torch.clamp(lengths - 1, 0, S - 1).long()
    last = x[torch.arange(B, device=x.device), idx]
    caches["lengths"] = lengths
    return L.unembed(model.cfg, model.embed, last), caches


def decode_step(model: Transformer, cache: Dict, tokens: torch.Tensor, *,
                flags: RunFlags = RunFlags(), mesh=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One token for every sequence. tokens: (B,) or (B, 1) (or (B, 1, D)
    frame embeds for input_mode=embeds). The caches (this rank's blocks
    under ``flags``) are updated in place; returns (logits (B, V), cache
    with lengths + 1)."""
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
        x, c = block.decode(x, c, lengths, flags, mesh)
        new_layers.append(c)
    x = L.apply_norm(cfg, model.out_norm, x)
    logits = L.unembed(cfg, model.embed, x[:, 0])
    return logits, {"layers": new_layers, "lengths": lengths + 1}
