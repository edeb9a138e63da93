"""Batched serving engine with slot-based continuous batching.

Port of ``repro/serve/engine.py``. The engine owns a fixed-shape
(max_batch, max_seq) KV cache. A request is admitted with a single-row
prefill whose cache rows are spliced into the live cache, so decoding never
stalls the whole batch for one admission. Finished slots free immediately.
Greedy or temperature sampling.

Over a mesh of ranks (``flags`` and ``mesh``, as the reference's engine
takes ``flags``), every rank runs the same requests and picks the same
tokens: each holds its experts (``moe_ep``), its slice of every
attention and latent cache along the sequence and its block of every
Mamba and mLSTM state along d_inner (the mixers compute on their block of
d_inner, ``models/transformer.py``), per
``cache_specs(cfg, flags.token_axes, flags.decode_seq_axes)``, and a
prefill's row cache is spliced in as this rank's slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import (RunFlags, Transformer,
                                            cast_for_compute, decode_step,
                                            init_cache, prefill)
from repro_torch.parallel.sharding import cache_specs, local_shard
from repro_torch.spans import span


@dataclass
class GenerationResult:
    request_id: int
    prompt: List[int]
    tokens: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class _Slot:
    request: Optional[GenerationResult] = None
    remaining: int = 0
    last_token: int = 0


class ServeEngine:
    """``params`` is a state dict named as ``models.params.model_defs``
    (under a mesh, whole or this rank's block per
    ``models.params.serving_plan``).

    Weight matrices are cast to ``cfg.dtype`` once here
    (:func:`~repro_torch.models.transformer.cast_for_compute`). ``timings``
    holds the host-clock seconds of every prefill and decode step; both end
    by copying logits to the host, which waits for the device. Under a
    profiler, each prefill and decode step and their phases (uploads, the
    model's call, the splice, sampling) are spans (:mod:`repro_torch.spans`).
    """

    def __init__(self, cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                 *, max_batch: int = 8, max_seq: int = 256,
                 eos_id: Optional[int] = None, seed: int = 0,
                 device: DeviceLike = "cuda", flags: RunFlags = RunFlags(),
                 mesh=None):
        if cfg.input_mode != "tokens":
            raise ValueError("ServeEngine drives token models; modality-stub "
                             "archs are exercised via prefill/decode directly")
        if mesh is not None and mesh.live(flags.token_axes):
            raise ValueError(f"the engine's slots are not split over "
                             f"{flags.token_axes}: every rank holds them all")
        self.device = resolve_device(device)
        self.flags, self.mesh = flags, mesh
        self.cfg = cfg
        self.model = Transformer(
            cfg, cast_for_compute(cfg, params, self.device), device=self.device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self._next_id = 0
        self._slots = [_Slot() for _ in range(max_batch)]
        self.cache = init_cache(cfg, max_batch, max_seq, self.device)
        self.specs = None
        if mesh is not None:
            self.specs = cache_specs(cfg, flags.token_axes,
                                     flags.decode_seq_axes)["layers"]
            self.cache["layers"] = [
                {k: local_shard(t, spec[k], mesh) for k, t in c.items()}
                for c, spec in zip(self.cache["layers"], self.specs)]
        self._rng = np.random.RandomState(seed)
        self._steps = 0
        self.timings: Dict[str, List[float]] = {"prefill": [], "decode": []}

    # -- admission ---------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s.request is None:
                return i
        return None

    @torch.inference_mode()
    def add_request(self, prompt: List[int], max_new: int = 32
                    ) -> Optional[GenerationResult]:
        """Prefill one row and splice it into the live cache. Returns None if
        no slot is free (caller queues)."""
        slot = self._free_slot()
        if slot is None:
            return None
        with span("engine.prefill", self._next_id):
            t0 = time.perf_counter()
            prompt = list(prompt)[: self.max_seq - max_new - 1]
            with span("engine.upload"):
                toks = torch.zeros((1, self.max_seq), dtype=torch.long)
                toks[0, :len(prompt)] = torch.as_tensor(prompt,
                                                        dtype=torch.long)
                lengths = torch.tensor([len(prompt)], dtype=torch.int32,
                                       device=self.device)
                toks = toks.to(self.device)
            with span("model.prefill"):
                logits, row_cache = prefill(
                    self.model, {"tokens": toks}, lengths,
                    flags=self.flags, mesh=self.mesh)
            with span("engine.splice"):
                self._splice(slot, row_cache)
            with span("engine.sample"):
                req = GenerationResult(self._next_id, prompt)
                self._next_id += 1
                first = self._pick(logits[0].cpu().numpy())
                req.tokens.append(first)
                self._slots[slot] = _Slot(req, max_new - 1, first)
            self.timings["prefill"].append(time.perf_counter() - t0)
            return req

    def _splice(self, slot: int, row_cache: Dict) -> None:
        specs = self.specs or [None] * len(self.cache["layers"])
        for dst, src, spec in zip(self.cache["layers"], row_cache["layers"],
                                  specs):
            for name, t in dst.items():
                row = src[name] if spec is None else local_shard(
                    src[name], spec[name], self.mesh)
                t[slot] = row[0]
        # the cache holds exactly len(prompt) entries; the first generated
        # token is written at position lengths on its first decode step
        self.cache["lengths"][slot] = row_cache["lengths"][0]

    def _pick(self, logits: np.ndarray, temperature: float = 0.0) -> int:
        if temperature <= 0:
            return int(logits.argmax())
        z = logits / temperature
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self._rng.choice(len(p), p=p))

    # -- decode loop -------------------------------------------------------

    def active(self) -> int:
        return sum(s.request is not None for s in self._slots)

    @torch.inference_mode()
    def step(self) -> List[GenerationResult]:
        """One decode step for every occupied slot. Returns newly finished."""
        occupied = [s.request is not None for s in self._slots]
        if not any(occupied):
            return []
        with span("engine.decode"):
            t0 = time.perf_counter()
            with span("engine.upload"):
                tokens = torch.tensor([s.last_token for s in self._slots],
                                      dtype=torch.long, device=self.device)
            prev_lengths = self.cache["lengths"]
            with span("model.decode"):
                logits, self.cache = decode_step(
                    self.model, self.cache, tokens, flags=self.flags,
                    mesh=self.mesh)
            # the dense decode advances every row's length; freed slots must
            # not keep walking (they would run past max_seq and corrupt the
            # position a future splice resumes from), so pin them in place
            with span("engine.upload"):
                mask = torch.tensor(occupied, device=self.device)
            self.cache["lengths"] = torch.where(
                mask, self.cache["lengths"], prev_lengths)
            with span("engine.sample"):
                logits = logits.cpu().numpy()
                finished = []
                self._steps += 1
                for i, s in enumerate(self._slots):
                    if s.request is None:
                        continue
                    nxt = self._pick(logits[i])
                    s.request.tokens.append(nxt)
                    s.last_token = nxt
                    s.remaining -= 1
                    hit_eos = self.eos_id is not None and nxt == self.eos_id
                    if s.remaining <= 0 or hit_eos:
                        s.request.done = True
                        finished.append(s.request)
                        self._slots[i] = _Slot()
                        self.cache["lengths"][i] = 0
            self.timings["decode"].append(time.perf_counter() - t0)
            return finished

    def run(self, requests: List[List[int]], max_new: int = 16
            ) -> List[GenerationResult]:
        """Serve a workload of prompts to completion (continuous batching)."""
        queue = list(requests)
        results: List[GenerationResult] = []
        while queue or self.active():
            while queue:
                r = self.add_request(queue[0], max_new=max_new)
                if r is None:
                    break
                results.append(r)
                queue.pop(0)
            if self.active():
                self.step()
        return results
