"""Deterministic synthetic LM data: a numpy-only copy of
``repro/data/synthetic.py`` ``SyntheticLM`` (the JAX module imports jax).

Sequences follow a noisy affine-modular walk (x_{t+1} = (a*x_t + b) mod V
with occasional uniform noise), which a model can learn. Batches are a pure
function of (seed, step), so a restarted job resumes the exact stream, and
each host's rows are a disjoint slice of the global batch. VLM batches
carry precomputed patch embeddings, audio batches frame embeddings derived
from the tokens through a fixed random table. ``input_specs`` gives the
dry run (``launch/dryrun.py``) every model input of a cell as a tensor on
the ``meta`` device, with the reference's keys, shapes and dtypes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.train.loss import IGNORE


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, noise: float = 0.05,
                 host_id: int = 0, n_hosts: int = 1):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {n_hosts} hosts")
        self.cfg = cfg
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.row0 = host_id * self.local_batch
        self.seq_len = seq_len
        self.seed = seed
        self.noise = noise
        self.a, self.b = 5, 17
        v = cfg.vocab_size
        # fixed random frame-embedding table for the audio stub
        if cfg.input_mode == "embeds":
            rng = np.random.RandomState(seed ^ 0xA5A5)
            self._frame_table = rng.randn(v, cfg.d_model).astype(np.float32) * 0.5

    def _tokens(self, step: int) -> np.ndarray:
        v = self.cfg.vocab_size
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2**31))
        full = np.zeros((self.global_batch, self.seq_len + 1), np.int64)
        full[:, 0] = rng.randint(0, v, self.global_batch)
        noise_mask = rng.rand(self.global_batch, self.seq_len) < self.noise
        noise_tok = rng.randint(0, v, (self.global_batch, self.seq_len))
        for t in range(self.seq_len):
            nxt = (self.a * full[:, t] + self.b) % v
            full[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return full[self.row0:self.row0 + self.local_batch]

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """This host's rows of the global batch at ``step``: numpy arrays,
        ``labels`` the next tokens (IGNORE under vision patches)."""
        cfg = self.cfg
        full = self._tokens(step)
        tokens = full[:, :-1].astype(np.int32)
        labels = full[:, 1:].astype(np.int32)
        if cfg.input_mode == "embeds":
            emb = self._frame_table[tokens]
            return {"frame_embeds": emb.astype(np.float32),
                    "labels": labels}
        if cfg.input_mode == "tokens+vision":
            vt = cfg.vision_tokens
            rng = np.random.RandomState((self.seed ^ 0x5A5A) + step)
            vis = rng.randn(self.local_batch, vt, cfg.d_model).astype(np.float32)
            lab = np.concatenate(
                [np.full((self.local_batch, vt), IGNORE, np.int32),
                 labels[:, :self.seq_len - vt]], axis=1)
            return {"tokens": tokens[:, :self.seq_len - vt],
                    "vision_embeds": vis, "labels": lab}
        return {"tokens": tokens, "labels": labels}


def to_torch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A :meth:`SyntheticLM.batch` as tensors on ``device``: tokens and
    labels as int64, what the model's embedding and the loss index with."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    for k in ("tokens", "labels"):
        if k in out:
            out[k] = out[k].long()
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                opt_cfg=None) -> Dict[str, torch.Tensor]:
    """Meta tensors standing for every model input of one dry-run cell
    (``repro/data/synthetic.py`` ``input_specs``): train and prefill take
    whole-sequence batches, decode one new token per sequence (the cache is
    built apart). Token ids and labels are int32, embeddings f32, as in
    the reference."""
    B, S = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device="meta")
    f32 = dict(dtype=torch.float32, device="meta")
    if shape.kind in ("train", "prefill"):
        out: Dict[str, torch.Tensor] = {}
        if cfg.input_mode == "embeds":
            out["frame_embeds"] = torch.empty(B, S, cfg.d_model, **f32)
        elif cfg.input_mode == "tokens+vision":
            vt = cfg.vision_tokens
            out["tokens"] = torch.empty(B, S - vt, **i32)
            out["vision_embeds"] = torch.empty(B, vt, cfg.d_model, **f32)
        else:
            out["tokens"] = torch.empty(B, S, **i32)
        if shape.kind == "train":
            out["labels"] = torch.empty(B, S, **i32)
        return out
    if cfg.input_mode == "embeds":
        return {"tokens": torch.empty(B, 1, cfg.d_model, **f32)}
    return {"tokens": torch.empty(B, **i32)}
