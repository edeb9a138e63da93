"""Deterministic synthetic LM data: a numpy-only copy of
``repro/data/synthetic.py`` ``SyntheticLM`` (the JAX module imports jax).

Sequences follow a noisy affine-modular walk (x_{t+1} = (a*x_t + b) mod V
with occasional uniform noise), which a model can learn. Batches are a pure
function of (seed, step), so a restarted job resumes the exact stream, and
each host's rows are a disjoint slice of the global batch. VLM batches
carry precomputed patch embeddings, audio batches frame embeddings derived
from the tokens through a fixed random table. ``input_specs`` (JAX shape
structs for the dry run) is not ported.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig
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
