"""Deterministic synthetic LM data pipeline (a copy of the JAX package's
numpy-only ``repro.data.lm_data``).

Sequences follow a learnable pattern (per-sequence modular stride with a
noisy token every ``noise_every`` positions), so a small model's loss drops
fast — useful for end-to-end training demos and convergence tests.

Determinism contract: ``batch_at(step)`` is a pure function of
``(seed, step, global_batch)`` — after a restart the pipeline resumes at the
exact batch it would have produced, giving exactly-once sample delivery
without any data-loader state in the checkpoint.  Sharding: each data shard
slices its rows from the same global batch, so the pipeline is elastic too.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LMDataConfig", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    max_stride: int = 8
    noise_every: int = 16


class SyntheticLM:
    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        start = rng.integers(0, c.vocab_size, size=(c.global_batch, 1))
        stride = rng.integers(1, c.max_stride + 1, size=(c.global_batch, 1))
        pos = np.arange(c.seq_len + 1)[None, :]
        seq = (start + stride * pos) % c.vocab_size
        noise_mask = (pos % c.noise_every) == (c.noise_every - 1)
        noise = rng.integers(0, c.vocab_size, size=seq.shape)
        seq = np.where(noise_mask, noise, seq)
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }

    def shard_rows(self, batch: dict, shard: int, n_shards: int) -> dict:
        per = self.cfg.global_batch // n_shards
        sl = slice(shard * per, (shard + 1) * per)
        return {k: v[sl] for k, v in batch.items()}
