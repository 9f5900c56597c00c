"""Deterministic synthetic-corpus LM data pipeline (the port's copy of
``repro.data.pipeline``: numpy only, the same token stream for each seed,
shard and step, which ``tests/test_torch_train.py`` holds byte-equal).

Generates a reproducible token stream from a seeded Markov-ish mixture so
training loss actually *decreases* (the stream has learnable structure:
skewed unigram + bigram correlations), sharded by (host, data-parallel
rank), with packing into fixed-length sequences and next-token targets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

N_PATCHES = 256     # the vlm stub's patches (the reference's models.model.N_PATCHES)


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # learnable structure knobs
    zipf_a: float = 1.2
    bigram_weight: float = 0.5


class SyntheticCorpus:
    """Infinite deterministic stream: each (epoch, shard) slice is pure."""

    def __init__(self, cfg: DataConfig, *, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # skewed unigram distribution
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = (ranks ** -cfg.zipf_a)
        self._unigram /= self._unigram.sum()
        # low-rank bigram structure: next ~ permutation(prev) half the time
        self._perm = rng.permutation(v)

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 65_537 + self.shard)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._batch_rng(step)
        B, S = self.local_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=B, p=self._unigram)
        iid = rng.choice(cfg.vocab_size, size=(B, S), p=self._unigram)
        use_bigram = rng.random((B, S)) < cfg.bigram_weight
        for t in range(S):
            follow = self._perm[toks[:, t]]
            toks[:, t + 1] = np.where(use_bigram[:, t], follow, iid[:, t])
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": np.ones((B, S), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def stub_inputs(cfg, rows: int, *, seed: int = 0) -> Dict[str, np.ndarray]:
    """The frontend stubs of a batch of ``rows``, as the reference's
    ``make_batch`` draws them from ``default_rng(seed + 17)``: an audio
    model's "frames" (rows, encoder_seq, d_model), a vlm model's "patches"
    (rows, N_PATCHES, d_model), fp32 N(0, 0.02²); nothing for the others.
    The same for every step."""
    rng = np.random.default_rng(seed + 17)
    n = {"audio": ("frames", cfg.encoder_seq), "vlm": ("patches", N_PATCHES)}.get(cfg.family)
    if n is None:
        return {}
    return {n[0]: rng.standard_normal((rows, n[1], cfg.d_model)).astype(np.float32) * 0.02}


def make_batch(cfg, shape, *, step: int = 0, seed: int = 0,
               d_model: Optional[int] = None) -> Dict[str, np.ndarray]:
    """One global batch for (ModelConfig, InputShape) incl. frontend stubs."""
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                    global_batch=shape.global_batch, seed=seed)
    b = SyntheticCorpus(dc).batch(step)
    b.update(stub_inputs(cfg, shape.global_batch, seed=seed))
    return b
