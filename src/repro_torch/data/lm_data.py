"""Deterministic synthetic LM data pipeline (a verbatim copy of
``repro/data/lm_data.py``: numpy only).

Host-sharded: each process materializes only its shard of the global batch
(``host_id``/``host_count``), the pattern used on multi-host pods.  Streams
zipf-distributed token sequences with markov-ish structure so the loss has
signal to minimize; fully seeded.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    host_count: int = 1


class SyntheticLM:
    def __init__(self, cfg: LMDataConfig):
        assert cfg.global_batch % cfg.host_count == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count
        rng = np.random.default_rng(cfg.seed)
        # a sparse "bigram table" gives the stream learnable structure
        self._next = rng.integers(0, cfg.vocab, size=cfg.vocab)
        self._noise_p = 0.15

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id, 0xD15EA5E))
        B, S = self.local_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.zipf(1.4, B) % cfg.vocab
        for t in range(S):
            follow = self._next[toks[:, t]]
            noise = rng.integers(0, cfg.vocab, B)
            use_noise = rng.random(B) < self._noise_p
            toks[:, t + 1] = np.where(use_noise, noise, follow)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
