"""Deterministic synthetic token data (the port's numpy copy).

Port of ``token_batches`` of the JAX package's ``data/synthetic.py``: the
affine-chain language next = (a*tok + c) mod V with noise epsilon.  Pure
numpy, so the same seed gives the same batches as the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenTaskConfig:
    vocab: int
    a: int = 31
    c: int = 17
    noise: float = 0.05


def token_batches(cfg: TokenTaskConfig, batch: int, seq: int, *,
                  seed: int = 0, shard: int = 0, num_shards: int = 1):
    """Yield {'tokens', 'labels'} int32 batches forever (labels = next tok)."""
    rng = np.random.default_rng((seed, shard))
    b_local = batch // num_shards
    while True:
        toks = np.empty((b_local, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=b_local)
        for t in range(seq):
            nxt = (cfg.a * toks[:, t] + cfg.c) % cfg.vocab
            flip = rng.random(b_local) < cfg.noise
            nxt = np.where(flip, rng.integers(0, cfg.vocab, b_local), nxt)
            toks[:, t + 1] = nxt
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
