"""Deterministic synthetic data (the port's numpy copy).

Port of ``token_batches``, ``image_batches`` and ``lm_batch_for`` of the
JAX package's ``data/synthetic.py``: the affine-chain language next =
(a*tok + c) mod V with noise epsilon, 10-class blob images (a
class-dependent spatial pattern plus noise), the stand-in for CIFAR-10
in the paper's experiments, and one uniform token batch for an LM
config.  Pure numpy, so the same seed gives the same batches as the
reference; ``lm_batch_for`` hands them over as tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def image_batches(batch: int, *, num_classes: int = 10, size: int = 32,
                  noise: float = 0.3, seed: int = 0, shard: int = 0,
                  num_shards: int = 1):
    """Yield {'images' [B,H,W,3] f32, 'labels' [B]} with class-specific blobs."""
    rng = np.random.default_rng((seed, shard))
    b_local = batch // num_shards
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size

    # fixed per-class pattern parameters
    prng = np.random.default_rng(1234)
    centers = prng.random((num_classes, 2)).astype(np.float32)
    freqs = (prng.integers(1, 4, size=(num_classes, 3))).astype(np.float32)

    while True:
        labels = rng.integers(0, num_classes, size=b_local).astype(np.int32)
        imgs = np.empty((b_local, size, size, 3), np.float32)
        for ci in range(3):
            cy = centers[labels, 0][:, None, None]
            cx = centers[labels, 1][:, None, None]
            f = freqs[labels, ci][:, None, None]
            r2 = (yy[None] - cy) ** 2 + (xx[None] - cx) ** 2
            imgs[..., ci] = np.cos(2 * np.pi * f * np.sqrt(r2 + 1e-6)) * \
                np.exp(-4.0 * r2)
        imgs += noise * rng.standard_normal(imgs.shape).astype(np.float32)
        yield {"images": imgs, "labels": labels}


def lm_batch_for(cfg, batch: int, seq: int, seed: int = 0, device="cpu"):
    """One batch matching an LMConfig's input structure: the reference's
    numpy stream (int32 tokens and labels, then f32 patch embeddings or
    audio frames for those families), as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    out = {
        "tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
    }
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}
