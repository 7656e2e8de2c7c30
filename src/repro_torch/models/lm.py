"""Top-level language model: init, prefill with cache, decode step.

Port of the serving half of the JAX package's ``models/lm.py`` for
homogeneous decoder stacks of ``"attn"`` blocks.  Parameters are a tree
of nested dicts in the reference's layout, block weights stacked
``[L, ...]``.  Matmul weights are stored at the compute dtype (bf16 on
the card): the reference's ``cast_gather_weights`` shows every use casts
them to that dtype anyway.  Norm weights and biases stay f32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.blocks import (apply_block_decode,
                                       apply_block_prefill, init_block,
                                       init_block_state)
from repro_torch.models.common import apply_norm, init_norm
from repro_torch.models.config import LMConfig
from repro_torch.utils.trees import tree_map


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _softcap(logits, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def layer(blocks, i: int):
    """Layer ``i`` of a stacked block tree (views, no copy)."""
    return tree_map(lambda a: a[i], blocks)


def prefill_blocks(cfg: LMConfig, blocks, x, cache):
    """Run a stacked block tree over x [B, S, D] (positions 0..S-1),
    filling ``cache`` ({"k","v"}: [L, B, C, kv, hd]) in place."""
    kind = cfg.layer_kinds[0]
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cache["k"].shape[0]):
        x = apply_block_prefill(layer(blocks, i), x, cfg, kind,
                                positions=positions, state=layer(cache, i))
    return x


def decode_blocks(cfg: LMConfig, blocks, x, cache, position: int):
    """One token x [B, 1, D] through a stacked block tree; writes K/V at
    ``position`` into ``cache`` in place."""
    kind = cfg.layer_kinds[0]
    for i in range(cache["k"].shape[0]):
        x = apply_block_decode(layer(blocks, i), x, layer(cache, i), cfg,
                               kind, position=position)
    return x


class LM:
    """Decoder-only LM over a homogeneous stack of attention blocks."""

    def __init__(self, cfg: LMConfig, device):
        if not cfg.homogeneous or cfg.tie_embeddings or cfg.enc_layers \
                or cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: only homogeneous dense decoders with an "
                "untied head are ported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = torch_dtype(cfg.dtype)

    # ---------------- init ----------------

    def init(self, generator: torch.Generator):
        """Random parameters drawn from ``generator`` (on ``self.device``)."""
        cfg, dev, dt = self.cfg, self.device, self.dtype

        def normal(shape, std):
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * std
            return w.to(dt)

        return {
            "embed": normal((cfg.padded_vocab, cfg.d_model), 0.02),
            "final_norm": init_norm(cfg.d_model, cfg.norm, device=dev),
            "blocks": init_block(generator, cfg, cfg.layer_kinds[0],
                                 device=dev, weight_dtype=dt,
                                 layers=cfg.num_layers),
            "head": normal((cfg.d_model, cfg.padded_vocab), 0.02),
        }

    # ---------------- pieces ----------------

    def _embed(self, params, tokens, dt):
        x = params["embed"].to(dt)[tokens]
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=dt)
        return x

    def _head_w(self, params, dt):
        return params["head"].to(dt)

    def logits(self, params, x):
        """Final norm + head on the last position: x [B, S, D] -> [B, V] f32."""
        cfg = self.cfg
        x = apply_norm(x, params["final_norm"], cfg.norm)
        out = _softcap(x[:, -1] @ self._head_w(params, x.dtype),
                       cfg.logit_softcap)
        return out[:, :cfg.vocab].to(torch.float32)

    # ---------------- serving ----------------

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   layers: int | None = None):
        cfg = self.cfg
        return init_block_state(cfg, cfg.layer_kinds[0], batch, cache_len,
                                dtype, device=self.device,
                                layers=cfg.num_layers if layers is None
                                else layers)

    def prefill_with_cache(self, params, batch, cache_len: int,
                           cache_dtype=torch.bfloat16):
        """One full-sequence forward that also fills the decode cache.

        Returns (last-position logits [B, V] f32, serve_state) with
        ``serve_state = {"cache": ..., "position": S}``.
        """
        tokens = batch["tokens"]
        x = self._embed(params, tokens, self.dtype)
        cache = self.init_cache(x.shape[0], cache_len, cache_dtype)
        x = prefill_blocks(self.cfg, params["blocks"], x, cache)
        return self.logits(params, x), {"cache": cache,
                                        "position": int(x.shape[1])}

    def decode_step(self, params, tokens, cache, position: int):
        """One serving step: tokens [B, 1] -> (logits [B, V] f32, cache).
        ``cache`` is updated in place and returned."""
        x = self._embed(params, tokens, self.dtype)
        x = decode_blocks(self.cfg, params["blocks"], x, cache, position)
        return self.logits(params, x), cache
