"""Top-level language model: init, training forward, prefill, decode.

Port of the JAX package's ``models/lm.py`` for
  * homogeneous stacks with an untied head: ``"attn"`` decoders and
    ``"rwkv"`` stacks (training forward, prefill with cache, decode);
  * MoE stacks of ``"attn"`` layers, tied or untied (granite-moe,
    qwen3-moe: forward with the aux loss, prefill with cache, decode);
  * hybrid stacks (recurrentgemma: ``"rglru"`` and ``"local"`` layers,
    tied embeddings; forward, prefill with cache, decode);
  * the encoder-decoder (whisper: stub frame embeddings + sinusoids
    through a stack of ``"enc"`` blocks and ``enc_norm``, ``_encode``; a
    homogeneous decoder of ``"xattn"`` blocks that attend to its output;
    untied head; forward, prefill with cache, ``fill_cross_kv``, decode);
  * the vlm family (paligemma: stub patch embeddings before the tokens,
    attended bidirectionally as a prefix, ``_with_prefix``; a homogeneous
    ``"attn"`` stack with tied embeddings; forward, prefill with cache,
    decode).
Parameters are a tree of nested dicts in the reference's layout: block
weights stacked ``[L, ...]`` for a homogeneous stack, a tuple of
per-layer trees for a heterogeneous one (and the decode cache likewise).

Two storage modes.  Serving (``init()``) stores matmul weights at the
compute dtype (bf16 on the card): the reference's ``cast_gather_weights``
shows every use casts them to that dtype anyway.  The leaves consumed in
f32 (``_KEEP_F32``: norms, the RG-LRU gates and lambda, ...) stay f32.
Training (``init(master=True)``) keeps every parameter in f32, the
reference's master weights; each forward casts the matmul weights to the
compute dtype once (``cast_gather_weights``).  Biases are f32 in both.

The training forward keeps one activation checkpoint per block
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` on the
scan body) and a sequence-chunked, rematerialised cross entropy, so the
[B, S, V] logits are never alive at once.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.blocks import (SERVE_KINDS, cross_kv, apply_block,
                                       apply_block_decode,
                                       apply_block_prefill, init_block,
                                       init_block_state)
from repro_torch.models.common import apply_norm, init_norm
from repro_torch.models.config import LMConfig
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten


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


def layers_of(tree) -> list:
    """The per-layer trees of a block tree or decode cache: a tuple
    (heterogeneous stack) as it is, a stacked tree ``[L, ...]`` as views."""
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return [layer(tree, i) for i in range(tree_leaves(tree)[0].shape[0])]


def _kinds(cfg: LMConfig, blocks) -> tuple:
    """Each layer's kind: a tuple of layers is the whole heterogeneous
    stack; a stacked tree (the whole stack or a slice of it) is one kind."""
    if isinstance(blocks, (tuple, list)):
        return cfg.layer_kinds
    return (cfg.layer_kinds[0],) * tree_leaves(blocks)[0].shape[0]


def _sin_pos(seq: int, d: int, offset: int = 0, *, device=None):
    """Sinusoidal positions [seq, d] f32: sin then cos of ``pos * freq``,
    ``freq = 10000^(-i / max(d/2 - 1, 1))`` (the reference's ``_sin_pos``,
    whose divisor is d/2 - 1, not d/2)."""
    pos = torch.arange(seq, device=device, dtype=torch.float32) + offset
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, device=device, dtype=torch.float32) / max(half - 1, 1))
    ang = pos[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def prefill_blocks(cfg: LMConfig, blocks, x, cache, enc_out=None,
                   prefix_len: int = 0):
    """Run a block tree over x [B, S, D] (positions 0..S-1), filling
    ``cache`` (one decode state per layer, ``init_cache``) in place; an
    "xattn" layer attends to (and caches the K/V of) ``enc_out``; the
    first ``prefix_len`` positions attend bidirectionally."""
    positions = torch.arange(x.shape[1], device=x.device)
    for p, st, kind in zip(layers_of(blocks), layers_of(cache),
                           _kinds(cfg, blocks), strict=True):
        x, _ = apply_block_prefill(p, x, cfg, kind, positions=positions,
                                   state=st, enc_out=enc_out,
                                   prefix_len=prefix_len)
    return x                                         # serving drops the aux


def decode_blocks(cfg: LMConfig, blocks, x, cache, position, active=None,
                  enc_out=None):
    """One token x [B, 1, D] through a block tree; updates each layer's
    decode state in ``cache`` in place.  ``position``: an ``int``, or an
    int64 tensor [B] of per-lane positions with ``active`` lanes
    (``apply_block_decode``); ``enc_out`` is read only by an "xattn"
    layer whose state holds no cross K/V."""
    for p, st, kind in zip(layers_of(blocks), layers_of(cache),
                           _kinds(cfg, blocks), strict=True):
        x = apply_block_decode(p, x, st, cfg, kind, position=position,
                               active=active, enc_out=enc_out)
    return x


# params consumed in f32 inside the blocks (norms, decay LoRAs, bonus) —
# everything else is matmul weight, safe to pre-cast (the reference's list)
_KEEP_F32 = {"ln1", "ln2", "lnx", "enc_norm", "final_norm", "gate_a",
             "gate_x", "lambda", "router", "w0", "w_a", "w_b", "u",
             "ln_w", "ln_b"}


def cast_gather_weights(tree, dt):
    """Pre-cast matmul weights to the compute dtype, once per step.

    The reference's ``cast_gather_weights``: every use casts them to that
    dtype anyway, so the result is the same; casting the stacked leaves
    once saves a cast (and its backward) per layer, use and micro-batch —
    thousands of kernel launches a step on rwkv6-3b, whose step the host
    bounds.  Autograd runs through the cast to the f32 master weights."""
    def walk(node, keep):
        if isinstance(node, dict):
            return {k: walk(v, keep or k in _KEEP_F32)
                    for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, keep) for v in node)
        if keep or node.dtype != torch.float32 or node.dim() < 2:
            return node
        return node.to(dt)
    return walk(tree, False)


def unstack(blocks, dt) -> list:
    """A block tree -> its per-layer trees, matmul weights cast to the
    compute dtype ``dt`` (``cast_gather_weights``).  A tuple of layers is
    already that.

    A stacked tree ``[L, ...]`` takes one ``unbind`` per leaf: its
    backward stacks the L layer gradients once.  Indexing ``a[i]`` per
    layer instead would give every layer's backward a zero-filled gradient
    of the whole stacked leaf (a 2.9 GB f32 tensor for rwkv6-3b's
    channel-mix weights) to add into."""
    cast = cast_gather_weights(blocks, dt)
    if isinstance(cast, (tuple, list)):
        return list(cast)
    parts = [a.unbind(0) for a in tree_leaves(cast)]
    return [tree_unflatten(cast, [t[i] for t in parts])
            for i in range(len(parts[0]))]


def run_blocks(cfg: LMConfig, layers: list, x, kinds: tuple | None = None,
               enc_out=None, prefix_len: int = 0):
    """Per-layer block trees (``unstack``) of ``kinds`` (default: all of
    the stack's one kind) over x [B, S, D] (positions 0..S-1), one
    activation checkpoint per block when autograd records; the encoder
    memory ``enc_out`` (for "xattn" layers) enters each checkpoint as an
    argument, the bidirectional prefix ``prefix_len`` as a plain int.
    -> (x, summed aux loss)."""
    kinds = kinds or (cfg.layer_kinds[0],) * len(layers)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(layers, kinds, strict=True):
        fn = lambda h, e, p=p, kind=kind: apply_block(  # noqa: E731
            p, h, cfg, kind, positions=positions, enc_out=e,
            prefix_len=prefix_len)
        if torch.is_grad_enabled():
            x, a = checkpoint(fn, x, enc_out, use_reentrant=False)
        else:
            x, a = fn(x, enc_out)
        aux = aux + a
    return x, aux


class LM:
    """LM over a homogeneous stack of attention or RWKV blocks with an
    untied head, a stack of MoE attention blocks, a hybrid stack of
    recurrent and local attention blocks (MoE and hybrid stacks tied or
    untied), an encoder-decoder: a homogeneous "xattn" decoder over an
    "enc" encoder, untied (the "audio" family), or a homogeneous "attn"
    stack behind a patch prefix, tied (the "vlm" family)."""

    def __init__(self, cfg: LMConfig, device):
        if "xattn" in cfg.layer_kinds or cfg.enc_layers \
                or cfg.family == "audio":
            if not (cfg.family == "audio" and cfg.enc_layers
                    and set(cfg.layer_kinds) == {"xattn"}
                    and not cfg.tie_embeddings):
                raise NotImplementedError(
                    f"{cfg.name}: 'xattn' blocks are ported as a "
                    "homogeneous audio decoder over an encoder "
                    "(enc_layers) with an untied head only")
        elif cfg.family == "vlm":
            if not (cfg.homogeneous and cfg.layer_kinds[0] == "attn"
                    and cfg.tie_embeddings and not cfg.is_moe
                    and cfg.num_patches > 0):
                raise NotImplementedError(
                    f"{cfg.name}: the vlm family is ported as a "
                    "homogeneous 'attn' stack with tied embeddings behind "
                    "a patch prefix (num_patches) only")
        elif cfg.family == "hybrid":
            kinds = tuple(k for k in SERVE_KINDS if k != "xattn")
            bad = sorted(set(cfg.layer_kinds) - set(kinds))
            if bad or cfg.is_moe:
                raise NotImplementedError(
                    f"{cfg.name}: hybrid stacks of {kinds} with a dense "
                    f"MLP are ported; not {bad or 'MoE'}")
        elif not cfg.homogeneous \
                or cfg.family not in ("dense", "ssm", "moe") \
                or (cfg.tie_embeddings and cfg.family != "moe"):
            raise NotImplementedError(
                f"{cfg.name}: only homogeneous dense or RWKV stacks with "
                "an untied head, MoE stacks (tied or untied) and hybrid "
                "stacks are ported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = torch_dtype(cfg.dtype)

    # ---------------- init ----------------

    def init(self, generator: torch.Generator, *, master: bool = False):
        """Random parameters drawn from ``generator`` (on ``self.device``):
        matmul weights at the compute dtype, or every tensor in f32 with
        ``master=True`` (training's master weights).  A heterogeneous
        stack's blocks are a tuple of per-layer trees; a tied head has no
        leaf of its own."""
        cfg, dev = self.cfg, self.device
        dt = torch.float32 if master else self.dtype

        def normal(shape, std):
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32).mul_(std)
            return w.to(dt)

        kw = dict(device=dev, weight_dtype=dt)
        params = {
            "embed": normal((cfg.padded_vocab, cfg.d_model), 0.02),
            "final_norm": init_norm(cfg.d_model, cfg.norm, device=dev),
            "blocks": (init_block(generator, cfg, cfg.layer_kinds[0],
                                  layers=cfg.num_layers, **kw)
                       if cfg.homogeneous else
                       tuple(init_block(generator, cfg, kind, **kw)
                             for kind in cfg.layer_kinds)),
        }
        if not cfg.tie_embeddings:
            params["head"] = normal((cfg.d_model, cfg.padded_vocab), 0.02)
        if cfg.enc_layers:
            params["enc_blocks"] = init_block(generator, cfg, "enc",
                                              layers=cfg.enc_layers, **kw)
            params["enc_norm"] = init_norm(cfg.d_model, cfg.norm, device=dev)
        return params

    # ---------------- pieces ----------------

    def _embed(self, params, tokens, dt):
        x = params["embed"].to(dt)[tokens]
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=dt)
        return x

    def _head_w(self, params, dt):
        if self.cfg.tie_embeddings:
            return params["embed"].to(dt).t()
        return params["head"].to(dt)

    def _run_blocks(self, params, x, enc_out=None, prefix_len: int = 0):
        return run_blocks(self.cfg, unstack(params["blocks"], x.dtype), x,
                          _kinds(self.cfg, params["blocks"]), enc_out,
                          prefix_len)

    def _with_prefix(self, batch, x, labels=None):
        """The vlm family's patch prefix: ``batch["patch_embeds"]`` [B, P,
        D] cast to the compute dtype and put before the token embeddings x
        [B, S, D], the labels [B, S] (or None) padded with -1 over it, as
        the reference's ``forward`` does.  -> (x, labels, prefix_len);
        another family's x and labels pass through, prefix 0."""
        if self.cfg.family != "vlm":
            return x, labels, 0
        patches = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([patches, x], dim=1)
        if labels is not None:
            labels = torch.cat([labels.new_full(patches.shape[:2], -1),
                                labels], dim=1)
        return x, labels, patches.shape[1]

    def _encode(self, params, frames):
        """The encoder on stub frame embeddings [B, T, D] (in the compute
        dtype): the sinusoids added, the "enc" stack (one activation
        checkpoint per block when autograd records), ``enc_norm``."""
        cfg = self.cfg
        dt, t = frames.dtype, frames.shape[1]
        pos = _sin_pos(t, cfg.d_model, device=frames.device)
        x = frames + pos.to(dt)[None]
        layers = unstack(params["enc_blocks"], dt)
        x, _ = run_blocks(cfg, layers, x, ("enc",) * len(layers))
        return apply_norm(x, params["enc_norm"], cfg.norm)

    def _encoder_memory(self, params, batch):
        """``_encode`` of the batch's frames for an encoder-decoder, else
        None."""
        if not self.cfg.enc_layers:
            return None
        return self._encode(params, batch["frames"].to(self.dtype))

    # ---------------- training ----------------

    def _xent_chunk(self, hc, lc, w):
        cfg = self.cfg
        logits = _softcap(hc @ w, cfg.logit_softcap).to(torch.float32)
        if cfg.padded_vocab != cfg.vocab:
            pad = torch.arange(cfg.padded_vocab, device=hc.device) >= cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc.clamp_min(0)[..., None])[..., 0]
        mask = (lc >= 0).to(torch.float32)
        return torch.sum((lse - ll) * mask), mask.sum()

    def xent(self, params, h, labels, chunk: int = 512):
        """Chunked softmax cross entropy.  h [B,S,D], labels [B,S] (-1 pad).
        Each chunk's logits are recomputed in the backward pass."""
        s = h.shape[1]
        w = self._head_w(params, h.dtype)
        labels = labels.to(torch.long)
        pad = (-s) % chunk
        if pad:
            h = torch.nn.functional.pad(h, (0, 0, 0, pad))
            labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        count = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(0, s + pad, chunk):
            hc, lc = h[:, c:c + chunk], labels[:, c:c + chunk]
            if torch.is_grad_enabled():
                ls, n = checkpoint(self._xent_chunk, hc, lc, w,
                                   use_reentrant=False)
            else:
                ls, n = self._xent_chunk(hc, lc, w)
            loss_sum, count = loss_sum + ls, count + n
        return loss_sum / torch.clamp_min(count, 1.0)

    def forward(self, params, batch):
        """Training forward.  Returns (loss, metrics); with no labels,
        (final hidden states, {"aux": ...})."""
        x = self._embed(params, batch["tokens"], self.dtype)
        x, labels, prefix_len = self._with_prefix(batch, x,
                                                  batch.get("labels"))
        x, aux = self._run_blocks(params, x,
                                  self._encoder_memory(params, batch),
                                  prefix_len)
        x = apply_norm(x, params["final_norm"], self.cfg.norm)
        if labels is None:
            return x, {"aux": aux}
        loss = self.xent(params, x, labels)
        return loss + 0.01 * aux, {"xent": loss, "aux": aux}

    def hidden(self, params, batch):
        """Final hidden states without loss."""
        out, _ = self.forward(params, {**batch, "labels": None})
        return out

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
        """Zeroed decode state: stacked ``[L, ...]`` for a homogeneous
        stack (``layers`` of them), a tuple of per-layer states for a
        heterogeneous one."""
        cfg = self.cfg
        if not cfg.homogeneous:
            return tuple(init_block_state(cfg, kind, batch, cache_len, dtype,
                                          device=self.device)
                         for kind in cfg.layer_kinds)
        return init_block_state(cfg, cfg.layer_kinds[0], batch, cache_len,
                                dtype, device=self.device,
                                layers=cfg.num_layers if layers is None
                                else layers)

    def prefill_with_cache(self, params, batch, cache_len: int,
                           cache_dtype=torch.bfloat16):
        """One full-sequence forward that also fills the decode cache.

        Returns (last-position logits [B, V] f32, serve_state) with
        ``serve_state = {"cache": ..., "position": S}``.  The audio family
        encodes ``batch["frames"]`` first; each "xattn" layer caches the
        cross K/V of the encoder memory.  The vlm family puts
        ``batch["patch_embeds"]`` [B, P, D] before the tokens (attended
        bidirectionally): then S counts P + the prompt, and ``cache_len``
        must hold them.
        """
        tokens = batch["tokens"]
        enc_out = self._encoder_memory(params, batch)
        x = self._embed(params, tokens, self.dtype)
        x, _, prefix_len = self._with_prefix(batch, x)
        cache = self.init_cache(x.shape[0], cache_len, cache_dtype)
        x = prefill_blocks(self.cfg, params["blocks"], x, cache, enc_out,
                           prefix_len)
        return self.logits(params, x), {"cache": cache,
                                        "position": int(x.shape[1])}

    def fill_cross_kv(self, params, enc_out, cache):
        """Write each "xattn" layer's cross K/V of the encoder memory
        ``enc_out`` [B, Se, D] into ``cache`` (``init_cache``), in place,
        at the cache dtype; returns ``cache``.  Done once before a
        token-by-token prefill: the decode steps then read them."""
        dt = enc_out.dtype
        for p, st in zip(layers_of(params["blocks"]), layers_of(cache),
                         strict=True):
            ck, cv = cross_kv(p["cross"], enc_out, self.cfg, dt)
            st["ck"].copy_(ck)
            st["cv"].copy_(cv)
        return cache

    def decode_step(self, params, tokens, cache, position, active=None,
                    enc_out=None):
        """One serving step: tokens [B, 1] -> (logits [B, V] f32, cache).
        ``cache`` is updated in place and returned.  ``position`` is an
        ``int`` for the batch, or an int64 tensor [B] of per-lane
        positions, with ``active`` [B] bool marking the lanes whose state
        the step may change (the serving engine's slots).  ``enc_out``
        serves an "xattn" cache without cross K/V (they are then
        recomputed each step, the reference's other branch)."""
        x = self._embed(params, tokens, self.dtype)
        x = decode_blocks(self.cfg, params["blocks"], x, cache, position,
                          active, enc_out)
        return self.logits(params, x), cache
