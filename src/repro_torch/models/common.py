"""Shared model building blocks: plain functions on tensors.

Port of the JAX package's ``models/common.py``.  Attention over a whole
sequence (``chunked_attention``) goes through ``kernels.ops.flash_attention``:
the CUDA kernel on the card, its plain version on the CPU.  Single-token
decode attention (``decode_attention``) is plain PyTorch, as the
reference's is plain jnp.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               device, dtype=torch.float32) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32) * scale
    return w.to(dtype)


def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(torch.float32))).to(x.dtype)


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def init_norm(d: int, kind: str, *, device):
    if kind == "rmsnorm":
        return {"w": torch.zeros((d,), dtype=torch.float32, device=device)}
    return {"w": torch.ones((d,), dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device)}


def activation(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    if kind == "relu":
        return F.relu(x)
    if kind == "sqrelu":
        return F.relu(x).square()
    raise ValueError(kind)


# --- rotary embeddings ------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, *, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., S, H, dh]; positions: [..., S] (broadcastable)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)          # [dh/2]
    ang = positions[..., None].to(torch.float32) * freqs    # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- attention --------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      prefix_len: int = 0):
    """Attention over a whole sequence at positions 0..S-1 on both sides
    (the prefill case of the reference's ``chunked_attention``).

    q: [B, Sq, Hq, dh]; k, v: [B, Skv, Hkv, dh] -> [B, Sq, Hq, dh].
    ``prefix_len`` > 0 makes positions below it bidirectional under the
    causal mask (the vlm family's prefix-LM masking).  The flash kernel
    reads the [B, S, H, dh] tensors through their transposed views
    (strides, no copy) and writes its output in the same layout.
    """
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              prefix_len=prefix_len)
    return out.transpose(1, 2)


def _attend_block(q, k, v, mask):
    """q [B,hq,G,dh], k/v [B,hkv,S,dh], mask broadcastable to
    [B,hkv,rep,G,S] bool -> [B,hq,G,dh]."""
    b, hq, g, dh = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    qg = q.reshape(b, hkv, rep, g, dh)
    logits = torch.einsum("bkrgd,bksd->bkrgs", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(dh)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrgs,bksd->bkrgd", p, v.to(torch.float32))
    return out.reshape(b, hq, g, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, position, window: int = 0):
    """Single-token decode: q [B,1,Hq,dh], caches [B,S,Hkv,dh].

    ``position`` is the index of the token being generated, an ``int``
    for the whole batch or an int64 tensor [B] of one position per row
    (the engine's lanes); cache entries at kv index > position (or
    outside the local window) are masked.
    """
    s = k_cache.shape[1]
    kv_pos = torch.arange(s, device=q.device)
    if torch.is_tensor(position):
        position = position[:, None]                        # [B, 1]
    mask = kv_pos <= position                               # [B | 1, S]
    if window > 0:
        mask = mask & (kv_pos > position - window)
    if mask.dim() == 1:
        mask = mask[None]
    out = _attend_block(q.transpose(1, 2), k_cache.transpose(1, 2),
                        v_cache.transpose(1, 2), mask[:, None, None, None])
    return out.transpose(1, 2)
