"""RWKV6 "Finch" block (arXiv:2404.05892): data-dependent decay WKV.

Port of the JAX package's ``models/rwkv.py``.  Time-mix recurrence per
head (dh = head dim):

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with decay w_t = exp(-exp(w0 + tanh(x W_A) W_B)).  The recurrence goes
through ``kernels.ops.wkv6``: the CUDA kernels on the card, on the CPU the
plain versions ``wkv6_scan`` (S <= 64) and ``wkv6_chunked`` (above), which
live beside the kernel in ``kernels/rwkv6.py``.  The decay is handed over
as ``log w = -exp(decay)``, so its gradient never divides by a w that has
underflowed.

Parameters keep the reference's names and layout; ``init_*`` draw them
from a ``torch.Generator`` with the reference's distributions, one layer
or ``layers`` of them stacked ``[L, ...]``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6 import (WKV_CHUNK, wkv6_chunked,  # noqa: F401
                                       wkv6_scan)

# matmul weights: stored at the weight dtype; everything else stays f32
MATMUL_WEIGHTS = ("w_r", "w_k", "w_v", "w_g", "w_o")


def _drawer(generator, device, layers):
    lead = () if layers is None else (layers,)

    def uniform(*shape):
        return torch.rand(lead + shape, generator=generator, device=device)

    def normal(*shape, std=1.0):
        return torch.randn(lead + shape, generator=generator,
                           device=device).mul_(std)

    def full(value, *shape):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=device)
    return uniform, normal, full


def init_rwkv_time(generator, d_model: int, head_dim: int, lora: int, *,
                   device, weight_dtype=torch.float32, layers=None):
    uniform, normal, full = _drawer(generator, device, layers)
    dense = lambda d_in, d_out: normal(d_in, d_out, std=1 / math.sqrt(d_in))
    p = {
        "mu_r": uniform(d_model), "mu_k": uniform(d_model),
        "mu_v": uniform(d_model), "mu_w": uniform(d_model),
        "mu_g": uniform(d_model),
        "w_r": dense(d_model, d_model), "w_k": dense(d_model, d_model),
        "w_v": dense(d_model, d_model), "w_g": dense(d_model, d_model),
        "w_o": dense(d_model, d_model),
        "w0": full(-6.0, d_model),                    # slow decay init
        "w_a": dense(d_model, lora), "w_b": dense(lora, d_model),
        "u": normal(d_model // head_dim, head_dim, std=0.1),
        "ln_w": full(1.0, d_model), "ln_b": full(0.0, d_model),
    }
    return {n: (t.to(weight_dtype) if n in MATMUL_WEIGHTS else t)
            for n, t in p.items()}


def init_rwkv_channel(generator, d_model: int, d_ff: int, *, device,
                      weight_dtype=torch.float32, layers=None):
    uniform, normal, _ = _drawer(generator, device, layers)
    dense = lambda d_in, d_out: normal(d_in, d_out, std=1 / math.sqrt(d_in))
    p = {"mu_k": uniform(d_model), "mu_r": uniform(d_model),
         "w_k": dense(d_model, d_ff), "w_v": dense(d_ff, d_model),
         "w_r": dense(d_model, d_model)}
    return {n: (t.to(weight_dtype) if n in MATMUL_WEIGHTS else t)
            for n, t in p.items()}


def _last(x, shift_in):
    """The token before x's first: zeros, or ``shift_in`` (a decode
    cache's shift, which may be stored wider than x) at x's dtype."""
    if shift_in is None:
        return torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype,
                           device=x.device)
    return shift_in.to(x.dtype)


def _token_shift(x, last):
    """shifted_t = x_{t-1}; position 0 uses ``last``."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _group_norm(x, w, b, n_heads: int, eps: float = 64e-5):
    """Per-head layernorm of the WKV output, in f32 (RWKV convention)."""
    b_, s, d = x.shape
    xh = x.reshape(b_, s, n_heads, d // n_heads).to(torch.float32)
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b_, s, d) * w + b).to(x.dtype)


def apply_rwkv_time(p, x, head_dim: int, *, shift_in=None, state_in=None,
                    dt=torch.bfloat16):
    """Time-mix.  x: [B, S, D].  Returns (out, (last_x, state))."""
    b, s, d = x.shape
    h = d // head_dim
    last = _last(x, shift_in)
    sh = _token_shift(x, last)
    mix = lambda mu: x + (sh - x) * p[mu].to(x.dtype)
    w_ = lambda n: p[n].to(dt)

    r = (mix("mu_r") @ w_("w_r")).reshape(b, s, h, head_dim)
    k = (mix("mu_k") @ w_("w_k")).reshape(b, s, h, head_dim)
    v = (mix("mu_v") @ w_("w_v")).reshape(b, s, h, head_dim)
    g = F.silu(mix("mu_g") @ w_("w_g"))
    xw = mix("mu_w").to(torch.float32)
    decay = p["w0"].to(torch.float32) + torch.tanh(
        xw @ p["w_a"].to(torch.float32)) @ p["w_b"].to(torch.float32)
    logw = (-torch.exp(decay)).reshape(b, s, h, head_dim)

    out, final = ops.wkv6(r, k, v, logw, p["u"].to(torch.float32),
                          s0=state_in)
    out = _group_norm(out.reshape(b, s, d), p["ln_w"].to(torch.float32),
                      p["ln_b"].to(torch.float32), h)
    out = (out * g) @ w_("w_o")
    return out, (x[:, -1], final)


def apply_rwkv_channel(p, x, *, shift_in=None, dt=torch.bfloat16):
    last = _last(x, shift_in)
    sh = _token_shift(x, last)
    mix = lambda mu: x + (sh - x) * p[mu].to(x.dtype)
    w_ = lambda n: p[n].to(dt)
    k = torch.square(F.relu(mix("mu_k") @ w_("w_k")))
    r = torch.sigmoid(mix("mu_r") @ w_("w_r"))
    return r * (k @ w_("w_v")), x[:, -1]
