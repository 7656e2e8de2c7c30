"""Griffin/RecurrentGemma recurrent block: conv1d + RG-LRU (arXiv:2402.19427).

Port of the JAX package's ``models/recurrent.py``.  The RG-LRU is a
diagonal linear recurrence with data-dependent decay:

    r_t = sigmoid(x_t W_a),  i_t = sigmoid(x_t W_x)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence scan goes through ``kernels.ops.rglru_scan`` at every
length: the CUDA kernel on the card, its plain version on the CPU.  (The
reference's model runs an associative scan, chunked above 256 steps; the
Pallas kernel computes the same function in one pass.)  The gates
``gate_a``, ``gate_x`` and ``lambda`` are consumed in f32, and the scan
runs on f32 inputs, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init

RG_LRU_C = 8.0


def init_recurrent(generator: torch.Generator, d_model: int, r_width: int,
                   conv_width: int, *, device, weight_dtype=torch.float32):
    """Matmul weights at ``weight_dtype``; the gates, lambda and the conv
    bias in f32 (``lm._KEEP_F32``: consumed in f32, or 1-D)."""
    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        return lo + (hi - lo) * u

    # Lambda init so that a^c lands in [0.9, 0.999] (paper appendix).
    u = uniform((r_width,), 0.9, 0.999)
    lam = torch.log(torch.expm1(-torch.log(u) / RG_LRU_C))  # softplus^-1
    dense = lambda d_in, d_out, dt=weight_dtype: dense_init(
        generator, d_in, d_out, device=device, dtype=dt)
    conv_w = torch.randn((conv_width, r_width), generator=generator,
                         device=device, dtype=torch.float32) * 0.1
    return {
        "in_x": dense(d_model, r_width),
        "in_y": dense(d_model, r_width),
        "conv_w": conv_w.to(weight_dtype),
        "conv_b": torch.zeros((r_width,), dtype=torch.float32, device=device),
        "gate_a": dense(r_width, r_width, torch.float32),
        "gate_x": dense(r_width, r_width, torch.float32),
        "lambda": lam,
        "out": dense(r_width, d_model),
    }


def causal_conv1d(x, w, b):
    """Depthwise causal conv.  x: [B, S, R], w: [W, R]."""
    width, s = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for j in range(width):
        shifted = F.pad(x, (0, 0, j, 0))[:, :s]
        out = out + shifted * w[width - 1 - j]
    return out + b


def _gates(p, xf):
    """(i, log a) from the conv output in f32."""
    r = torch.sigmoid(xf @ p["gate_a"].to(torch.float32))
    i = torch.sigmoid(xf @ p["gate_x"].to(torch.float32))
    log_a = -RG_LRU_C * F.softplus(p["lambda"].to(torch.float32)) * r
    return i, log_a


def apply_recurrent(p, x, dt=torch.bfloat16, return_state: bool = False):
    """Full-sequence forward.  x: [B, S, D] -> [B, S, D]; with
    ``return_state`` also the decode state {"h": [B, R], "conv":
    [B, W-1, R]}, both f32."""
    w = lambda n: p[n].to(dt)
    y = F.gelu(x @ w("in_y"), approximate="tanh")    # jax.nn.gelu's default
    xr_raw = x @ w("in_x")
    xr = causal_conv1d(xr_raw, w("conv_w"), w("conv_b"))

    xf = xr.to(torch.float32)
    i, log_a = _gates(p, xf)
    h, h_last = ops.rglru_scan(i * xf, log_a)
    out = (h.to(dt) * y) @ w("out")
    if not return_state:
        return out
    width = p["conv_w"].shape[0]
    tail = xr_raw[:, -(width - 1):]
    pad = (width - 1) - tail.shape[1]
    if pad > 0:                       # sequence shorter than the conv
        tail = F.pad(tail, (0, 0, pad, 0))
    return out, {"h": h_last, "conv": tail.to(torch.float32)}


def init_recurrent_state(batch: int, r_width: int, conv_width: int, *,
                         device, dtype=torch.float32):
    return {
        "h": torch.zeros((batch, r_width), dtype=dtype, device=device),
        "conv": torch.zeros((batch, conv_width - 1, r_width), dtype=dtype,
                            device=device),
    }


def apply_recurrent_decode(p, x, state, dt=torch.bfloat16):
    """Single-token decode.  x: [B, 1, D] -> ([B, 1, D], new_state).  The
    conv history is f32, so the conv runs in f32 on the history and the
    weights rounded to ``dt`` (the reference's type promotion)."""
    w = lambda n: p[n].to(dt)
    y = F.gelu(x @ w("in_y"), approximate="tanh")
    xr = (x @ w("in_x"))[:, 0]                                    # [B, R]
    hist = torch.cat([state["conv"], xr[:, None].to(state["conv"].dtype)],
                     dim=1)                                       # [B, W, R]
    cw = w("conv_w").to(hist.dtype)
    xr = torch.einsum("bwr,wr->br", hist, cw) + w("conv_b").to(hist.dtype)
    new_conv = hist[:, 1:]

    xf = xr.to(torch.float32)
    i, log_a = _gates(p, xf)
    a = torch.exp(log_a)
    h = a * state["h"] + torch.sqrt(torch.clamp_min(1 - a * a, 1e-12)) \
        * (i * xf)
    out = (h[:, None].to(dt) * y) @ w("out")
    return out, {"h": h, "conv": new_conv}

