"""Per-block absmax quantizer shared by the wire codec.

Port of the block quantizer of the JAX package's ``training/compress.py``
(``qmax_for``, ``payload_dtype``, ``quantize_blocks``,
``dequantize_blocks``).  These are the plain PyTorch versions the wire
codec kernels (``kernels/wire_codec.py``) are held to bit for bit.
The error-feedback gradient compression waits for the training slice.
"""
from __future__ import annotations

import torch

# Largest representable magnitude per payload dtype: int8 keeps the
# symmetric [-127, 127] range; fp8 uses e4m3 (max 448).
_QMAX = {"int8": 127.0, "fp8": 448.0}


def payload_dtype(wire_dtype: str) -> torch.dtype:
    """The torch dtype a codec puts on the wire."""
    if wire_dtype == "int8":
        return torch.int8
    if wire_dtype == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(
        f"unknown quantized codec {wire_dtype!r} (expected 'int8' or 'fp8')")


def qmax_for(wire_dtype: str) -> float:
    """Largest representable payload magnitude for a quantized codec —
    the constant the quantizer and the CUDA encode kernel share."""
    if wire_dtype not in _QMAX:
        payload_dtype(wire_dtype)  # raise the canonical error
    return _QMAX[wire_dtype]


def _div_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 quotient ``a / b`` on any device.

    Computed in f64 and rounded once to f32, which is exact for division
    (53 >= 2*24 + 2 bits).  PyTorch's own f32 division need not be:
    division by a scalar becomes a multiply by its reciprocal."""
    return (a.to(torch.float64) / b.to(torch.float64)).to(torch.float32)


def quantize_blocks(blocks: torch.Tensor, wire_dtype: str = "int8"):
    """[..., B] fp32 blocks -> (payload int8/fp8-e4m3, fp32 scales [..., 1]).

    Per-block absmax scaling: the block maximum maps to the payload
    dtype's max magnitude.  All-zero blocks keep a clamped tiny scale so
    decode returns exact zeros.  The division is a true f32 division and
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    qmax = qmax_for(wire_dtype)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(_div_f32(amax, torch.full_like(amax, qmax)),
                            1e-12)
    scaled = _div_f32(blocks, scale)
    if wire_dtype == "int8":
        q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    else:
        q = scaled.to(payload_dtype("fp8"))
    return q, scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_blocks`` (fp32 output)."""
    return q.to(torch.float32) * scale
