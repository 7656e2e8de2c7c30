"""Wire codec kernels for the cut-activation hop, and their plain versions.

Port of the JAX package's ``kernels/wire_codec.py`` (``encode_fused`` /
``decode_fused``).  Layout contract, identical to the reference:

    x [..., d]  ->  payload [..., d/b, b] int8|fp8-e4m3, scales [..., d/b, 1]

with ``b = wire_block(d)``, the largest divisor of d <= 256, so the wire
never carries padding bytes.  ``encode_cuda`` / ``decode_cuda`` launch the
hand-written kernel in ``csrc/wire_codec.cu``; ``encode_plain`` /
``decode_plain`` are the plain PyTorch versions (the block quantizer of
``training/compress.py``), which the kernels are held to bit for bit.
The decode kernel runs one warp per block on one of two routes, which
``decode_route`` names before the launch: ``"warp256"`` (b = 256, payload
8-byte and output 16-byte aligned: vector loads and stores) or
``"strided"`` (any other b or alignment); ``ROUTES`` counts the decode
launches of each.  ``kernels/ops.py`` picks between kernel and plain
version by the tensor's device.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.training.compress import (dequantize_blocks, payload_dtype,
                                           qmax_for, quantize_blocks)

_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WIRE = {"int8": 0, "fp8": 1}
ROUTES: collections.Counter = collections.Counter()


def wire_block(dim: int, block: int = 256) -> int:
    """Largest block size <= ``block`` dividing ``dim`` (no padding)."""
    b = min(block, max(dim, 1))
    while dim % b:
        b -= 1
    return b


def decode_route(b: int, q_ptr: int, out_ptr: int) -> str:
    """The decode kernel's route for blocks of ``b`` payload bytes at
    address ``q_ptr`` written to ``out_ptr``: the vector route takes b = 256
    with the payload 8-byte and the output 16-byte aligned, as its loads
    and stores need (the test of ``launch_decode`` in csrc/wire_codec.cu).
    A pure function of its arguments: it launches nothing."""
    if b == 256 and q_ptr % 8 == 0 and out_ptr % 16 == 0:
        return "warp256"
    return "strided"


# ---------------------------------------------------------------- plain


def encode_plain(x: torch.Tensor, wire_dtype: str):
    d = x.shape[-1]
    b = wire_block(d)
    blocks = x.to(torch.float32).reshape(x.shape[:-1] + (d // b, b))
    return quantize_blocks(blocks, wire_dtype)


def decode_plain(q: torch.Tensor, scale: torch.Tensor, out_dtype):
    x = dequantize_blocks(q, scale)
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],)).to(out_dtype)


# ---------------------------------------------------------------- CUDA


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "wire_encode": [_P, _P, _P, _LL, _I, _I, _I, ctypes.c_float, _I, _P],
    "wire_decode": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
}


def _lib():
    return build.load("wire_codec", _SIGNATURES)


def _check_cuda(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def encode_cuda(x: torch.Tensor, wire_dtype: str):
    """Launch the encode kernel on a CUDA tensor [..., d] (bf16 | f32)."""
    _check_cuda(x, "encode input")
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"encode kernel takes bf16 or f32, got {x.dtype}")
    d = x.shape[-1]
    b = wire_block(d)
    nb = d // b
    lead = tuple(x.shape[:-1])
    q = torch.empty(lead + (nb, b), dtype=payload_dtype(wire_dtype),
                    device=x.device)
    scale = torch.empty(lead + (nb, 1), dtype=torch.float32, device=x.device)
    code = _lib().wire_encode(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), x.numel() // b, b,
        _IN_DTYPES[x.dtype], _WIRE[wire_dtype], qmax_for(wire_dtype),
        x.device.index, build.stream_of(x))
    build.check("wire_codec", code, "wire_encode launch")
    return q, scale


def decode_cuda(q: torch.Tensor, scale: torch.Tensor, out_dtype):
    """Launch the decode kernel: (payload, scales) -> [..., d] at
    ``out_dtype`` (bf16 | f32), on the route ``decode_route`` names
    (counted in ``ROUTES``)."""
    _check_cuda(q, "decode payload")
    _check_cuda(scale, "decode scales")
    if out_dtype not in _IN_DTYPES:
        raise TypeError(f"decode kernel writes bf16 or f32, not {out_dtype}")
    wire = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}.get(q.dtype)
    if wire is None:
        raise TypeError(f"decode payload must be int8 or fp8, got {q.dtype}")
    if scale.dtype != torch.float32 or \
            tuple(scale.shape) != tuple(q.shape[:-1]) + (1,):
        raise ValueError(f"scales {tuple(scale.shape)} {scale.dtype} do not "
                         f"match payload {tuple(q.shape)}")
    nb, b = q.shape[-2], q.shape[-1]
    out = torch.empty(tuple(q.shape[:-2]) + (nb * b,), dtype=out_dtype,
                      device=q.device)
    code = _lib().wire_decode(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), q.numel(), b,
        _WIRE[wire], _IN_DTYPES[out_dtype], q.device.index,
        build.stream_of(q))
    build.check("wire_codec", code, "wire_decode launch")
    if q.numel():
        ROUTES[decode_route(b, q.data_ptr(), out.data_ptr())] += 1
    return out
