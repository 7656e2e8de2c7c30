"""Per-block absmax quantizer and gradient compression with error feedback.

Port of the JAX package's ``training/compress.py``.  ``quantize_blocks``
and ``dequantize_blocks`` are the plain PyTorch versions the wire codec
kernels (``kernels/wire_codec.py``) are held to bit for bit, and the top-k
gradient hop quantizes its kept entries with them (``parallel/wire.py``).

``compress_grads`` is EF-SGD on the gradients: each tensor, plus its
residual, is quantized per 256-element block to int8 with an fp32 scale,
and the quantization error is fed back into the next step's gradient
(``parallel/steps.py::make_lm_train_step(compress=True)``, ``launch/train.py
--compress-grads``).  ``quantize`` / ``dequantize`` go through
``kernels.ops.wire_encode`` / ``wire_decode`` on the padded ``[-1, 256]``
f32 view: the codec kernels at block 256 on the card, their plain versions
on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten

BLOCK = 256

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


def _pad_len(n: int) -> int:
    return (BLOCK - n % BLOCK) % BLOCK


def quantize(g: torch.Tensor, wire_dtype: str = "int8"):
    """fp32 tensor -> (payload [n/256, 256], fp32 scales [n/256, 1],
    original shape), the flat tensor zero-padded to a multiple of 256."""
    from repro_torch.kernels import ops
    flat = g.reshape(-1).to(torch.float32)
    pad = _pad_len(flat.shape[0])
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scale = ops.wire_encode(flat.reshape(-1, BLOCK), wire_dtype)
    return q.reshape(-1, BLOCK), scale.reshape(-1, 1), tuple(g.shape)


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of ``quantize``: f32 tensor of ``shape``."""
    from repro_torch.kernels import ops
    flat = ops.wire_decode(q.reshape(-1, 1, BLOCK), scale.reshape(-1, 1, 1),
                           torch.float32).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def _compress_one(g: torch.Tensor, e: torch.Tensor):
    """One leaf: ((q, scale, shape), deq(Q(g + e)), (g + e) - deq(...))."""
    corrected = g.to(torch.float32) + e
    q, s, shp = quantize(corrected)
    deq = dequantize(q, s, shp)
    return (q, s, shp), deq, corrected - deq


def compress_grads(grads, error_fb):
    """Apply EF: g' = Q(g + e); new e = (g + e) - deq(Q(g + e)).

    Returns (quantized tree, new error-feedback tree); the quantized tree
    holds (q, scale, shape) triples, what would travel the wire."""
    out = [_compress_one(g, e) for g, e in zip(
        tree_leaves(grads), tree_leaves(error_fb), strict=True)]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[2] for o in out]))


def compress_grads_(grads, error_fb) -> None:
    """``compress_grads`` then ``decompress_grads``, one leaf at a time
    and in place: each gradient becomes its decompressed value and each
    residual its new value, with one encode and one decode a leaf (the
    decode the residual needs is the decompressed gradient, bit for bit).
    A second f32 tree of either would not fit beside AdamW's state at
    full width."""
    for g, e in zip(tree_leaves(grads), tree_leaves(error_fb), strict=True):
        _, deq, new_e = _compress_one(g, e)
        e.copy_(new_e)
        g.copy_(deq)
        del deq, new_e


def decompress_grads(qtree):
    is_triple = lambda x: isinstance(x, tuple) and len(x) == 3 \
        and isinstance(x[2], tuple)
    return _map_over(lambda t: dequantize(*t), qtree, is_triple)


def init_error_fb(params):
    """Zero f32 residuals shaped like the parameters."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _map_over(fn, tree, is_leaf):
    """``tree_map`` that stops at the nodes ``is_leaf`` accepts."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_over(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_over(fn, v, is_leaf) for v in tree)
    return fn(tree)
