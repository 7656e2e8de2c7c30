"""Quantized wire codec for the cut-activation hop (dense forward codec).

Port of the dense half of the JAX package's ``parallel/wire.py``: the
codec grammar, the degenerate-block net-loss rule and
``encode``/``decode``/``roundtrip``.  ``encode`` and ``decode`` go through
``kernels.ops``: the CUDA kernels for a tensor on the card, their plain
versions for a tensor on the CPU (the port has no "jnp off-TPU" rule).

``CodedHop`` is the one-card counterpart of the reference's
``coded_ppermute``: the cut activation goes through encode -> decode, and
its gradient through the same codec on the way back (the straight-through
wire transpose), with the wire bytes of each direction counted in a
``HopMeter``.  Top-k sparsification with error feedback on the gradient
hop is not ported yet.

Codec grammar (``parse_wire_dtype``):

    "none" | "int8" | "fp8" | "<base>+topk<frac>"   e.g. "int8+topk0.25"
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.wire_codec import wire_block  # noqa: F401

WIRE_DTYPES = ("none", "int8", "fp8")   # base codecs


def parse_wire_dtype(wire_dtype):
    """Codec name -> ``(base, topk_frac | None)``.

    Accepts 'none' / 'int8' / 'fp8' and '<base>+topk<frac>' (e.g.
    'int8+topk0.25').  ``frac >= 1`` keeps every entry, so it normalizes
    to the dense base codec (frac None) — 'int8+topk1.0' IS 'int8'.
    """
    w = "none" if wire_dtype is None else str(wire_dtype).strip().lower()
    base, sep, suffix = w.partition("+")
    frac = None
    if sep:
        if not suffix.startswith("topk"):
            raise ValueError(
                f"wire_dtype {wire_dtype!r}: unknown modifier {suffix!r} "
                "(expected '<base>+topk<frac>', e.g. 'int8+topk0.25')")
        try:
            frac = float(suffix[len("topk"):])
        except ValueError:
            raise ValueError(
                f"wire_dtype {wire_dtype!r}: top-k fraction "
                f"{suffix[len('topk'):]!r} is not a number")
        if not frac > 0.0:
            raise ValueError(
                f"wire_dtype {wire_dtype!r}: top-k fraction must be > 0")
        if frac >= 1.0:
            frac = None           # keeps everything == dense base codec
    if base not in WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype {wire_dtype!r} base {base!r} not in {WIRE_DTYPES} "
            "— 'none' ships the raw activation, 'int8'/'fp8' block-"
            "quantize the hop, '<base>+topk<frac>' adds top-k + error "
            "feedback on the gradient hop")
    if frac is not None and base == "none":
        raise ValueError(
            f"wire_dtype {wire_dtype!r}: top-k rides a quantized payload "
            "— use 'int8+topk<frac>' or 'fp8+topk<frac>'")
    return base, frac


def format_wire_dtype(base: str, frac) -> str:
    return base if frac is None else f"{base}+topk{frac:g}"


def validate_wire_dtype(wire_dtype) -> str:
    """Normalize + validate a codec name; returns the canonical spelling
    ('int8+topk1.0' normalizes to 'int8')."""
    base, frac = parse_wire_dtype(wire_dtype)
    return format_wire_dtype(base, frac)


def codec_net_loss(d: int, act_itemsize: int) -> bool:
    """True when the dense codec would INFLATE the wire for this width:
    ``1 + 4/block`` bytes/element >= the raw element width (block=1 at a
    prime d_model costs 5 B/elt — worse than bf16 or fp32)."""
    b = wire_block(int(d))
    return (1.0 + 4.0 / b) >= float(act_itemsize)


_NET_LOSS_WARNED: set = set()


def _warn_net_loss_once(wire_dtype, d: int, dtype: torch.dtype):
    key = (str(wire_dtype), int(d), str(dtype))
    if key in _NET_LOSS_WARNED:
        return
    _NET_LOSS_WARNED.add(key)
    b = wire_block(int(d))
    warnings.warn(
        f"wire codec {wire_dtype!r} is a net loss at d_model={d}: block "
        f"{b} costs {1.0 + 4.0 / b:.2f} wire bytes/element vs "
        f"{dtype.itemsize} raw ({dtype}) — shipping the raw activation "
        "instead (pick a d_model with a divisor <= 256, or "
        "wire_dtype='none')")


def encode(x: torch.Tensor, wire_dtype: str):
    """[..., d] activation -> (payload [..., d/b, b], fp32 scales
    [..., d/b, 1]) for a quantized codec, on x's device.

    Degenerate blocks (``codec_net_loss``) fall back to the raw payload:
    returns ``(x, None)`` with a one-time warning, which ``decode``
    passes through unchanged — the hop then ships exactly the raw bytes.
    """
    d = x.shape[-1]
    if codec_net_loss(d, x.element_size()):
        _warn_net_loss_once(wire_dtype, d, x.dtype)
        return x, None
    return ops.wire_encode(x.contiguous(), wire_dtype)


def decode(payload: torch.Tensor, scale, out_dtype: torch.dtype):
    """Inverse of ``encode``: back to [..., d] at the activation dtype.
    ``scale=None`` is the raw net-loss fallback — passthrough."""
    if scale is None:
        return payload.to(out_dtype)
    return ops.wire_decode(payload, scale, out_dtype)


def roundtrip(x: torch.Tensor, wire_dtype: str):
    """encode->decode without the hop — the codec's numerical identity
    (what the receiver gets when the link is lossless)."""
    q, s = encode(x, wire_dtype)
    return decode(q, s, x.dtype)


# ---------------------------------------------------------------------------
# The coded hop between pipeline stages, with its backward.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HopMeter:
    """Wire bytes of the coded hop: payload + scale bytes (raw bytes for
    'none' and the net-loss fallback), per direction."""
    up: int = 0            # forward: cut activations
    down: int = 0          # backward: their gradients
    hops_up: int = 0
    hops_down: int = 0

    def reset(self) -> None:
        self.up = self.down = self.hops_up = self.hops_down = 0


def _wire_roundtrip(x: torch.Tensor, wire_dtype: str):
    """What the receiving stage gets, and the bytes that crossed."""
    if wire_dtype == "none":
        return x, x.numel() * x.element_size()
    q, s = encode(x, wire_dtype)
    nbytes = q.numel() * q.element_size()
    if s is not None:
        nbytes += s.numel() * s.element_size()
    return decode(q, s, x.dtype), nbytes


class CodedHop(torch.autograd.Function):
    """encode -> decode of the cut activation; the backward codes the
    cotangent the same way (the straight-through transpose: quantization
    is piecewise constant, so its true derivative is zero almost
    everywhere; the downlink payload is quantized like the uplink's)."""

    @staticmethod
    def forward(ctx, x, wire_dtype: str, meter):
        ctx.wire_dtype, ctx.meter = wire_dtype, meter
        y, nbytes = _wire_roundtrip(x, wire_dtype)
        if meter is not None:
            meter.up += nbytes
            meter.hops_up += 1
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        dx, nbytes = _wire_roundtrip(g.contiguous(), ctx.wire_dtype)
        if ctx.meter is not None:
            ctx.meter.down += nbytes
            ctx.meter.hops_down += 1
        return dx, None, None


def coded_hop(x: torch.Tensor, wire_dtype: str = "none",
              meter: HopMeter | None = None) -> torch.Tensor:
    """One stage-to-stage hop of ``x`` [..., d] under ``wire_dtype``."""
    base, frac = parse_wire_dtype(wire_dtype)
    if frac is not None:
        raise NotImplementedError(
            f"wire_dtype {wire_dtype!r}: top-k with error feedback on the "
            "gradient hop is not ported yet (dense none/int8/fp8 only)")
    return CodedHop.apply(x, base, meter)
