"""Quantized wire codec for the cut-activation hop.

Port of the JAX package's ``parallel/wire.py``: the codec grammar, the
degenerate-block net-loss rule, the dense ``encode``/``decode``/
``roundtrip`` and the top-k gradient codec (``topk_encode``/
``topk_decode``).  ``encode`` and ``decode`` go through ``kernels.ops``:
the CUDA kernels for a tensor on the card, their plain versions for a
tensor on the CPU (the port has no "jnp off-TPU" rule).  Top-k is
``torch.topk`` and gathers, as the reference computes it with
``jax.lax.top_k`` outside any Pallas kernel; its kept row is quantized by
the plain block quantizer.

``CodedHop`` is the one-card counterpart of the reference's
``coded_ppermute``: the cut activation goes through encode -> decode, and
its gradient through the same codec on the way back (the straight-through
wire transpose).  ``CodedHopEF`` is that of ``coded_ppermute_ef``, the hop
of a ``+topk`` codec: the dense base codec forward, and backward the
top-k of the cotangent plus the residual of its (stage, tick) slot, the
slot's new residual written back in place.  Each direction's wire bytes
are counted in a ``HopMeter``.

Codec grammar (``parse_wire_dtype``):

    "none" | "int8" | "fp8" | "<base>+topk<frac>"   e.g. "int8+topk0.25"
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.wire_codec import wire_block  # noqa: F401
from repro_torch.training.compress import dequantize_blocks, quantize_blocks

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


def has_topk(wire_dtype) -> bool:
    """True when the codec sparsifies the gradient hop (needs the EF
    buffer threaded through the pipeline)."""
    return parse_wire_dtype(wire_dtype)[1] is not None


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
# Top-k sparsified gradient codec.
# ---------------------------------------------------------------------------


def topk_count(d: int, frac: float) -> int:
    """Entries kept per row of ``d`` under a top-k fraction (>= 1)."""
    return max(1, min(int(d), int(round(frac * d))))


def topk_index_dtype(d: int) -> torch.dtype:
    """int16 wire indices whenever they fit (d <= 32767)."""
    return torch.int16 if int(d) <= 32767 else torch.int32


def topk_encode(x: torch.Tensor, wire_dtype: str):
    """f32 [..., d] -> (payload [..., kk], indices [..., kk] int16/int32,
    fp32 per-row scale [..., 1]) keeping the ``frac*d`` largest-magnitude
    entries per row in descending order, base-quantized against the row
    absmax.  Ties may pick other entries than ``jax.lax.top_k``, which
    prefers the lower index; ``torch.topk`` promises no order among
    equal magnitudes."""
    base, frac = parse_wire_dtype(wire_dtype)
    if frac is None:
        raise ValueError(
            f"wire_dtype {wire_dtype!r} has no top-k fraction — use the "
            "dense encode/decode")
    d = x.shape[-1]
    kk = topk_count(d, frac)
    xf = x.to(torch.float32)
    idx = torch.topk(xf.abs(), kk, dim=-1).indices
    vals = torch.gather(xf, -1, idx)
    q, scale = quantize_blocks(vals, base)   # one "block" = the kept row
    return q, idx.to(topk_index_dtype(d)), scale


def topk_decode(q: torch.Tensor, idx: torch.Tensor, scale: torch.Tensor,
                d: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Scatter the kept entries back into dense [..., d] rows.  An add,
    not a set: indices are unique in a row, and an all-zero payload whose
    indices collide still decodes to exact zeros."""
    vals = dequantize_blocks(q, scale)
    out = torch.zeros(tuple(q.shape[:-1]) + (int(d),), dtype=torch.float32,
                      device=q.device)
    out.scatter_add_(-1, idx.to(torch.int64), vals)
    return out.to(out_dtype)


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


class CodedHopEF(torch.autograd.Function):
    """The hop of a ``+topk`` codec: the dense base codec forward, exactly
    ``CodedHop``'s; backward, ``corrected = g + ef`` ships
    ``topk_decode(topk_encode(corrected))`` at the cotangent's dtype, and
    the slot ``ef`` (f32, the cotangent's shape) takes the dropped mass
    ``corrected - decoded`` in place, once per backward.  At a degenerate
    block (``codec_net_loss``) both directions go raw and the slot keeps
    its residual."""

    @staticmethod
    def forward(ctx, x, ef, wire_dtype: str, meter):
        base, _ = parse_wire_dtype(wire_dtype)
        ctx.wire_dtype, ctx.meter, ctx.ef = wire_dtype, meter, ef
        y, nbytes = _wire_roundtrip(x, base)
        if meter is not None:
            meter.up += nbytes
            meter.hops_up += 1
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        ef, d = ctx.ef, g.shape[-1]
        if codec_net_loss(d, g.element_size()):
            dx, nbytes = g, g.numel() * g.element_size()
        else:
            corrected = g.to(torch.float32) + ef
            q, idx, scale = topk_encode(corrected, ctx.wire_dtype)
            dec = topk_decode(q, idx, scale, d, torch.float32)
            ef.copy_(corrected - dec)
            dx = dec.to(g.dtype)
            nbytes = sum(t.numel() * t.element_size() for t in (q, idx, scale))
        if ctx.meter is not None:
            ctx.meter.down += nbytes
            ctx.meter.hops_down += 1
        return dx, None, None, None


def coded_hop(x: torch.Tensor, wire_dtype: str = "none",
              meter: HopMeter | None = None,
              ef: torch.Tensor | None = None) -> torch.Tensor:
    """One stage-to-stage hop of ``x`` [..., d] under ``wire_dtype``.  A
    ``+topk`` codec needs ``ef``, the f32 error-feedback slot of this hop
    (``x``'s shape), which its backward updates in place."""
    base, frac = parse_wire_dtype(wire_dtype)
    if frac is None:
        return CodedHop.apply(x, base, meter)
    if ef is None:
        raise ValueError(
            f"wire_dtype {wire_dtype!r} sparsifies the gradient hop with "
            "error feedback — pass the hop's f32 residual slot (build the "
            "buffer with pipeline.wire_ef_zeros)")
    if tuple(ef.shape) != tuple(x.shape) or ef.dtype != torch.float32:
        raise ValueError(f"ef slot {tuple(ef.shape)} {ef.dtype} != the "
                         f"hop's {tuple(x.shape)} float32")
    return CodedHopEF.apply(x, ef, format_wire_dtype(base, frac), meter)
