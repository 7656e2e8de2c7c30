"""Flash attention forward: the CUDA kernel and its plain version.

Port of the JAX package's ``kernels/flash_attention.py`` (``flash_attention``)
with ``kernels/ref.py::attention_ref`` as the plain version.

    q [B, Hq, Sq, dh], k/v [B, Hkv, Skv, dh] -> [B, Hq, Sq, dh] in q's dtype

Masks are positional from 0 on both sides (causal ``k <= q``, window
``k > q - window``); GQA maps q head ``h`` to kv head ``h // (Hq/Hkv)``.
``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` on tensors
of any strides with a unit stride along ``dh`` — a ``[B, S, H, dh]``
activation passes as its ``transpose(1, 2)`` view, with no copy — and
writes its output with q's strides.  ``route`` picks the kernel before
the launch: ``"mma"`` (bf16 on the tensor cores, K/V loaded 16 bytes at a
time by ``cp.async``) or ``"simt"`` (f32, and bf16 whose addresses or
strides are not 16-byte aligned); ``ROUTES`` counts the launches of each.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)      # instantiated in the CUDA source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_IDS = {"simt": 0, "mma": 1}
ROUTES: collections.Counter = collections.Counter()


def route(dtype, strides, data_ptrs) -> str:
    """The kernel route for q, k, v and out of ``dtype``: ``strides`` are
    their batch, head and sequence strides in elements, ``data_ptrs`` their
    base addresses.  The tensor-core kernel takes bf16 whose bases are
    16-byte aligned and whose strides are multiples of 8 elements.  A pure
    function of its arguments: it launches nothing."""
    if dtype != torch.bfloat16:
        return "simt"
    if any(s % 8 for s in strides) or any(p % 16 for p in data_ptrs):
        return "simt"
    return "mma"


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Dense softmax attention in f32 (port of ``attention_ref``)."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, hkv, rep, sq, dh).to(torch.float32)
    s = torch.einsum("bkrqd,bksd->bkrqs", qg,
                     k.to(torch.float32)) / math.sqrt(dh)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrqs,bksd->bkrqd", p, v.to(torch.float32))
    return o.reshape(b, hq, sq, dh).to(q.dtype)


_L, _I, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                            ctypes.c_float, _I, _I, _I, _I, _P],
}


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the flash kernel on CUDA tensors (bf16 | f32), on the route
    ``route`` picks (counted in ``ROUTES``)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [B, H, S, dh] with unit stride "
                             f"along dh, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes one of bf16/f32 for q, k, v; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not built (have {HEAD_DIMS})")
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b \
            or k.shape[3] != dh or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    out = torch.empty_like(q)       # keeps q's strides (dense layouts)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    tensors = (q, k, v, out)
    strides = [s for t in tensors for s in t.stride()[:3]]
    how = route(q.dtype, strides, [t.data_ptr() for t in tensors])
    lib = build.load("flash_attention", _SIGNATURES)
    code = lib.flash_attention_fwd(
        *(t.data_ptr() for t in tensors), b, hq, hkv, sq, skv, dh,
        _DTYPES[q.dtype], *strides, 1.0 / math.sqrt(dh), int(bool(causal)),
        int(window), _ROUTE_IDS[how], q.device.index, build.stream_of(q))
    build.check("flash_attention", code, f"flash_attention launch ({how})")
    ROUTES[how] += 1
    return out
