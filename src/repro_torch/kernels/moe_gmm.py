"""Grouped expert matmul: the CUDA kernel and its plain version.

Port of the JAX package's ``kernels/moe_gmm.py`` (``moe_gmm``) with
``kernels/ref.py::moe_gmm_ref`` as the plain version:

    h [E, C, D] @ w [E, D, F] -> [E, C, F], summed in f32, in h's dtype.

``moe_gmm_cuda`` launches ``csrc/moe_gmm.cu`` on any E, C, D and F, on
one of three routes that ``route`` picks from the inputs' dtype, shape,
strides and addresses before the launch: ``"wgmma"`` (bf16 on the tensor
cores, fed by TMA), ``"wgmma_small_c"`` (the same with the operands
swapped, for C <= ``SMALL_C``: a decode step) and ``"simt"`` (f32, and
bf16 that TMA cannot address).  ``ROUTES`` counts the launches of each.
``moe_gmm_bwd_cuda`` launches the backward, two products (dh, then dw),
on the route ``bwd_route`` picks before the launch: ``"wgmma"`` (bf16 on
the tensor cores, the transposes taken in the TMA maps and the wgmma
descriptors) or ``"simt"`` (f32, and bf16 that TMA cannot address, the
operands read transposed through their strides); ``BWD_ROUTES`` counts
the launches of each.  ``moe_gmm_bwd_plain`` is its plain version.
``kernels/ops.py`` dispatches by device.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_IDS = {"simt": 0, "wgmma": 1, "wgmma_small_c": 2}
SMALL_C = 16            # the largest C of the swapped (small-C) variant
ROUTES: collections.Counter = collections.Counter()
BWD_ROUTES: collections.Counter = collections.Counter()


def _tma_legal(dtype, strides, data_ptrs) -> bool:
    """bf16 that TMA can address: bases 16-byte aligned, every stride a
    multiple of 8 elements (16 bytes)."""
    return dtype == torch.bfloat16 and not any(s % 8 for s in strides) \
        and not any(p % 16 for p in data_ptrs)


def route(dtype, c: int, d: int, strides, data_ptrs) -> str:
    """The kernel route for h [E, C, D] and w [E, D, F] of ``dtype``:
    ``strides`` are h's and w's E and row strides in elements (hse, hsc,
    wse, wsd), ``data_ptrs`` their base addresses.  The tensor-core routes
    take bf16 that TMA can address (``_tma_legal``) and D >= 1.  A pure
    function of its arguments: it launches nothing."""
    if d < 1 or not _tma_legal(dtype, strides, data_ptrs):
        return "simt"
    return "wgmma_small_c" if c <= SMALL_C else "wgmma"


def bwd_route(dtype, dims, strides, data_ptrs) -> str:
    """The backward's kernel route for h [E, C, D], w [E, D, F] and dout
    [E, C, F] of ``dtype``: ``dims`` are (E, C, D, F), ``strides`` the E
    and row strides in elements of h, w and dout (hse, hsc, wse, wsd,
    dose, dosc), ``data_ptrs`` the base addresses of h, w, dout, dh and
    dw.  ``"wgmma"`` takes bf16 that TMA can address (``_tma_legal``)
    with every dimension >= 1; else ``"simt"``.  A pure function of its
    arguments: it launches nothing."""
    if min(dims) < 1 or not _tma_legal(dtype, strides, data_ptrs):
        return "simt"
    return "wgmma"


def moe_gmm_plain(h, w):
    """f32 einsum, cast to h's dtype (the counterpart of ``moe_gmm_ref``).
    Autograd runs through it."""
    return torch.einsum("ecd,edf->ecf", h.to(torch.float32),
                        w.to(torch.float32)).to(h.dtype)


def moe_gmm_bwd_plain(h, w, dout):
    """The backward of ``moe_gmm_plain``: (dh [E, C, D], dw [E, D, F]) with
    ``dh[e] = dout[e] @ w[e]^T`` and ``dw[e] = h[e]^T @ dout[e]``, f32 sums,
    in the dtypes of h and w (what autodiff of the reference's einsums
    gives)."""
    f32 = torch.float32
    dout = dout.to(f32)
    dh = torch.einsum("ecf,edf->ecd", dout, w.to(f32))
    dw = torch.einsum("ecd,ecf->edf", h.to(f32), dout)
    return dh.to(h.dtype), dw.to(w.dtype)


_L, _I, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "moe_gmm_fwd": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I, _I, _I,
                    _P],
    "moe_gmm_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L,
                    _L, _I, _I, _I, _P],
}


def _check(h, w):
    """Raise unless h [E, C, D] and w [E, D, F] are CUDA tensors of one
    dtype (f32 | bf16) with a unit stride on their last axes; -> (E, C, D,
    F)."""
    for name, t in (("h", h), ("w", w)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride on its last "
                             f"axis, got strides {t.stride()}")
    if w.device != h.device:
        raise ValueError(f"w is on {w.device}, h on {h.device}")
    e, c, d = h.shape
    if w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"h {tuple(h.shape)} and w {tuple(w.shape)} do not "
                         "make [E, C, D] @ [E, D, F]")
    if h.dtype not in _DTYPES or w.dtype != h.dtype:
        raise TypeError(f"moe_gmm kernel takes f32 or bf16 h and w of one "
                        f"dtype, got {h.dtype} and {w.dtype}")
    if e > 65535 or -(-max(c, d) // 64) > 65535:
        raise ValueError(f"[E, C, D] = {(e, c, d)} exceeds the kernel's grid")
    return e, c, d, w.shape[2]


def moe_gmm_cuda(h, w):
    """Launch the grouped matmul kernel on CUDA tensors: h [E, C, D] and
    w [E, D, F] of one dtype (f32 | bf16), each with a unit stride on its
    last axis -> a contiguous [E, C, F] in that dtype.  The route is
    chosen by ``route`` and counted in ``ROUTES``."""
    e, c, d, f = _check(h, w)
    strides = (h.stride(0), h.stride(1), w.stride(0), w.stride(1))
    how = route(h.dtype, c, d, strides, (h.data_ptr(), w.data_ptr()))
    out = torch.empty((e, c, f), dtype=h.dtype, device=h.device)
    lib = build.load("moe_gmm", _SIGNATURES)
    code = lib.moe_gmm_fwd(
        h.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f, *strides,
        _DTYPES[h.dtype], _ROUTE_IDS[how], h.device.index,
        build.stream_of(h))
    build.check("moe_gmm", code, f"moe_gmm launch ({how})")
    ROUTES[how] += 1
    return out


def moe_gmm_bwd_cuda(h, w, dout):
    """Launch the backward on CUDA tensors: h and w as ``moe_gmm_cuda``
    takes them, dout [E, C, F] of their dtype (one without a unit stride
    on its last axis is copied first) -> contiguous (dh [E, C, D], dw
    [E, D, F]) in that dtype, on the route ``bwd_route`` picks (counted
    in ``BWD_ROUTES``): one tensor-core kernel over both products' tiles,
    or two SIMT kernels, dh then dw; none where a dimension is 0 (the
    gradients are then zeros)."""
    e, c, d, f = _check(h, w)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    if tuple(dout.shape) != (e, c, f) or dout.dtype != h.dtype \
            or dout.device != h.device:
        raise ValueError(f"dout must be a {h.dtype} [E, C, F] = "
                         f"{(e, c, f)} tensor on {h.device}, got "
                         f"{dout.dtype} {tuple(dout.shape)} on {dout.device}")
    dh = torch.empty((e, c, d), dtype=h.dtype, device=h.device)
    dw = torch.empty((e, d, f), dtype=h.dtype, device=h.device)
    if 0 in (e, c, d, f):
        return dh.zero_(), dw.zero_()
    strides = (h.stride(0), h.stride(1), w.stride(0), w.stride(1),
               dout.stride(0), dout.stride(1))
    ptrs = [t.data_ptr() for t in (h, w, dout, dh, dw)]
    how = bwd_route(h.dtype, (e, c, d, f), strides, ptrs)
    lib = build.load("moe_gmm", _SIGNATURES)
    code = lib.moe_gmm_bwd(*ptrs, e, c, d, f, *strides, _DTYPES[h.dtype],
                           _ROUTE_IDS[how], h.device.index,
                           build.stream_of(h))
    build.check("moe_gmm", code, f"moe_gmm_bwd launch ({how})")
    BWD_ROUTES[how] += 1
    return dh, dw
