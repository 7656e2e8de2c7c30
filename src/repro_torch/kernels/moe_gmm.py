"""Grouped expert matmul: the CUDA kernel and its plain version.

Port of the JAX package's ``kernels/moe_gmm.py`` (``moe_gmm``) with
``kernels/ref.py::moe_gmm_ref`` as the plain version:

    h [E, C, D] @ w [E, D, F] -> [E, C, F], summed in f32, in h's dtype.

``moe_gmm_cuda`` launches ``csrc/moe_gmm.cu`` on any E, C, D and F;
``kernels/ops.py`` dispatches by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def moe_gmm_plain(h, w):
    """f32 einsum, cast to h's dtype (the counterpart of ``moe_gmm_ref``).
    Autograd runs through it."""
    return torch.einsum("ecd,edf->ecf", h.to(torch.float32),
                        w.to(torch.float32)).to(h.dtype)


_L, _I, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "moe_gmm_fwd": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I, _I, _P],
}


def moe_gmm_cuda(h, w):
    """Launch the grouped matmul kernel on CUDA tensors: h [E, C, D] and
    w [E, D, F] of one dtype (f32 | bf16), each with a unit stride on its
    last axis -> a contiguous [E, C, F] in that dtype."""
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
    f = w.shape[2]
    if e > 65535 or -(-c // 64) > 65535:
        raise ValueError(f"[E, C] = {(e, c)} exceeds the kernel's grid")
    out = torch.empty((e, c, f), dtype=h.dtype, device=h.device)
    lib = build.load("moe_gmm", _SIGNATURES)
    code = lib.moe_gmm_fwd(
        h.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
        h.stride(0), h.stride(1), w.stride(0), w.stride(1),
        _DTYPES[h.dtype], h.device.index, build.stream_of(h))
    build.check("moe_gmm", code, "moe_gmm launch")
    return out
