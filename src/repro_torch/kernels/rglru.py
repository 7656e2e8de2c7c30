"""RG-LRU scan: the CUDA kernel and its plain version.

Port of the JAX package's ``kernels/rglru.py`` (``rglru_scan``) with
``kernels/ref.py::rg_lru_ref`` as the plain version.  Per lane, in f32:

    a_t = exp(log_a_t),  h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) x_t

x, log_a [B, S, R]; h0 [B, R] or None (zeros) -> (h [B, S, R], h_last
[B, R]), both in x's dtype, as the Pallas kernel returns them.
``rglru_cuda`` launches ``csrc/rglru.cu`` on any S and R: one pass over
tiles of ``LANES`` lanes by chunks of ``CHUNK`` steps, one CTA each, the
chunks of a tile chained by look-back through scratch that the wrapper
allocates (``tiling`` gives its sizes).  ``kernels/ops.py`` dispatches by
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_H0_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
LANES = 64      # lanes (r) of a tile: csrc/rglru.cu kLanes
CHUNK = 64      # time steps of a chunk: csrc/rglru.cu kChunk
MAX_CTAS = 2 ** 31 - 1


def tiling(b: int, s: int, r: int):
    """(r-tiles, chunks, CTAs) of the kernel's grid for x [b, s, r]: one CTA
    per (batch, r-tile, chunk); S = 0 still takes one chunk, which writes
    h_last.  The scratch is int32 [1 + CTAs] (a ticket counter and a flag
    per CTA, zeroed each call) and f32 [3 * CTAs * LANES] (each chunk's
    aggregate (A, H) and carry, per lane)."""
    n_rt = -(-r // LANES)
    n_chunks = max(1, -(-s // CHUNK))
    return n_rt, n_chunks, b * n_rt * n_chunks


def rglru_plain(x, log_a, h0=None):
    """Sequential scan over S in f32 with the Pallas body's formula (the
    counterpart of ``rg_lru_ref``).  Autograd runs through it."""
    b, s, r = x.shape
    h = torch.zeros((b, r), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.to(torch.float32)
    a = torch.exp(log_a.to(torch.float32))
    bx = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) \
        * x.to(torch.float32)
    hs = []
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        hs.append(h)
    out = torch.stack(hs, dim=1) if hs else torch.zeros_like(
        x, dtype=torch.float32)
    return out.to(x.dtype), h.to(x.dtype)


_L, _I, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "rglru_scan_fwd": [_P, _P, _P, _I, _L, _P, _P, _I, _I, _I,
                       _L, _L, _L, _L, _I, _I, _P, _L, _P, _L, _I, _P],
}


def rglru_cuda(x, log_a, h0=None):
    """Launch the scan kernel on CUDA tensors: x and log_a f32 | bf16 with a
    unit stride along R, h0 f32 | bf16 | f16 with a unit stride along R."""
    named = [("x", x), ("log_a", log_a)] + ([("h0", h0)] if h0 is not None
                                            else [])
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dim() and t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride along R, got "
                             f"strides {t.stride()}")
    if x.dim() != 3 or tuple(log_a.shape) != tuple(x.shape):
        raise ValueError(f"x and log_a must be one [B, S, R] shape, got "
                         f"{tuple(x.shape)} and {tuple(log_a.shape)}")
    b, s, r = x.shape
    if x.dtype not in _DTYPES or log_a.dtype not in _DTYPES:
        raise TypeError(f"rglru kernel takes f32 or bf16 x and log_a, got "
                        f"{x.dtype} and {log_a.dtype}")
    if h0 is not None and (tuple(h0.shape) != (b, r)
                           or h0.dtype not in _H0_DTYPES):
        raise ValueError(f"h0 must be [B, R] = {(b, r)} in one of "
                         f"{list(_H0_DTYPES)}, got {tuple(h0.shape)} "
                         f"{h0.dtype}")
    n_ctas = tiling(b, s, r)[2]
    if n_ctas > MAX_CTAS:
        raise ValueError(f"[{b}, {s}, {r}] needs {n_ctas} CTAs, past the "
                         f"kernel's grid ({MAX_CTAS})")
    h = torch.empty((b, s, r), dtype=x.dtype, device=x.device)
    h_last = torch.empty((b, r), dtype=x.dtype, device=x.device)
    status = torch.zeros(1 + n_ctas, dtype=torch.int32, device=x.device)
    scratch = torch.empty(3 * n_ctas * LANES, dtype=torch.float32,
                          device=x.device)
    lib = build.load("rglru", _SIGNATURES)
    code = lib.rglru_scan_fwd(
        x.data_ptr(), log_a.data_ptr(),
        None if h0 is None else h0.data_ptr(),
        0 if h0 is None else _H0_DTYPES[h0.dtype],
        0 if h0 is None else h0.stride(0),
        h.data_ptr(), h_last.data_ptr(), b, s, r,
        x.stride(0), x.stride(1), log_a.stride(0), log_a.stride(1),
        _DTYPES[x.dtype], _DTYPES[log_a.dtype], status.data_ptr(),
        status.numel(), scratch.data_ptr(), scratch.numel(), x.device.index,
        build.stream_of(x))
    build.check("rglru", code, "rglru_scan launch")
    return h, h_last
