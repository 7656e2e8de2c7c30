"""RG-LRU scan: the CUDA kernel and its plain version.

Port of the JAX package's ``kernels/rglru.py`` (``rglru_scan``) with
``kernels/ref.py::rg_lru_ref`` as the plain version.  Per lane, in f32:

    a_t = exp(log_a_t),  h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) x_t

x, log_a [B, S, R]; h0 [B, R] or None (zeros) -> (h [B, S, R], h_last
[B, R]), both in x's dtype, as the Pallas kernel returns them.
``rglru_cuda`` launches ``csrc/rglru.cu`` on any S and R: one pass over
tiles of ``LANES`` lanes by chunks of ``CHUNK`` steps, one CTA each, the
chunks of a tile chained by look-back through scratch that the wrapper
allocates (``tiling`` gives its sizes).  ``rglru_bwd_cuda`` launches the
backward, the same look-back run from the last chunk (its plain version
``rglru_bwd_plain``).  ``kernels/ops.py`` dispatches by device.
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


def rglru_bwd_plain(x, log_a, h0, h, dh, dh_last=None):
    """The backward of ``rglru_plain`` in f32, from its output ``h``:
    (dx, dlog_a, dh0) in the dtypes of x, log_a and h0 (dh0 None without
    h0).  With a_t = exp(l_t), c_t = sqrt(max(1 - a_t^2, 1e-12)) and
    h_{-1} = h0 (or 0): the reverse scan g_t = dh_t + a_{t+1} g_{t+1},
    dh_last added at the last step; dx_t = c_t g_t; dl_t = g_t (a_t h_{t-1}
    - [1 - a_t^2 > 1e-12] a_t^2 x_t / c_t); dh0 = a_0 g_0."""
    f32 = torch.float32
    b, s, r = x.shape
    xf, a = x.to(f32), torch.exp(log_a.to(f32))
    one_m = 1.0 - a * a
    c = torch.sqrt(torch.clamp_min(one_m, 1e-12))
    prev = torch.zeros((b, 1, r), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)[:, None]
    h_prev = torch.cat([prev, h.to(f32)[:, :-1]], dim=1)
    dhf = dh.to(f32)
    g = torch.zeros((b, r), dtype=f32, device=x.device) \
        if dh_last is None else dh_last.to(f32)
    gs = [None] * s
    for t in range(s - 1, -1, -1):
        g = dhf[:, t] + (a[:, t + 1] * g if t + 1 < s else g)
        gs[t] = g
    gt = torch.stack(gs, dim=1) if s else torch.zeros_like(xf)
    dx = c * gt
    dl = gt * (a * h_prev - torch.where(one_m > 1e-12, a * a * xf / c, 0.0))
    dh0 = None
    if h0 is not None:
        dh0 = (a[:, 0] * gt[:, 0] if s else g).to(h0.dtype)
    return dx.to(x.dtype), dl.to(log_a.dtype), dh0


_L, _I, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "rglru_scan_fwd": [_P, _P, _P, _I, _L, _P, _P, _I, _I, _I,
                       _L, _L, _L, _L, _I, _I, _P, _L, _P, _L, _I, _P],
    "rglru_scan_bwd": [_P, _P, _P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _L, _L, _L, _L, _I, _I, _P, _L, _P, _L, _I, _P],
}


def _check(x, log_a, h0):
    """Raise unless x, log_a [B, S, R] and h0 [B, R] (or None) are CUDA
    tensors the kernels take; -> the CTAs of the grid."""
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
    return n_ctas


def _scratch(x, n_ctas):
    """The zeroed tickets and flags and the look-back scratch of a call."""
    return (torch.zeros(1 + n_ctas, dtype=torch.int32, device=x.device),
            torch.empty(3 * n_ctas * LANES, dtype=torch.float32,
                        device=x.device))


def rglru_cuda(x, log_a, h0=None):
    """Launch the scan kernel on CUDA tensors: x and log_a f32 | bf16 with a
    unit stride along R, h0 f32 | bf16 | f16 with a unit stride along R."""
    n_ctas = _check(x, log_a, h0)
    b, s, r = x.shape
    h = torch.empty((b, s, r), dtype=x.dtype, device=x.device)
    h_last = torch.empty((b, r), dtype=x.dtype, device=x.device)
    status, scratch = _scratch(x, n_ctas)
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


def rglru_bwd_cuda(x, log_a, h0, h, dh, dh_last=None):
    """Launch the backward kernel on CUDA tensors: x, log_a and h0 as
    ``rglru_cuda`` takes them, ``h`` its output, ``dh`` h's gradient and
    ``dh_last`` h_last's (or None), of h's shapes and x's dtype (copied
    to be contiguous where they are not) -> (dx, dlog_a, dh0) as
    ``rglru_bwd_plain`` returns them."""
    n_ctas = _check(x, log_a, h0)
    b, s, r = x.shape
    h, dh = h.contiguous(), dh.contiguous()
    if dh_last is not None:
        dh_last = dh_last.contiguous()
    for name, t, shape in (("h", h, (b, s, r)), ("dh", dh, (b, s, r)),
                           ("dh_last", dh_last, (b, r))):
        if t is not None and (tuple(t.shape) != shape or t.dtype != x.dtype
                              or t.device != x.device):
            raise ValueError(f"{name} must be a {x.dtype} {shape} tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    dx = torch.empty((b, s, r), dtype=x.dtype, device=x.device)
    dla = torch.empty((b, s, r), dtype=log_a.dtype, device=x.device)
    dh0 = None if h0 is None else torch.empty(
        (b, r), dtype=torch.float32, device=x.device)
    status, scratch = _scratch(x, n_ctas)
    lib = build.load("rglru", _SIGNATURES)
    code = lib.rglru_scan_bwd(
        x.data_ptr(), log_a.data_ptr(),
        None if h0 is None else h0.data_ptr(),
        0 if h0 is None else _H0_DTYPES[h0.dtype],
        0 if h0 is None else h0.stride(0), h.data_ptr(), dh.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), dx.data_ptr(),
        dla.data_ptr(), None if dh0 is None else dh0.data_ptr(), b, s, r,
        x.stride(0), x.stride(1), log_a.stride(0), log_a.stride(1),
        _DTYPES[x.dtype], _DTYPES[log_a.dtype], status.data_ptr(),
        status.numel(), scratch.data_ptr(), scratch.numel(), x.device.index,
        build.stream_of(x))
    build.check("rglru", code, "rglru_scan_bwd launch")
    return dx, dla, None if dh0 is None else dh0.to(h0.dtype)
