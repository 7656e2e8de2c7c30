"""WKV6 (RWKV6 time-mix recurrence): the CUDA kernels and their plain versions.

Port of the JAX package's ``kernels/rwkv6.py`` (``wkv6``, a chunked Pallas
kernel).  The plain versions are the reference's ``models/rwkv.py::
wkv6_scan`` / ``wkv6_chunked``, ported here beside the kernel (the port's
``models/rwkv.py`` re-exports them).  Per (batch, head), with an f32
state S [dh, dh]:

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

r, k, v: [B, S, H, dh]; w (decay in (0, 1]): [B, S, H, dh] f32; u: [H, dh];
s0: [B, H, dh, dh] f32 or None.  Returns (out [B, S, H, dh] in r's dtype,
final state [B, H, dh, dh] f32).

The kernels (``csrc/wkv6.cu``) take the decay as ``logw = log w``, so the
backward kernel returns d log w, which stays finite where w underflows.
``wkv6_fwd_cuda`` / ``wkv6_bwd_cuda`` launch them; ``kernels/ops.py`` wires
them into autograd.  ``route`` picks the kernels before the launch:
``"chunked"`` (bf16 at head dim 64 with 16-byte aligned bases: the
chunked form on the tensor cores, two launches forward, and two backward
plus the sum of du's per-chunk partials) or ``"simt"`` (f32, which keeps
the 1e-4 contract, and the other bf16 calls: the step-by-step scan);
``ROUTES`` counts the launches of each, as ``"wkv6:<route>"`` and
``"wkv6_bwd:<route>"``.  ``wkv6_plain`` is what a CPU tensor takes: the
reference's dispatch, ``wkv6_scan`` for S <= 64 and ``wkv6_chunked`` above.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build

WKV_CHUNK = 64
HEAD_DIMS = (16, 32, 64)                # instantiated in the CUDA source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_IDS = {"simt": 0, "chunked": 1}
ROUTES: collections.Counter = collections.Counter()


def route(dtype, dh, data_ptrs=()) -> str:
    """The kernel route for r, k, v (and dout) of ``dtype`` at head dim
    ``dh``: the tensor-core kernels take bf16 at dh 64 whose bases (in
    ``data_ptrs``) are 16-byte aligned, as ``cp.async`` loads them.  A
    pure function of its arguments: it launches nothing."""
    if dtype != torch.bfloat16 or dh != 64:
        return "simt"
    if any(p % 16 for p in data_ptrs):
        return "simt"
    return "chunked"


# ---------------------------------------------------------------- plain


def wkv6_scan(r, k, v, w, u, s0=None):
    """Step-by-step WKV6 (the reference's ``wkv6_scan``), f32 state."""
    b, s, h, dh = r.shape
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32,
                        device=r.device) if s0 is None else s0
    rf, kf, vf, wf = (a.to(torch.float32) for a in (r, k, v, w))
    ub = u[None, :, :, None]
    outs = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # [B,H,dh,dh]
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, t], state + ub * kv))
        state = wf[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1).to(r.dtype), state


def wkv6_chunked(r, k, v, w, u, s0=None, chunk: int = WKV_CHUNK):
    """Chunked WKV6 (the reference's ``wkv6_chunked``): per chunk of C
    steps, with cumulative log-decay ``L_t = sum_{j<t} log w_j``,

        o_t = (r_t e^{L_t})^T S_in + sum_{j<t} [r_t e^{L_t}].[k_j e^{-L_{j+1}}] v_j
              + (r_t . (u * k_t)) v_t
        S_out = diag(e^{L_C}) S_in + sum_j diag(e^{L_C - L_{j+1}}) k_j v_j^T

    with the intra term's two factors split around m = L_C / 2."""
    b, s, h, dh = r.shape
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32,
                        device=r.device) if s0 is None else s0.float()
    pad = (-s) % chunk
    rf, kf, vf, wf = (a.to(torch.float32) for a in (r, k, v, w))
    if pad:
        zp = lambda a, val=0.0: torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, pad), value=val)
        rf, kf, vf = zp(rf), zp(kf), zp(vf)
        wf = zp(wf, 1.0)                   # w = 1 => state unchanged
    n = (s + pad) // chunk
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                   device=r.device), -1)
    outs = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, wc = rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl]
        logw = torch.log(torch.clamp_min(wc, 1e-30))
        lcum = torch.cumsum(logw, dim=1)                   # L_{t+1}
        l_t = lcum - logw                                  # L_t
        l_total = lcum[:, -1:]                             # L_C
        m = 0.5 * l_total
        r_t = rc * torch.exp(l_t - m)
        k_j = kc * torch.exp(m - lcum)
        att = torch.einsum("bthi,bjhi->bhtj", r_t, k_j) * causal
        diag = torch.einsum("bthi,bthi->bth", rc, u[None, None] * kc)
        o = torch.einsum("bhtj,bjhi->bthi", att, vc) + diag[..., None] * vc
        o = o + torch.einsum("bthi,bhij->bthj", rc * torch.exp(l_t), state)
        k_hat = kc * torch.exp(l_total - lcum)
        state = torch.exp(l_total[:, 0, :, :, None]) * state \
            + torch.einsum("bjhi,bjhd->bhid", k_hat, vc)
        outs.append(o)
    out = torch.cat(outs, dim=1)[:, :s]
    return out.to(r.dtype), state


def wkv6_plain(r, k, v, logw, u, s0=None):
    """The reference's model-side dispatch on ``w = exp(logw)``: the scan
    for S <= 64, the chunked form above.  Autograd runs through it."""
    w = torch.exp(logw)
    fn = wkv6_scan if r.shape[1] <= WKV_CHUNK else wkv6_chunked
    return fn(r, k, v, w, u, s0=s0)


# ---------------------------------------------------------------- CUDA


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "wkv6_fwd": [_P] * 9 + [_I] * 7 + [_P],
    "wkv6_bwd": [_P] * 19 + [_I] * 7 + [_P],
}


def _lib():
    return build.load("wkv6", _SIGNATURES)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_inputs(r, k, v, logw, u, s0):
    if r.dim() != 4:
        raise ValueError(f"r must be [B, S, H, dh], got {tuple(r.shape)}")
    b, s, h, dh = r.shape
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6 kernel takes one of bf16/f32 for r, k, v; "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not built (have {HEAD_DIMS})")
    want = {"k": (k, tuple(r.shape), None), "v": (v, tuple(r.shape), None),
            "logw": (logw, tuple(r.shape), torch.float32),
            "u": (u, (h, dh), torch.float32)}
    if s0 is not None:
        want["s0"] = (s0, (b, h, dh, dh), torch.float32)
    for name, t in [("r", r)] + [(n, w[0]) for n, w in want.items()]:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, (t, shape, dt) in want.items():
        if tuple(t.shape) != shape or (dt is not None and t.dtype != dt):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{shape} {dt or r.dtype}")
    return b, s, h, dh


def _route_of(*tensors):
    return route(tensors[0].dtype, tensors[0].shape[-1],
                 [t.data_ptr() for t in tensors])


def _states(b, s, h, dh, device):
    """Scratch of the chunked route: the state at every chunk boundary."""
    return torch.empty((b, h, -(-s // WKV_CHUNK) + 1, dh, dh),
                       dtype=torch.float32, device=device)


def wkv6_fwd_cuda(r, k, v, logw, u, s0=None):
    """Launch the forward kernels on the route ``route`` picks (counted in
    ``ROUTES``).  -> (out like r, final state f32)."""
    b, s, h, dh = _check_inputs(r, k, v, logw, u, s0)
    how = _route_of(r, k, v, logw)
    out = torch.empty_like(r)
    s_t = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    states = _states(b, s, h, dh, r.device) if how == "chunked" else None
    code = _lib().wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), _ptr(s0), out.data_ptr(), s_t.data_ptr(),
        _ptr(states), b, s, h, dh, _DTYPES[r.dtype], _ROUTE_IDS[how],
        r.device.index, build.stream_of(r))
    build.check("wkv6", code, f"wkv6_fwd launch ({how})")
    ROUTES[f"wkv6:{how}"] += 1
    return out, s_t


def wkv6_bwd_cuda(r, k, v, logw, u, s0, dout, ds_t=None):
    """Launch the backward kernels on the route ``route`` picks (counted
    in ``ROUTES``).  ``dout`` is the gradient of ``out`` (cast to r's
    dtype), ``ds_t`` that of the final state or None.
    -> (dr, dk, dv like r, dlogw f32, du [H, dh] f32, ds0 f32 or None)."""
    b, s, h, dh = _check_inputs(r, k, v, logw, u, s0)
    dout = dout.to(r.dtype).contiguous()
    if ds_t is not None:
        ds_t = ds_t.to(torch.float32).contiguous()
    how = _route_of(r, k, v, logw, dout)
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = torch.empty_like(r), torch.empty_like(r), torch.empty_like(r)
    dlogw = torch.empty_like(logw)
    ds0 = None if s0 is None else torch.empty((b, h, dh, dh), **f32)
    p = q = f = states = dstates = None
    if how == "chunked":               # du per (b, chunk)
        du_part = torch.empty((b * -(-s // WKV_CHUNK), h, dh), **f32)
        states, dstates = (_states(b, s, h, dh, r.device) for _ in range(2))
    else:                              # du per batch; P, Q, F of the scan
        du_part = torch.empty((b, h, dh), **f32)
        p, q = (torch.empty((b, s, h, dh), **f32) for _ in range(2))
        f = torch.empty((b, h, dh), **f32)
    code = _lib().wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), _ptr(s0), dout.data_ptr(), _ptr(ds_t),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
        du_part.data_ptr(), _ptr(ds0), _ptr(p), _ptr(q), _ptr(f),
        _ptr(states), _ptr(dstates), b, s, h, dh, _DTYPES[r.dtype],
        _ROUTE_IDS[how], r.device.index, build.stream_of(r))
    build.check("wkv6", code, f"wkv6_bwd launch ({how})")
    ROUTES[f"wkv6_bwd:{how}"] += 1
    return dr, dk, dv, dlogw, du_part.sum(dim=0), ds0
