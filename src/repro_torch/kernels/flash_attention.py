"""Flash attention forward and backward: the CUDA kernels and their plain
versions.

Port of the JAX package's ``kernels/flash_attention.py`` (``flash_attention``)
with ``kernels/ref.py::attention_ref`` as the plain version.

    q [B, Hq, Sq, dh], k/v [B, Hkv, Skv, dh] -> [B, Hq, Sq, dh] in q's dtype

Masks are positional from 0 on both sides (causal ``k <= q``, or ``k <
prefix_len`` for the prefix-LM's bidirectional prefix, as the reference's
``models/common.py::chunked_attention`` masks; window ``k > q - window``
on top); GQA maps q head ``h`` to kv head ``h // (Hq/Hkv)``.
``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` on tensors
of any strides with a unit stride along ``dh`` — a ``[B, S, H, dh]``
activation passes as its ``transpose(1, 2)`` view, with no copy — and
writes its output with q's strides.  ``route`` picks the kernel before
the launch: ``"mma"`` (bf16 on the tensor cores, K/V loaded 16 bytes at a
time by ``cp.async``) or ``"simt"`` (f32, and bf16 whose addresses or
strides are not 16-byte aligned); ``ROUTES`` counts the launches of each.
With ``with_lse`` it also returns each row's log-sum-exp ``lse [B, Hq, Sq]``
f32 (``attention_plain_lse`` is its plain version).

The backward has no Pallas counterpart: the reference differentiates its
jnp attention (``models/common.py::_attend_block``).
``flash_attention_bwd_cuda`` launches ``csrc/flash_attention_bwd.cu`` (head
dims ``BWD_HEAD_DIMS``) on the route ``bwd_route`` picks before the launch:
``"mma"`` (bf16 at head dims ``BWD_MMA_HEAD_DIMS`` whose eight tensors
``route`` would send to the tensor cores) or ``"simt"`` (f32 sums on the
SIMT pipes, for f32 and every other bf16 call); ``BWD_ROUTES`` counts the
launches of each, apart from the forward's ``ROUTES``.  At head dim 256
the mma route's dK/dV kernel splits each GQA group's query heads over
``dkv_groups`` blocks, whose f32 partials the wrapper's scratch holds and
a last kernel adds in order.
``attention_bwd_plain`` is its plain version, in the same algebra: P
recomputed from lse, ``D = rowsum(dO * O)``.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)      # instantiated in the CUDA source
BWD_HEAD_DIMS = (16, 32, 64, 128, 256)  # SIMT: 256 in tiles of 32 rows
BWD_MMA_HEAD_DIMS = (64, 128, 256)      # the backward's tensor-core kernels
DKV_BLOCKS = 528     # dK/dV blocks wanted at head dim 256: 4 waves of 132
DKV_KEYS = 64        # keys a dK/dV block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_IDS = {"simt": 0, "mma": 1}
ROUTES: collections.Counter = collections.Counter()
BWD_ROUTES: collections.Counter = collections.Counter()


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


def bwd_route(dtype, dh: int, strides, data_ptrs) -> str:
    """The backward's kernel route: ``"mma"`` where ``route`` sends the
    eight tensors (q, k, v, o, dO, dq, dk, dv: their batch, head and
    sequence ``strides`` and base addresses) to the tensor cores and the
    head dim is one of ``BWD_MMA_HEAD_DIMS``, else ``"simt"``.  A pure
    function of its arguments: it launches nothing."""
    if dh not in BWD_MMA_HEAD_DIMS:
        return "simt"
    return route(dtype, strides, data_ptrs)


def dkv_groups(dh: int, rep: int, hkv: int, b: int, skv: int) -> int:
    """The blocks each GQA group's ``rep`` query heads are split over in
    the tensor-core dK/dV kernel: at head dim 256 the fewest that divide
    ``rep`` and give ``DKV_BLOCKS`` blocks of ``DKV_KEYS`` keys (``rep``
    itself where none does), so that one kv head fills the card in waves
    short enough that the causal mask's light blocks even them out; 1 at
    the other head dims.  A pure function of its arguments."""
    if dh != 256:
        return 1
    blocks = hkv * b * -(-skv // DKV_KEYS)
    return next((g for g in range(1, rep + 1)
                 if rep % g == 0 and blocks * g >= DKV_BLOCKS), rep)


def _mask(sq: int, skv: int, causal: bool, window: int, device,
          prefix_len: int = 0):
    """[Sq, Skv] bool: query row i sees key j (positions from 0)."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        seen = k_pos <= q_pos
        if prefix_len > 0:
            seen = seen | (k_pos < prefix_len)
        mask = mask & seen
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    return mask


def _grouped(t, hkv: int):
    """[B, Hq, S, dh] -> [B, Hkv, Hq/Hkv, S, dh] in f32."""
    b, hq, s, dh = t.shape
    return t.reshape(b, hkv, hq // hkv, s, dh).to(torch.float32)


def _logits(q, k, causal: bool, window: int, prefix_len: int = 0):
    """Scaled logits [B, Hkv, rep, Sq, Skv] f32, masked to -1e30, and the
    mask."""
    dh, skv = q.shape[-1], k.shape[2]
    mask = _mask(q.shape[2], skv, causal, window, q.device, prefix_len)
    s = torch.einsum("bkrqd,bksd->bkrqs", _grouped(q, k.shape[1]),
                     k.to(torch.float32)) / math.sqrt(dh)
    return torch.where(mask, s, NEG_INF), mask


def _attend(q, k, v, causal: bool, window: int, prefix_len: int = 0):
    """(out [B, Hq, Sq, dh] in q's dtype, the masked logits)."""
    s, _ = _logits(q, k, causal, window, prefix_len)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrqs,bksd->bkrqd", p, v.to(torch.float32))
    return o.reshape(q.shape).to(q.dtype), s


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix_len: int = 0):
    """Dense softmax attention in f32 (port of ``attention_ref``, with the
    reference's ``prefix_len`` of ``chunked_attention``)."""
    return _attend(q, k, v, causal, window, prefix_len)[0]


def attention_plain_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        prefix_len: int = 0):
    """``attention_plain`` and each row's log-sum-exp of its scaled, masked
    logits: (out [B, Hq, Sq, dh] in q's dtype, lse [B, Hq, Sq] f32).  A row
    without any key has lse -1e30 (-1e30 + log Skv, rounded)."""
    o, s = _attend(q, k, v, causal, window, prefix_len)
    return o, torch.logsumexp(s, dim=-1).reshape(q.shape[:3])


def attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, prefix_len: int = 0):
    """The attention backward in the kernel's algebra, in f32: (dq, dk, dv)
    in the dtypes of q, k, v.  ``o`` and ``lse`` are the forward's output
    and log-sum-exp, ``do`` the output's gradient.

    P = exp(S - lse) where a key is seen (0 elsewhere), D = rowsum(dO * O),
    dV = P^T dO, dP = dO V^T, dS = P * (dP - D), dQ = dS K / sqrt(dh),
    dK = dS^T Q / sqrt(dh), dK and dV summed over the query heads of each
    kv head.  A row without any key (its softmax uniform over the Skv keys
    in the forward) takes P = 1/Skv and dS = 0: it adds dO/Skv to dV and
    nothing to dQ or dK, as the reference's ``where`` mask gives."""
    hkv, skv, dh = k.shape[1], k.shape[2], q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    s, mask = _logits(q, k, causal, window, prefix_len)
    lg = lse.reshape(s.shape[:4])[..., None]
    p = torch.where(mask, torch.exp(s - lg), 0.0)
    p = torch.where(mask.any(-1, keepdim=True), p, 1.0 / max(skv, 1))
    dog = _grouped(do, hkv)
    d = (dog * _grouped(o, hkv)).sum(-1, keepdim=True)
    dp = torch.einsum("bkrqd,bksd->bkrqs", dog, v.to(torch.float32))
    ds = torch.where(mask, p * (dp - d), 0.0)
    dq = torch.einsum("bkrqs,bksd->bkrqd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bkrqs,bkrqd->bksd", ds, _grouped(q, hkv)) * scale
    dv = torch.einsum("bkrqs,bkrqd->bksd", p, dog)
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_L, _I, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                            ctypes.c_float, _I, _I, _I, _I, _I, _P],
}
_BWD_SIGNATURES = {
    "flash_attention_bwd": [_P] * 10 + [_I] * 7
                           + [ctypes.POINTER(_L), ctypes.c_float, _I, _I,
                              _I, _I, _I, _P, _I, _P],
}


def _check_qkv(q, k, v, head_dims):
    """Raise unless q, k, v are CUDA [B, H, S, dh] tensors of one dtype
    (bf16 | f32) with a unit stride along dh, of agreeing shapes and a
    built head dim."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [B, H, S, dh] with unit stride "
                             f"along dh, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    b, hq, _, dh = q.shape
    hkv = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes one of bf16/f32 for q, k, v; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in head_dims:
        raise ValueError(f"head dim {dh} not built (have {head_dims})")
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b \
            or k.shape[3] != dh or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")


def _empty_like(t):
    """An output with ``t``'s strides where they are dense, else
    contiguous; unit stride along dh either way."""
    out = torch.empty_like(t)
    if out.stride(-1) != 1:
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out


def _check_prefix(prefix_len):
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    return int(prefix_len)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         prefix_len: int = 0, with_lse: bool = False):
    """Launch the flash kernel on CUDA tensors (bf16 | f32), on the route
    ``route`` picks (counted in ``ROUTES``).  With ``with_lse`` returns
    (out, lse [B, Hq, Sq] f32), the rows' log-sum-exp the backward reads."""
    _check_qkv(q, k, v, HEAD_DIMS)
    prefix_len = _check_prefix(prefix_len)
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    out = _empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    tensors = (q, k, v, out)
    strides = [s for t in tensors for s in t.stride()[:3]]
    how = route(q.dtype, strides, [t.data_ptr() for t in tensors])
    lib = build.load("flash_attention", _SIGNATURES)
    code = lib.flash_attention_fwd(
        *(t.data_ptr() for t in tensors),
        None if lse is None else lse.data_ptr(), b, hq, hkv, sq, skv, dh,
        _DTYPES[q.dtype], *strides, 1.0 / math.sqrt(dh), int(bool(causal)),
        int(window), prefix_len, _ROUTE_IDS[how], q.device.index,
        build.stream_of(q))
    build.check("flash_attention", code, f"flash_attention launch ({how})")
    ROUTES[how] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, prefix_len: int = 0):
    """Launch the backward kernels on CUDA tensors, on the route
    ``bwd_route`` picks (counted in ``BWD_ROUTES``): (dq, dk, dv) with the
    dtypes of q, k, v and, where dense, their strides.  ``o`` and ``lse``
    come from ``flash_attention_cuda(..., with_lse=True)`` on the same
    inputs and masks (``causal``, ``window``, ``prefix_len``); ``do`` may
    have any strides (one without a unit stride along dh is copied
    first).  Two launches: dQ with D, then dK
    and dV, and at head dim 256 on "mma" with ``dkv_groups`` > 1 a third
    that adds the groups' f32 partials (scratch allocated here); none
    where Sq or Skv is 0, and the gradients are zeros."""
    _check_qkv(q, k, v, BWD_HEAD_DIMS)
    prefix_len = _check_prefix(prefix_len)
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    if do.stride(-1) != 1:
        do = do.contiguous()
    for name, t in (("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype \
                or tuple(t.shape) != tuple(q.shape) or t.stride(-1) != 1:
            raise ValueError(f"{name} must be a {q.dtype} tensor of q's "
                             f"shape {tuple(q.shape)} on {q.device} with a "
                             f"unit stride along dh, got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous f32 [B, Hq, Sq] = "
                         f"{(b, hq, sq)} tensor, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dq, dk, dv = _empty_like(q), _empty_like(k), _empty_like(v)
    if sq == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    d = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    tensors = (q, k, v, o, do, dq, dk, dv)
    flat = [s for t in tensors for s in t.stride()[:3]]
    how = bwd_route(q.dtype, dh, flat, [t.data_ptr() for t in tensors])
    groups = dkv_groups(dh, hq // hkv, hkv, b, skv) if how == "mma" else 1
    part = (torch.empty(2 * groups * b * hkv * skv * dh, dtype=torch.float32,
                        device=q.device) if groups > 1 else None)
    lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
    code = lib.flash_attention_bwd(
        *(t.data_ptr() for t in (q, k, v, o, do, lse, d, dq, dk, dv)),
        b, hq, hkv, sq, skv, dh, _DTYPES[q.dtype], (_L * 24)(*flat),
        1.0 / math.sqrt(dh), int(bool(causal)), int(window), prefix_len,
        _ROUTE_IDS[how], groups, None if part is None else part.data_ptr(),
        q.device.index, build.stream_of(q))
    build.check("flash_attention_bwd", code,
                f"flash_attention_bwd launch ({how})")
    BWD_ROUTES[how] += 1
    return dq, dk, dv
