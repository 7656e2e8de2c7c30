"""Dispatcher over the kernels, with a launch count on each.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel, which raises when it cannot
(no build, a refused launch, a shape it does not take).  Nothing falls
back.  ``LAUNCHES[name]`` grows by one at each launch of that kernel and
nowhere else, so a run can show that its path went through the kernels.

Every kernel but the codec's is differentiable on both devices: on the
CPU autograd runs through the plain versions, on the card through
``_WKV6``, ``_Flash``, ``_RGLRU`` and ``_GMM``, whose backwards are the
hand-written backward kernels (counted as ``wkv6_bwd``,
``flash_attention_bwd``, ``rglru_scan_bwd`` and ``moe_gmm_bwd``, one per
backward call).
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _mg
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import rwkv6 as _rw
from repro_torch.kernels import wire_codec as _wc

KERNELS = ("wire_encode", "wire_decode", "flash_attention",
           "flash_attention_bwd", "wkv6", "wkv6_bwd", "rglru_scan",
           "rglru_scan_bwd", "moe_gmm", "moe_gmm_bwd")
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def wire_encode(x: torch.Tensor, wire_dtype: str = "int8"):
    """[..., d] -> (payload [..., d/b, b], fp32 scales [..., d/b, 1])."""
    if not _on_cuda(x):
        return _wc.encode_plain(x, wire_dtype)
    out = _wc.encode_cuda(x, wire_dtype)
    LAUNCHES["wire_encode"] += 1
    return out


def wire_decode(q: torch.Tensor, scale: torch.Tensor,
                out_dtype=torch.bfloat16):
    """(payload, scales) -> [..., d] at ``out_dtype``."""
    if not _on_cuda(q):
        return _wc.decode_plain(q, scale, out_dtype)
    out = _wc.decode_cuda(q, scale, out_dtype)
    LAUNCHES["wire_decode"] += 1
    return out


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _Flash(torch.autograd.Function):
    """The CUDA flash forward (which also writes each row's log-sum-exp)
    and the backward kernels as one autograd node."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len):
        out, lse = _fa.flash_attention_cuda(q, k, v, causal=causal,
                                            window=window,
                                            prefix_len=prefix_len,
                                            with_lse=True)
        LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, prefix_len=prefix_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                  **ctx.masks)
        LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix_len: int = 0):
    """q [B,Hq,S,dh], k/v [B,Hkv,S,dh] -> [B,Hq,S,dh].  Under ``causal``
    the first ``prefix_len`` keys are seen by every row (prefix-LM)."""
    if not _on_cuda(q):
        return _fa.attention_plain(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len)
    if _records_grad(q, k, v):
        return _Flash.apply(q, k, v, causal, window, prefix_len)
    out = _fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len)
    LAUNCHES["flash_attention"] += 1
    return out


class _WKV6(torch.autograd.Function):
    """The CUDA forward and backward kernels as one autograd node.  The
    decay enters as log w: its gradient is the backward kernel's d log w."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        ctx.set_materialize_grads(False)
        out, s_t = _rw.wkv6_fwd_cuda(r, k, v, logw, u, s0)
        LAUNCHES["wkv6"] += 1
        ctx.save_for_backward(r, k, v, logw, u, s0)
        return out, s_t

    @staticmethod
    def backward(ctx, dout, ds_t):
        r, k, v, logw, u, s0 = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(r)
        dr, dk, dv, dlogw, du, ds0 = _rw.wkv6_bwd_cuda(
            r, k, v, logw, u, s0, dout, ds_t)
        LAUNCHES["wkv6_bwd"] += 1
        return dr, dk, dv, dlogw, du, ds0


def wkv6(r, k, v, logw, u, s0=None):
    """WKV6 on r, k, v [B,S,H,dh], decay ``logw = log w`` [B,S,H,dh] f32,
    bonus u [H,dh] f32, initial state s0 [B,H,dh,dh] f32 or None ->
    (out [B,S,H,dh] in r's dtype, final state [B,H,dh,dh] f32)."""
    if not _on_cuda(r):
        return _rw.wkv6_plain(r, k, v, logw, u, s0)
    if _records_grad(r, k, v, logw, u, s0):
        return _WKV6.apply(r, k, v, logw, u, s0)
    out = _rw.wkv6_fwd_cuda(r, k, v, logw, u, s0)
    LAUNCHES["wkv6"] += 1
    return out


class _RGLRU(torch.autograd.Function):
    """The CUDA scan and its backward kernel as one autograd node; the
    backward reads the forward's output h for h_{t-1}."""

    @staticmethod
    def forward(ctx, x, log_a, h0):
        ctx.set_materialize_grads(False)
        h, h_last = _rg.rglru_cuda(x, log_a, h0)
        LAUNCHES["rglru_scan"] += 1
        ctx.save_for_backward(x, log_a, h0, h)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        x, log_a, h0, h = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        dx, dla, dh0 = _rg.rglru_bwd_cuda(x, log_a, h0, h, dh, dh_last)
        LAUNCHES["rglru_scan_bwd"] += 1
        return dx, dla, dh0


def rglru_scan(x, log_a, h0=None):
    """RG-LRU scan: x, log_a [B,S,R], h0 [B,R] or None -> (h [B,S,R],
    h_last [B,R]) in x's dtype, carried in f32."""
    if not _on_cuda(x):
        return _rg.rglru_plain(x, log_a, h0)
    if _records_grad(x, log_a, h0):
        return _RGLRU.apply(x, log_a, h0)
    out = _rg.rglru_cuda(x, log_a, h0)
    LAUNCHES["rglru_scan"] += 1
    return out


class _GMM(torch.autograd.Function):
    """The grouped matmul kernel and its backward kernel (dh and dw) as one
    autograd node."""

    @staticmethod
    def forward(ctx, h, w):
        out = _mg.moe_gmm_cuda(h, w)
        LAUNCHES["moe_gmm"] += 1
        ctx.save_for_backward(h, w)
        return out

    @staticmethod
    def backward(ctx, dout):
        h, w = ctx.saved_tensors
        dh, dw = _mg.moe_gmm_bwd_cuda(h, w, dout)
        LAUNCHES["moe_gmm_bwd"] += 1
        return dh, dw


def moe_gmm(h, w):
    """Grouped expert matmul: h [E,C,D] @ w [E,D,F] -> [E,C,F] in h's
    dtype, summed in f32."""
    if not _on_cuda(h):
        return _mg.moe_gmm_plain(h, w)
    if _records_grad(h, w):
        return _GMM.apply(h, w)
    out = _mg.moe_gmm_cuda(h, w)
    LAUNCHES["moe_gmm"] += 1
    return out
