"""Dispatcher over the kernels, with a launch count on each.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel, which raises when it cannot
(no build, a refused launch, a shape it does not take).  Nothing falls
back.  ``LAUNCHES[name]`` grows by one at each launch of that kernel and
nowhere else, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import wire_codec as _wc

KERNELS = ("wire_encode", "wire_decode", "flash_attention")
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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,Hq,S,dh], k/v [B,Hkv,S,dh] -> [B,Hq,S,dh]."""
    if not _on_cuda(q):
        return _fa.attention_plain(q, k, v, causal=causal, window=window)
    out = _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    LAUNCHES["flash_attention"] += 1
    return out
