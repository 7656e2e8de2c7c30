"""The flash forward's tensor-core route ("mma") at whisper-small's calls,
emulated on the CPU, against the element gate the card holds it to.

``csrc/flash_attention.cu``'s ``flash_fwd_mma`` walks the keys in tiles of
64 with a running row max m: P = exp(S - m) in f32, summed unrounded into
l, rounded to bf16 for P V (f32 sums), and o = acc / l rounded to bf16
once.  On the card (chip_smoke.py ``FLASH_FWD_ELEM``,
``tests/test_torch_cuda.py::test_flash_kernel_at_whisper_calls``) o is
held element by element to |o - p| <= 1e-3 + 2^-7 P|V| against the plain
version in f32, P the plain softmax.  This file repeats the route's
arithmetic and shows three things at those calls: the route lies inside
the gate; a gate on |o| instead fails it at the causal self-attention
(|o| cancels, while P's rounding grows with P|V|); and a route that leaves
out the P V of the last key tile (28 live keys of 1500 = 23 x 64 + 28, 44
of 300, 32 of 224) fails the gate.  Imports torch only.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

ATOL, RTOL = 1e-3, 2 ** -7       # FLASH_FWD_ELEM["bfloat16"]
KEYS = 64                        # key tile of flash_fwd_mma at head dim 64

# (b, h, sq, skv, causal): whisper's encoder, its cross-attention of 224
# rows on 1500 frames, a small ragged Skv, its decoder self-attention;
# heads cut from 12 where the call is large
CASES = [(1, 4, 1500, 1500, False), (1, 12, 224, 1500, False),
         (1, 4, 100, 300, False), (2, 12, 224, 224, True)]


def _inputs(case, seed=0):
    b, h, sq, skv, _ = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, 64))
                             .astype(np.float32)).to(torch.bfloat16)
            for s in (sq, skv, skv)]


def fwd_mma(q, k, v, causal, *, drop_last_tile=False):
    """The "mma" route's arithmetic on bf16 inputs: out [B, H, Sq, 64]
    bf16.  ``drop_last_tile`` leaves the last key tile out of P V (its P
    still enters l), as a kernel that lost the ragged edge would."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    sq, skv = q.shape[2], k.shape[2]
    s = qf @ kf.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(torch.ones(sq, skv, dtype=torch.bool).triu(1),
                          -math.inf)
    m = torch.full(q.shape[:3] + (1,), -math.inf)
    l = torch.zeros(q.shape[:3] + (1,))
    acc = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, skv, KEYS):
        st = s[..., k0:k0 + KEYS]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        if not (drop_last_tile and k0 + KEYS >= skv):
            acc = acc + p.to(torch.bfloat16).float() @ vf[..., k0:k0 + KEYS, :]
        m = m_new
    return (acc / l).to(torch.bfloat16)


def _share(o, q, k, v, causal, *, scale_by_pv=True):
    """The worst element's error as a share of its limit."""
    f32 = [t.float() for t in (q, k, v)]
    want = fa.attention_plain(*f32, causal=causal)
    size = (fa.attention_plain(f32[0], f32[1], f32[2].abs(), causal=causal)
            if scale_by_pv else want.abs())
    return float(((o.float() - want).abs() / (ATOL + RTOL * size)).max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_route_lies_inside_the_gate(case):
    q, k, v = _inputs(case)
    share = _share(fwd_mma(q, k, v, case[4]), q, k, v, case[4])
    assert share <= 0.75, share


def test_a_gate_on_o_fails_the_route_at_causal_self_attention():
    case = CASES[-1]
    q, k, v = _inputs(case)
    o = fwd_mma(q, k, v, True)
    assert _share(o, q, k, v, True, scale_by_pv=False) > 1.0
    assert _share(o, q, k, v, True) <= 0.75


@pytest.mark.parametrize("case", [c for c in CASES if c[3] % KEYS],
                         ids=str)
def test_the_gate_fails_a_route_without_the_ragged_tile(case):
    q, k, v = _inputs(case)
    o = fwd_mma(q, k, v, case[4], drop_last_tile=True)
    assert _share(o, q, k, v, case[4]) > 4.0
