"""The flash backward's tensor-core route ("mma"), emulated on the CPU.

``csrc/flash_attention_bwd.cu`` runs bf16 at head dims 64, 128 and 256 on
``mma.sync`` (namespaces ``bwd_mma`` and ``bwd256``): bf16 operands and f32
sums, with P and dS entering their products as a bf16 high part plus a
bf16 low part.
This file repeats that arithmetic in PyTorch, tile by tile, and walks the
tiles as the two kernels do:

* ``flash_bwd_dq_mma``: per q tile of 64 rows, the kv tiles of ``KEYS_DQ``
  keys from the window's first reach to the causal diagonal; S = q k^T
  and dP = dO v^T in f32, P = exp(S / sqrt(dh) - lse), dS = P (dP - D),
  dQ += (hi + lo of dS) k, dQ scaled once at the end;
* ``flash_bwd_dkv_mma``: per kv tile of 64 keys, the query heads of its
  GQA group and the q tiles of ``ROWS_DKV`` rows that see it (the causal
  diagonal to the window's reach) or hold rows without a key (P = 1/Skv,
  dS = 0); dV += (hi + lo of P)^T dO, dK += (hi + lo of dS)^T q.  At head
  dim 256 (``flash_bwd_dkv_mma256``) each GQA group's query heads are split
  over ``flash_attention.dkv_groups`` blocks, each summing its heads into
  f32 partials that a last kernel adds in group order before dK's scale
  and the bf16 rounding.

The result is held to ``attention_bwd_plain`` under the card's gates
(chip_smoke.py ``FLASH_TOL`` and ``FLASH_BWD_ELEM``): 5e-2 absolute and
|g - p| <= 1e-3 + 2^-7 |p| element by element, on bf16 inputs made from
numpy seeds.  P and dS rounded to bf16 alone break the element gate,
which is why the kernels carry the low parts.  The file also pins
``bwd_route``, which picks the route before the launch.  Imports torch
only.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32
TOL = 5e-2                       # FLASH_TOL["bfloat16"]
ATOL, RTOL = 1e-3, 2 ** -7       # FLASH_BWD_ELEM["bfloat16"]
ROWS_DQ, KEYS_DKV = 64, 64       # 4 warps of 16 rows (dq) or keys (dkv)
# keys a kv tile of flash_bwd_dq_mma, q rows a tile of flash_bwd_dkv_mma,
# by head dim (csrc/flash_attention_bwd.cu `bwd_mma::Cfg`)
KEYS_DQ = {64: 64, 128: 64, 256: 64}
ROWS_DKV = {64: 64, 128: 32, 256: 64}

# (name, B, Hq, Hkv, Sq, Skv, dh, causal, window)
CASES = [
    ("qwen_training_call", 2, 20, 20, 512, 512, 128, True, 0),
    ("granite_gqa", 2, 24, 8, 512, 512, 64, True, 0),
    ("window", 2, 4, 4, 300, 300, 128, True, 64),
    ("rows_without_keys", 1, 1, 1, 256, 128, 64, True, 16),
    ("ragged_bidirectional", 1, 4, 2, 130, 130, 64, False, 0),
    ("gqa10_dh256_window", 1, 10, 1, 200, 200, 256, True, 48),
]


def _inputs(case, seed):
    """bf16 q, k, v, dO [B, H, S, dh] from numpy, the forward's output
    (f32 attention rounded to bf16, as the kernel writes it) and its
    lse."""
    _, b, hq, hkv, sq, skv, dh, causal, window = case
    rng = np.random.default_rng(seed)

    def mk(h, s):
        return torch.from_numpy(
            rng.standard_normal((b, h, s, dh)).astype(np.float32)).to(BF16)
    q, k, v, do = mk(hq, sq), mk(hkv, skv), mk(hkv, skv), mk(hq, sq)
    o, lse = fa.attention_plain_lse(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
    return q, k, v, o.to(BF16), lse, do


def _hi_lo(x):
    """f32 x as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), each
    back in f32: the kernels' A fragments of P and dS."""
    hi = x.to(BF16).to(F32)
    return hi, (x - hi).to(BF16).to(F32)


def _product(a, b, parts):
    """a @ b with a in bf16 parts (both, or hi alone), f32 sums."""
    hi, lo = _hi_lo(a)
    return hi @ b + lo @ b if parts == 2 else hi @ b


def _masks(rows, keys, sq, skv, causal, window):
    """(seen [r, k], no_key [r, 1]) for absolute row and key indices."""
    qi, kj = rows[:, None], keys[None, :]
    seen = (qi < sq) & (kj < skv)
    if causal:
        seen &= kj <= qi
    if window > 0:
        seen &= kj > qi - window
    no_key = (qi < sq) & (window > 0) & (qi - window + 1 >= skv)
    return seen, no_key & (kj < skv)


def emulate_dq(q, k, v, o, lse, do, causal, window, parts=2):
    """dq [B, Hq, Sq, dh] f32 and D [B, Hq, Sq], in flash_bwd_dq_mma's
    tile order and roundings."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep, bk, scale = hq // hkv, KEYS_DQ[dh], 1.0 / math.sqrt(dh)
    # a q head reads its kv head: repeat the kv heads over the group
    kf, vf = (t.float().repeat_interleave(rep, dim=1) for t in (k, v))
    qf, dof = q.float(), do.float()
    d = (dof * o.float()).sum(-1)
    dq = torch.zeros_like(qf)
    for q0 in range(0, sq, ROWS_DQ):
        q_last = min(q0 + ROWS_DQ, sq) - 1
        kt_end = -(-skv // bk)
        if causal:
            kt_end = min(kt_end, q_last // bk + 1)
        kt_begin = max(q0 - window + 1, 0) // bk if window > 0 else 0
        rows = torch.arange(q0, q0 + ROWS_DQ)
        r = slice(q0, q_last + 1)
        acc = torch.zeros((b, hq, q_last + 1 - q0, dh))
        for kt in range(kt_begin, kt_end):
            k0 = kt * bk
            seen, _ = _masks(rows, torch.arange(k0, k0 + bk), sq, skv,
                             causal, window)
            seen = seen[:q_last + 1 - q0]
            c = slice(k0, min(k0 + bk, skv))
            seen = seen[:, :c.stop - k0]
            s = qf[:, :, r] @ kf[:, :, c].transpose(-1, -2)
            p = torch.where(seen, torch.exp(s * scale - lse[:, :, r, None]),
                            0.0)
            dp = dof[:, :, r] @ vf[:, :, c].transpose(-1, -2)
            ds = torch.where(seen, p * (dp - d[:, :, r, None]), 0.0)
            acc += _product(ds, kf[:, :, c], parts)
        dq[:, :, r] = acc * scale
    return dq, d


def emulate_dkv(q, k, v, lse, do, d, causal, window, parts=2):
    """(dk, dv) [B, Hkv, Skv, dh] f32 in flash_bwd_dkv_mma's walk: each kv
    tile over its group's query heads and the q tiles it visits, the heads
    split over ``dkv_groups`` blocks whose f32 partials add in order."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep, bq, scale = hq // hkv, ROWS_DKV[dh], 1.0 / math.sqrt(dh)
    groups = fa.dkv_groups(dh, rep, hkv, b, skv)
    n_qt = -(-sq // bq)
    uniform = 1.0 / skv
    qf, dof, kf, vf = (t.float() for t in (q, do, k, v))
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, skv, KEYS_DKV):
        k_last = min(k0 + KEYS_DKV, skv) - 1
        c = slice(k0, k_last + 1)
        qt_lo = k0 // bq if causal else 0
        reach = k_last + window - 1 if window > 0 else sq - 1
        qt_hi = min(reach, sq - 1) // bq
        first_no_key = skv + window - 1
        qt_nokey = first_no_key // bq if window > 0 and first_no_key < sq \
            else n_qt
        part_k = torch.zeros((groups, b, hkv, k_last + 1 - k0, dh))
        part_v = torch.zeros_like(part_k)
        for hh in range(rep):
            acc_k, acc_v = part_k[hh // (rep // groups)], \
                part_v[hh // (rep // groups)]
            heads = torch.arange(hkv) * rep + hh
            for qt in range(qt_lo, n_qt):
                if qt_hi < qt < qt_nokey:
                    continue
                q0 = qt * bq
                r = slice(q0, min(q0 + bq, sq))
                seen, no_key = _masks(torch.arange(q0, r.stop),
                                      torch.arange(k0, k_last + 1), sq, skv,
                                      causal, window)
                seen, no_key = seen.T, no_key.T          # [keys, rows]
                qh, doh = qf[:, heads, r], dof[:, heads, r]
                st = kf[:, :, c] @ qh.transpose(-1, -2)
                lg = lse[:, heads, r][:, :, None, :]
                dg = d[:, heads, r][:, :, None, :]
                p = torch.where(seen, torch.exp(st * scale - lg),
                                torch.where(no_key, uniform, 0.0))
                dpt = vf[:, :, c] @ doh.transpose(-1, -2)
                dst = torch.where(seen, p * (dpt - dg), 0.0)
                acc_v += _product(p, doh, parts)
                acc_k += _product(dst, qh, parts)
        sum_k, sum_v = part_k[0].clone(), part_v[0].clone()
        for g in range(1, groups):
            sum_k += part_k[g]
            sum_v += part_v[g]
        dk[:, :, c], dv[:, :, c] = sum_k * scale, sum_v
    return dk, dv


def emulate(q, k, v, o, lse, do, causal, window, parts=2):
    dq, d = emulate_dq(q, k, v, o, lse, do, causal, window, parts)
    dk, dv = emulate_dkv(q, k, v, lse, do, d, causal, window, parts)
    return [g.to(BF16) for g in (dq, dk, dv)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mma_route_algebra_passes_the_card_gates(case):
    causal, window = case[7], case[8]
    q, k, v, o, lse, do = _inputs(case, seed=0)
    got = emulate(q, k, v, o, lse, do, causal, window)
    plain = fa.attention_bwd_plain(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), causal=causal,
                                   window=window)
    for name, g, p in zip(("dq", "dk", "dv"), got, plain):
        err = (g.float() - p).abs()
        assert float(err.max()) <= TOL, (name, float(err.max()))
        share = float((err / (ATOL + RTOL * p.abs())).max())
        assert share <= 1.0, (name, share)


def test_bf16_p_and_ds_alone_break_the_element_gate():
    """The reason for the low parts: with P and dS rounded to bf16 once,
    dv misses the element gate more than twice over (here on the window
    case; its 5e-2 absolute holds)."""
    case = CASES[2]
    causal, window = case[7], case[8]
    q, k, v, o, lse, do = _inputs(case, seed=0)
    _, dk, dv = emulate(q, k, v, o, lse, do, causal, window, parts=1)
    plain = fa.attention_bwd_plain(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), causal=causal,
                                   window=window)
    err = (dv.float() - plain[2]).abs()
    assert float(err.max()) <= TOL
    assert float((err / (ATOL + RTOL * plain[2].abs())).max()) > 2.0


def _bwd_route(tensors, dh=None):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return fa.bwd_route(tensors[0].dtype, dh or tensors[0].shape[-1], flat,
                        [t.data_ptr() for t in tensors])


@pytest.mark.parametrize("dh,dtype,want", [
    (128, BF16, "mma"),     # qwen1.5-4b
    (64, BF16, "mma"),      # granite-moe-3b-a800m
    (32, BF16, "simt"),     # no tensor-core instance
    (16, BF16, "simt"),
    (128, F32, "simt"),     # f32 holds 2e-4: no bf16 products
    (64, F32, "simt"),
    (256, BF16, "mma"),     # recurrentgemma-2b's local layers
    (256, F32, "simt"),
])
def test_bwd_route_by_dtype_and_head_dim(dh, dtype, want):
    """Eight aligned [B, S, H, dh] views (q, k, v, o, dO, dq, dk, dv)."""
    ts = [torch.zeros((2, 16, 4, dh), dtype=dtype).transpose(1, 2)
          for _ in range(8)]
    assert _bwd_route(ts) == want


@pytest.mark.parametrize("which", range(8))
def test_bwd_route_takes_simt_when_one_tensor_is_misaligned(which):
    """Any one of the eight tensors based 2 bytes off 16, or with a row
    stride that is not a multiple of 8 elements, sends the call to SIMT."""
    ts = [torch.zeros((1, 2, 16, 64), dtype=BF16) for _ in range(8)]
    buf = torch.zeros(2 * 16 * 64 + 1, dtype=BF16)
    shifted = list(ts)
    shifted[which] = buf[1:].view(1, 2, 16, 64)
    assert _bwd_route(shifted) == "simt"
    wide = list(ts)
    wide[which] = torch.zeros((1, 2, 16, 68), dtype=BF16)[..., :64]
    assert _bwd_route(wide) == "simt"
    assert _bwd_route(ts) == "mma"


@pytest.mark.parametrize("dh,rep,hkv,b,skv,want", [
    (256, 10, 1, 2, 4096, 5),   # recurrentgemma-2b's training call
    (256, 10, 1, 16, 4096, 1),  # 1024 blocks without a split
    (256, 10, 1, 1, 200, 10),   # a small call: every head a block
    (256, 1, 2, 1, 130, 1),     # no GQA group to split
    (256, 6, 2, 4, 2048, 3),    # 256 blocks: the fewest groups for 528
    (256, 6, 2, 1, 1024, 6),    # 32 blocks: none gives 528
    (128, 10, 1, 2, 4096, 1),   # the other head dims never split
    (64, 3, 8, 2, 512, 1),
])
def test_dkv_groups(dh, rep, hkv, b, skv, want):
    assert fa.dkv_groups(dh, rep, hkv, b, skv) == want
