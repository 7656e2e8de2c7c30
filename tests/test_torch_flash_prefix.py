"""The flash attention's prefix-LM mask in the plain versions and in the
kernels' tile walks, on the CPU, without JAX.

Under ``causal`` a key is seen when ``k <= q`` or ``k < prefix_len`` (the
vlm family's bidirectional patch prefix, the reference's
``models/common.py::chunked_attention`` rule), then ``k > q - window``
on top.  ``attention_plain`` / ``attention_plain_lse`` and
``attention_bwd_plain`` are held against a softmax masked element by
element in f64 and its autograd (1e-5 of the largest value), at a prefix
of 0, a ragged one, a multiple of 64 and one at or past Sq, with and
without a window; ``prefix_len=0`` gives the bits of the functions as
they were before the prefix (their code copied here), and a prefix at or
past Sq the non-causal call's.  The CUDA kernels' tile decisions
(``csrc/flash_attention.cu`` ``causal_end`` and the ``edge`` test,
``csrc/flash_attention_bwd.cu`` ``causal_last``, ``causal_cuts`` and
``first_q_tile``), written out here as the sources state them, are held
to the mask at the tile sizes the kernels use: a tile a walk skips holds
no seen pair, and a tile the element mask is skipped on holds no unseen
one.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.common import chunked_attention

SQ, HQ, HKV, DH = 100, 4, 1, 16
PREFIXES = [0, 37, 64, SQ, SQ + 10]


def _direct_mask(sq, skv, causal, window, prefix):
    m = np.ones((sq, skv), bool)
    for i in range(sq):
        for j in range(skv):
            if causal and not (j <= i or j < prefix):
                m[i, j] = False
            if window > 0 and not j > i - window:
                m[i, j] = False
    return torch.from_numpy(m)


def _direct(q, k, v, mask):
    """Masked softmax attention in f64: (out, lse), rows without a key
    uniform as the plain version's -1e30 fill gives."""
    rep = q.shape[1] // k.shape[1]
    kk = k.double().repeat_interleave(rep, 1)
    vv = v.double().repeat_interleave(rep, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kk) / math.sqrt(
        q.shape[-1])
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=torch.float64))
    return torch.softmax(s, -1) @ vv, torch.logsumexp(s, -1)


def _inputs(seed, sq=SQ, skv=SQ):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((2, h, s, DH), generator=g)
            for h, s in ((HQ, sq), (HKV, skv), (HKV, skv), (HQ, sq)))


def _close(got, want, tol=1e-5):
    scale = max(1.0, float(want.abs().max()))
    assert float((got.double() - want.double()).abs().max()) <= tol * scale


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_plain_prefix_forward_and_backward_match_direct_mask(prefix, window):
    q, k, v, do = _inputs(prefix + window)
    mask = _direct_mask(SQ, SQ, True, window, prefix)
    assert torch.equal(fa._mask(SQ, SQ, True, window, "cpu", prefix), mask)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    out, lse = fa.attention_plain_lse(q, k, v, **kw)
    want, want_lse = _direct(q, k, v, mask)
    _close(out, want)
    _close(lse, want_lse)
    assert torch.equal(fa.attention_plain(q, k, v, **kw), out)
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    ref, _ = _direct(*leaves, mask)
    grads_want = torch.autograd.grad(ref, leaves, do.double())
    grads = fa.attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for g, w in zip(grads, grads_want):
        _close(g, w)


def _old_attend(q, k, v, causal, window):
    """The plain forward as it was before ``prefix_len``: (out, lse)."""
    sq, skv, dh = q.shape[2], k.shape[2], q.shape[-1]
    q_pos = torch.arange(sq)[:, None]
    k_pos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    s = torch.einsum("bkrqd,bksd->bkrqs", fa._grouped(q, k.shape[1]),
                     k.to(torch.float32)) / math.sqrt(dh)
    s = torch.where(mask, s, fa.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrqs,bksd->bkrqd", p, v.to(torch.float32))
    return o.reshape(q.shape).to(q.dtype), torch.logsumexp(s, -1).reshape(
        q.shape[:3])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 20),
                                           (False, 0), (False, 20)])
def test_prefix_zero_gives_the_old_bits(causal, window):
    q, k, v, do = _inputs(3)
    old_o, old_lse = _old_attend(q, k, v, causal, window)
    for kw in (dict(), dict(prefix_len=0)):
        o, lse = fa.attention_plain_lse(q, k, v, causal=causal,
                                        window=window, **kw)
        assert torch.equal(o, old_o) and torch.equal(lse, old_lse)
        assert torch.equal(fa.attention_plain(q, k, v, causal=causal,
                                              window=window, **kw), old_o)
    base = fa.attention_bwd_plain(q, k, v, old_o, old_lse, do,
                                  causal=causal, window=window)
    zero = fa.attention_bwd_plain(q, k, v, old_o, old_lse, do,
                                  causal=causal, window=window, prefix_len=0)
    assert all(torch.equal(a, b) for a, b in zip(base, zero))


@pytest.mark.parametrize("prefix", [SQ, SQ + 10])
def test_prefix_past_sq_is_the_non_causal_call(prefix):
    q, k, v, do = _inputs(5)
    o, lse = fa.attention_plain_lse(q, k, v, causal=True, prefix_len=prefix)
    o2, lse2 = fa.attention_plain_lse(q, k, v, causal=False)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    a = fa.attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                               prefix_len=prefix)
    b = fa.attention_bwd_plain(q, k, v, o, lse, do, causal=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_dispatcher_and_chunked_attention_pass_the_prefix():
    """On the CPU ``ops.flash_attention`` is the plain version with the
    prefix (and autograd runs through it); ``chunked_attention`` takes
    the model's [B, S, H, dh] layout."""
    q, k, v, _ = _inputs(9)
    want = fa.attention_plain(q, k, v, causal=True, prefix_len=37)
    assert torch.equal(ops.flash_attention(q, k, v, causal=True,
                                           prefix_len=37), want)
    got = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, prefix_len=37)
    assert torch.equal(got.transpose(1, 2), want)
    assert not torch.equal(want, fa.attention_plain(q, k, v, causal=True))
    leaf = q.clone().requires_grad_(True)
    ops.flash_attention(leaf, k, v, causal=True, prefix_len=37).sum() \
        .backward()
    assert leaf.grad is not None and leaf.grad.abs().sum() > 0


# ---------------------------------------------------- the kernels' tile walks


def _causal_end(q_last, prefix, n_tiles, tile):
    """flash_attention.cu ``causal_end`` (the dQ kernels' end likewise,
    through flash_attention_bwd.cu ``causal_last``)."""
    return min(n_tiles, max(q_last, prefix - 1) // tile + 1)


def _causal_cuts(k0, keys, q0, prefix):
    """flash_attention_bwd.cu ``causal_cuts``; the forward's ``edge``."""
    return k0 + keys - 1 > q0 and k0 + keys > prefix


def _first_q_tile(k0, rows, prefix):
    """flash_attention_bwd.cu ``first_q_tile`` under a causal mask."""
    return k0 // rows if k0 >= prefix else 0


# (query rows a tile, keys a tile): the forward's mma tiles (64 x 64, and
# 64 x 32 at dh 256), the SIMT tiles (64, and 32 at dh 256 in the
# backward), the dh-256 backward's (64 x 64), the dK/dV kernels' q tiles
# of 32
TILES = [(64, 64), (64, 32), (32, 32), (32, 64)]


@pytest.mark.parametrize("rows,keys", TILES)
@pytest.mark.parametrize("sq,prefix", [(768, 256), (384, 256), (512, 200),
                                       (130, 0), (130, 37), (100, 100),
                                       (100, 130), (64, 63)])
def test_kernel_tile_walks_cover_the_prefix_mask(sq, prefix, rows, keys):
    mask = fa._mask(sq, sq, True, 0, "cpu", prefix).numpy()
    n_q, n_k = -(-sq // rows), -(-sq // keys)
    for qt in range(n_q):
        q0, q_last = qt * rows, min(qt * rows + rows, sq) - 1
        end = _causal_end(q_last, prefix, n_k, keys)
        for kt in range(n_k):
            k0 = kt * keys
            tile = mask[q0:q_last + 1, k0:min(k0 + keys, sq)]
            if kt >= end:       # the dQ / forward walk stops before it
                assert not tile.any(), (qt, kt)
            if not _causal_cuts(k0, keys, q0, prefix):  # no element mask
                assert tile.all(), (qt, kt)
    for kt in range(n_k):       # the dK / dV walk starts at first_q_tile
        k0 = kt * keys
        first = _first_q_tile(k0, rows, prefix)
        assert not mask[:first * rows, k0:min(k0 + keys, sq)].any(), kt
        if first:
            assert mask[first * rows:min(first * rows + rows, sq),
                        k0:min(k0 + keys, sq)].any(), kt
