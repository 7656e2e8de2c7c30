"""The RG-LRU scan kernel's decomposition, emulated on the CPU.

``csrc/rglru.cu`` cuts [B, S, R] into chunks of ``CHUNK`` steps, each run
by ``CHUNK // steps`` threads a lane of ``steps`` steps.  Each step is the
affine map h -> a h + bx; each thread folds its steps from a zero carry
into (A, H), the chunk folds its threads' (A, H) into its aggregate, and
its carry comes from a look-back over the earlier chunks' aggregates to the
nearest published carry.  Each thread then re-runs its steps from its true
carry.  ``emulate`` does the same in torch, sequential where the kernel is
sequential, and is held to the sequential scan: in f64 at 1e-12 (the
algebra), in f32 at 2e-4 against ``rglru_plain`` (the kernel's contract),
relative to the largest value.  The look-back's claim of determinism (a
carry has the same bits wherever the look-back stops) is checked in f32.
Imports torch only.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import rglru as rg

CU = Path(rg.__file__).resolve().parents[1] / "csrc" / "rglru.cu"


def _apply(a, bx, h):
    """h -> a h + bx, the kernel's rounding (one product, one sum)."""
    return a * h + bx


def _steps(x, log_a, dtype):
    a = torch.exp(log_a.to(dtype))
    bx = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * x.to(dtype)
    return a, bx


def _sequential(x, log_a, h0, dtype):
    """The plain sequential scan at ``dtype``."""
    a, bx = _steps(x, log_a, dtype)
    b, s, r = x.shape
    h = torch.zeros((b, r), dtype=dtype) if h0 is None else h0.to(dtype)
    hs = []
    for t in range(s):
        h = _apply(a[:, t], bx[:, t], h)
        hs.append(h)
    return (torch.stack(hs, 1) if hs else torch.zeros((b, 0, r), dtype=dtype)), h


def _runs(a, bx):
    """Fold [..., n, R] steps into (A, H) from a zero carry, in order."""
    A = torch.ones_like(a[..., 0, :])
    H = torch.zeros_like(bx[..., 0, :])
    for u in range(a.shape[-2]):
        H = _apply(a[..., u, :], bx[..., u, :], H)
        A = A * a[..., u, :]
    return A, H


def _carries(agg_a, agg_h, h0, stops):
    """Each chunk's carry in by look-back: chunk c folds the aggregates of
    the chunks after ``stops(c)`` forward from that chunk's published carry
    (chunk 0 starts from h0; every chunk publishes A carry + H)."""
    n = agg_a.shape[1]
    carry_in, published = [h0], []
    for c in range(n):
        if c:
            p = stops(c)
            carry = published[p]
            for q in range(p + 1, c):
                carry = _apply(agg_a[:, q], agg_h[:, q], carry)
            carry_in.append(carry)
        published.append(_apply(agg_a[:, c], agg_h[:, c], carry_in[c]))
    return carry_in


def emulate(x, log_a, h0, dtype, chunk=rg.CHUNK, steps=16,
            stops=lambda c: c - 1):
    """The kernel's decomposition at ``dtype`` -> (h [B, S, R], h_last)."""
    b, s, r = x.shape
    n_chunks = max(1, -(-s // chunk))
    a, bx = _steps(x, log_a, dtype)
    pad = n_chunks * chunk - s                  # identity steps: a 1, bx 0
    a = torch.cat([a, torch.ones((b, pad, r), dtype=dtype)], 1)
    bx = torch.cat([bx, torch.zeros((b, pad, r), dtype=dtype)], 1)
    subs = chunk // steps
    a = a.view(b, n_chunks, subs, steps, r)
    bx = bx.view(b, n_chunks, subs, steps, r)
    run_a, run_h = _runs(a, bx)                          # [B, chunks, subs, R]
    agg_a, agg_h = run_a[:, :, 0], run_h[:, :, 0]
    for j in range(1, subs):
        agg_h = _apply(run_a[:, :, j], run_h[:, :, j], agg_h)
        agg_a = agg_a * run_a[:, :, j]
    zero = torch.zeros((b, r), dtype=dtype)
    carry_in = _carries(agg_a, agg_h, zero if h0 is None else h0.to(dtype),
                        stops)
    out = torch.empty((b, n_chunks, subs, steps, r), dtype=dtype)
    for c in range(n_chunks):
        carry = carry_in[c]
        for j in range(subs):
            h = carry
            for u in range(steps):
                h = _apply(a[:, c, j, u], bx[:, c, j, u], h)
                out[:, c, j, u] = h
            carry = _apply(run_a[:, c, j], run_h[:, c, j], carry)
    h = out.reshape(b, n_chunks * chunk, r)[:, :s]
    last = h[:, -1] if s else carry_in[0]
    return h, last


def _inputs(s, with_h0, decay, seed=0, b=2, r=12):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, r)))
    if decay == "zero":                       # a = 1: the 1e-12 clamp
        la = torch.zeros((b, s, r), dtype=torch.float64)
    else:
        lo = {"model": -0.105, "strong": -20.0}[decay]
        la = torch.from_numpy(rng.uniform(lo, 0.0, (b, s, r)))
    h0 = torch.from_numpy(rng.standard_normal((b, r))) if with_h0 else None
    return x, la, h0


def _rel(a, b):
    if not b.numel():
        return 0.0
    return float((a.double() - b.double()).abs().max()) / max(
        1.0, float(b.double().abs().max()))


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("decay", ["model", "strong", "zero"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [0, 1, 63, 64, 65, 130, 300])
def test_decomposition_matches_the_scan_in_f64(s, with_h0, decay, chunk):
    x, la, h0 = _inputs(s, with_h0, decay)
    h, last = emulate(x, la, h0, torch.float64, chunk=chunk)
    hs, lasts = _sequential(x, la, h0, torch.float64)
    assert h.shape == hs.shape and last.shape == lasts.shape
    assert _rel(h, hs) <= 1e-12 and _rel(last, lasts) <= 1e-12


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("decay", ["model", "strong", "zero"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [0, 1, 63, 64, 65, 130, 300])
def test_decomposition_in_f32_holds_the_kernel_contract(s, with_h0, decay,
                                                        chunk):
    x, la, h0 = (t if t is None else t.float()
                 for t in _inputs(s, with_h0, decay, seed=1))
    h, last = emulate(x, la, h0, torch.float32, chunk=chunk)
    hp, lastp = rg.rglru_plain(x, la, h0)
    assert h.dtype == hp.dtype == torch.float32
    assert _rel(h, hp) <= 2e-4 and _rel(last, lastp) <= 2e-4


@pytest.mark.parametrize("s,chunk", [(300, 16), (130, 16), (300, 64)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_carry_bits_do_not_depend_on_where_the_look_back_stops(s, chunk,
                                                               with_h0):
    """Every stop gives the same carry bits as folding from chunk 0, since
    a published carry is that same fold's value: two calls agree bit for
    bit whichever flags each look-back happened to see."""
    x, la, h0 = (t if t is None else t.float()
                 for t in _inputs(s, with_h0, "model", seed=2))
    assert -(-s // chunk) > 2                   # chunks with a choice of stop
    base, base_last = emulate(x, la, h0, torch.float32, chunk=chunk)
    rng = np.random.default_rng(3)
    for stops in (lambda c: 0, lambda c: c // 2,
                  lambda c: int(rng.integers(0, c))):
        h, last = emulate(x, la, h0, torch.float32, chunk=chunk, stops=stops)
        assert torch.equal(h, base) and torch.equal(last, base_last)


def test_plain_scan_at_zero_length_returns_h0():
    x = torch.zeros((2, 0, 5))
    h0 = torch.randn(2, 5)
    h, last = rg.rglru_plain(x, x, h0)
    assert h.shape == (2, 0, 5) and torch.equal(last, h0)
    h, last = rg.rglru_plain(x, x)
    assert torch.equal(last, torch.zeros(2, 5))


@pytest.mark.parametrize("shape,want", [
    ((4, 512, 2560), (40, 8, 1280)),       # recurrentgemma-2b prefill
    ((1, 4096, 2560), (40, 64, 2560)),     # 64 chunks chained
    ((3, 300, 200), (4, 5, 60)),           # ragged S and R
    ((2, 0, 70), (2, 1, 4)),               # S = 0 still writes h_last
    ((2, 1, 1), (1, 1, 2)),
    ((70000, 64, 64), (1, 1, 70000)),      # batch past one grid axis (65535)
])
def test_tiling(shape, want):
    assert rg.tiling(*shape) == want


def test_tiling_mirrors_the_cuda_source():
    src = CU.read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kLanes"] == rg.LANES
    assert const["kSubs"] * const["kSteps"] == rg.CHUNK
    assert math.gcd(rg.LANES, 32) == 32          # whole warps a lane row
