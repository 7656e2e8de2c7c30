"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one (the marker
``cuda``).  The file imports no JAX, so it also runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import rwkv6 as rw
from repro_torch.kernels import wire_codec as wc
from repro_torch.models.lm import LM
from repro_torch.parallel import wire
from repro_torch.parallel.pipeline import PipelineSpec
from repro_torch.parallel.steps import make_lm_train_step
from repro_torch.training import compress
from repro_torch.training.optim import sgd
from repro_torch.serving.infer import run_split_infer
from repro_torch.utils.trees import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_CASES = [  # (b, hq, hkv, s, dh, causal, window)
    (1, 4, 4, 32, 16, True, 0),
    (2, 4, 2, 37, 64, True, 0),      # GQA rep 2, ragged S
    (1, 2, 1, 150, 128, True, 8),    # sliding window
    (1, 2, 2, 70, 32, False, 0),
    (4, 20, 20, 512, 128, True, 0),  # the main path's shape
    (4, 10, 1, 512, 256, True, 2048),   # recurrentgemma-2b's local layers
    (1, 10, 1, 3072, 256, True, 2048),  # ... where the window bites
    (4, 24, 8, 512, 64, True, 0),    # granite-moe-3b-a800m, GQA rep 3
    (4, 32, 4, 512, 128, True, 0),   # qwen3-moe-30b-a3b, GQA rep 8
]


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("wire_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("shape,dt", [((2048, 2560), "bfloat16"),
                                      ((4, 2560), "bfloat16"),
                                      ((37, 96), "float32"),
                                      ((5, 200), "bfloat16"),
                                      ((3, 7, 251), "float32")])
def test_codec_kernel_bit_exact(wire_dtype, shape, dt):
    dev = cuda_device()
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[0, :wc.wire_block(shape[-1])] = 0.0
    x = torch.from_numpy(3 * x).to(dev, TORCH_DT[dt])
    q, s = wc.encode_cuda(x, wire_dtype)
    qp, sp = wc.encode_plain(x, wire_dtype)
    assert torch.equal(q.view(torch.uint8), qp.view(torch.uint8))
    assert torch.equal(s, sp)
    assert torch.equal(wc.decode_cuda(q, s, TORCH_DT[dt]),
                       wc.decode_plain(q, s, TORCH_DT[dt]))


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_flash_kernel_matches_plain(case, dt, tol):
    dev = cuda_device()
    b, hq, hkv, s, dh, causal, window = case
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(TORCH_DT[dt])
               for shape in ((b, hq, s, dh), (b, hkv, s, dh),
                             (b, hkv, s, dh)))
    o = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    op = fa.attention_plain(q, k, v, causal=causal, window=window)
    assert float((o.float() - op.float()).abs().max()) <= tol


# whisper-small's calls (12 heads of 64): the encoder non-causal over its
# 1500 frames, the cross-attention of 224 or 448 decoder rows on 1500 keys
# (23 full tiles of 64 and a ragged 28), and a small ragged Skv
FLASH_XATTN_CASES = [  # (b, h, sq, skv, causal)
    (1, 12, 1500, 1500, False),
    (2, 12, 224, 1500, False),
    (1, 12, 448, 1500, False),
    (1, 4, 100, 300, False),
    (2, 12, 224, 224, True),
]

# the forward element by element: |o - p| <= atol + rtol P|V|, P the plain
# softmax.  The tensor-core route rounds P to bf16 before P V and o to
# bf16, together under 2^-8 P|V|; |o| itself cancels (~0.04 over 1500
# keys), so a gate on |o| would fail a right kernel's causal rows
FLASH_FWD_ELEM = {"float32": (2e-5, 1e-4), "bfloat16": (1e-3, 2 ** -7)}


@pytest.mark.parametrize("case", FLASH_XATTN_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_flash_kernel_at_whisper_calls(case, dt, tol):
    """Model-layout [B, S, H, 64] views, Sq != Skv where the cross path
    calls, bf16 on "mma" and f32 on "simt": within ``tol`` absolute of the
    plain version, and, with and without lse, within ``FLASH_FWD_ELEM``
    element by element of the plain version in f32 (over 1500 keys |o| is
    ~0.04, under the absolute bf16 gate); the lse within 1e-4."""
    dev = cuda_device()
    b, h, sq, skv, causal = case
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((b, s, h, 64), generator=g, device=dev).to(
        TORCH_DT[dt]).transpose(1, 2) for s in (sq, skv, skv))
    fa.ROUTES.clear()
    out = fa.flash_attention_cuda(q, k, v, causal=causal)
    assert dict(fa.ROUTES) == {"mma" if dt == "bfloat16" else "simt": 1}
    want = fa.attention_plain(q, k, v, causal=causal)
    assert out.shape == q.shape and out.stride() == q.stride()
    assert float((out.float() - want.float()).abs().max()) <= tol
    out2, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                        with_lse=True)
    f32 = [t.float() for t in (q, k, v)]
    want32, lse_p = fa.attention_plain_lse(*f32, causal=causal)
    mag = fa.attention_plain(f32[0], f32[1], f32[2].abs(), causal=causal)
    atol, rtol = FLASH_FWD_ELEM[dt]
    for got in (out, out2):
        err = (got.float() - want32).abs()
        assert bool((err <= atol + rtol * mag).all()), float(err.max())
    assert float((lse - lse_p).abs().max()) <= 1e-4



def test_flash_kernel_reads_the_model_layout():
    """[B, S, H, dh] activations pass as transposed views; the output
    keeps that layout, so the model reshapes it without a copy."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((2, 40, 4, 64), generator=g, device=dev)
               .transpose(1, 2) for _ in range(3))
    o = fa.flash_attention_cuda(q, k, v, causal=True)
    assert o.transpose(1, 2).is_contiguous()
    op = fa.attention_plain(q, k, v, causal=True)
    assert float((o - op).abs().max()) <= 2e-4


def test_unsupported_shapes_raise():
    dev = cuda_device()
    t = torch.randn(1, 2, 8, 48, device=dev)     # head dim 48 not built
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(t, t, t)
    with pytest.raises(TypeError):
        wc.encode_cuda(torch.zeros(2, 64, device=dev, dtype=torch.float16),
                       "int8")


def test_dispatcher_counts_launches():
    dev = cuda_device()
    ops.reset_launches()
    x = torch.randn(4, 2560, device=dev, dtype=torch.bfloat16)
    q, s = ops.wire_encode(x, "int8")
    ops.wire_decode(q, s, torch.bfloat16)
    t = torch.randn(1, 2, 64, 64, device=dev)
    ops.flash_attention(t, t, t)
    assert dict(ops.LAUNCHES) == {"wire_encode": 1, "wire_decode": 1,
                                  "flash_attention": 1}


def test_small_model_on_card_matches_cpu_and_split_serves():
    dev = cuda_device()
    cfg = get_arch("qwen1.5-4b").smoke
    cpu, card = LM(cfg, "cpu"), LM(cfg, dev)
    params = cpu.init(torch.Generator().manual_seed(0))
    pcard = tree_map(lambda t: t.to(dev), params)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    lc, _ = cpu.prefill_with_cache(params, {"tokens": toks}, 48,
                                   torch.float32)
    ops.reset_launches()
    lg, _ = card.prefill_with_cache(pcard, {"tokens": toks.to(dev)}, 48,
                                    torch.float32)
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)
    res = run_split_infer(card, pcard, cut=1, prompts=toks[:, :8], gen=4,
                          cache_len=16, wire_dtype="int8")
    assert res["frames"] == 5
    assert res["measured_payload_bytes"] == res["billed_payload_bytes"]
    assert ops.LAUNCHES["wire_encode"] == ops.LAUNCHES["wire_decode"] == 5


WKV_CASES = [  # (b, s, h, dh, strong decay, initial state)
    (2, 512, 40, 64, False, False),  # one micro-batch of the training path
    (2, 96, 4, 64, False, False),    # S not a multiple of 64
    (2, 128, 3, 32, True, False),
    (1, 70, 2, 16, False, True),
    (2, 64, 3, 64, True, True),
    (1, 130, 3, 64, False, True),    # ragged third chunk, an initial state
    (2, 200, 2, 64, True, False),
    (4, 1, 40, 64, False, True),     # rwkv6-3b's decode step: S 1 from a state
    (4, 10, 40, 64, False, True),    # S 10 from a state (token-loop length)
]


def _wkv_inputs(dev, b, s, h, dh, strong, with_s0, dt, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    r, k, v = (rnd(b, s, h, dh).to(dt) for _ in range(3))
    lo = -3.0 if strong else -6.0
    logw = -torch.exp(torch.rand((b, s, h, dh), generator=g, device=dev)
                      * (0.5 - lo) + lo)
    s0 = rnd(b, h, dh, dh) * 0.1 if with_s0 else None
    return r, k, v, logw, rnd(h, dh) * 0.2, s0


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_wkv6_kernels_match_plain(case, dt, tol):
    """Forward and backward kernels against the plain version's forward
    and autograd; tolerance relative to the largest value (bf16 rounds
    r, k, v, out and dr, dk, dv to a step of 2^-8)."""
    dev = cuda_device()
    *shape, strong, with_s0 = case
    r, k, v, logw, u, s0 = _wkv_inputs(dev, *shape, strong, with_s0,
                                       TORCH_DT[dt])
    rw.ROUTES.clear()
    out, s_t = rw.wkv6_fwd_cuda(r, k, v, logw, u, s0)
    g = torch.Generator(device=dev).manual_seed(1)
    dout = torch.randn(out.shape, generator=g, device=dev).to(out.dtype)
    ds_t = torch.randn(s_t.shape, generator=g, device=dev) \
        if with_s0 else None
    grads = rw.wkv6_bwd_cuda(r, k, v, logw, u, s0, dout, ds_t)
    how = rw.route(r.dtype, shape[-1])
    assert dict(rw.ROUTES) == {f"wkv6:{how}": 1, f"wkv6_bwd:{how}": 1}
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u)]
    s0p = s0.clone().requires_grad_(True) if with_s0 else None
    op, sp = rw.wkv6_plain(*ins, s0p)
    loss = (op.float() * dout.float()).sum()
    if with_s0:
        loss = loss + (sp * ds_t).sum()
    plain = torch.autograd.grad(loss, ins + ([s0p] if with_s0 else []))
    assert _rel(out, op) <= tol and _rel(s_t, sp) <= tol
    for got, want in zip(grads, plain):
        assert _rel(got, want) <= tol


@pytest.mark.parametrize("log_w", [-5.0, -20.0])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_chunked_takes_strong_decay(log_w, with_s0):
    """Constant log w of -5 and -20, where the reference's single-level
    chunked form (and so ``wkv6_plain``) overflows: the chunked kernels
    against ``wkv6_scan`` and its autograd, finite and within 1e-2 of the
    largest value."""
    dev = cuda_device()
    b, s, h, dh = 2, 130, 3, 64
    r, k, v, _, u, s0 = _wkv_inputs(dev, b, s, h, dh, False, with_s0,
                                    torch.bfloat16, seed=2)
    logw = torch.full((b, s, h, dh), log_w, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    dout = torch.randn((b, s, h, dh), generator=g, device=dev).to(
        torch.bfloat16)
    ds_t = torch.randn((b, h, dh, dh), generator=g, device=dev) \
        if with_s0 else None
    rw.ROUTES.clear()
    out, s_t = rw.wkv6_fwd_cuda(r, k, v, logw, u, s0)
    grads = rw.wkv6_bwd_cuda(r, k, v, logw, u, s0, dout, ds_t)
    assert dict(rw.ROUTES) == {"wkv6:chunked": 1, "wkv6_bwd:chunked": 1}
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u)]
    s0p = s0.clone().requires_grad_(True) if with_s0 else None
    op, sp = rw.wkv6_scan(*ins[:3], ins[3].exp(), ins[4], s0p)
    loss = (op.float() * dout.float()).sum()
    if with_s0:
        loss = loss + (sp * ds_t).sum()
    plain = torch.autograd.grad(loss, ins + ([s0p] if with_s0 else []))
    got = [out, s_t] + [t for t in grads if t is not None]
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert _rel(out, op) <= 1e-2 and _rel(s_t, sp) <= 1e-2
    for x, want in zip(grads, plain):
        assert _rel(x, want) <= 1e-2


def test_wkv6_misaligned_bf16_takes_simt():
    """bf16 r at head dim 64 whose base is 2 bytes off 16 (cp.async moves
    16 aligned bytes): the SIMT kernels, forward and backward, within the
    same 1e-2 of the plain version."""
    dev = cuda_device()
    r, k, v, logw, u, s0 = _wkv_inputs(dev, 2, 96, 4, 64, False, True,
                                       torch.bfloat16, seed=4)
    buf = torch.empty(r.numel() + 1, dtype=r.dtype, device=dev)
    r = buf[1:].view(r.shape).copy_(r)
    g = torch.Generator(device=dev).manual_seed(5)
    dout = torch.randn(r.shape, generator=g, device=dev).to(torch.bfloat16)
    ds_t = torch.randn(s0.shape, generator=g, device=dev)
    rw.ROUTES.clear()
    out, s_t = rw.wkv6_fwd_cuda(r, k, v, logw, u, s0)
    grads = rw.wkv6_bwd_cuda(r, k, v, logw, u, s0, dout, ds_t)
    assert dict(rw.ROUTES) == {"wkv6:simt": 1, "wkv6_bwd:simt": 1}
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
    op, sp = rw.wkv6_plain(*ins)
    loss = (op.float() * dout.float()).sum() + (sp * ds_t).sum()
    plain = torch.autograd.grad(loss, ins)
    assert _rel(out, op) <= 1e-2 and _rel(s_t, sp) <= 1e-2
    for x, want in zip(grads, plain):
        assert _rel(x, want) <= 1e-2


def test_wkv6_chunked_backward_is_reproducible():
    """du is summed from per-(batch, chunk) partials in a fixed order, so
    two backward calls on the same inputs give the same bits."""
    dev = cuda_device()
    r, k, v, logw, u, s0 = _wkv_inputs(dev, 2, 200, 3, 64, False, True,
                                       torch.bfloat16, seed=6)
    g = torch.Generator(device=dev).manual_seed(7)
    dout = torch.randn(r.shape, generator=g, device=dev).to(torch.bfloat16)
    ds_t = torch.randn(s0.shape, generator=g, device=dev)
    rw.ROUTES.clear()
    first = rw.wkv6_bwd_cuda(r, k, v, logw, u, s0, dout, ds_t)
    second = rw.wkv6_bwd_cuda(r, k, v, logw, u, s0, dout, ds_t)
    assert dict(rw.ROUTES) == {"wkv6_bwd:chunked": 2}
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_wkv6_autograd_counts_forward_and_backward_launches():
    dev = cuda_device()
    r, k, v, logw, u, _ = _wkv_inputs(dev, 1, 40, 2, 64, False, False,
                                      torch.bfloat16)
    ins = [t.requires_grad_(True) for t in (r, k, v, logw, u)]
    ops.reset_launches()
    out, _ = ops.wkv6(*ins)
    assert dict(ops.LAUNCHES) == {"wkv6": 1}
    grads = torch.autograd.grad(out.float().sum(), ins)
    assert dict(ops.LAUNCHES) == {"wkv6": 1, "wkv6_bwd": 1}
    assert all(bool(torch.isfinite(t).all()) for t in grads)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_autograd_launches_the_backward_kernel(dt):
    """Under autograd ops.flash_attention is one node of the forward and
    backward kernels, one launch each; without autograd the forward alone.
    f32 (the SIMT backward): gradients equal the CPU's autograd through the
    plain version.  bf16 (the tensor-core backward): the node's gradients
    are the bits of the backward kernel called on the forward's output and
    lse."""
    dev = cuda_device()
    g = torch.Generator().manual_seed(8)
    qkv = [torch.randn((1, 4, 70, 64), generator=g) for _ in range(3)]
    cpu = [t.clone().requires_grad_(True) for t in qkv]
    card = [t.to(dev, TORCH_DT[dt]).requires_grad_(True) for t in qkv]
    ops.reset_launches()
    fa.BWD_ROUTES.clear()
    out = ops.flash_attention(*card)
    assert dict(ops.LAUNCHES) == {"flash_attention": 1}
    got = torch.autograd.grad(out.square().sum(), card)
    assert dict(ops.LAUNCHES) == {"flash_attention": 1,
                                  "flash_attention_bwd": 1}
    assert dict(fa.BWD_ROUTES) == {"simt" if dt == "float32" else "mma": 1}
    if dt == "float32":
        want = torch.autograd.grad(ops.flash_attention(*cpu).square().sum(),
                                   cpu)
        for a, b in zip(got, want):
            assert float((a.cpu() - b).abs().max()) <= 2e-4
    else:
        with torch.no_grad():
            o, lse = fa.flash_attention_cuda(*card, with_lse=True)
            want = fa.flash_attention_bwd_cuda(*card, o, lse, 2 * o)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with torch.no_grad():
        assert ops.flash_attention(*card).shape == card[0].shape
    assert dict(ops.LAUNCHES) == {"flash_attention": 2,
                                  "flash_attention_bwd": 1}


FLASH_BWD_CASES = [  # (b, hq, hkv, sq, skv, dh, causal, window, bshd)
    (2, 4, 4, 130, 130, 64, True, 0, True),
    (2, 6, 2, 100, 100, 64, True, 0, True),       # GQA rep 3
    (1, 4, 2, 150, 150, 128, True, 24, False),    # sliding window, GQA
    (1, 2, 2, 90, 90, 128, False, 0, False),
    (1, 2, 1, 96, 96, 64, False, 32, True),       # bidirectional window
    (1, 1, 1, 256, 128, 64, True, 16, False),     # rows 143-255: no key
    (1, 4, 4, 100, 300, 64, False, 0, True),      # Sq < Skv, ragged Skv
    (1, 12, 12, 448, 1500, 64, False, 0, True),   # whisper's cross call
    (1, 12, 12, 1500, 1500, 64, False, 0, True),  # whisper's encoder
]


def _flash_bwd_inputs(dev, case, dt, seed=0):
    """q, k, v (model-layout views where ``bshd``), the forward's output
    and lse on the card, and dO: a model-layout view where ``bshd`` (read
    in place), else laid out [B, H, dh, S], with no unit stride along dh
    (the wrapper copies it)."""
    b, hq, hkv, sq, skv, dh, causal, window, bshd = case
    g = torch.Generator(device=dev).manual_seed(seed)

    def mk(h, s):
        if bshd:
            return torch.randn((b, s, h, dh), generator=g, device=dev).to(
                dt).transpose(1, 2)
        return torch.randn((b, h, s, dh), generator=g, device=dev).to(dt)
    q, k, v = mk(hq, sq), mk(hkv, skv), mk(hkv, skv)
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     with_lse=True)
    if bshd:
        do = mk(hq, sq)
    else:
        do = torch.randn((b, hq, dh, sq), generator=g, device=dev).to(
            dt).transpose(2, 3)
    return q, k, v, o, lse, do


# element by element, |g - p| <= atol + rtol |p|: bf16 rounds each gradient
# to 2^-8 of its size, so a missing contribution to a small entry shows
FLASH_BWD_ELEM = {"float32": (2e-5, 1e-4), "bfloat16": (1e-3, 2 ** -7)}


def _assert_elementwise(got, want, dt):
    atol, rtol = FLASH_BWD_ELEM[dt]
    err = (got.float() - want).abs()
    assert bool((err <= atol + rtol * want.abs()).all()), float(err.max())


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_flash_bwd_matches_plain(case, dt, tol):
    """dq, dk, dv against attention_bwd_plain on the same values (in f32),
    within ``tol`` absolute and ``FLASH_BWD_ELEM`` element by element, and
    the forward's lse against the plain lse (rows without a key: both
    -1e30).  Every case has head dim 64 or 128: bf16 on the tensor-core
    route, f32 on SIMT."""
    dev = cuda_device()
    causal, window = case[6], case[7]
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, case, TORCH_DT[dt])
    fa.BWD_ROUTES.clear()
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    assert dict(fa.BWD_ROUTES) == {"mma" if dt == "bfloat16" else "simt": 1}
    f32 = [t.float() for t in (q, k, v)]
    _, lse_p = fa.attention_plain_lse(*f32, causal=causal, window=window)
    plain = fa.attention_bwd_plain(*f32, o.float(), lse_p, do.float(),
                                   causal=causal, window=window)
    assert float((lse - lse_p).abs().max()) <= 1e-4
    for got, want, t in zip(grads, plain, (q, k, v)):
        assert got.dtype == t.dtype and got.shape == t.shape
        assert float((got.float() - want).abs().max()) <= tol
        _assert_elementwise(got, want, dt)


def test_flash_bwd_misaligned_bf16_and_the_full_width_call():
    """A bf16 q based 2 bytes off 16 (the forward and the backward on SIMT)
    and qwen1.5-4b's training call [2, 20, 512, 128] in the model layout
    (both on the tensor cores), within 5e-2 and element by element."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(9)
    n = 2 * 4 * 40 * 64
    buf = torch.randn(n + 1, generator=g, device=dev).to(torch.bfloat16)
    q = buf[1:].view(2, 4, 40, 64)
    k, v, do = (torch.randn((2, 4, 40, 64), generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(3))
    cases = [(q, k, v, do)]
    cases.append([torch.randn((2, 512, 20, 128), generator=g, device=dev)
                  .to(torch.bfloat16).transpose(1, 2) for _ in range(4)])
    for q, k, v, do in cases:
        fa.ROUTES.clear()
        o, lse = fa.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
        assert dict(fa.ROUTES) == {"simt" if q.data_ptr() % 16 else "mma": 1}
        fa.BWD_ROUTES.clear()
        grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
        assert dict(fa.BWD_ROUTES) == dict(fa.ROUTES)
        f32 = [t.float() for t in (q, k, v)]
        _, lse_p = fa.attention_plain_lse(*f32, causal=True)
        plain = fa.attention_bwd_plain(*f32, o.float(), lse_p, do.float(),
                                       causal=True)
        for got, want in zip(grads, plain):
            assert float((got.float() - want).abs().max()) <= 5e-2
            _assert_elementwise(got, want, "bfloat16")


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_flash_bwd_is_bit_reproducible(dt):
    """No float atomics: two backward calls on the same inputs give the
    same bits (GQA, a window and rows without a key included), on the
    tensor-core route (bf16) and on SIMT (f32)."""
    dev = cuda_device()
    for case in (FLASH_BWD_CASES[1], FLASH_BWD_CASES[-1]):
        q, k, v, o, lse, do = _flash_bwd_inputs(dev, case, TORCH_DT[dt], 3)
        kw = dict(causal=case[6], window=case[7])
        fa.BWD_ROUTES.clear()
        first = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        second = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        assert dict(fa.BWD_ROUTES) == {
            "mma" if dt == "bfloat16" else "simt": 2}
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_flash_bwd_bf16_takes_the_tensor_cores():
    """Every aligned bf16 backward at head dims 64 and 128 (the cases
    above, and qwen1.5-4b's and granite's training calls in the model
    layout) launches on "mma", the forward's route count untouched."""
    dev = cuda_device()
    cases = FLASH_BWD_CASES + [(2, 20, 20, 512, 512, 128, True, 0, True),
                               (2, 24, 8, 512, 512, 64, True, 0, True)]
    fa.BWD_ROUTES.clear()
    for case in cases:
        q, k, v, o, lse, do = _flash_bwd_inputs(dev, case, torch.bfloat16)
        fa.ROUTES.clear()
        fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=case[6],
                                    window=case[7])
        assert not fa.ROUTES
    torch.cuda.synchronize()
    assert dict(fa.BWD_ROUTES) == {"mma": len(cases)}


@pytest.mark.parametrize("sq,skv", [(0, 16), (16, 0)])
def test_flash_bwd_at_zero_length_gives_zero_gradients(sq, skv):
    """No query row or no key: nothing to launch, and the gradients are
    zeros (an empty dq, or dk and dv), as the plain version gives."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(4)
    q, do = (torch.randn((1, 2, sq, 64), generator=g, device=dev)
             for _ in range(2))
    k, v = (torch.randn((1, 2, skv, 64), generator=g, device=dev)
            for _ in range(2))
    o, lse = torch.zeros_like(q), torch.zeros((1, 2, sq), device=dev)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    plain = fa.attention_bwd_plain(q, k, v, o, lse, do)
    for got, want, t in zip(grads, plain, (q, k, v)):
        assert got.shape == t.shape and torch.equal(got, want)
        assert not bool(got.any())


def test_flash_bwd_raises_on_what_it_does_not_take():
    dev = cuda_device()
    t = torch.randn(1, 2, 8, 96, device=dev)     # dh 96: not built
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_cuda(t, t, t, t, torch.zeros(1, 2, 8,
                                                            device=dev), t)
    t = torch.randn(1, 2, 8, 64, device=dev)
    o, lse = fa.flash_attention_cuda(t, t, t, with_lse=True)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_cuda(t, t, t, o, lse[:, :1], t)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_cuda(t, t, t, o, lse, t.bfloat16())


FLASH_BWD256_CASES = [  # (b, hq, hkv, sq, skv, dh, causal, window, bshd)
    (2, 10, 1, 200, 200, 256, True, 48, True),    # GQA 10 : 1, window < S
    (1, 10, 1, 256, 130, 256, True, 48, True),    # rows 177-255: no key
    (1, 2, 2, 130, 130, 256, False, 0, False),    # ragged, one head a group
    (1, 4, 2, 300, 300, 256, True, 100, False),   # GQA 2 : 1, ragged S
]


@pytest.mark.parametrize("case", FLASH_BWD256_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_flash_bwd_at_head_dim_256(case, dt, tol):
    """recurrentgemma-2b's local attention and its edges at dh 256: GQA
    10 : 1 (the dK/dV heads split over ``dkv_groups`` blocks), a window
    shorter than S, rows without keys, ragged S, one head per group; bf16
    on the tensor-core route "mma", f32 on SIMT (tiles of 32 rows);
    within ``tol`` absolute and element by element, and two calls bit
    for bit."""
    dev = cuda_device()
    causal, window = case[6], case[7]
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, case, TORCH_DT[dt], 5)
    fa.BWD_ROUTES.clear()
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    assert dict(fa.BWD_ROUTES) == {
        "mma" if dt == "bfloat16" else "simt": 2}
    f32 = [t.float() for t in (q, k, v)]
    _, lse_p = fa.attention_plain_lse(*f32, causal=causal, window=window)
    plain = fa.attention_bwd_plain(*f32, o.float(), lse_p, do.float(),
                                   causal=causal, window=window)
    for got, want, same in zip(grads, plain, again):
        assert float((got.float() - want).abs().max()) <= tol
        _assert_elementwise(got, want, dt)
        assert torch.equal(got, same)


# paligemma-3b's prefix-LM calls (8 q heads on one kv head of 256, causal,
# the first ``prefix`` keys seen by every row) and their edges
FLASH_PREFIX_CASES = [  # (b, hq, hkv, s, dh, prefix, window)
    (2, 8, 1, 768, 256, 256, 0),     # the training call: 512 + 256 patches
    (4, 8, 1, 384, 256, 256, 0),     # the patch prefill: 128 + 256
    (1, 8, 1, 512, 256, 200, 0),     # a prefix that splits a key tile
    (1, 4, 1, 300, 256, 300, 0),     # prefix = Sq: bidirectional
    (1, 4, 1, 130, 64, 200, 0),      # prefix past Sq
    (1, 4, 1, 100, 16, 37, 0),       # dh 16, ragged
    (1, 4, 2, 300, 128, 100, 64),    # a window on top of the prefix
]


def _prefix_inputs(dev, case, dt, seed):
    """q, k, v, dO [B, S, H, dh] in the model layout (transposed views)."""
    b, hq, hkv, s, dh = case[:5]
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, s, h, dh), generator=g, device=dev).to(dt)
            .transpose(1, 2) for h in (hq, hkv, hkv, hq)]


@pytest.mark.parametrize("case", FLASH_PREFIX_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_flash_kernels_with_a_prefix_match_plain(case, dt, tol):
    """The forward, with and without lse, and the backward under the
    prefix-LM mask against the plain versions with ``prefix_len``: bf16 on
    "mma" (the backward at dh 256 on ``bwd256``; at dh 16 on SIMT), f32 on
    "simt"; the
    forward within ``tol`` and ``FLASH_FWD_ELEM`` (on P|V|), the lse
    within 1e-4, dq / dk / dv within ``tol`` and ``FLASH_BWD_ELEM``, two
    backward calls bit for bit.  A prefix at or past Sq gives the
    non-causal call's bits both ways."""
    dev = cuda_device()
    prefix, window = case[5], case[6]
    q, k, v, do = _prefix_inputs(dev, case, TORCH_DT[dt], 11)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    route = "mma" if dt == "bfloat16" else "simt"
    bwd_route = route if case[4] in fa.BWD_MMA_HEAD_DIMS else "simt"
    fa.ROUTES.clear()
    fa.BWD_ROUTES.clear()
    out = fa.flash_attention_cuda(q, k, v, **kw)
    o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    assert dict(fa.ROUTES) == {route: 2}
    assert dict(fa.BWD_ROUTES) == {bwd_route: 2}
    f32 = [t.float() for t in (q, k, v)]
    want, lse_p = fa.attention_plain_lse(*f32, **kw)
    mag = fa.attention_plain(f32[0], f32[1], f32[2].abs(), **kw)
    atol, rtol = FLASH_FWD_ELEM[dt]
    for got in (out, o):
        err = (got.float() - want).abs()
        assert float(err.max()) <= tol
        assert bool((err <= atol + rtol * mag).all()), float(err.max())
    assert float((lse - lse_p).abs().max()) <= 1e-4
    plain = fa.attention_bwd_plain(*f32, o.float(), lse_p, do.float(), **kw)
    for got, p, same in zip(grads, plain, again):
        assert float((got.float() - p).abs().max()) <= tol
        _assert_elementwise(got, p, dt)
        assert torch.equal(got, same)
    if prefix >= q.shape[2]:
        o2, lse2 = fa.flash_attention_cuda(q, k, v, causal=False,
                                           window=window, with_lse=True)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        free = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                           causal=False, window=window)
        assert all(torch.equal(a, b) for a, b in zip(grads, free))


def test_flash_prefix_autograd_counts_and_refuses_a_negative_prefix():
    """``ops.flash_attention`` with a prefix under autograd: one forward
    and one backward launch, the backward with the forward's prefix (the
    gradients equal the plain autograd's within 5e-2 in bf16); a
    negative prefix raises before any launch."""
    dev = cuda_device()
    case = (1, 8, 1, 200, 256, 64, 0)
    q, k, v, do = _prefix_inputs(dev, case, torch.bfloat16, 3)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    ops.flash_attention(*leaves, causal=True, prefix_len=64).backward(do)
    assert dict(ops.LAUNCHES) == {"flash_attention": 1,
                                  "flash_attention_bwd": 1}
    plain = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    fa.attention_plain(*plain, causal=True, prefix_len=64).backward(
        do.float())
    for a, b in zip(leaves, plain):
        assert float((a.grad.float() - b.grad).abs().max()) <= 5e-2
    with pytest.raises(ValueError, match="prefix_len"):
        fa.flash_attention_cuda(q, k, v, prefix_len=-1)


def _small_training_step_on_card_and_cpu(arch, wire_dtype, **step_kw):
    """One SGD step of ``arch``'s f32 smoke model on the CPU and on the
    card, pipelined (S = 2, k = 2) or with ``step_kw`` (k = 2 by
    accumulation): (loss, params, launches) of each."""
    dev = cuda_device()
    cfg = get_arch(arch).smoke
    params = LM(cfg, "cpu").init(torch.Generator().manual_seed(0),
                                 master=True)
    gen = torch.Generator().manual_seed(2)
    batch = {n: torch.randint(0, cfg.vocab, (4, 40), generator=gen)
             for n in ("tokens", "labels")}
    if cfg.enc_layers:
        batch["frames"] = torch.randn((4, cfg.enc_seq, cfg.d_model),
                                      generator=gen)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((4, cfg.num_patches,
                                             cfg.d_model), generator=gen)
    out = {}
    for where in ("cpu", dev):
        opt = sgd(0.1, momentum=0.9)
        p = tree_map(lambda t: t.clone().to(where), params)
        step = make_lm_train_step(
            LM(cfg, where), opt,
            **(step_kw or dict(pipeline=PipelineSpec(
                2, 2, wire_dtype=wire_dtype))))
        ops.reset_launches()
        state, mets = step({"params": p, "opt_state": opt.init(p),
                            "step": 0},
                           {n: t.to(where) for n, t in batch.items()})
        out[str(where)] = (float(mets["loss"]), state["params"],
                           dict(ops.LAUNCHES))
    (lc, pc, _), (lg, pg, launches) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 1e-4
    if wire_dtype == "int8":
        assert launches["wire_encode"] == launches["wire_decode"] == 4
    return launches


@pytest.mark.parametrize("wire_dtype", ["none", "int8"])
def test_small_rwkv_training_step_on_card_matches_cpu(wire_dtype):
    """One pipelined (S = 2, k = 2) SGD step of the f32 smoke RWKV model,
    the hop raw or int8-coded (the codec is bit-exact on both devices):
    loss and updated parameters at 1e-4, every kernel of the path
    launched."""
    launches = _small_training_step_on_card_and_cpu("rwkv6-3b", wire_dtype)
    assert launches["wkv6"] > 0 and launches["wkv6_bwd"] > 0


@pytest.mark.parametrize("wire_dtype", ["none", "int8"])
def test_small_qwen_training_step_on_card_matches_cpu(wire_dtype):
    """The same step on the f32 smoke qwen model: every attention block's
    backward is the flash backward kernel.  2 blocks x 2 micro-batches:
    each block's forward runs twice under its activation checkpoint."""
    launches = _small_training_step_on_card_and_cpu("qwen1.5-4b", wire_dtype)
    assert launches["flash_attention"] == 8
    assert launches["flash_attention_bwd"] == 4


def test_small_granite_training_step_on_card_matches_cpu():
    """The f32 smoke granite-moe (2 MoE layers, top 2 of 5 experts, tied
    head), S = 2, k = 2, the hop int8: three grouped matmuls and one flash
    a block and micro-batch, each twice under the activation checkpoint,
    and their backward kernels once."""
    launches = _small_training_step_on_card_and_cpu("granite-moe-3b-a800m",
                                                    "int8")
    assert launches == {"flash_attention": 8, "flash_attention_bwd": 4,
                        "moe_gmm": 24, "moe_gmm_bwd": 12,
                        "wire_encode": 4, "wire_decode": 4}


@pytest.mark.parametrize("wire_dtype", ["none", "int8"])
def test_small_whisper_training_step_on_card_matches_cpu(wire_dtype):
    """The f32 smoke whisper (2 encoder and 2 decoder layers), S = 2, k =
    2: the encoder once over the batch (2 flash a layer under its
    checkpoint, 1 backward), each decoder layer's self- and
    cross-attention per micro-batch (4 flash, 2 backwards); the hop
    carries h alone."""
    launches = _small_training_step_on_card_and_cpu("whisper-small",
                                                    wire_dtype)
    assert launches["flash_attention"] == 2 * 2 + 2 * 2 * 2 * 2
    assert launches["flash_attention_bwd"] == 2 + 2 * 2 * 2


@pytest.mark.parametrize("wire_dtype", ["none", "int8"])
def test_small_paligemma_training_step_on_card_matches_cpu(wire_dtype):
    """The f32 smoke paligemma (2 layers, 4 q heads on 1 kv head of 16, 8
    patches before 40 tokens), S = 2, k = 2: each block's flash forward
    twice a micro-batch under its checkpoint and its backward once, every
    one with the prefix of 8 on "simt"; the hop carries the 48 rows."""
    fa.ROUTES.clear()
    fa.BWD_ROUTES.clear()
    launches = _small_training_step_on_card_and_cpu("paligemma-3b",
                                                    wire_dtype)
    assert launches["flash_attention"] == 8
    assert launches["flash_attention_bwd"] == 4
    assert dict(fa.BWD_ROUTES) == {"simt": 4}


def test_small_hybrid_training_step_on_card_matches_cpu():
    """The f32 smoke recurrentgemma (rglru, rglru, local with window 8 at
    S 40), k = 2 by accumulation: the scan and flash forwards twice a
    block and micro-batch, their backward kernels once."""
    launches = _small_training_step_on_card_and_cpu("recurrentgemma-2b",
                                                    "none", microbatches=2)
    assert launches == {"rglru_scan": 8, "rglru_scan_bwd": 4,
                        "flash_attention": 4, "flash_attention_bwd": 2}


RGLRU_CASES = [  # (b, s, r, h0)
    (4, 512, 2560, False),    # recurrentgemma-2b prefill's call
    (4, 512, 2560, True),
    (3, 300, 200, True),      # ragged S and R
    (2, 7, 33, False),
]


def _rglru_inputs(dev, b, s, r, with_h0, dt, seed=0):
    """x and the model's log a range (-8 softplus(lambda) r in (-0.105, 0))
    at dtype ``dt``; h0 f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, r), generator=g, device=dev).to(dt)
    la = (-0.105 * torch.rand((b, s, r), generator=g, device=dev)).to(dt)
    h0 = torch.randn((b, r), generator=g, device=dev) if with_h0 else None
    return x, la, h0


@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 1e-2)])
def test_rglru_kernel_matches_plain(case, dt, tol):
    """Tolerance relative to the largest value: 2e-4 in f32 (the
    reference's own kernel bound), 1e-2 in bf16 (outputs rounded to bf16)."""
    dev = cuda_device()
    x, la, h0 = _rglru_inputs(dev, *case, TORCH_DT[dt])
    h, last = rg.rglru_cuda(x, la, h0)
    hp, lastp = rg.rglru_plain(x, la, h0)
    assert h.dtype == last.dtype == x.dtype
    assert _rel(h, hp) <= tol and _rel(last, lastp) <= tol


def test_rglru_kernel_takes_strided_inputs_and_raises_on_the_rest():
    dev = cuda_device()
    x, la, h0 = _rglru_inputs(dev, 2, 40, 64, True, torch.float32)
    xs = torch.randn((40, 2, 64), device=dev).transpose(0, 1)  # [B,S,R] view
    h, last = rg.rglru_cuda(xs, la.to(torch.bfloat16), h0.half())
    hp, lastp = rg.rglru_plain(xs, la.to(torch.bfloat16), h0.half())
    assert _rel(h, hp) <= 2e-4 and _rel(last, lastp) <= 2e-4
    with pytest.raises(ValueError):
        rg.rglru_cuda(x.transpose(1, 2), la.transpose(1, 2))
    with pytest.raises(TypeError):
        rg.rglru_cuda(x.half(), la)
    with pytest.raises(ValueError):
        rg.rglru_cuda(x, la[:, :5])


RGLRU_BWD_CASES = [  # (b, s, r, h0)
    (2, 1, 70, True),
    (2, 1, 64, False),
    (2, rg.CHUNK - 1, 70, False),
    (2, rg.CHUNK + 1, 130, True),      # ragged S and R
    (3, 300, 200, True),
    (2, 0, 70, True),
    (2, 4096, 2560, False),            # recurrentgemma-2b's training call
]

def test_rglru_counts_launches_and_backward_matches_plain():
    """Without autograd one forward launch; under it the forward and, in
    the backward, the backward kernel once, whose dx, dlog a and dh0 equal
    autograd through the plain version within 2e-4 of the largest
    value (f32)."""
    dev = cuda_device()
    x, la, h0 = _rglru_inputs(dev, 2, 70, 96, True, torch.float32)
    ops.reset_launches()
    ops.rglru_scan(x, la)
    assert dict(ops.LAUNCHES) == {"rglru_scan": 1}
    leaves = [t.clone().requires_grad_(True) for t in (x, la, h0)]
    h, last = ops.rglru_scan(*leaves)
    g = torch.Generator(device=dev).manual_seed(3)
    dh, dl = torch.randn(h.shape, generator=g, device=dev), torch.randn(
        last.shape, generator=g, device=dev)
    got = torch.autograd.grad((h * dh).sum() + (last * dl).sum(), leaves)
    assert dict(ops.LAUNCHES) == {"rglru_scan": 2, "rglru_scan_bwd": 1}
    hp, lastp = rg.rglru_plain(*leaves)
    want = torch.autograd.grad((hp * dh).sum() + (lastp * dl).sum(), leaves)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 2e-4


@pytest.mark.parametrize("case", RGLRU_BWD_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 1e-2)])
def test_rglru_bwd_kernel_edge_shapes(case, dt, tol):
    """The backward kernel against ``rglru_bwd_plain`` on the kernel's own
    h, with dh_last given: S = 1, S across chunk edges, R not a multiple
    of 64, with and without h0, S = 0 (dh0 = dh_last), the full call."""
    dev = cuda_device()
    b, s, r, with_h0 = case
    x, la, h0 = _rglru_inputs(dev, b, s, r, with_h0, TORCH_DT[dt], seed=2)
    h, _ = rg.rglru_cuda(x, la, h0)
    g = torch.Generator(device=dev).manual_seed(4)
    dh = torch.randn(h.shape, generator=g, device=dev).to(h.dtype)
    dl = torch.randn((b, r), generator=g, device=dev).to(h.dtype)
    got = rg.rglru_bwd_cuda(x, la, h0, h, dh, dl)
    want = rg.rglru_bwd_plain(x, la, h0, h, dh, dl)
    for a, w, t in zip(got, want, (x, la, h0)):
        if t is None:
            assert a is None and w is None
            continue
        assert a.dtype == t.dtype and a.shape == t.shape
        assert not a.numel() or _rel(a, w) <= tol


RGLRU_EDGE_CASES = [  # (b, s, r, h0, log a span): chunks of rg.CHUNK steps
    (2, 1, 70, True, 0.105),
    (2, rg.CHUNK - 1, 70, False, 0.105),
    (2, rg.CHUNK, 70, True, 0.105),
    (2, rg.CHUNK + 1, 130, True, 0.105),   # ragged S and R
    (1, 4096, 2560, True, 0.105),          # 64 chunks chained by look-back
    (2, 300, 130, True, 20.0),             # strong decay, log a in (-20, 0)
]


@pytest.mark.parametrize("case", RGLRU_EDGE_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 1e-2)])
def test_rglru_kernel_edge_shapes(case, dt, tol):
    dev = cuda_device()
    b, s, r, with_h0, span = case
    x, la, h0 = _rglru_inputs(dev, b, s, r, with_h0, TORCH_DT[dt], seed=1)
    la = (la.float() * (span / 0.105)).to(TORCH_DT[dt])
    h, last = rg.rglru_cuda(x, la, h0)
    hp, lastp = rg.rglru_plain(x, la, h0)
    assert h.dtype == last.dtype == x.dtype
    assert _rel(h, hp) <= tol and _rel(last, lastp) <= tol


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_kernel_at_zero_length_writes_h0(with_h0):
    dev = cuda_device()
    x, la, h0 = _rglru_inputs(dev, 3, 0, 70, with_h0, torch.float32)
    h, last = rg.rglru_cuda(x, la, h0)
    torch.cuda.synchronize()
    assert h.shape == (3, 0, 70)
    assert torch.equal(last, h0 if with_h0 else torch.zeros_like(last))


def test_rglru_back_to_back_calls_read_no_stale_flags():
    """Two calls in a row on different inputs (same shape, so the
    allocator may hand back the same scratch), each held to the plain
    version: a flag left from the first call would give the second one a
    wrong carry."""
    dev = cuda_device()
    ins = [_rglru_inputs(dev, 2, 700, 200, True, torch.float32, seed=k)
           for k in (3, 4)]
    outs = [rg.rglru_cuda(*i) for i in ins]
    for i, (h, last) in zip(ins, outs):
        hp, lastp = rg.rglru_plain(*i)
        assert _rel(h, hp) <= 2e-4 and _rel(last, lastp) <= 2e-4


def test_rglru_kernel_is_bit_reproducible():
    dev = cuda_device()
    x, la, h0 = _rglru_inputs(dev, 4, 512, 2560, True, torch.float32, seed=5)
    h1, last1 = rg.rglru_cuda(x, la, h0)
    h2, last2 = rg.rglru_cuda(x, la, h0)
    assert torch.equal(h1, h2) and torch.equal(last1, last2)


@pytest.mark.parametrize("wire_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_decode_misaligned_payload_takes_the_strided_route(wire_dtype, dt):
    dev = cuda_device()
    x = torch.randn((64, 2560), device=dev).to(TORCH_DT[dt])
    q, s = wc.encode_cuda(x, wire_dtype)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    qm = buf[1:].view(q.shape).copy_(q)            # base 1 byte off
    wc.ROUTES.clear()
    y = wc.decode_cuda(qm, s, TORCH_DT[dt])
    assert dict(wc.ROUTES) == {"strided": 1}
    assert torch.equal(y, wc.decode_plain(q, s, TORCH_DT[dt]))
    wc.ROUTES.clear()
    assert torch.equal(wc.decode_cuda(q, s, TORCH_DT[dt]), y)
    assert dict(wc.ROUTES) == {"warp256": 1}


def test_decode_routes_by_block_size():
    dev = cuda_device()
    wc.ROUTES.clear()
    for d in (2560, 96, 251):
        q, s = wc.encode_cuda(torch.randn((5, d), device=dev), "int8")
        wc.decode_cuda(q, s, torch.float32)
    assert dict(wc.ROUTES) == {"warp256": 1, "strided": 2}


@pytest.mark.parametrize("rows", [2048, 4])
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_torch_mul_computes_the_int8_decode(rows, dt):
    """The library yardstick of the int8 decode: one torch.mul of the
    payload by its scales into the output dtype gives the kernel's bits."""
    dev = cuda_device()
    x = torch.randn((rows, 2560), device=dev).to(TORCH_DT[dt])
    q, s = wc.encode_cuda(x, "int8")
    o = torch.empty(q.shape, dtype=TORCH_DT[dt], device=dev)
    torch.mul(q, s, out=o)
    assert torch.equal(o.view(rows, 2560), wc.decode_cuda(q, s, TORCH_DT[dt]))


def test_small_recurrentgemma_on_card_matches_cpu():
    """The f32 SMOKE model: prefill of a 12-token prompt (longer than the
    window of 8, so the ring wraps) and 8 greedy decode steps, at 1e-3."""
    dev = cuda_device()
    cfg = get_arch("recurrentgemma-2b").smoke
    cpu, card = LM(cfg, "cpu"), LM(cfg, dev)
    params = cpu.init(torch.Generator().manual_seed(0))
    pcard = tree_map(lambda t: t.to(dev), params)
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        lc, sc = cpu.prefill_with_cache(params, {"tokens": toks}, 20,
                                        torch.float32)
        ops.reset_launches()
        lg, sg = card.prefill_with_cache(pcard, {"tokens": toks.to(dev)}, 20,
                                         torch.float32)
        assert dict(ops.LAUNCHES) == {"rglru_scan": 2, "flash_attention": 1}
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)
        tok = torch.argmax(lc, -1, keepdim=True)
        for pos in range(12, 20):
            lc, _ = cpu.decode_step(params, tok, sc["cache"], pos)
            lg, _ = card.decode_step(pcard, tok.to(dev), sg["cache"], pos)
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)
            tok = torch.argmax(lc, -1, keepdim=True)


GMM_CASES = [  # (E, C, D, F)
    (40, 512, 1536, 512),     # granite-moe-3b-a800m prefill: w1, w3
    (40, 512, 512, 1536),     # ... w2
    (40, 8, 1536, 512),       # a decode step (capacity 8)
    (5, 37, 200, 72),         # ragged C, D and F
    (1, 1, 1, 1),
    (3, 130, 200, 72),        # C past one 128-row tile, ragged D and F
    (2, 17, 64, 136),         # the smallest C of the 128-row tiles
    (2, 1, 200, 72),          # small-C variant, N = 8
    (3, 8, 200, 72),
    (2, 12, 200, 72),         # small-C variant, N = 16, ragged
    (2, 16, 200, 72),
    (128, 160, 2048, 768),    # qwen3-moe-30b-a3b prefill (B 4 x S 512): w1, w3
    (128, 160, 768, 2048),    # ... w2
    (128, 8, 2048, 768),      # its decode step (capacity 8)
]


def _gmm_inputs(dev, e, c, d, f, dt, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((e, c, d), generator=g, device=dev).to(dt)
    w = (torch.randn((e, d, f), generator=g, device=dev) / d ** 0.5).to(dt)
    return h, w


@pytest.mark.parametrize("case", GMM_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 1e-2)])
def test_moe_gmm_kernel_matches_plain(case, dt, tol):
    """Tolerance relative to the largest value: 2e-4 in f32 (sums over D
    in another order), 1e-2 in bf16 (the output rounded to bf16 once)."""
    dev = cuda_device()
    h, w = _gmm_inputs(dev, *case, TORCH_DT[dt])
    out = mg.moe_gmm_cuda(h, w)
    assert out.dtype == h.dtype and out.is_contiguous()
    assert _rel(out, mg.moe_gmm_plain(h, w)) <= tol


def test_moe_gmm_kernel_takes_strided_inputs_and_raises_on_the_rest():
    dev = cuda_device()
    h, w = _gmm_inputs(dev, 3, 20, 48, 40, torch.float32)
    hs = torch.randn((20, 3, 48), device=dev).transpose(0, 1)  # [E,C,D] view
    ws = w[:, :, :33]                                  # row stride 40
    assert _rel(mg.moe_gmm_cuda(hs, ws), mg.moe_gmm_plain(hs, ws)) <= 2e-4
    with pytest.raises(ValueError):
        mg.moe_gmm_cuda(h.transpose(1, 2), w)
    with pytest.raises(ValueError):
        mg.moe_gmm_cuda(h, w[:, :40])
    with pytest.raises(TypeError):
        mg.moe_gmm_cuda(h, w.to(torch.bfloat16))
    with pytest.raises(TypeError):
        mg.moe_gmm_cuda(h.half(), w.half())


def test_moe_gmm_counts_launches_and_backward_matches_plain():
    """Without autograd one forward launch; under it the forward and the
    backward kernel once, dh and dw equal to autograd through the plain
    version within 2e-4 of the largest value (f32)."""
    dev = cuda_device()
    h, w = _gmm_inputs(dev, 3, 40, 48, 24, torch.float32)
    ops.reset_launches()
    ops.moe_gmm(h, w)
    assert dict(ops.LAUNCHES) == {"moe_gmm": 1}
    leaves = [t.clone().requires_grad_(True) for t in (h, w)]
    dout = torch.randn((3, 40, 24), device=dev)
    got = torch.autograd.grad(ops.moe_gmm(*leaves), leaves, dout)
    assert dict(ops.LAUNCHES) == {"moe_gmm": 2, "moe_gmm_bwd": 1}
    want = torch.autograd.grad(mg.moe_gmm_plain(*leaves), leaves, dout)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 2e-4


GMM_BWD_CASES = [  # (E, C, D, F)
    (40, 256, 1536, 512),     # granite-moe-3b-a800m training: w1, w3
    (40, 256, 512, 1536),     # ... w2
    (5, 37, 200, 72),         # ragged
    (3, 8, 64, 40),           # C below SMALL_C
    (2, 130, 96, 33),         # C past one tile
]


@pytest.mark.parametrize("case", GMM_BWD_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 1e-2)])
def test_moe_gmm_bwd_kernel_matches_plain(case, dt, tol):
    """dh and dw against ``moe_gmm_bwd_plain`` within ``tol`` of the
    largest value (the forward's contract), contiguous, in the dtype; bf16
    on the tensor cores ("wgmma") where TMA can address every input (rows
    a multiple of 16 bytes: not F = 33), f32 on SIMT."""
    dev = cuda_device()
    h, w = _gmm_inputs(dev, *case, TORCH_DT[dt])
    e, c, d, f = case
    dout = torch.randn((e, c, f), device=dev).to(TORCH_DT[dt])
    mg.BWD_ROUTES.clear()
    got = mg.moe_gmm_bwd_cuda(h, w, dout)
    aligned = d % 8 == 0 and f % 8 == 0
    assert dict(mg.BWD_ROUTES) == {
        "wgmma" if dt == "bfloat16" and aligned else "simt": 1}
    for a, b, t in zip(got, mg.moe_gmm_bwd_plain(h, w, dout), (h, w)):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert a.is_contiguous() and _rel(a, b) <= tol


def test_moe_gmm_bwd_takes_misaligned_views():
    """h, w and dout as strided views (h [E, C, D] from a [C, E, D]
    buffer, w a column slice, dout without a unit stride, copied), bf16
    based 2 bytes off 16: on SIMT, within 1e-2 of the largest value."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(6)
    buf = torch.randn(20 * 3 * 48 + 1, generator=g, device=dev).to(
        torch.bfloat16)
    h = buf[1:].view(20, 3, 48).transpose(0, 1)
    w = (torch.randn((3, 48, 40), generator=g, device=dev) / 7).to(
        torch.bfloat16)[:, :, :33]
    dout = torch.randn((3, 33, 20), generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    mg.BWD_ROUTES.clear()
    for a, b in zip(mg.moe_gmm_bwd_cuda(h, w, dout),
                    mg.moe_gmm_bwd_plain(h, w, dout)):
        assert _rel(a, b) <= 1e-2
    assert dict(mg.BWD_ROUTES) == {"simt": 1}


def test_small_granite_on_card_matches_cpu():
    """The f32 SMOKE granite-moe (2 layers, top 2 of 5 experts, tied
    head): prefill launches three grouped matmuls and one flash a layer;
    prefill and 8 greedy decode steps within 1e-3 of the CPU."""
    dev = cuda_device()
    cfg = get_arch("granite-moe-3b-a800m").smoke
    cpu, card = LM(cfg, "cpu"), LM(cfg, dev)
    params = cpu.init(torch.Generator().manual_seed(0))
    pcard = tree_map(lambda t: t.to(dev), params)
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        lc, sc = cpu.prefill_with_cache(params, {"tokens": toks}, 20,
                                        torch.float32)
        ops.reset_launches()
        lg, sg = card.prefill_with_cache(pcard, {"tokens": toks.to(dev)}, 20,
                                         torch.float32)
        assert dict(ops.LAUNCHES) == {"moe_gmm": 3 * cfg.num_layers,
                                      "flash_attention": cfg.num_layers}
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)
        tok = torch.argmax(lc, -1, keepdim=True)
        for pos in range(12, 20):
            lc, _ = cpu.decode_step(params, tok, sc["cache"], pos)
            lg, _ = card.decode_step(pcard, tok.to(dev), sg["cache"], pos)
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)
            tok = torch.argmax(lc, -1, keepdim=True)
        assert ops.LAUNCHES["moe_gmm"] == 3 * cfg.num_layers * 9


def test_moe_gmm_routes_by_shape_and_layout():
    """bf16 at granite's prefill shape takes the wgmma route, its decode
    shape the small-C variant; (1, 1, 1, 1), a w whose row stride TMA
    cannot take, and f32 take the SIMT kernel; each within its tolerance."""
    dev = cuda_device()
    cases = [((40, 512, 1536, 512), torch.bfloat16, "wgmma"),
             ((40, 8, 1536, 512), torch.bfloat16, "wgmma_small_c"),
             ((1, 1, 1, 1), torch.bfloat16, "simt"),
             ((3, 20, 48, 40), torch.float32, "simt")]
    for shape, dt, want in cases:
        h, w = _gmm_inputs(dev, *shape, dt)
        mg.ROUTES.clear()
        out = mg.moe_gmm_cuda(h, w)
        assert dict(mg.ROUTES) == {want: 1}, (shape, dt, dict(mg.ROUTES))
        tol = 1e-2 if dt == torch.bfloat16 else 2e-4
        assert _rel(out, mg.moe_gmm_plain(h, w)) <= tol
    h, w = _gmm_inputs(dev, 3, 20, 48, 44, torch.bfloat16)
    wa = w[:, :, :40].contiguous()                     # row stride 40: 80 B
    ws = w[:, :, :33]                                  # row stride 44: 88 B
    mg.ROUTES.clear()
    assert _rel(mg.moe_gmm_cuda(h, wa), mg.moe_gmm_plain(h, wa)) <= 1e-2
    assert _rel(mg.moe_gmm_cuda(h, ws), mg.moe_gmm_plain(h, ws)) <= 1e-2
    assert dict(mg.ROUTES) == {"wgmma": 1, "simt": 1}


FLASH_BF16_CASES = [  # (b, hq, hkv, sq, skv, dh, causal, window, [B,S,H,dh])
    (4, 20, 20, 512, 512, 128, True, 0, True),     # qwen1.5-4b's prefill
    (4, 24, 8, 512, 512, 64, True, 0, True),       # granite-moe's
    (4, 10, 1, 512, 512, 256, True, 2048, True),   # recurrentgemma's
    (2, 4, 2, 64, 200, 64, False, 0, False),       # Sq < Skv
    (1, 4, 4, 100, 37, 128, True, 0, False),       # Sq > Skv, causal
    (1, 2, 1, 70, 300, 256, True, 32, False),      # Sq < Skv, window
    (2, 3, 3, 33, 33, 16, False, 0, True),
]


@pytest.mark.parametrize("case", FLASH_BF16_CASES, ids=str)
def test_flash_bf16_takes_the_tensor_cores(case):
    """bf16 on the mma route: model-layout views and Sq != Skv, within
    5e-2 of the plain version; the output keeps q's layout."""
    dev = cuda_device()
    b, hq, hkv, sq, skv, dh, causal, window, bshd = case
    g = torch.Generator(device=dev).manual_seed(3)

    def mk(h, s):
        if bshd:
            return torch.randn((b, s, h, dh), generator=g, device=dev).to(
                torch.bfloat16).transpose(1, 2)
        return torch.randn((b, h, s, dh), generator=g,
                           device=dev).to(torch.bfloat16)
    q, k, v = mk(hq, sq), mk(hkv, skv), mk(hkv, skv)
    fa.ROUTES.clear()
    o = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert dict(fa.ROUTES) == {"mma": 1}
    assert o.stride() == q.stride()
    op = fa.attention_plain(q, k, v, causal=causal, window=window)
    assert float((o.float() - op.float()).abs().max()) <= 5e-2


def test_flash_misaligned_bf16_takes_simt():
    """A bf16 q whose base is not 16-byte aligned goes to the SIMT kernel
    (cp.async moves 16 aligned bytes), within the same 5e-2."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(4)
    n = 2 * 4 * 40 * 64
    buf = torch.randn(n + 1, generator=g, device=dev).to(torch.bfloat16)
    q = buf[1:].view(2, 4, 40, 64)
    k, v = (torch.randn((2, 4, 40, 64), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    fa.ROUTES.clear()
    o = fa.flash_attention_cuda(q, k, v, causal=True)
    assert dict(fa.ROUTES) == {"simt": 1}
    op = fa.attention_plain(q, k, v, causal=True)
    assert float((o.float() - op.float()).abs().max()) <= 5e-2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt,misaligned", [("float32", False),
                                           ("bfloat16", False),
                                           ("bfloat16", True)])
def test_flash_rows_without_keys_take_the_mean_of_v(causal, dt, misaligned):
    """Sq >= Skv + window: query rows 143-255 of q [1, 1, 256, 64] against
    k/v [1, 1, 128, 64] under window 16 have no key, so the plain version
    gives each the mean of V over all 128 keys; the rows that do have keys
    share their blocks.  Both routes (bf16 forced onto SIMT by a q whose
    base is 2 bytes off) within 2e-4 (f32) / 5e-2 (bf16)."""
    dev = cuda_device()
    dtype = TORCH_DT[dt]
    g = torch.Generator(device=dev).manual_seed(5)
    n = 256 * 64
    buf = torch.randn(n + 1, generator=g, device=dev).to(dtype)
    q = (buf[1:] if misaligned else buf[:n]).view(1, 1, 256, 64)
    k, v = (torch.randn((1, 1, 128, 64), generator=g, device=dev).to(dtype)
            for _ in range(2))
    fa.ROUTES.clear()
    o = fa.flash_attention_cuda(q, k, v, causal=causal, window=16)
    want = "mma" if dt == "bfloat16" and not misaligned else "simt"
    assert dict(fa.ROUTES) == {want: 1}
    op = fa.attention_plain(q, k, v, causal=causal, window=16)
    tol = 2e-4 if dt == "float32" else 5e-2
    assert float((o.float() - op.float()).abs().max()) <= tol
    mean = v.float().mean(dim=2)[0, 0]
    assert float((o[0, 0, 200].float() - mean).abs().max()) <= tol


# ------------------------------------- top-k hop, interleaving, compression


def _residual_flips(a, b, atol):
    """Elements of two f32 residuals more than ``atol`` apart; each must
    be an int8 rounding flip (the two at half a quantum on either side,
    ``a = -b``).  Returns their count."""
    off = (a - b).abs() > atol
    err = float((a + b)[off].abs().max()) if off.any() else 0.0
    assert err <= atol, (int(off.sum()), err)
    return int(off.sum())


class _HopDecisions:
    """The hops' codec decisions of one run, replayed in another: each
    forward hop's decoded activation in call order, and each top-k hop's
    kept indices by EF slot.  A card-vs-CPU step then compares the
    arithmetic, not the side of an int8 rounding boundary or of a top-k
    near-tie on which each device's f32 roundings land (the codec is
    discontinuous: one activation a quantum off moves the loss by ~1e-5
    at the smoke width).  ``flips`` counts the replayed decisions the
    replaying run would have taken otherwise."""

    def __init__(self, monkeypatch):
        from repro_torch.training.compress import quantize_blocks
        self.replay, self.fwd, self.payloads, self.idx = False, [], [], {}
        self.flips = {"forward payload elements": 0, "top-k picks": 0}
        roundtrip, encode = wire._wire_roundtrip, wire.topk_encode
        dense, backward = wire.encode, wire.CodedHopEF.backward
        slot = [None]

        def enc_dense(x, w):
            q, sc = dense(x, w)
            if not self.replay:
                self.payloads.append(q.cpu())
            else:
                self.flips["forward payload elements"] += int(
                    (self.payloads.pop(0).int() != q.cpu().int()).sum())
            return q, sc

        def rt(x, w):
            y, n = roundtrip(x, w)
            if not self.replay:
                self.fwd.append(y.detach().cpu())
                return y, n
            return self.fwd.pop(0).to(y.device), n

        def bwd(ctx, g):
            slot[0] = ctx.ef.storage_offset() // ctx.ef.numel()
            return backward(ctx, g)

        def enc(x, w):
            q, idx, s = encode(x, w)
            if not self.replay:
                self.idx[slot[0]] = idx.cpu()
                return q, idx, s
            want = self.idx[slot[0]].to(x.device)
            self.flips["top-k picks"] += int((want.sort(-1).values
                                              != idx.sort(-1).values).sum())
            vals = torch.gather(x.to(torch.float32), -1, want.long())
            q, s = quantize_blocks(vals, wire.parse_wire_dtype(w)[0])
            return q, want, s
        monkeypatch.setattr(wire, "encode", enc_dense)
        monkeypatch.setattr(wire, "_wire_roundtrip", rt)
        monkeypatch.setattr(wire, "topk_encode", enc)
        monkeypatch.setattr(wire.CodedHopEF, "backward", staticmethod(bwd))


def test_compress_grads_on_card_bit_equal_to_plain():
    """``compress_grads`` / ``decompress_grads`` / ``compress_grads_`` go
    through the codec kernels on f32 [n/256, 256] (padded) views: bit for
    bit their plain versions on the CPU, one encode and one decode a leaf
    in place."""
    dev = cuda_device()
    rng = np.random.default_rng(3)
    shapes = [(2048, 2560), (3, 100), (7,), (256,)]
    grads = [torch.from_numpy((rng.standard_normal(s) * rng.uniform(1e-3, 10))
                              .astype(np.float32)) for s in shapes]
    efs = [torch.from_numpy((rng.standard_normal(s) * 1e-3)
                            .astype(np.float32)) for s in shapes]
    cq, ce = compress.compress_grads(grads, efs)
    gq, ge = compress.compress_grads([g.to(dev) for g in grads],
                                     [e.to(dev) for e in efs])
    for (q, sc, shp), (q2, sc2, shp2) in zip(cq, gq):
        assert shp == shp2 and torch.equal(q, q2.cpu())
        assert torch.equal(sc, sc2.cpu())
    for a, b in zip(ce, ge):
        assert torch.equal(a, b.cpu())
    for a, b in zip(compress.decompress_grads(cq),
                    compress.decompress_grads(gq)):
        assert torch.equal(a, b.cpu())
    g2, e2 = [g.to(dev) for g in grads], [e.to(dev) for e in efs]
    ops.reset_launches()
    compress.compress_grads_(g2, e2)
    assert dict(ops.LAUNCHES) == {"wire_encode": 4, "wire_decode": 4}
    for a, b, c, d in zip(g2, compress.decompress_grads(cq), e2, ce):
        assert torch.equal(a.cpu(), b) and torch.equal(c.cpu(), d)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_topk_hop_on_card_matches_cpu(dt):
    """The EF hop at the training hop's shape: the dense forward bit for
    bit (the codec kernels), and the top-k gradient and the slot's new
    residual bit for bit on rows without a tie at the cut (torch.topk on
    either device picks among equal magnitudes as it likes), the kept
    magnitudes equal on every row; the backward launches no codec."""
    dev = cuda_device()
    g0 = torch.Generator().manual_seed(5)
    x = (torch.randn((2, 512, 2560), generator=g0) * 3).to(TORCH_DT[dt])
    g = torch.randn((2, 512, 2560), generator=g0).to(TORCH_DT[dt])
    ef = torch.randn((2, 512, 2560), generator=g0) * 1e-2
    out = {}
    for where in ("cpu", dev):
        xt = x.to(where).requires_grad_(True)
        slot = ef.clone().to(where)
        ops.reset_launches()
        y = wire.coded_hop(xt, "int8+topk0.25", None, slot)
        fwd = dict(ops.LAUNCHES)
        (gx,) = torch.autograd.grad(y, xt, g.to(where))
        out[str(where)] = (y.detach().cpu(), gx.cpu(), slot.cpu(), fwd,
                           dict(ops.LAUNCHES))
    (yc, gc, sc, _, _), (yg, gg, sg, fwd, both) = out["cpu"], out[str(dev)]
    assert fwd == both == {"wire_encode": 1, "wire_decode": 1}
    assert torch.equal(yc, yg)
    corrected = (g.float() + ef).abs().sort(dim=-1, descending=True).values
    kk = wire.topk_count(2560, 0.25)
    free = corrected[..., kk - 1] != corrected[..., kk]
    assert int(free.sum()) >= free.numel() // 2
    assert torch.equal(gc[free], gg[free]) and torch.equal(sc[free], sg[free])
    assert torch.equal(gc.abs().sort(dim=-1).values,
                       gg.abs().sort(dim=-1).values)


def test_small_interleaved_topk_compressed_step_on_card_matches_cpu(
        monkeypatch):
    """One S 2, v 2, k 2 ``int8+topk0.25`` step with ``compress=True`` of
    the f32 smoke qwen at 4 layers on the card, and on the CPU with the
    card's hop decisions replayed (``_HopDecisions``; how many it
    overrode is printed): loss at 1e-4; ``error_fb`` at 1e-6 but for the
    compressor's int8 rounding flips; parameters at 1e-4 once each
    flip's step (SGD: lr x the residuals' difference, one quantum) is
    taken out; the EF buffer live in the same slots, at 1e-4 of its
    largest value but for the top-k rows' int8 rounding flips; exactly
    the path's launches (16 flash forwards, 8 backwards, 6 hop encodes
    and decodes and one more of each a parameter leaf)."""
    import dataclasses

    from repro_torch.parallel.pipeline import wire_ef_zeros
    dev = cuda_device()
    cfg = dataclasses.replace(get_arch("qwen1.5-4b").smoke, num_layers=4)
    spec = PipelineSpec(2, 2, virtual_stages=2, wire_dtype="int8+topk0.25")
    params = LM(cfg, "cpu").init(torch.Generator().manual_seed(0),
                                 master=True)
    gen = torch.Generator().manual_seed(2)
    batch = {n: torch.randint(0, cfg.vocab, (4, 40), generator=gen)
             for n in ("tokens", "labels")}
    decisions = _HopDecisions(monkeypatch)
    out = {}
    for where in (dev, "cpu"):          # the CPU replays the card's hops
        decisions.replay = where == "cpu"
        opt = sgd(0.1, momentum=0.9)
        p = tree_map(lambda t: t.clone().to(where), params)
        state = {"params": p, "opt_state": opt.init(p), "step": 0,
                 "wire_ef": wire_ef_zeros(cfg, spec, 4, 40, where),
                 "error_fb": compress.init_error_fb(p)}
        step = make_lm_train_step(LM(cfg, where), opt, pipeline=spec,
                                  compress=True)
        ops.reset_launches()
        state, mets = step(state, {n: t.to(where) for n, t in batch.items()})
        out[str(where)] = (float(mets["loss"]), state, dict(ops.LAUNCHES))
    print(f"card decisions the CPU would have taken otherwise: "
          f"{decisions.flips}")
    (lc, sc, _), (lg, sg, launches) = out["cpu"], out[str(dev)]
    n_leaves = len(tree_leaves(params))
    assert launches == {"flash_attention": 16, "flash_attention_bwd": 8,
                        "wire_encode": 6 + n_leaves,
                        "wire_decode": 6 + n_leaves}
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    # an int8 rounding flip of a compressed gradient moves its parameter
    # by lr x one quantum, lr times the two residuals' difference
    for a, b, ea, eb in zip(tree_leaves(sg["params"]),
                            tree_leaves(sc["params"]),
                            tree_leaves(sg["error_fb"]),
                            tree_leaves(sc["error_fb"])):
        _residual_flips(ea.cpu(), eb, 1e-6)
        moved = (a.detach().cpu() - b.detach()) - 0.1 * (ea.cpu() - eb)
        assert float(moved.abs().max()) <= 1e-4
    efc, efg = sc["wire_ef"], sg["wire_ef"].cpu()
    assert torch.equal(efc.flatten(2).abs().amax(-1) > 0,
                       efg.flatten(2).abs().amax(-1) > 0)
    _residual_flips(efg, efc, 1e-4 * float(efc.abs().max()))


# ------------------------------------- the streaming runtime (runtime/)


class _StreamDecisions:
    """The streaming runtime's codec decisions of one run, replayed in
    another, keyed by (direction, client, round): each ACT frame's dense
    payload and each GRAD frame's top-k picks and payload (the reply
    keeps its own scales, and its EF residual follows from the replayed
    picks).  ``flips`` counts the decisions the replaying run would have
    taken otherwise."""

    def __init__(self, monkeypatch):
        from repro_torch.runtime.bs import BSDispatcher
        from repro_torch.runtime.ue import UEClient
        self.replay, self.rec = False, {}
        self.flips = {"payload elements": 0, "top-k picks": 0}
        key = [None]
        act_frame, grad_frame = UEClient._act_frame, BSDispatcher._grad_frame
        dense, topk = wire.encode, wire.topk_encode

        def act(client, acts, labels, step, dl):
            key[0] = ("up", client.client_id, step)
            return act_frame(client, acts, labels, step, dl)

        def grad(disp, cid, step, g, loss):
            key[0] = ("down", cid, step)
            return grad_frame(disp, cid, step, g, loss)

        def enc(x, w):
            q, sc = dense(x, w)
            if not self.replay:
                self.rec[key[0]] = q.cpu()
                return q, sc
            want = self.rec.pop(key[0])
            self.flips["payload elements"] += int(
                (want.float() != q.cpu().float()).sum())
            return want.to(q.device), sc

        def enc_topk(x, w):
            q, idx, sc = topk(x, w)
            if not self.replay:
                self.rec[key[0]] = (q.cpu(), idx.cpu())
                return q, idx, sc
            want_q, want_idx = self.rec.pop(key[0])
            self.flips["top-k picks"] += int(
                (want_idx.sort(-1).values != idx.sort(-1).values).sum())
            q, sc = compress.quantize_blocks(
                torch.gather(x.to(torch.float32), -1, want_idx.long()),
                wire.parse_wire_dtype(w)[0])
            self.flips["payload elements"] += int(
                (want_q.float() != q.float()).sum())
            return want_q, want_idx, sc

        monkeypatch.setattr(UEClient, "_act_frame", act)
        monkeypatch.setattr(BSDispatcher, "_grad_frame", grad)
        monkeypatch.setattr(wire, "encode", enc)
        monkeypatch.setattr(wire, "topk_encode", enc_topk)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree.detach().cpu()}


@pytest.mark.parametrize("wire_dtype", ["none", "int8+topk0.25"])
def test_small_streaming_run_on_card_matches_cpu(wire_dtype, monkeypatch):
    """``run_streaming`` of the f32 smoke qwen at 4 layers, cut 2, 3 UEs,
    3 rounds on the card, and on the CPU with the card's codec decisions
    replayed (``_StreamDecisions``; how many it overrode is printed):
    losses and each client's losses within 1e-5, every parameter within
    1e-5 but for one element in 10^4 and the key bias, which are held to
    AdamW's reach of 2 lr a round (AdamW divides each element's step by
    its own running size, so where that is at the rounding noise's scale
    each device's f32 roundings become steps of their own; ROADMAP Queue
    3, fault 13); exactly the run's flash and codec launches."""
    import asyncio
    import dataclasses

    from repro_torch.runtime.driver import run_streaming
    dev = cuda_device()
    cfg = dataclasses.replace(get_arch("qwen1.5-4b").smoke, num_layers=4)
    params = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    decisions = _StreamDecisions(monkeypatch)
    n, rounds, lr, out = 3, 3, 1e-3, {}
    for where in (dev, "cpu"):          # the CPU replays the card's hops
        decisions.replay = where == "cpu"
        ops.reset_launches()
        res = asyncio.run(run_streaming(
            cfg, cut=2, n_clients=n, steps=rounds, batch_per_client=2,
            seq=32, wire_dtype=wire_dtype, lr=lr, device=where,
            params=tree_map(lambda t: t.clone().to(where), params)))
        out[str(where)] = (res, dict(ops.LAUNCHES))
    print(f"card decisions the CPU would have taken otherwise: "
          f"{decisions.flips}")
    (rg, launches), (rc, _) = out[str(dev)], out["cpu"]
    want = {"flash_attention": 10 * n * rounds,
            "flash_attention_bwd": 4 * n * rounds}
    if wire_dtype != "none":
        want.update(wire_encode=n * rounds, wire_decode=n * rounds)
    assert launches == want
    np.testing.assert_allclose(rg["losses"], rc["losses"], atol=1e-5, rtol=0)
    for c in rc["client_losses"]:
        np.testing.assert_allclose(rg["client_losses"][c],
                                   rc["client_losses"][c], atol=1e-5, rtol=0)
    n_el, outliers = 0, 0
    for half in ("ue", "bs"):
        pg, pc = _flat(rg["params"][half]), _flat(rc["params"][half])
        for path, a in pg.items():
            d = (a - pc[path]).abs()
            n_el += d.numel()
            assert float(d.max()) <= 2 * rounds * lr, path
            if path != "blocks.attn.kb":
                outliers += int((d > 1e-5).sum())
    print(f"parameter elements past 1e-5: {outliers} of {n_el}")
    assert outliers <= n_el // 10 ** 4


def test_grad_frame_topk_residual_on_card_matches_cpu():
    """Three rounds of one client's ``int8+topk0.25`` gradient hop at the
    full-width shape [2, 512, 2560] bf16, from a small random f32
    residual and then each round from one residual:
    the card's picks, payload, scales, decoded gradient and new f32
    residual bit for bit the CPU's on rows without a tie at the cut
    (bf16 gradients tie often; ``torch.topk`` picks among equal
    magnitudes as it likes on either device; the other rows are counted),
    the kept magnitudes equal on every row, and no codec kernel
    launched."""
    from repro_torch.runtime import protocol
    dev = cuda_device()
    g0 = torch.Generator().manual_seed(9)
    kk = wire.topk_count(2560, 0.25)
    ef, tied = torch.randn((2, 512, 2560), generator=g0) * 1e-2, 0
    for step in range(3):
        g = torch.randn((2, 512, 2560), generator=g0).to(torch.bfloat16)
        corrected = g.float() + ef
        mags = corrected.abs().sort(dim=-1, descending=True).values
        free = mags[..., kk - 1] != mags[..., kk]
        tied += int((~free).sum())
        assert int(free.sum()) >= free.numel() // 2
        ac, mc, ef_c = protocol.encode_grad_payload(g, "int8+topk0.25", ef)
        ops.reset_launches()
        ag, mg_, ef_g = protocol.encode_grad_payload(
            g.to(dev), "int8+topk0.25", ef.to(dev))
        assert dict(ops.LAUNCHES) == {}
        by_c = ac["idx"].long().argsort(-1)     # kept entries by column
        by_g = ag["idx"].cpu().long().argsort(-1)
        for k in ("idx", "q"):
            assert torch.equal(torch.gather(ac[k], -1, by_c)[free],
                               torch.gather(ag[k].cpu(), -1, by_g)[free])
        assert torch.equal(ac["scale"][free], ag["scale"].cpu()[free])
        assert torch.equal(ef_c[free], ef_g.cpu()[free])
        assert bool(torch.isfinite(ef_g).all())
        dec_c = protocol.decode_grad_payload(protocol.unpack_frame(
            protocol.pack_frame(protocol.GRAD, 0, step, mc, ac)[4:]), "cpu")
        dec_g = protocol.decode_grad_payload(protocol.unpack_frame(
            protocol.pack_frame(protocol.GRAD, 0, step, mg_, ag)[4:]), dev)
        assert torch.equal(dec_c[free], dec_g.cpu()[free])
        assert torch.equal(dec_c.abs().sort(-1).values,
                           dec_g.cpu().abs().sort(-1).values)
        ef = ef_c
    print(f"rows with a tie at the cut, held to their kept magnitudes: "
          f"{tied}")


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_encode_grad_payload_int8_on_card_is_the_plain_codec(dt):
    """The dense int8 GRAD frame coded on the card is bit-identical to the
    plain codec's frame (one encode launch), and decodes on the card to
    the plain decode's values (one decode launch, route warp256)."""
    from repro_torch.runtime import protocol
    dev = cuda_device()
    g = (torch.randn((2, 512, 2560), generator=torch.Generator().manual_seed(
        3)) * 2).to(TORCH_DT[dt])
    ac, mc, _ = protocol.encode_grad_payload(g, "int8")
    ops.reset_launches()
    ag, mg_, _ = protocol.encode_grad_payload(g.to(dev), "int8")
    assert dict(ops.LAUNCHES) == {"wire_encode": 1}
    fc = protocol.pack_frame(protocol.GRAD, 1, 2, mc, ac)
    fg = protocol.pack_frame(protocol.GRAD, 1, 2, mg_, ag)
    assert fc == fg
    wc.ROUTES.clear()
    out = protocol.decode_grad_payload(protocol.unpack_frame(fg[4:]), dev)
    assert dict(ops.LAUNCHES) == {"wire_encode": 1, "wire_decode": 1}
    assert dict(wc.ROUTES) == {"warp256": 1}
    assert torch.equal(out.cpu(), protocol.decode_grad_payload(
        protocol.unpack_frame(fc[4:]), "cpu"))


# ------------------------------------- ResNet-18 split training (f32, no TF32)

RESNET_ALLOC = [3, 2, 1, 2]     # UE 2 sits out three of k = 4 micro-batches


def _resnet_inputs(n=8, seed=0):
    from repro_torch.data.synthetic import image_batches
    from repro_torch.models import resnet
    b = next(image_batches(n, seed=seed))
    params = resnet.init_resnet18(torch.Generator().manual_seed(seed))
    return (params, torch.from_numpy(b["images"]),
            torch.from_numpy(b["labels"]).long())


def test_resnet_convolution_on_card_is_full_f32():
    """A 3x3 convolution at stage 2's width in f32 on the card against the
    CPU in f64: TF32 (10 mantissa bits) would miss 1e-5 by ~100x."""
    from repro_torch.models import resnet
    dev = cuda_device()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 256, 8, 8, generator=g)
    w = torch.randn(256, 256, 3, 3, generator=g) * 0.03
    want = resnet._conv(x.double(), w.double(), 2)
    got = resnet._conv(x.to(dev), w.to(dev), 2).cpu().double()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_resnet_forward_cut_on_card_matches_cpu():
    from repro_torch.models import resnet
    dev = cuda_device()
    params, x, _ = _resnet_inputs()
    card = tree_map(lambda t: t.to(dev), params)
    with torch.no_grad():
        for l in range(1, 6):
            a = resnet.forward_cut(params, x, 0, l)
            ag = resnet.forward_cut(card, x.to(dev), 0, l)
            assert float((ag.cpu() - a).abs().max()) <= 1e-3
            out = resnet.forward_cut(params, a, l, 6)
            outg = resnet.forward_cut(card, ag, l, 6)
            assert float((outg.cpu() - out).abs().max()) <= 1e-3


def _resnet_step(scheme, where, params, x, y, l=1, k=4, lr=0.05):
    from repro_torch.launch.wireless_sl import STEPS
    from repro_torch.sl.c2p2sl import init_sl_state, shard_batch
    from repro_torch.sl.split import resnet_split
    spec = resnet_split(l)
    opt = sgd(lr, momentum=0.9)
    st = init_sl_state(spec, tree_map(lambda t: t.to(where), params), opt)
    tree = {"ue_params": st.ue_params, "bs_params": st.bs_params,
            "opt_state_ue": st.opt_state_ue,
            "opt_state_bs": st.opt_state_bs, "step": st.step}
    kk = k if scheme == "C2P2SL" else 1
    xs, ys = shard_batch(x.to(where), y.to(where), np.array(RESNET_ALLOC), kk)
    tree, mets = STEPS[scheme](spec, opt, kk)(tree, xs, ys)
    return float(mets["loss"]), tree


@pytest.mark.parametrize("scheme", ["C2P2SL", "PSL", "EPSL", "SL"])
def test_resnet_split_step_on_card_matches_cpu(scheme):
    """One SGD step of each scheme at cut 1 (C²P²SL at k = 4) on the card
    and on the CPU: loss and every updated parameter within 1e-3.  At lr
    0.01: SL's four updates in a row on 1-3 images at lr 0.05 drive its
    last loss to 0 and leave its f32 parameters 2.1e-3 from the same step
    in f64 on one CPU (2.3e-4 at lr 0.01), so no two f32 devices could
    agree to 1e-3 there."""
    dev = cuda_device()
    params, x, y = _resnet_inputs()
    lc, tc = _resnet_step(scheme, "cpu", params, x, y, lr=0.01)
    lg, tg = _resnet_step(scheme, dev, params, x, y, lr=0.01)
    assert abs(lg - lc) <= 1e-3
    for side in ("ue_params", "bs_params"):
        for a, b in zip(tree_leaves(tg[side]), tree_leaves(tc[side])):
            assert float((a.detach().cpu() - b.detach()).abs().max()) <= 1e-3


def test_resnet_c2p2sl_equals_psl_on_card():
    """k = 4 C²P²SL against k = 1 PSL on the card at 2e-4, the reference's
    equivalence bound, and EPSL's UE side away from it."""
    dev = cuda_device()
    params, x, y = _resnet_inputs()
    _, tc = _resnet_step("C2P2SL", dev, params, x, y)
    _, tp = _resnet_step("PSL", dev, params, x, y)
    _, te = _resnet_step("EPSL", dev, params, x, y)
    dist = lambda a, b, side: max(float((u - v).detach().abs().max())
                                  for u, v in zip(
        tree_leaves(a[side]), tree_leaves(b[side])))
    assert dist(tc, tp, "ue_params") < 2e-4 and dist(tc, tp, "bs_params") < 2e-4
    assert dist(te, tp, "ue_params") > 2e-4


# ------------------------------------- the launcher: resume and replan


_LAUNCH = ["--arch", "qwen1.5-4b", "--size", "smoke", "--batch", "4",
           "--seq", "16", "--log-every", "0", "--pipeline-stages", "2"]


def test_launcher_resume_on_the_card_equals_the_uninterrupted_run(
        tmp_path):
    """The f32 SMOKE qwen on the card, top-k hop and compressed
    gradients: steps 1-2 and a checkpoint, then step 3 from it, equal the
    3-step run bit for bit (loss and every state leaf, kept on the card)."""
    from repro_torch.launch import train
    cuda_device()
    argv = _LAUNCH + ["--steps", "3", "--pipeline-k", "2", "--wire-dtype",
                      "int8+topk0.25", "--compress-grads"]
    whole = train.main(argv)
    ck = str(tmp_path / "ck")
    train.main(argv + ["--ckpt-dir", ck, "--ckpt-every", "2"])
    resumed = train.main(argv + ["--ckpt-dir", ck])
    assert resumed["ckpt"]["resumed_from"] == 2
    assert resumed["rows"][0]["loss"] == whole["rows"][2]["loss"]
    for key in whole["state"]:
        for a, b in zip(tree_leaves(resumed["state"][key]),
                        tree_leaves(whole["state"][key])):
            if isinstance(a, torch.Tensor):
                assert a.device.type == "cuda" and torch.equal(a, b)
            else:
                assert a == b


def test_launcher_switches_once_on_the_card(tmp_path):
    """The SMOKE bandwidth-drop run of ``test_torch_launch_train.py`` on
    the card: one switch after the drop, to the top-k hop; finite losses
    and every step's hop bytes its own cell's bill."""
    import json

    from repro_torch.launch import train
    from repro_torch.runtime import protocol
    cuda_device()
    trace, plan_out = tmp_path / "trace.json", tmp_path / "plan.json"
    trace.write_text('{"steps": [0, 6], "bw_Bps": [1e8, 1e4]}')
    res = train.main(_LAUNCH + [
        "--steps", "12", "--replan", "every:3,hysteresis:0.05",
        "--replan-trace", str(trace), "--plan-out", str(plan_out)])
    switches = json.loads(plan_out.read_text())["replan"]["switches"]
    assert [(s["step"], s["new"]["wire_dtype"]) for s in switches] == [
        (10, "int8+topk0.25")]
    d = res["model"].cfg.d_model
    for r in res["rows"]:
        s, _k, v, wire = r["cell"]
        bill = tuple((s * v - 1) * protocol.billed_hop_bytes(
            4 * 16 * d, d, wire, 4, backward=bwd) for bwd in (False, True))
        assert np.isfinite(r["loss"])
        assert (r["hop_bytes_up"], r["hop_bytes_down"]) == bill
    assert res["state"]["wire_ef"].device.type == "cuda"


# ------------------------------------- the serving engine's CUDA graph


def _engine_model(arch, dev):
    """A SMOKE model (f32) on the card and the same weights on the CPU."""
    cfg = get_arch(arch).smoke
    cpu = LM(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    return (LM(cfg, dev), tree_map(lambda t: t.to(dev), params), cpu,
            params)


def _engine_requests(vocab, specs):
    from repro_torch.serving.scheduler import Request
    rng = np.random.default_rng(11)
    return [Request(rid=i, prompt=rng.integers(0, vocab, p),
                    max_new_tokens=g) for i, (p, g) in enumerate(specs)]


ENGINE_SPECS = [(5, 4), (5, 2), (7, 6), (5, 3), (7, 5)]


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "recurrentgemma-2b",
                                  "granite-moe-3b-a800m", "rwkv6-3b"])
def test_engine_graph_equals_eager_and_cpu(arch):
    """The captured step against the eager one on the card (tokens, and
    one step's logits bit for bit) and against the CPU engine (tokens)."""
    from repro_torch.serving.engine import ServingEngine
    dev = cuda_device()
    card, pcard, cpu, params = _engine_model(arch, dev)
    runs = {}
    for name, model, p, graph in (("graph", card, pcard, True),
                                  ("eager", card, pcard, False),
                                  ("cpu", cpu, params, False)):
        eng = ServingEngine(model, p, slots=3, cache_len=16, graph=graph,
                            keep_logits=(0,))
        runs[name] = (eng.run(_engine_requests(model.cfg.vocab,
                                               ENGINE_SPECS)), eng)
    assert runs["graph"][1].stats()["graph"]
    for rid, toks in runs["cpu"][0].items():
        np.testing.assert_array_equal(runs["graph"][0][rid], toks)
        np.testing.assert_array_equal(runs["eager"][0][rid], toks)
    assert torch.equal(runs["graph"][1].kept_logits[0],
                       runs["eager"][1].kept_logits[0])


def test_engine_replay_counts_launches_and_keeps_inactive_slots():
    """granite-moe SMOKE (moe_gmm in decode): a replayed step adds the
    launches the capture recorded, 3 moe_gmm a layer, and leaves the
    inactive slots' arena bytes unchanged."""
    from repro_torch.serving import kv
    from repro_torch.serving.engine import ServingEngine
    dev = cuda_device()
    card, pcard, _cpu, _params = _engine_model("granite-moe-3b-a800m", dev)
    eng = ServingEngine(card, pcard, slots=3, cache_len=16)
    for r in _engine_requests(card.cfg.vocab, [(5, 1), (5, 5)]):
        eng.submit(r)
    eng.step_once()
    assert list(eng.active) == [False, True, False]
    rows = lambda s: [t.clone() for t in tree_leaves(
        kv.take_slot(eng.cache, eng.axes, s))]
    before = [rows(s) for s in range(3)]
    ops.reset_launches()
    eng.step_once()
    torch.cuda.synchronize()
    assert dict(ops.LAUNCHES) == {"moe_gmm": 3 * card.cfg.num_layers}
    after = [rows(s) for s in range(3)]
    for s in (0, 2):
        assert all(torch.equal(a, b) for a, b in zip(before[s], after[s]))
    assert not all(torch.equal(a, b) for a, b in zip(before[1], after[1]))


def test_engine_capture_failure_raises(monkeypatch):
    """A step that reads a value on the host cannot be captured: the
    engine raises and does not carry on eagerly."""
    from repro_torch.serving.engine import ServingEngine
    dev = cuda_device()
    card, pcard, _cpu, _params = _engine_model("qwen1.5-4b", dev)
    orig = card.decode_step

    def syncing(*a, **k):
        logits, cache = orig(*a, **k)
        float(logits.sum())
        return logits, cache

    monkeypatch.setattr(card, "decode_step", syncing)
    with pytest.raises(RuntimeError, match="does not fall back"):
        ServingEngine(card, pcard, slots=2, cache_len=16)
