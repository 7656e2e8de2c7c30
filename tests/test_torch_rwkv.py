"""The port's RWKV6 path against the JAX package's, on the CPU.

Inputs come from numpy seeds; parameters from the reference's ``init``
through ``bridge.py``.  Tolerances and their reasons:

* the plain ``wkv6_scan`` / ``wkv6_chunked`` against the JAX functions of
  the same name: 1e-5 in f32 relative to the largest value (the same
  arithmetic; sums in another order);
* the plain versions against the Pallas ``wkv6`` in interpret mode: 3e-4,
  the bound the reference's own test holds its kernel to;
* plain autograd against ``jax.vjp`` of ``wkv6_chunked``: 1e-4 relative to
  the largest gradient (two autodiffs of f32 chunked products);
* the RWKV block and the LM loss: 1e-5 in f32.

The reference runs through ``_ref_run``: jitted, and compiled without
LLVM's optimisation passes, since each graph runs once on small inputs
and its compile time is the test's time.

The CUDA kernels cannot run here; their backward is a decomposition of
the adjoint that ``csrc/wkv6.cu`` spells out pass by pass.  That
decomposition is written out below in f64 and held to autograd at 1e-9,
so a fault in the algebra shows here and not only on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.kernels.rwkv6 import wkv6 as pallas_wkv6
from repro.models import LM as RefLM
from repro.models import blocks as ref_blocks
from repro.models import rwkv as ref_rwkv
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as rw
from repro_torch.models import blocks
from repro_torch.models.lm import LM
from repro_torch.models.lm import layer as lm_layer
from repro_torch.utils.trees import tree_leaves

RNG = np.random.default_rng(12)
CFG_REF = ref_arch("rwkv6-3b").smoke
CFG = get_arch("rwkv6-3b").smoke


def _inputs(b, s, h, dh, *, strong=False, s0=False, seed=0):
    """r, k, v, w (the reference's decay draws), u, s0 as numpy f32."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (rng.standard_normal(shape)
                                   * scale).astype(np.float32)
    lo = -3.0 if strong else -6.0
    w = np.exp(-np.exp(rng.uniform(lo, 0.5, (b, s, h, dh)))).astype(
        np.float32)
    return (f(b, s, h, dh), f(b, s, h, dh), f(b, s, h, dh), w,
            f(h, dh, scale=0.2), f(b, h, dh, dh, scale=0.1) if s0 else None)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _ref_run(fn, *args):
    """``fn(*args)`` of the reference, jitted and compiled at LLVM
    optimisation level 0 (the same HLO; a few times faster to build)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _close(got, want, tol):
    """Within ``tol`` relative to the largest value: the outputs are sums
    over up to 150 steps whose small entries come from cancellation."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


# ------------------------------------------------------------ plain forward


@pytest.mark.parametrize("s,s0,strong", [(40, False, False), (64, True, False),
                                         (100, True, True), (150, False, True)])
def test_plain_wkv6_matches_jax(s, s0, strong):
    args = _inputs(2, s, 3, 16, strong=strong, s0=s0, seed=s)
    for name in ("wkv6_scan", "wkv6_chunked"):
        o, st_ = getattr(rw, name)(*map(_t, args))
        ro, rst = _ref_run(getattr(ref_rwkv, name), *map(_j, args))
        _close(o, ro, 1e-5)
        _close(st_, rst, 1e-5)


@pytest.mark.parametrize("b,h,s_chunks,dh,strong", [(2, 1, 1, 32, True),
                                                    (1, 2, 2, 16, False)])
def test_plain_wkv6_matches_pallas_interpret(b, h, s_chunks, dh, strong):
    args = _inputs(b, 64 * s_chunks, h, dh, strong=strong, s0=True,
                   seed=dh + s_chunks)
    po, pst = _ref_run(lambda *a: pallas_wkv6(*a, interpret=True),
                       *map(_j, args))
    for fn in (rw.wkv6_scan, rw.wkv6_chunked):
        o, st_ = fn(*map(_t, args))
        _close(o, po, 3e-4)
        _close(st_, pst, 3e-4)


# ------------------------------------------------------------ plain backward


@pytest.mark.parametrize("s,strong,s0", [(96, True, True), (33, False, False)])
def test_plain_wkv6_grads_match_jax_vjp(s, strong, s0):
    """Autograd through the port's dispatch (scan or chunked, on log w)
    against jax.vjp of the reference's wkv6_chunked, ragged S included."""
    r, k, v, w, u, s0_ = _inputs(1, s, 2, 16, strong=strong, s0=s0, seed=s)
    rng = np.random.default_rng(s + 1)
    dout = rng.standard_normal(r.shape).astype(np.float32)
    ds_t = rng.standard_normal((1, 2, 16, 16)).astype(np.float32)
    logw = np.log(w)

    def ref_grads(*prim):
        def fn(r, k, v, logw, u, s0=None):
            return ref_rwkv.wkv6_chunked(r, k, v, jnp.exp(logw), u, s0)
        _, vjp = jax.vjp(fn, *prim)
        return vjp((jnp.asarray(dout), jnp.asarray(ds_t)))

    want = _ref_run(ref_grads, *[jnp.asarray(a) for a in (r, k, v, logw, u)],
                    *([jnp.asarray(s0_)] if s0 else []))

    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in (r, k, v, logw, u)] + \
        ([torch.from_numpy(s0_).requires_grad_(True)] if s0 else [])
    out, s_t = ops.wkv6(*ins[:5], s0=ins[5] if s0 else None)
    loss = (out * torch.from_numpy(dout)).sum() + \
        (s_t * torch.from_numpy(ds_t)).sum()
    got = torch.autograd.grad(loss, ins)
    for g, wnt in zip(got, want):
        _close(g, wnt, 1e-4)


def _kernel_backward_passes(r, k, v, logw, u, s0, dout, ds_t):
    """The adjoint exactly as csrc/wkv6.cu computes it (its three passes
    and the d log w scan), vectorized over (b, h, i), in f64."""
    b, s, h, dh = r.shape
    w = logw.exp()
    S = s0.clone()
    dr, p = torch.empty_like(r), torch.empty_like(r)
    du = torch.zeros((b, h, dh), dtype=r.dtype)
    for t in range(s):                           # pass 0: rows, forward
        acc = torch.einsum("bhij,bhj->bhi", S, dout[:, t])
        vdo = (v[:, t] * dout[:, t]).sum(-1, keepdim=True)
        dr[:, t] = acc + u * k[:, t] * vdo
        p[:, t] = r[:, t] * acc
        du += r[:, t] * k[:, t] * vdo
        S = w[:, t, ..., None] * S + k[:, t, ..., None] * v[:, t, :, None]
    f = (ds_t * S).sum(-1)
    dS_rows, dS_cols = ds_t.clone(), ds_t.clone()
    dk, dv, q = (torch.empty_like(r) for _ in range(3))
    for t in reversed(range(s)):                 # passes 1 and 2: reverse
        acc = torch.einsum("bhij,bhj->bhi", dS_rows, v[:, t])
        vdo = (v[:, t] * dout[:, t]).sum(-1, keepdim=True)
        dk[:, t] = acc + r[:, t] * u * vdo
        q[:, t] = k[:, t] * acc
        ruk = (r[:, t] * u * k[:, t]).sum(-1, keepdim=True)
        dv[:, t] = torch.einsum("bhi,bhij->bhj", k[:, t], dS_cols) \
            + dout[:, t] * ruk
        step = lambda d: w[:, t, ..., None] * d \
            + r[:, t, ..., None] * dout[:, t, :, None]
        dS_rows, dS_cols = step(dS_rows), step(dS_cols)
    dlogw = torch.empty_like(r)
    run_p = torch.zeros_like(f)
    run_q = torch.zeros_like(f)
    for t in reversed(range(s)):                 # d log w: suffix sums
        run_q = run_q + q[:, t]
        dlogw[:, t] = run_p - run_q + f
        run_p = run_p + p[:, t]
    return dr, dk, dv, dlogw, du.sum(0), dS_rows


@pytest.mark.parametrize("strong", [False, True])
def test_kernel_backward_decomposition_matches_autograd(strong):
    r, k, v, w, u, s0 = (torch.from_numpy(a).double() for a in
                         _inputs(2, 37, 3, 8, strong=strong, s0=True))
    logw = w.log()
    rng = np.random.default_rng(3)
    dout = torch.from_numpy(rng.standard_normal(r.shape))
    ds_t = torch.from_numpy(rng.standard_normal(s0.shape))
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
    state = ins[5]
    outs = []
    for t in range(r.shape[1]):                  # the scan in f64
        kv = ins[1][:, t, ..., None] * ins[2][:, t, :, None]
        outs.append(torch.einsum("bhi,bhij->bhj", ins[0][:, t],
                                 state + ins[4][None, ..., None] * kv))
        state = ins[3][:, t].exp()[..., None] * state + kv
    loss = (torch.stack(outs, 1) * dout).sum() + (state * ds_t).sum()
    want = torch.autograd.grad(loss, ins)
    got = _kernel_backward_passes(r, k, v, logw, u, s0, dout, ds_t)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("log_w,finite", [(-1.3, True), (-1.4, False)])
def test_single_level_chunked_form_overflows_past_88(log_w, finite):
    """ROADMAP Queue 3, fault 7: the reference's chunked form splits the
    intra-chunk decay around m = L_C / 2, so once a chunk's cumulative
    log-decay |L_C| passes ~88 (64 steps of log w = -1.4: 89.6) the masked
    j > t entries are inf * 0 = NaN.  Pinned at [1, 65, 1, 16], the
    smallest input that takes the chunked path (S > 64): the JAX
    ``wkv6_chunked`` and the port's ``wkv6_plain`` agree on it, and the
    step-by-step scans of both stay finite.  The port's chunked CUDA route
    (two-level factors, no positive exponent) is held to the scan at
    log w = -5 and -20 in tests/test_torch_cuda.py."""
    r, k, v, _, u, _ = _inputs(1, 65, 1, 16, seed=0)
    logw = np.full(r.shape, log_w, np.float32)
    w = np.exp(logw)
    ro, rst = _ref_run(ref_rwkv.wkv6_chunked, *map(_j, (r, k, v, w, u)))
    po, pst = rw.wkv6_plain(*map(_t, (r, k, v, logw, u)))
    assert bool(np.isfinite(np.asarray(ro)).all()) is finite
    assert bool(torch.isfinite(po).all()) is finite
    assert bool(np.isfinite(np.asarray(rst)).all())
    for out, st_ in (rw.wkv6_scan(*map(_t, (r, k, v, w, u))),
                     _ref_run(ref_rwkv.wkv6_scan, *map(_j, (r, k, v, w, u)))):
        assert bool(np.isfinite(np.asarray(out)).all())
        assert bool(np.isfinite(np.asarray(st_)).all())


def test_cpu_dispatch_takes_the_plain_version_and_counts_nothing():
    args = [_t(a) for a in _inputs(1, 20, 2, 16)]
    args[3] = args[3].log()
    ops.reset_launches()
    out, s_t = ops.wkv6(*args[:5])
    want, want_s = rw.wkv6_scan(*[_t(a) for a in _inputs(1, 20, 2, 16)][:5])
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s_t, want_s, rtol=1e-6, atol=1e-6)
    assert sum(ops.LAUNCHES.values()) == 0


# ------------------------------------------------------------ block and LM


@pytest.fixture(scope="module")
def rwkv_models():
    ref = RefLM(CFG_REF)
    tree = jax.tree.map(np.asarray, _ref_run(ref.init, jax.random.key(0)))
    return ref, jax.tree.map(jnp.asarray, tree), LM(CFG, "cpu"), \
        bridge.params_from_jax(tree)


@pytest.mark.parametrize("s", [24, 80])     # the scan and the chunked form
def test_rwkv_block_matches_reference(rwkv_models, s):
    _ref, ref_params, _port, params = rwkv_models
    x = np.random.default_rng(s).standard_normal((2, s, CFG.d_model)) \
        .astype(np.float32)
    layer = lambda tree: jax.tree.map(lambda a: a[0], tree)
    want, _ = _ref_run(lambda p, x: ref_blocks.apply_block(
        p, x, CFG_REF, "rwkv", positions=jnp.arange(s)),
        layer(ref_params["blocks"]), jnp.asarray(x))
    got, aux = blocks.apply_block(lm_layer(params["blocks"], 0),
                                  torch.from_numpy(x), CFG, "rwkv")
    _close(got.detach(), want, 1e-5)
    assert float(aux) == 0.0


@pytest.mark.parametrize("s", [100])   # chunked WKV, two xent chunks' pad
def test_lm_forward_loss_matches_reference(rwkv_models, s):
    ref, ref_params, port, params = rwkv_models
    rng = np.random.default_rng(s)
    toks, labs = (rng.integers(0, CFG.vocab, (2, s)).astype(np.int32)
                  for _ in range(2))
    labs[0, :5] = -1                                 # padded labels
    want, wm = _ref_run(ref.forward, ref_params,
                        {"tokens": jnp.asarray(toks),
                         "labels": jnp.asarray(labs)})
    got, gm = port.forward(params, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(labs)})
    _close(float(got), float(want), 1e-5)
    _close(float(gm["xent"]), float(wm["xent"]), 1e-5)
    hidden = port.hidden(params, {"tokens": torch.from_numpy(toks)})
    _close(hidden.detach(), _ref_run(
        ref.hidden, ref_params, {"tokens": jnp.asarray(toks)}), 1e-5)


def test_master_init_layout_and_dtypes(rwkv_models):
    _ref, ref_params, port, _params = rwkv_models
    master = port.init(torch.Generator().manual_seed(0), master=True)
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref_params)
    assert jax.tree.map(lambda a: tuple(a.shape),
                        bridge.params_to_jax(master)) == shapes
    assert all(t.dtype == torch.float32 for t in tree_leaves(master))
    full = dataclasses.replace(CFG, dtype="bfloat16")
    serve = LM(full, "cpu").init(torch.Generator().manual_seed(0))
    assert serve["blocks"]["time"]["w_r"].dtype == torch.bfloat16
    assert serve["blocks"]["time"]["w0"].dtype == torch.float32
    assert serve["blocks"]["time"]["u"].dtype == torch.float32
