"""The attention backward's plain version against the JAX package, on the CPU.

The reference has no backward kernel: it differentiates
``models/common.py::chunked_attention`` (``_attend_block`` under
``jax.checkpoint``).  Here ``jax.vjp`` of that function, run with a
``q_chunk`` smaller than Sq so that its chunked branch (padded query
chunks under ``lax.scan``) runs, is held against the port's plain
forward with its log-sum-exp (``attention_plain_lse``) and its plain
backward (``attention_bwd_plain``, the algebra the CUDA kernel uses), at
1e-5 relative to the largest value, in f32.  The plain backward is also
held to the port's own autograd through ``attention_plain`` at 1e-6.

Inputs come from numpy seeds; q, k, v in the model's [B, S, H, dh]
layout, passed to the port as ``transpose(1, 2)`` views.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as ref_common
from repro_torch.kernels import flash_attention as fa

# (name, B, Hq, Hkv, Sq, Skv, dh, causal, window, q_chunk)
CASES = [
    ("causal_mha", 2, 3, 3, 40, 40, 16, True, 0, 16),
    ("causal_gqa", 1, 4, 2, 37, 37, 32, True, 0, 16),
    ("window", 1, 2, 2, 50, 50, 16, True, 8, 16),
    ("non_causal", 2, 2, 1, 24, 24, 16, False, 0, 16),
    # Sq >= Skv + window: rows 27-39 see no key, their softmax is uniform
    ("rows_without_keys", 1, 2, 1, 40, 20, 16, True, 8, 16),
    # recurrentgemma's local attention: dh 256, 10 q heads on 1 kv head
    ("dh256_window_gqa10", 1, 10, 1, 40, 40, 256, True, 16, 16),
]
TOL = 1e-5


def inputs(case, seed=0):
    _, b, hq, hkv, sq, skv, dh, *_ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    return q, k, v, do


def reference(case, q, k, v, do):
    """(out, lse, (dq, dk, dv)) of the reference, in its [B, S, H, dh]
    layout; lse [B, Hq, Sq] from the reference's masked logits.  One jitted
    graph, compiled without LLVM's optimisation passes (it runs once)."""
    _, b, hq, hkv, sq, skv, dh, causal, window, q_chunk = case

    def attend(q_, k_, v_):
        return ref_common.chunked_attention(
            q_, k_, v_, q_positions=jnp.arange(sq),
            kv_positions=jnp.arange(skv), causal=causal, window=window,
            q_chunk=q_chunk)

    def run(q_, k_, v_, do_):
        out, vjp = jax.vjp(attend, q_, k_, v_)
        qg = jnp.swapaxes(q_, 1, 2).reshape(b, hkv, hq // hkv, sq, dh)
        logits = jnp.einsum("bkrqd,bksd->bkrqs", qg,
                            jnp.swapaxes(k_, 1, 2)) / np.sqrt(dh)
        qp, kp = jnp.arange(sq)[:, None], jnp.arange(skv)[None, :]
        mask = jnp.ones((sq, skv), bool)
        if causal:
            mask = mask & (kp <= qp)
        if window > 0:
            mask = mask & (kp > qp - window)
        lse = jax.nn.logsumexp(jnp.where(mask, logits, -1e30), axis=-1)
        return out, lse.reshape(b, hq, sq), vjp(do_)
    args = [jnp.asarray(a) for a in (q, k, v, do)]
    out, lse, grads = jax.jit(run).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


def port_views(*arrays):
    """numpy [B, S, H, dh] -> torch [B, H, S, dh] views."""
    return [torch.from_numpy(a).transpose(1, 2) for a in arrays]


def close(got, want, tol=TOL):
    """max |got - want| within ``tol`` of the largest |want|."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_lse_and_backward_match_reference_vjp(case):
    causal, window = case[7], case[8]
    q, k, v, do = inputs(case)
    out_ref, lse_ref, grads_ref = reference(case, q, k, v, do)
    qt, kt, vt, dot = port_views(q, k, v, do)
    out, lse = fa.attention_plain_lse(qt, kt, vt, causal=causal,
                                      window=window)
    close(out.transpose(1, 2).numpy(), out_ref)
    finite = lse_ref > -1e29             # rows without keys: both -1e30
    np.testing.assert_array_equal(finite, lse.numpy() > -1e29)
    close(lse.numpy()[finite], lse_ref[finite])
    grads = fa.attention_bwd_plain(qt, kt, vt, out, lse, dot, causal=causal,
                                   window=window)
    for got, want in zip(grads, grads_ref):
        close(got.transpose(1, 2).numpy(), want)
    if not finite.all():
        # the reference's where mask: no gradient into q from those rows
        np.testing.assert_array_equal(
            grads[0].transpose(1, 2).numpy()[:, ~finite[0, 0]], 0.0)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_port_autograd(case):
    causal, window = case[7], case[8]
    q, k, v, do = inputs(case, seed=1)
    qt, kt, vt, dot = port_views(q, k, v, do)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out, lse = fa.attention_plain_lse(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, dot)
    got = fa.attention_bwd_plain(qt, kt, vt, out.detach(), lse.detach(), dot,
                                 causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        close(g.numpy(), w.numpy(), tol=1e-6)


def test_plain_lse_of_a_row_without_keys_is_the_mask_value():
    """Every logit of such a row is -1e30, so log(Skv e^-1e30) rounds to
    -1e30 in f32, which the CUDA forward writes too."""
    case = CASES[-1]
    q, k, v, _ = inputs(case)
    _, lse = fa.attention_plain_lse(*port_views(q, k, v), causal=True,
                                    window=case[8])
    first = case[5] + case[8] - 1                # Skv + window - 1
    assert torch.all(lse[..., first:] == -1e30)
    assert torch.all(lse[..., :first] > -1e29)


@pytest.mark.parametrize("sq,skv", [(0, 12), (12, 0)])
def test_plain_backward_at_zero_length_is_zero(sq, skv):
    """No query row or no key: zero gradients of the inputs' shapes (the
    CUDA wrapper returns the same without a launch)."""
    rng = np.random.default_rng(5)
    q, do = (torch.from_numpy(rng.standard_normal((1, 2, sq, 16))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, skv, 16))
                             .astype(np.float32)) for _ in range(2))
    o, lse = torch.zeros_like(q), torch.zeros((1, 2, sq))
    for g, t in zip(fa.attention_bwd_plain(q, k, v, o, lse, do), (q, k, v)):
        assert g.shape == t.shape and not bool(g.any())
