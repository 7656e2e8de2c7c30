"""Hybrid and MoE training in the port against the JAX package, on the CPU.

The backward kernels' plain versions against ``jax.vjp`` of the
reference functions they stand for, and one AdamW step of each family's
SMOKE model against the reference's ``make_lm_train_step``.  Inputs come
from numpy seeds; parameters from the reference's ``init`` through
``bridge.py``.  Tolerances and their reasons:

* ``rglru_bwd_plain`` against ``jax.vjp`` of ``models/recurrent.py``
  ``rg_lru_scan`` (S <= 256) and ``rg_lru_scan_chunked`` (S > 256, padded
  with log a = 0), f32: 1e-5 relative to the largest value.  The port's
  coefficient is ``sqrt(1 - a * a)``, the reference's ``sqrt(1 -
  exp(2 log a))``; with log a <= -0.01 (1 - a^2 >= 0.02) the two differ
  by well under that.  bf16: the f32 reference on the bf16 inputs (widened
  exactly) to 1e-2 of the largest value, the bf16 scan's contract on the
  card (``chip_smoke.py``): the backward reads the forward's h, which is
  rounded to bf16 (ROADMAP Queue 3, fault 4), and dlog a sums a h_{t-1}
  and a^2 x / c terms that cancel;
* ``moe_gmm_bwd_plain`` against ``jax.vjp`` of the reference's expert
  einsum (``models/moe.py``): 1e-5 relative to the largest value in f32
  (sums in another order), 5e-2 in bf16 (each output rounded to bf16
  once on both sides), the forward's contract;
* the training steps: losses, aux and every parameter leaf and AdamW
  moment at 1e-5 (the bound ``test_torch_training.py`` holds the dense
  and RWKV steps to), at lr 1e-4 for the reason given there.

The attention backward at head dim 256 (GQA 10 : 1 with a window) is a
case of ``test_torch_flash_bwd.py``.  The reference's graphs are compiled
by ``ref_compile`` (LLVM optimisation level 0): each runs once or twice.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.data.synthetic import TokenTaskConfig as RefTask
from repro.data.synthetic import token_batches as ref_token_batches
from repro.models import LM as RefLM
from repro.models import recurrent as ref_rec
from repro.parallel.steps import make_lm_train_step as ref_train_step
from repro.training import optim as ref_optim
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import rglru as rg
from repro_torch.launch import train
from repro_torch.models.lm import LM
from repro_torch.parallel import pipeline
from repro_torch.parallel.steps import make_lm_train_step
from repro_torch.runtime import protocol
from repro_torch.training import optim

GRANITE, HYBRID = "granite-moe-3b-a800m", "recurrentgemma-2b"
SEQ = 24            # past the hybrid SMOKE window of 8


def ref_compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def close(got, want, tol):
    """Within ``tol`` of the largest |want|."""
    got = np.asarray(torch.as_tensor(got).detach().double()
                     if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def as_torch(a, dt):
    return torch.from_numpy(a).to(dt)


# ------------------------------------------------------------ RG-LRU


@pytest.mark.parametrize("s,with_h0,dt", [
    (37, True, torch.float32), (1, False, torch.float32),
    (300, True, torch.float32), (300, False, torch.float32),
    (70, True, torch.bfloat16)])
def test_rglru_bwd_plain_matches_reference_vjp(s, with_h0, dt):
    """(dx, dlog_a, dh0) from the gradients of h and h_last; S > 256 runs
    the reference's chunked scan (two chunks, the second padded)."""
    b, r = 2, 24
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, r)).astype(np.float32)
    la = rng.uniform(-3.0, -0.01, (b, s, r)).astype(np.float32)
    h0 = rng.standard_normal((b, r)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((b, s, r)).astype(np.float32)
    dh_last = rng.standard_normal((b, r)).astype(np.float32)
    if dt == torch.bfloat16:      # the reference on the bf16 values
        x, la, dh, dh_last = (np.asarray(as_torch(a, dt).float())
                              for a in (x, la, dh, dh_last))
    scan = ref_rec.rg_lru_scan_chunked if s > 256 else ref_rec.rg_lru_scan

    def run(x_, la_, h0_, dh_, dhl_):
        _, vjp = jax.vjp(scan, x_, la_, h0_)
        return vjp((dh_, dhl_))
    h0_ref = np.zeros((b, r), np.float32) if h0 is None else h0
    args = [jnp.asarray(a) for a in (x, la, h0_ref, dh, dh_last)]
    want = ref_compile(run, *args)(*args)

    xt, lat, dht, dhlt = (as_torch(a, dt) for a in (x, la, dh, dh_last))
    h0t = None if h0 is None else torch.from_numpy(h0)
    h, _ = rg.rglru_plain(xt, lat, h0t)
    got = rg.rglru_bwd_plain(xt, lat, h0t, h, dht, dhlt)
    assert got[0].dtype == dt and got[1].dtype == dt
    tol = 1e-2 if dt == torch.bfloat16 else 1e-5
    for g, w in zip(got[:2], want[:2]):
        close(g, w, tol)
    if h0 is None:
        assert got[2] is None
    else:
        close(got[2], want[2], tol)


def test_rglru_bwd_plain_matches_port_autograd_at_zero_length():
    """S = 0: h_last is h0, so dh0 is dh_last and nothing else moves."""
    rng = np.random.default_rng(4)
    x = torch.zeros((2, 0, 8))
    h0, dhl = (torch.from_numpy(rng.standard_normal((2, 8)).astype(
        np.float32)) for _ in range(2))
    dx, dla, dh0 = rg.rglru_bwd_plain(x, x, h0, x, x, dhl)
    assert dx.shape == dla.shape == (2, 0, 8)
    torch.testing.assert_close(dh0, dhl, rtol=0, atol=0)


# ------------------------------------------------------------ moe_gmm


@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-5),
                                    (torch.bfloat16, 5e-2)])
def test_moe_gmm_bwd_plain_matches_reference_vjp(dt, tol):
    """dh = dout w^T and dw = h^T dout per expert, against the vjp of the
    reference's ``einsum("ecd,edf->ecf")`` in the same dtype."""
    rng = np.random.default_rng(7)
    e, c, d, f = 5, 24, 40, 16
    h = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    do = rng.standard_normal((e, c, f)).astype(np.float32)
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32

    def run(h_, w_, do_):
        _, vjp = jax.vjp(lambda a, b: jnp.einsum("ecd,edf->ecf", a, b),
                         h_, w_)
        return vjp(do_)
    args = [jnp.asarray(a, jdt) for a in (h, w, do)]
    want = ref_compile(run, *args)(*args)
    got = mg.moe_gmm_bwd_plain(*(as_torch(a, dt) for a in (h, w, do)))
    for g, wv in zip(got, want):
        assert g.dtype == dt
        close(g, np.asarray(wv, np.float32), tol)


# ------------------------------------------------------------ train steps


def _setup(arch):
    """The reference SMOKE model, its init as numpy and two batches of
    6 x SEQ tokens."""
    ref = RefLM(ref_arch(arch).smoke)
    key = jax.random.key(0)
    tree = jax.tree.map(np.asarray, ref_compile(ref.init, key)(key))
    batches = ref_token_batches(RefTask(vocab=get_arch(arch).smoke.vocab),
                                6, SEQ, seed=3)
    return ref, tree, next(batches)


def _close_trees(got, want, tol=1e-5):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        close(g, np.asarray(w), tol)


@pytest.mark.parametrize("arch,port_kw", [
    (GRANITE, dict(microbatches=2)),
    (GRANITE, dict(pipeline=pipeline.PipelineSpec(2, 2))),
    (HYBRID, dict(microbatches=2))], ids=["moe_k2", "moe_s2_none", "hybrid_k2"])
def test_train_step_matches_reference(arch, port_kw):
    """One AdamW step, k = 2: the port's accumulated step, or its S = 2
    pipeline with the raw hop, against the reference's accumulated step:
    loss, aux, parameters (the MoE router through the aux) and m, v.  The
    train state crosses by ``bridge.train_state_from_jax`` and comes back
    by ``train_state_to_jax`` (the stacked MoE tree with its f32 router,
    the hybrid's tuple of blocks), the initial one bit for bit."""
    ref, tree, batch = _setup(arch)
    ref_opt = ref_optim.adamw(1e-4, grad_clip=1.0)
    params = jax.tree.map(jnp.asarray, tree)
    rs = {"params": params, "opt_state": ref_opt.init(params),
          "step": jnp.zeros((), jnp.int32)}
    start = jax.tree.map(np.asarray, rs)
    ps = bridge.train_state_from_jax(start)
    back = bridge.train_state_to_jax(ps)
    assert jax.tree.structure(back) == jax.tree.structure(start)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(start)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rbatch = jax.tree.map(jnp.asarray, batch)
    rs, rm = ref_compile(ref_train_step(ref, ref_opt, microbatches=2),
                         rs, rbatch)(rs, rbatch)

    step = make_lm_train_step(LM(get_arch(arch).smoke, "cpu"),
                              optim.adamw(1e-4, grad_clip=1.0), **port_kw)
    ps, pm = step(ps, {n: torch.from_numpy(np.asarray(a))
                       for n, a in batch.items()})
    close(float(pm["loss"]), float(rm["loss"]), 1e-5)
    close(float(pm["aux"]), float(rm["aux"]), 1e-5)
    if arch == GRANITE:
        assert float(pm["aux"]) > 0
    got = bridge.train_state_to_jax(ps)
    assert int(got["step"]) == int(rs["step"]) == 1
    for k in ("params", "opt_state"):
        _close_trees(got[k], rs[k])
    moved = jax.tree.map(lambda a, b: bool(np.any(a != b)),
                         got["params"], tree)
    assert all(jax.tree.leaves(moved))


# ------------------------------------------------------------ CLI


@pytest.mark.parametrize("arch,argv", [
    (GRANITE, ["--pipeline-stages", "2", "--pipeline-k", "2",
               "--wire-dtype", "int8"]),
    (HYBRID, ["--microbatches", "2"])])
def test_train_cli_on_cpu(arch, argv):
    """Two logged steps at the SMOKE size; the rows carry the aux, and the
    MoE run's int8 hop bills its bytes exactly."""
    res = train.main(["--arch", arch, "--size", "smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "4", "--seq", "16",
                      "--log-every", "1", *argv])
    d = get_arch(arch).smoke.d_model
    billed = protocol.billed_hop_bytes(4 * 16 * d, d, "int8", 4) \
        if arch == GRANITE else 0
    for r in res["rows"]:
        assert np.isfinite(r["loss"])
        assert np.isfinite(r["aux"]) if arch == GRANITE else "aux" not in r
        assert r["hop_bytes_up"] == r["hop_bytes_down"] == billed
    if arch == HYBRID:
        with pytest.raises(ValueError, match="homogeneous"):
            train.main(["--arch", arch, "--device", "cpu", "--steps", "1",
                        "--pipeline-stages", "3"])
