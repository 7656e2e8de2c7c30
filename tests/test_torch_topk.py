"""The coded pipeline step's top-k gradient hop with error feedback,
interleaved virtual stages and error-feedback gradient compression,
against the JAX package's, on the CPU.

Inputs are numpy draws from fixed seeds (the smoke qwen's parameters from
the reference's ``init``).  Tolerances:

* the top-k codec: payload, indices and scales bit for bit against the
  reference run eagerly, on rows without a tie among the ``kk + 1``
  largest magnitudes (``torch.topk`` promises no order among equal
  magnitudes, ``jax.lax.top_k`` takes the lower index);
* the EF hop against ``coded_ppermute_ef``: the forward within one
  quantum plus 1e-6 (the reference's jitted dense scale is
  ``amax * (1/qmax)``, ROADMAP Queue 3, fault 1); the gradient and the new
  residual bit for bit (the top-k path of the hop runs unjitted there);
* ``compress_grads``: bit for bit against the reference run eagerly;
* the byte model: exact;
* the one-card S 2, v 2, ``int8+topk0.25`` compressed step against the
  reference's run on 8 virtual devices (mesh pod 2 × data 2 × model 2)
  over 2 AdamW steps: losses 1e-5 relative, parameters 1e-5, the EF
  buffer within 1e-5 of its largest value (8.6e-7 measured) with its
  zero/nonzero slots equal, and ``error_fb`` within 1e-6 but for int8
  rounding flips, where the two residuals sit on either side of half a
  quantum (``g ≈ -r``; 1 element of 4096 measured, fault 1 again).
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import autotune as ref_autotune
from repro.configs import get_arch as ref_arch
from repro.models import LM as RefLM
from repro.models import LMConfig as RefLMConfig
from repro.parallel import compat as ref_compat
from repro.parallel import pipeline as ref_pipeline
from repro.parallel import wire as ref_wire
from repro.parallel.compat import PartitionSpec as P
from repro.runtime import protocol as ref_protocol
from repro.training import compress as ref_compress
from repro_torch import bridge
from repro_torch.analysis import autotune
from repro_torch.models.config import LMConfig
from repro_torch.models.lm import LM
from repro_torch.parallel import pipeline, wire
from repro_torch.parallel.steps import make_lm_train_step
from repro_torch.runtime import protocol
from repro_torch.training import compress, optim

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def tie_free_rows(x: np.ndarray, kk: int) -> np.ndarray:
    """Rows [..., d] whose kk + 1 largest magnitudes are all distinct."""
    top = -np.sort(-np.abs(x), axis=-1)[..., :kk + 1]
    return (np.diff(top, axis=-1) != 0).all(axis=-1)


# ------------------------------------------------------------ top-k codec


@pytest.mark.parametrize("wire_dtype", ["int8+topk0.25", "fp8+topk0.25"])
@pytest.mark.parametrize("d", [64, 2560])
def test_topk_codec_matches_reference(wire_dtype, d):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((3, 5, d))
         * rng.uniform(0.01, 10, (3, 5, 1))).astype(np.float32)
    x[0, 0] = np.round(x[0, 0])             # a row full of ties
    q, idx, s = ref_wire.topk_encode(jnp.asarray(x), wire_dtype)
    pq, pidx, ps = wire.topk_encode(torch.from_numpy(x), wire_dtype)
    kk = wire.topk_count(d, 0.25)
    assert pq.shape == (3, 5, kk) and pidx.dtype == torch.int16
    free = tie_free_rows(x, kk)
    assert not free[0, 0] and free.sum() >= 10
    np.testing.assert_array_equal(
        pq.to(torch.float32).numpy()[free],
        np.asarray(q.astype(jnp.float32))[free])
    np.testing.assert_array_equal(pidx.numpy()[free], np.asarray(idx)[free])
    np.testing.assert_array_equal(ps.numpy(), np.asarray(s))
    want = np.asarray(ref_wire.topk_decode(q, idx, s, d, jnp.float32))
    got = wire.topk_decode(pq, pidx, ps, d, torch.float32).numpy()
    np.testing.assert_array_equal(got[free], want[free])
    # a row with ties keeps other entries of the same magnitudes
    np.testing.assert_array_equal(np.sort(np.abs(got), axis=-1),
                                  np.sort(np.abs(want), axis=-1))
    # the all-zero payload (indices colliding at 0) decodes to zeros
    zq = torch.zeros((3, kk), dtype=pq.dtype)
    zero = wire.topk_decode(zq, torch.zeros((3, kk), dtype=torch.int16),
                            torch.zeros((3, 1)), d, torch.bfloat16)
    assert zero.dtype == torch.bfloat16 and not zero.any()


def test_topk_count_and_index_dtype_match_reference():
    for d in (1, 7, 64, 257, 2560, 32767, 32768, 40000):
        for frac in (0.001, 0.1, 0.25, 0.5, 0.999):
            assert wire.topk_count(d, frac) == ref_wire.topk_count(d, frac)
        want = np.dtype(ref_wire.topk_index_dtype(d)).itemsize
        assert wire.topk_index_dtype(d).itemsize == want
    for name in ("none", "int8", "fp8", "int8+topk0.25", "fp8+topk0.5",
                 "int8+topk1.0"):
        assert wire.has_topk(name) == ref_wire.has_topk(name)


def _identity_ef_hop(wdt, x, ef):
    """``coded_ppermute_ef`` on a 1-device pod mesh with the identity
    permutation: a lossless link, the codec's arithmetic alone."""
    mesh = ref_compat.make_mesh((1,), ("pod",))
    return ref_compat.shard_map(
        lambda x, ef: ref_wire.coded_ppermute_ef(wdt, "pod", ((0, 0),), x,
                                                 ef),
        mesh, in_specs=(P(), P()), out_specs=P(), check=False)(x, ef)


@pytest.mark.parametrize("d", [64, 257])
def test_ef_hop_matches_reference_coded_ppermute_ef(d):
    """Forward the dense int8 codec, backward top-k of g + ef with the
    dropped mass as the slot's new residual; at d 257 (block 1: a net
    loss) both directions go raw and the residual stays."""
    wdt = "int8+topk0.25"
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 3, d)) * 3).astype(np.float32)
    ef = (rng.standard_normal((2, 3, d)) * 0.1).astype(np.float32)
    g = rng.standard_normal((2, 3, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, e: _identity_ef_hop(wdt, a, e),
                        jnp.asarray(x), jnp.asarray(ef))
    want_gx, want_ef = vjp(jnp.asarray(g))

    meter = wire.HopMeter()
    xt = torch.from_numpy(x).requires_grad_(True)
    slot = torch.from_numpy(ef.copy())
    got = wire.coded_hop(xt, wdt, meter, slot)
    (got_gx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    if d == 257:
        for a, b in ((got, x), (got_gx, g), (slot, ef),
                     (got, want), (got_gx, want_gx), (slot, want_ef)):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
        assert (meter.up, meter.down) == (x.nbytes, g.nbytes)
        return
    _, scale = wire.encode(torch.from_numpy(x), "int8")
    quantum = scale.expand(2, 3, 1, d).reshape(2, 3, d).numpy()
    err = np.abs(got.detach().numpy() - np.asarray(want))
    assert (err <= quantum + 1e-6).all(), float((err - quantum).max())
    np.testing.assert_array_equal(got_gx.numpy(), np.asarray(want_gx))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_ef))
    kk = wire.topk_count(d, 0.25)
    assert (meter.up, meter.down, meter.hops_up, meter.hops_down) == (
        6 * d + 6 * 4, 6 * (kk + 2 * kk + 4), 1, 1)
    with pytest.raises(ValueError, match="error feedback"):
        wire.coded_hop(xt, wdt, meter)


# ------------------------------------------------------------ compression


def test_compress_grads_match_reference():
    """Two rounds of EF on the smoke qwen's parameter tree (leaves of
    sizes that are and are not multiples of 256)."""
    ref = RefLM(ref_arch("qwen1.5-4b").smoke)
    key = jax.random.key(0)
    tree = jax.tree.map(np.asarray, jax.jit(ref.init)(key))
    rng = np.random.default_rng(2)
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                     * rng.uniform(1e-3, 1)).astype(
                                         np.float32), tree) for _ in range(2)]
    r_ef = ref_compress.init_error_fb(jax.tree.map(jnp.asarray, tree))
    p_ef = compress.init_error_fb(bridge.params_from_jax(tree))
    for g in grads:
        r_q, r_ef = ref_compress.compress_grads(
            jax.tree.map(jnp.asarray, g), r_ef)
        p_q, p_ef = compress.compress_grads(bridge.params_from_jax(g), p_ef)
        for a, b in zip(jax.tree.leaves(bridge.params_to_jax(p_ef)),
                        jax.tree.leaves(r_ef)):
            np.testing.assert_array_equal(a, np.asarray(b))
        r_dec = ref_compress.decompress_grads(r_q)
        p_dec = compress.decompress_grads(p_q)
        for a, b in zip(jax.tree.leaves(bridge.params_to_jax(p_dec)),
                        jax.tree.leaves(r_dec)):
            np.testing.assert_array_equal(a, np.asarray(b))
    leaf = p_q["embed"]
    assert leaf[0].dtype == torch.int8 and leaf[0].shape[-1] == 256
    assert leaf[1].shape == (leaf[0].shape[0], 1)


# ------------------------------------------------------------ EF buffer


def test_wire_ef_shapes_match_reference():
    ref_cfg = RefLMConfig(name="t", num_layers=4, d_model=32, n_heads=4,
                          n_kv=2, d_ff=64, vocab=128, dtype="float32")
    cfg = LMConfig(name="t", num_layers=4, d_model=32, n_heads=4, n_kv=2,
                   d_ff=64, vocab=128, dtype="float32")
    for s, k, v, w, b in ((2, 4, 2, "int8+topk0.25", 8),
                          (2, 4, 2, "int8+topk0.25", 10),
                          (3, 5, 1, "fp8+topk0.5", 7), (2, 4, 1, "int8", 8),
                          (1, 4, 2, "int8+topk0.25", 8)):
        rs = ref_pipeline.PipelineSpec(s, k, virtual_stages=v, wire_dtype=w)
        ps = pipeline.PipelineSpec(s, k, virtual_stages=v, wire_dtype=w)
        assert pipeline.wire_ef_ticks(ps) == ref_pipeline.wire_ef_ticks(rs)
        for m in range(k):
            assert pipeline._sigma(m, s, v) == ref_pipeline._sigma(m, s, v)
        want = ref_pipeline.wire_ef_zeros(ref_cfg, rs, b, 16)
        got = pipeline.wire_ef_zeros(cfg, ps, b, 16)
        if want is None:
            assert got is None
        else:
            assert tuple(got.shape) == tuple(want.shape)
            assert got.dtype == torch.float32 and not got.any()


# ------------------------------------------------------------ byte model


def test_backward_byte_model_matches_reference():
    for w in ("none", "int8", "fp8", "int8+topk0.25", "fp8+topk0.1"):
        for act in (2.0, 4.0):
            for d in (None, 32, 257, 2560, 40000):
                block = autotune.wire_block_for(d)
                assert block == ref_autotune.wire_block_for(d)
                got = autotune.wire_bytes_per_element_bwd(w, act, block, d)
                assert got == ref_autotune.wire_bytes_per_element_bwd(
                    w, act, block, d)
                assert autotune.wire_link_scale_bwd(w, act, block, d) == \
                    ref_autotune.wire_link_scale_bwd(w, act, block, d)
                if d is not None:
                    for bwd in (False, True):
                        assert protocol.billed_hop_bytes(
                            1000 * d, d, w, act, backward=bwd) == \
                            ref_protocol.billed_hop_bytes(
                                1000 * d, d, w, act, backward=bwd)
    # the top-k hop's own byte count is the bill at d 2560 (640 kept)
    n = 4096 * 2560
    assert protocol.billed_hop_bytes(n, 2560, "int8+topk0.25", 2,
                                     backward=True) == 4096 * (640 * 3 + 4)


# ------------------------------------------------------------ the step

_REF_STEP = """
    import pickle, sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.data import TokenTaskConfig, token_batches
    from repro.models import LM, LMConfig
    from repro.parallel.compat import make_mesh, mesh_context
    from repro.parallel.pipeline import PipelineSpec, wire_ef_zeros
    from repro.parallel.steps import make_lm_train_step
    from repro.training.compress import init_error_fb
    from repro.training.optim import adamw

    cfg = LMConfig(name="t", num_layers=4, d_model=32, n_heads=4, n_kv=2,
                   d_ff=64, vocab=128, dtype="float32")
    m = LM(cfg)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    it = token_batches(TokenTaskConfig(vocab=cfg.vocab), 8, 16, seed=5)
    batches = [next(it) for _ in range(2)]
    opt = adamw(1e-3)
    params = m.init(jax.random.key(0))
    spec = PipelineSpec(num_stages=2, microbatches=4, virtual_stages=2,
                        wire_dtype="int8+topk0.25")
    state = {"params": params, "opt_state": opt.init(params),
             "step": jnp.zeros((), jnp.int32),
             "wire_ef": wire_ef_zeros(cfg, spec, 8, 16),
             "error_fb": init_error_fb(params)}
    out = {"init": jax.tree.map(np.asarray, state), "batches": batches}
    step = jax.jit(make_lm_train_step(m, opt, pipeline=spec, mesh=mesh,
                                      compress=True))
    losses = []
    with mesh_context(mesh):
        for b in batches:
            state, mets = step(state, jax.tree.map(jnp.asarray, b))
            losses.append(float(mets["loss"]))
    out["losses"] = losses
    out["state"] = jax.tree.map(np.asarray, state)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


def test_interleaved_topk_compressed_step_matches_reference_8_devices(
        tmp_path):
    path = tmp_path / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    run = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF_STEP), str(path)],
        capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)

    cfg = LMConfig(name="t", num_layers=4, d_model=32, n_heads=4, n_kv=2,
                   d_ff=64, vocab=128, dtype="float32")
    spec = pipeline.PipelineSpec(2, 4, virtual_stages=2,
                                 wire_dtype="int8+topk0.25")
    opt = optim.adamw(1e-3)
    state = bridge.train_state_from_jax(ref["init"])
    assert set(state) == {"params", "opt_state", "step", "wire_ef",
                          "error_fb"}
    step = make_lm_train_step(LM(cfg, "cpu"), opt, pipeline=spec,
                              compress=True)
    losses = []
    for b in ref["batches"]:
        step.meter.reset()
        state, mets = step(state, {n: torch.from_numpy(np.asarray(a))
                                   for n, a in b.items()})
        losses.append(float(mets["loss"]))
        assert step.meter.hops_up == step.meter.hops_down == 12
    assert state["step"] == 2
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    got, want = bridge.train_state_to_jax(state), ref["state"]
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(want["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    ef, ref_ef = got["wire_ef"], want["wire_ef"]
    live = np.abs(ef).reshape(ef.shape[:2] + (-1,)).max(-1) > 0
    ref_live = np.abs(ref_ef).reshape(ef.shape[:2] + (-1,)).max(-1) > 0
    np.testing.assert_array_equal(live, ref_live)
    want_live = np.zeros_like(live)     # [(c + 1) mod S, sigma(m) + c]
    for m in range(4):
        for c in range(3):
            want_live[(c + 1) % 2, pipeline._sigma(m, 2, 2) + c] = True
    np.testing.assert_array_equal(live, want_live)
    assert live.sum() == 12
    assert np.abs(ef - ref_ef).max() <= 1e-5 * np.abs(ref_ef).max()

    flips = 0
    for a, b in zip(jax.tree.leaves(got["error_fb"]),
                    jax.tree.leaves(want["error_fb"])):
        off = np.abs(a - b) > 1e-6
        flips += int(off.sum())
        np.testing.assert_allclose(a[off], -b[off], rtol=0, atol=1e-6)
    n = sum(a.size for a in jax.tree.leaves(want["error_fb"]))
    assert flips <= n // 1000, (flips, n)
    assert any(np.abs(a).max() > 0 for a in jax.tree.leaves(got["error_fb"]))
