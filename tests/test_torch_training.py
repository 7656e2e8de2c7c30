"""The port's training path against the JAX package's, on the CPU.

Parameters come from the reference's ``init`` through ``bridge.py``; data
from numpy seeds (``token_batches`` is the same numpy code on both sides).
Everything runs in f32 on the smoke configs; the steps, the bridge and
the CLI run on both ``rwkv6-3b`` and ``qwen1.5-4b`` (``ARCHS``: the WKV6
and the attention blocks).  Tolerances:

* optimizers and the schedule: 1e-6 relative (elementwise f32 updates);
* the microbatched train step: 1e-5 on parameters and AdamW's m and v,
  the bound the port holds its model to in f32;
* the coded hop: one quantum (the block's scale) plus 1e-6, because the
  reference's jitted codec scales by ``amax * (1/qmax)``, one f32 ULP away
  from the port's exact ``amax / qmax`` in some blocks (ROADMAP Queue 3).

The reference's graphs are compiled by ``ref_compile``, without LLVM's
optimisation passes: each runs a few times on small inputs, so its
compile time is the test's time.  The C²P²SL step is held to the
reference in ``test_torch_c2p2sl.py``.
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
from repro.parallel import compat as ref_compat
from repro.parallel import pipeline as ref_pipeline
from repro.parallel import wire as ref_wire
from repro.parallel.compat import PartitionSpec as P
from repro.parallel.steps import make_lm_train_step as ref_train_step
from repro.training import optim as ref_optim
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import TokenTaskConfig, token_batches
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models.lm import LM
from repro_torch.parallel import pipeline, wire
from repro_torch.parallel.steps import make_lm_train_step
from repro_torch.runtime import protocol
from repro_torch.training import optim
from repro_torch.utils.trees import tree_leaves

CFG = get_arch("rwkv6-3b").smoke
ARCHS = ("rwkv6-3b", "qwen1.5-4b")
SEQ = 24


def ref_compile(fn, *args):
    """The reference's ``fn`` jitted for ``args`` and compiled at LLVM
    optimisation level 0 (the same HLO; a few times faster to build)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def close_trees(port_tree, ref_tree, tol):
    """Every leaf within ``tol`` (absolute and relative)."""
    got = bridge.params_to_jax(port_tree)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref_tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)


def reference_setup(arch: str = "rwkv6-3b"):
    """The reference model of ``arch``'s smoke config, its initial
    parameters as numpy and two batches of 6 x SEQ tokens."""
    ref = RefLM(ref_arch(arch).smoke)
    key = jax.random.key(0)
    tree = jax.tree.map(np.asarray, ref_compile(ref.init, key)(key))
    vocab = get_arch(arch).smoke.vocab
    batches = list(zip(range(2), ref_token_batches(RefTask(vocab=vocab),
                                                   6, SEQ, seed=3)))
    return ref, tree, [b for _, b in batches]


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    """``reference_setup`` of each of ``ARCHS`` and the port's config."""
    return (*reference_setup(request.param), get_arch(request.param).smoke)


def port_batch(b):
    return {n: torch.from_numpy(np.asarray(a)) for n, a in b.items()}


# ------------------------------------------------------------ optimizers


def test_adamw_sgd_and_schedule_match_reference():
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 3)
                          .astype(np.float32), params) for _ in range(3)]
    sched = dict(peak_lr=1e-2, warmup=2, total=5, floor=1e-3)
    for name, kw in (("adamw", dict(weight_decay=0.1, grad_clip=1.0)),
                     ("sgd", dict(momentum=0.9, weight_decay=0.1))):
        ref_opt = getattr(ref_optim, name)(
            ref_optim.cosine_schedule(**sched), **kw)
        port_opt = getattr(optim, name)(optim.cosine_schedule(**sched), **kw)
        rp = jax.tree.map(jnp.asarray, params)
        rs = ref_opt.init(rp)
        pp = bridge.params_from_jax(params)
        ps = port_opt.init(pp)
        ref_update = ref_compile(ref_opt.update, jax.tree.map(
            jnp.asarray, grads[0]), rs, rp, jnp.int32(0))
        for step, g in enumerate(grads):
            rp, rs = ref_update(jax.tree.map(jnp.asarray, g), rs, rp,
                                jnp.int32(step))
            pp, ps = port_opt.update(bridge.params_from_jax(g), ps, pp, step)
        close_trees(pp, rp, 1e-6)
        close_trees(ps, rs, 1e-6)
    ref_lr = ref_optim.cosine_schedule(**sched)
    port_lr = optim.cosine_schedule(**sched)
    for step in range(8):
        np.testing.assert_allclose(port_lr(step),
                                   float(ref_lr(jnp.int32(step))), rtol=1e-6)


def test_token_batches_match_reference():
    port = token_batches(TokenTaskConfig(vocab=100), 4, 9, seed=5)
    ref = ref_token_batches(RefTask(vocab=100), 4, 9, seed=5)
    for _ in range(2):
        a, b = next(port), next(ref)
        for n in ("tokens", "labels"):
            np.testing.assert_array_equal(a[n], b[n])


# ------------------------------------------------------------ train steps


def _ref_state(tree, opt):
    params = jax.tree.map(jnp.asarray, tree)
    return {"params": params, "opt_state": opt.init(params),
            "step": jnp.zeros((), jnp.int32)}


def port_state(tree, opt):
    params = bridge.params_from_jax(tree)
    return {"params": params, "opt_state": opt.init(params), "step": 0}


def test_microbatched_train_step_matches_reference(setup):
    """Two AdamW steps with k = 2 micro-batches: parameters, m and v.

    lr 1e-4: Adam's first steps divide by |g| + eps, so a gradient element
    near eps turns f32 rounding into an update difference of up to lr
    (3e-5 at lr 1e-3, the reference's own test_equivalence notes the
    same); at 1e-4 that stays under the 1e-5 bound while every update
    (~1e-4) is still ten times it.  m and v carry the gradients at 1e-5."""
    ref, tree, batches, cfg = setup
    ref_opt = ref_optim.adamw(1e-4, grad_clip=1.0)
    rs = _ref_state(tree, ref_opt)
    step = ref_compile(ref_train_step(ref, ref_opt, microbatches=2), rs,
                       jax.tree.map(jnp.asarray, batches[0]))
    port_opt = optim.adamw(1e-4, grad_clip=1.0)
    ps = port_state(tree, port_opt)
    port_step = make_lm_train_step(LM(cfg, "cpu"), port_opt, microbatches=2)
    for b in batches:
        rs, rm = step(rs, jax.tree.map(jnp.asarray, b))
        ps, pm = port_step(ps, port_batch(b))
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=1e-5)
    assert ps["step"] == 2
    close_trees(ps["params"], rs["params"], 1e-5)
    close_trees(ps["opt_state"], rs["opt_state"], 1e-5)


def test_pipelined_none_step_equals_microbatched_step(setup):
    """S = 2, k = 2 with the raw hop is the k = 2 accumulated step; int8
    runs the same path and bills its hop bytes exactly."""
    _ref, tree, batches, cfg = setup
    model, batch = LM(cfg, "cpu"), port_batch(batches[0])
    out = {}
    for name, kw in (("micro", dict(microbatches=2)),
                     ("none", dict(pipeline=pipeline.PipelineSpec(2, 2))),
                     ("int8", dict(pipeline=pipeline.PipelineSpec(
                         2, 2, wire_dtype="int8")))):
        opt = optim.sgd(0.1)
        stepper = make_lm_train_step(model, opt, **kw)
        state, mets = stepper(port_state(tree, opt), batch)
        out[name] = (float(mets["loss"]), state["params"], stepper.meter)
    np.testing.assert_allclose(out["none"][0], out["micro"][0], rtol=1e-6)
    for a, b in zip(tree_leaves(out["none"][1]), tree_leaves(out["micro"][1])):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-5,
                                   atol=1e-5)
    meter, n = out["int8"][2], 6 * SEQ * cfg.d_model
    billed = protocol.billed_hop_bytes(n, cfg.d_model, "int8", 4)
    assert (meter.up, meter.down, meter.hops_up, meter.hops_down) \
        == (billed, billed, 2, 2)
    assert abs(out["int8"][0] - out["none"][0]) < 1e-2


def test_split_stages_match_reference():
    blocks = {"w": np.arange(8 * 3, dtype=np.float32).reshape(8, 3)}
    layers = [{"w": torch.from_numpy(blocks["w"][i])} for i in range(8)]
    for s_, v_ in ((2, 1), (2, 2), (4, 1)):
        want = np.asarray(ref_pipeline._split_stages(
            jax.tree.map(jnp.asarray, blocks), s_, v_)["w"])
        got = pipeline._split_stages(layers, s_, v_)
        for s in range(s_):
            for j in range(v_):
                np.testing.assert_array_equal(
                    np.stack([t["w"].numpy() for t in got[s][j]]),
                    want[s, j])
    for s_, v_, w in ((2, 2, "none"), (2, 1, "int8+topk0.25"),
                      (2, 2, "fp8+topk0.5")):
        got = pipeline.PipelineSpec(2, 4, virtual_stages=v_, wire_dtype=w)
        want = ref_pipeline.PipelineSpec(2, 4, virtual_stages=v_,
                                         wire_dtype=w)
        assert (got.virtual_stages, got.wire_dtype) == \
            (want.virtual_stages, want.wire_dtype)


# ------------------------------------------------------------ coded hop


@pytest.mark.parametrize("wire_dtype", ["int8", "fp8"])
def test_coded_hop_matches_reference_coded_ppermute(wire_dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 6, 64)) * 3).astype(np.float32)
    g = (rng.standard_normal((2, 6, 64)) * 0.01).astype(np.float32)
    mesh = ref_compat.make_mesh((1,), ("pod",))
    hop = ref_compat.shard_map(
        lambda a: ref_wire.coded_ppermute(wire_dtype, "pod", ((0, 0),), a),
        mesh, in_specs=(P(),), out_specs=P())
    want, vjp = jax.vjp(jax.jit(hop), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))

    meter = wire.HopMeter()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = wire.coded_hop(xt, wire_dtype, meter)
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    for ours, theirs, src in ((got, want, x), (got_g, want_g, g)):
        _, scale = wire.encode(torch.from_numpy(src), wire_dtype)
        quantum = scale.expand(2, 6, 1, 64).reshape(2, 6, 64).numpy()
        if wire_dtype == "fp8":      # e4m3: an ULP of the payload value
            quantum = quantum * np.maximum(np.abs(src) / quantum, 1) / 8
        err = np.abs(ours.detach().numpy() - np.asarray(theirs))
        assert (err <= quantum + 1e-6).all(), float((err - quantum).max())
    nbytes = 2 * 6 * 64 + 2 * 6 * 4
    assert (meter.up, meter.down) == (nbytes, nbytes)
    with pytest.raises(ValueError, match="error feedback"):
        wire.coded_hop(xt, "int8+topk0.5")      # a top-k hop needs its slot


def test_bridge_round_trip_of_rwkv_params_and_adamw_state(setup):
    _ref, tree, _, _ = setup
    opt = ref_optim.adamw(1e-3)
    state = jax.tree.map(np.asarray, opt.init(jax.tree.map(jnp.asarray,
                                                           tree)))
    state = jax.tree.map(lambda a: a + 0.5, state)
    for t in (tree, state):
        back = bridge.params_to_jax(bridge.params_from_jax(t))
        for a, c in zip(jax.tree.leaves(back), jax.tree.leaves(t)):
            np.testing.assert_array_equal(a, c)


# ------------------------------------------------------------ CLI, flash


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch):
    res = train.main(["--arch", arch, "--size", "smoke", "--device",
                      "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
                      "--pipeline-stages", "2", "--pipeline-k", "2",
                      "--wire-dtype", "int8", "--log-every", "1"])
    rows = res["rows"]
    assert [r["step"] for r in rows] == [1, 2]
    d = get_arch(arch).smoke.d_model
    billed = protocol.billed_hop_bytes(4 * 16 * d, d, "int8", 4)
    for r in rows:
        assert np.isfinite(r["loss"]) and r["peak_gb"] is None
        assert r["hop_bytes_up"] == r["hop_bytes_down"] == billed
    with pytest.raises(SystemExit):
        train.main(["--arch", "rwkv6-3b", "--device", "cpu",
                    "--pipeline-stages", "2", "--microbatches", "2"])


def test_train_cli_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "rwkv6-3b", "--steps", "1"])


def test_flash_attention_keeps_autograd_on_the_cpu():
    """On the CPU ops.flash_attention is the plain version, so autograd
    runs through it (on the card through the forward and backward kernels;
    test_torch_cuda.py)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 9, 16), generator=g, requires_grad=True)
               for _ in range(3))
    grads = torch.autograd.grad(ops.flash_attention(q, k, v).square().sum(),
                                (q, k, v))
    assert all(float(t.abs().max()) > 0 for t in grads)
