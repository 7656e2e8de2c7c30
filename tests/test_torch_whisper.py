"""whisper-small, the encoder-decoder, in the port against the JAX package,
on the CPU.

The SMOKE config (2 + 2 layers, d 64, 4 heads, 16 frames) in f32, with
the reference's weights carried by ``bridge.py`` (every bias and norm
perturbed, the cross path's unused biases too, so that a port adding them
would show) and frames and tokens from numpy seeds.  Held at 1e-5
relative to the largest value: the encoder (``_encode``), the training
forward's loss, ``prefill_with_cache`` (the last logits and the four
cache leaves k, v, ck, cv), ``fill_cross_kv``, teacher-forced decode
steps, and two AdamW steps at k 2 (parameters, m and v; the cross biases
stay exactly 0 on both sides).  The port's own equivalences: decode from
the cached cross K/V against decode recomputing them from ``enc_out`` at
the reference test's 2e-4 (``tests/test_models.py::
test_whisper_cross_kv_cache_equivalence``), the S 2, k 2 pipeline with the
raw hop against the accumulated step, and its int8 hop's bytes against the
bill of ``h`` alone (the encoder memory rides outside the hop); the token
loop against the one-pass prefill is ``tests/test_torch_rwkv_serving.py::
test_token_loop_prefill_matches_chunked_prefill[whisper-small]``.  The
launchers: the serve and train CLIs on the CPU (``--continuous`` and
``--split-cut`` refused), a resumed train run equal to the uninterrupted
one bit for bit (the frames' stream resumed with the tokens'), and the
planner's whisper plan equal to the reference's under its constants.

The reference runs through ``_ref_exe``: jitted and compiled at LLVM
optimisation level 0 (each graph runs a few times on small inputs).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import LM as RefLM
from repro.parallel.steps import make_decode_step
from repro.parallel.steps import make_lm_train_step as ref_train_step
from repro.training import optim as ref_optim
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.launch import serve, train
from repro_torch.models import blocks
from repro_torch.models.lm import LM, _sin_pos
from repro_torch.parallel import pipeline
from repro_torch.parallel.steps import make_lm_train_step
from repro_torch.runtime import protocol
from repro_torch.training import optim
from repro_torch.utils.trees import tree_leaves

ARCH = "whisper-small"
CFG_REF = ref_arch(ARCH).smoke
CFG = get_arch(ARCH).smoke
TOL = 1e-5
B, S, G, CACHE = 2, 7, 4, 12
CROSS_BIASES = ("qb", "kb", "vb", "ob")
SMOKE = ["--arch", ARCH, "--size", "smoke", "--device", "cpu"]


def _ref_exe(fn, *args):
    """``fn`` of the reference, jitted and compiled for ``args``' shapes at
    LLVM optimisation level 0."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _close(got, want, tol=TOL):
    """Within ``tol`` relative to the largest value."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _perturb(tree, rng):
    """Random biases and norm weights (the reference inits them to 1 / 0),
    the cross path's unused biases among them."""
    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-1] in ("qb", "kb", "vb", "ob", "b1", "b2") or any(
                n in path for n in ("ln1", "ln2", "lnx", "enc_norm",
                                    "final_norm")):
            return (node + 0.1 * rng.standard_normal(node.shape)).astype(
                np.float32)
        return node
    return walk(tree)


@pytest.fixture(scope="module")
def ref_init():
    ref = RefLM(CFG_REF)
    key = jax.random.key(0)
    return ref, jax.tree.map(np.asarray, _ref_exe(ref.init, key)(key))


@pytest.fixture(scope="module")
def models(ref_init):
    ref, tree = ref_init
    tree = _perturb(tree, np.random.default_rng(1))
    return ref, jax.tree.map(jnp.asarray, tree), LM(CFG, "cpu"), \
        bridge.params_from_jax(tree)


def _inputs(seed=7, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab, (B, s)).astype(np.int32)
    frames = rng.standard_normal((B, CFG.enc_seq, CFG.d_model)).astype(
        np.float32)
    return toks, frames


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ the model


def test_init_layout_and_the_bridge(models, ref_init):
    """The port's fresh init has the reference's tree (enc_blocks,
    enc_norm, each layer's lnx and cross with its four biases); the
    bridge carries it both ways unchanged."""
    _ref, tree = ref_init
    port = LM(CFG, "cpu")
    fresh = bridge.params_to_jax(port.init(torch.Generator().manual_seed(0),
                                           master=True))
    assert jax.tree.map(np.shape, fresh) == jax.tree.map(np.shape, tree)
    assert set(fresh["blocks"]["cross"]) == {"q", "k", "v", "o",
                                             *CROSS_BIASES}
    assert fresh["enc_blocks"]["attn"]["q"].shape == (2, 64, 64)
    back = bridge.params_to_jax(bridge.params_from_jax(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_sin_pos_matches_reference():
    """At the SMOKE sizes within 1e-5; at FULL's 1500 frames within one
    f32 ulp of the largest angle (1499 rad: 2^-13), which two ``exp``
    implementations one ulp apart reach."""
    from repro.models.lm import _sin_pos as ref_sin_pos
    for seq, d, off in ((16, 64, 0), (16, 64, 3), (5, 2, 0)):
        _close(_sin_pos(seq, d, off), ref_sin_pos(seq, d, off))
    np.testing.assert_allclose(_sin_pos(1500, 768).numpy(),
                               np.asarray(ref_sin_pos(1500, 768)), rtol=0,
                               atol=2.0 ** -13)


def test_encoder_and_forward_loss_match_reference(models):
    ref, rp, port, params = models
    toks, frames = _inputs()
    labels = np.random.default_rng(8).integers(
        0, CFG.vocab, (B, S)).astype(np.int32)
    enc_r = _ref_exe(ref._encode, rp, jnp.asarray(frames))(
        rp, jnp.asarray(frames))
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "frames": jnp.asarray(frames)}
    loss_r, mets_r = _ref_exe(ref.forward, rp, batch)(rp, batch)
    with torch.no_grad():
        enc_p = port._encode(params, _t(frames))
        loss_p, mets_p = port.forward(params, {
            "tokens": _t(toks).long(), "labels": _t(labels),
            "frames": _t(frames)})
    _close(enc_p, enc_r)
    _close(loss_p, loss_r)
    _close(mets_p["xent"], mets_r["xent"])


def test_prefill_fill_cross_kv_and_decode_match_reference(models):
    """Prefill logits and the four cache leaves; ``fill_cross_kv`` of the
    encoder memory; then G teacher-forced decode steps from both
    caches."""
    ref, rp, port, params = models
    toks, frames = _inputs()
    batch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    rl, rs = _ref_exe(lambda p, b: ref.prefill_with_cache(
        p, b, CACHE, cache_dtype=jnp.float32), rp, batch)(rp, batch)
    with torch.no_grad():
        pl, ps = port.prefill_with_cache(
            params, {"tokens": _t(toks).long(), "frames": _t(frames)},
            CACHE, torch.float32)
    assert ps["position"] == int(rs["position"]) == S
    _close(pl, rl)
    for name in ("k", "v", "ck", "cv"):
        assert tuple(ps["cache"][name].shape) == rs["cache"][name].shape
        _close(ps["cache"][name], rs["cache"][name])

    enc_r = _ref_exe(ref._encode, rp, jnp.asarray(frames))(
        rp, jnp.asarray(frames))
    filled_r = _ref_exe(ref.fill_cross_kv, rp, enc_r, rs["cache"])(
        rp, enc_r, rs["cache"])
    with torch.no_grad():
        cache = port.init_cache(B, CACHE, torch.float32)
        out = port.fill_cross_kv(params, port._encode(params, _t(frames)),
                                 cache)
    assert out is cache
    for name in ("ck", "cv"):
        _close(cache[name], filled_r[name])
        _close(cache[name], ps["cache"][name])
    assert not cache["k"].any() and not cache["v"].any()

    decode = _ref_exe(make_decode_step(ref), rp, rs,
                      jnp.zeros((B, 1), jnp.int32))
    forced = np.random.default_rng(9).integers(0, CFG.vocab, (B, G))
    cache = ps["cache"]
    for i in range(G):
        tok = forced[:, i:i + 1].astype(np.int32)
        rl, rs = decode(rp, rs, jnp.asarray(tok))
        with torch.no_grad():
            pl, cache = port.decode_step(params, _t(tok).long(), cache,
                                         S + i)
        _close(pl, rl)
    for name in ("k", "v"):
        _close(cache[name], rs["cache"][name])


def test_cached_cross_kv_equals_per_step_recompute(models):
    """The port's counterpart of the reference's
    ``test_whisper_cross_kv_cache_equivalence`` (2e-4): decode from the
    cross K/V ``fill_cross_kv`` cached against decode from a cache
    without them, which recomputes them from ``enc_out`` each step; and
    the latter against the reference's ``decode_step(enc_out=)``."""
    ref, rp, port, params = models
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, CFG.enc_seq, CFG.d_model)).astype(
        np.float32)
    toks = rng.integers(0, CFG.vocab, (B, 5)).astype(np.int32)
    with torch.no_grad():
        enc = port._encode(params, _t(frames))
        cache_a = port.fill_cross_kv(params, enc,
                                     port.init_cache(B, 8, torch.float32))
        cache_b = {k: v for k, v in port.init_cache(B, 8, torch.float32)
                   .items() if k not in ("ck", "cv")}
        for t in range(5):
            tok = _t(toks[:, t:t + 1]).long()
            la, _ = port.decode_step(params, tok, cache_a, t)
            lb, _ = port.decode_step(params, tok, cache_b, t, enc_out=enc)
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=2e-4, atol=2e-4)
    enc_r = _ref_exe(ref._encode, rp, jnp.asarray(frames))(
        rp, jnp.asarray(frames))
    rc = {k: v for k, v in ref.init_cache(B, 8, jnp.float32).items()
          if k not in ("ck", "cv")}
    step = _ref_exe(lambda p, tk, c, pos, e: ref.decode_step(
        p, tk, c, pos, enc_out=e), rp, jnp.asarray(toks[:, :1]), rc,
        jnp.int32(0), enc_r)
    for t in range(5):
        rl, rc = step(rp, jnp.asarray(toks[:, t:t + 1]), rc, jnp.int32(t),
                      enc_r)
    _close(lb, rl)


def test_padded_vocab_is_never_seen():
    """The FULL head is [768, 51872]; the logits stop at 51865 and the
    loss masks the 7 pad columns, so a pad column's weight has no
    gradient."""
    full = get_arch(ARCH).full
    assert (full.padded_vocab, full.vocab) == (51_872, 51_865)
    cfg = CFG.__class__(**{**CFG.__dict__, "vocab": 509,
                           "vocab_pad_multiple": 16})
    model = LM(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0), master=True)
    assert params["head"].shape == (64, 512)
    params["head"].requires_grad_(True)
    toks, frames = _inputs()
    toks = toks % cfg.vocab
    loss, _ = model.forward(params, {"tokens": _t(toks).long(),
                                     "labels": _t(toks),
                                     "frames": _t(frames)})
    loss.backward()
    assert not params["head"].grad[:, 509:].any()
    assert params["head"].grad[:, :509].abs().sum() > 0
    with torch.no_grad():
        logits, _ = model.prefill_with_cache(
            params, {"tokens": _t(toks).long(), "frames": _t(frames)}, S,
            torch.float32)
    assert logits.shape == (B, 509)


def test_unported_cross_attention_stacks_raise():
    import dataclasses
    for bad in (dict(family="hybrid", pattern=("attn", "xattn")),
                dict(enc_layers=0), dict(tie_embeddings=True),
                dict(family="dense")):
        with pytest.raises(NotImplementedError, match="xattn"):
            LM(dataclasses.replace(CFG, **bad), "cpu")
    with pytest.raises(NotImplementedError, match="enc"):
        blocks.init_block_state(CFG, "enc", 1, 4, device="cpu")


# ------------------------------------------------------------ training


def _batches(n, seed=3, batch=4, seq=8):
    it = train.build_batch_iter(CFG, batch, seq, seed=seed)
    return [next(it) for _ in range(n)]


def test_build_batch_iter_matches_reference():
    from repro.launch.train import build_batch_iter as ref_iter
    port = train.build_batch_iter(CFG, 4, 8, seed=5)
    ref = ref_iter(CFG_REF, 4, 8, seed=5)
    for _ in range(2):
        a, b = next(port), next(ref)
        assert sorted(a) == sorted(b) == ["frames", "labels", "tokens"]
        for n in a:
            np.testing.assert_array_equal(a[n], b[n])
    assert a["frames"].shape == (4, CFG.enc_seq, CFG.d_model)


def _port_state(tree, opt):
    params = bridge.params_from_jax(tree)
    return {"params": params, "opt_state": opt.init(params), "step": 0}


def _cross_biases(tree):
    return [tree["blocks"]["cross"][n] for n in CROSS_BIASES]


def test_two_adamw_steps_match_reference_and_keep_cross_biases_zero(
        ref_init):
    """Two AdamW steps at k 2 micro-batches from the reference's init:
    parameters, m and v within 1e-5; the cross biases, which no forward
    reads, get zero gradients and stay exactly 0 on both sides (m and v
    too)."""
    ref, tree = ref_init
    batches = _batches(2)
    ref_opt = ref_optim.adamw(1e-4, grad_clip=1.0)
    params = jax.tree.map(jnp.asarray, tree)
    rs = {"params": params, "opt_state": ref_opt.init(params),
          "step": jnp.zeros((), jnp.int32)}
    step = _ref_exe(ref_train_step(ref, ref_opt, microbatches=2), rs,
                    jax.tree.map(jnp.asarray, batches[0]))
    port_opt = optim.adamw(1e-4, grad_clip=1.0)
    ps = _port_state(tree, port_opt)
    port_step = make_lm_train_step(LM(CFG, "cpu"), port_opt, microbatches=2)
    for b in batches:
        rs, rm = step(rs, jax.tree.map(jnp.asarray, b))
        ps, pm = port_step(ps, {n: _t(a) for n, a in b.items()})
        _close(pm["loss"], rm["loss"])
    got = bridge.train_state_to_jax(ps)
    for name in ("params", "opt_state"):
        for g, w in zip(jax.tree.leaves(got[name]),
                        jax.tree.leaves(rs[name])):
            _close(g, w)
    for t in _cross_biases(got["params"]) + _cross_biases(rs["params"]):
        assert not np.asarray(t).any()
    for moment in ("m", "v"):
        for t in _cross_biases(got["opt_state"][moment]) \
                + _cross_biases(rs["opt_state"][moment]):
            assert not np.asarray(t).any()
    moved = bridge.params_to_jax(ps["params"])["blocks"]["cross"]["q"]
    assert not np.array_equal(moved, tree["blocks"]["cross"]["q"])


def test_pipelined_none_equals_accumulated_step_and_bills_h_alone(ref_init):
    """S 2, k 2 with the raw hop is the k 2 accumulated step (loss and
    every parameter within 1e-5, the encoder's among them); at int8 the
    hop's measured bytes equal ``billed_hop_bytes`` of ``h`` [4, 8, 64]
    alone, one hop each way a micro-batch.  A batch of 5 pads one zero
    row into x and the encoder memory alike: it equals the whole-batch
    step, which no split of 5 rows into 2 accumulates."""
    _ref, tree = ref_init
    model = LM(CFG, "cpu")
    for batch_rows in (4, 5):
        batch = {n: _t(a) for n, a in _batches(1, batch=batch_rows)[0]
                 .items()}
        out = {}
        for name, kw in (("micro", dict(microbatches=2 - batch_rows % 2)),
                         ("none", dict(pipeline=pipeline.PipelineSpec(2, 2))),
                         ("int8", dict(pipeline=pipeline.PipelineSpec(
                             2, 2, wire_dtype="int8")))):
            opt = optim.sgd(0.1)
            stepper = make_lm_train_step(model, opt, **kw)
            state, mets = stepper(_port_state(tree, opt), batch)
            out[name] = (float(mets["loss"]), state["params"],
                         stepper.meter)
        np.testing.assert_allclose(out["none"][0], out["micro"][0],
                                   rtol=1e-6)
        for a, b in zip(tree_leaves(out["none"][1]),
                        tree_leaves(out["micro"][1])):
            torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-5,
                                       atol=1e-5)
        meter = out["int8"][2]
        mb = -(-batch_rows // 2)
        billed = protocol.billed_hop_bytes(mb * 8 * CFG.d_model,
                                           CFG.d_model, "int8", 4)
        assert (meter.up, meter.down, meter.hops_up, meter.hops_down) \
            == (2 * billed, 2 * billed, 2, 2)
        assert abs(out["int8"][0] - out["none"][0]) < 1e-2


# ------------------------------------------------------------ the CLIs


def test_serve_cli_on_the_cpu_and_its_refusals(capsys):
    argv = SMOKE + ["--batch", "2", "--prompt-len", "6", "--gen", "4"]
    greedy = serve.main(argv)
    loop = serve.main(argv + ["--token-loop-prefill"])
    sampled = serve.main(argv + ["--temperature", "0.8"])
    for res in (greedy, loop, sampled):
        toks = res["tokens"]
        assert toks.shape == (2, 4)
        assert int(toks.min()) >= 0 and int(toks.max()) < CFG.vocab
    assert torch.equal(greedy["tokens"], loop["tokens"])
    with pytest.raises(ValueError, match="continuous batching"):
        serve.main(SMOKE + ["--continuous", "--requests", "2"])
    with pytest.raises(ValueError, match="SplitDecode"):
        serve.main(argv + ["--split-cut", "1"])


def test_train_cli_on_the_cpu():
    argv = SMOKE + ["--batch", "4", "--seq", "8", "--steps", "2",
                    "--log-every", "0"]
    piped = train.main(argv + ["--pipeline-stages", "2", "--pipeline-k",
                               "2", "--wire-dtype", "int8"])
    accum = train.main(argv + ["--microbatches", "2"])
    billed = protocol.billed_hop_bytes(2 * 8 * CFG.d_model, CFG.d_model,
                                       "int8", 4)
    for row in piped["rows"]:
        assert np.isfinite(row["loss"])
        assert row["hop_bytes_up"] == row["hop_bytes_down"] == 2 * billed
    for a, b in zip(piped["rows"], accum["rows"]):
        assert abs(a["loss"] - b["loss"]) < 1e-2


def test_resumed_train_run_equals_the_uninterrupted_run(tmp_path):
    """Steps 1-2 with a checkpoint at 2, then step 3 from it: the loss
    and every leaf of the final state equal the 3-step run's bit for bit
    (the third batch's frames drawn after the first two's, as in the
    uninterrupted run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        argv = SMOKE + ["--batch", "4", "--seq", "8", "--steps", "3",
                        "--log-every", "0", "--pipeline-stages", "2",
                        "--pipeline-k", "2", "--wire-dtype", "int8"]
        whole = train.main(argv)
        ck = str(tmp_path / "ck")
        train.main(argv + ["--ckpt-dir", ck, "--ckpt-every", "2"])
        assert sorted(os.listdir(ck)) == ["step_2"]
        resumed = train.main(argv + ["--ckpt-dir", ck])
    finally:
        torch.set_num_threads(threads)
    assert resumed["ckpt"]["resumed_from"] == 2
    assert [r["step"] for r in resumed["rows"]] == [3]
    assert resumed["rows"][0]["loss"] == whole["rows"][2]["loss"]
    for key in ("params", "opt_state"):
        la, lb = tree_leaves(resumed["state"][key]), \
            tree_leaves(whole["state"][key])
        assert len(la) == len(lb)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------------------ the planner


@pytest.mark.parametrize("size,batch,seq", [("smoke", 8, 16),
                                            ("full", 32, 448)])
@pytest.mark.parametrize("k,wire", [(None, "int8"), ("auto", "auto"),
                                    (4, "int8")])
def test_whisper_plan_matches_reference(monkeypatch, tmp_path, size, batch,
                                        seq, k, wire):
    """``resolve_pipeline_plan`` for whisper under the reference's peak
    and link constants: the same spec and the same evidence.  Both
    packages' ``param_count`` counts no attention weight of an "xattn"
    layer (ROADMAP Queue 3): the port keeps the reference's count."""
    import ml_dtypes  # noqa: F401  (registers bfloat16 with numpy)

    from repro.analysis import autotune as ref_at
    from repro.launch import train as ref_train
    from repro_torch.analysis import autotune as at
    monkeypatch.setattr(at, "HW", dict(ref_at.HW))
    monkeypatch.setattr(at, "LINK_PRIOR_BPS", ref_at.HW["dcn_bw"])
    monkeypatch.setattr(at, "HOP_OVERHEAD_PRIOR_S",
                        ref_at.HW["dcn_latency_s"])
    kw = dict(pipeline_stages=2, pipeline_k=k, virtual_stages=None,
              batch=batch, seq=seq, wire_dtype=wire, plan_hints=None)
    port_cfg = getattr(get_arch(ARCH), size)
    ref_cfg = getattr(ref_arch(ARCH), size)
    assert port_cfg.param_count() == ref_cfg.param_count()
    spec, info = train.resolve_pipeline_plan(cfg=port_cfg, **kw)
    ref_spec, ref_info = ref_train.resolve_pipeline_plan(
        cfg=ref_cfg, plan_roofline=None, **kw)
    assert (spec.num_stages, spec.microbatches, spec.virtual_stages,
            spec.wire_dtype) == (ref_spec.num_stages, ref_spec.microbatches,
                                 ref_spec.virtual_stages, ref_spec.wire_dtype)
    assert json.loads(json.dumps(info)) == json.loads(json.dumps(ref_info))


def test_param_count_undercounts_the_cross_attention_layers():
    """FULL: 221,233,152 counted (both packages) against 278,154,240
    drawn (the reference's parameter tree): the gap is the 12 decoder
    layers' self- and cross-attention weights (12 x 8 x 768^2) and every
    bias and norm vector (297,984).  Logged in ROADMAP Queue 3, not
    repaired here."""
    from repro.configs import param_specs
    full = get_arch(ARCH).full
    flat = jax.tree_util.tree_flatten_with_path(
        param_specs(ref_arch(ARCH).full))[0]
    drawn = sum(int(np.prod(a.shape)) for _, a in flat)
    vectors = sum(int(np.prod(a.shape)) for path, a in flat
                  if a.ndim == 1 or (a.ndim == 2 and path[0].key in (
                      "blocks", "enc_blocks")))
    assert full.param_count() == ref_arch(ARCH).full.param_count() \
        == 221_233_152
    assert (drawn, vectors) == (278_154_240, 297_984)
    assert drawn - full.param_count() == 12 * 8 * 768 ** 2 + vectors
