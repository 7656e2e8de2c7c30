"""The port's recurrentgemma path against the JAX package's, on the CPU.

Inputs come from numpy seeds; parameters from the reference's ``init``
through ``bridge.py``.  Tolerances and their reasons:

* the plain ``rglru_plain`` against ``kernels/ref.py::rg_lru_ref`` and the
  Pallas ``rglru_scan`` in interpret mode: 2e-4, the bound the reference's
  own ``test_rglru_sweep`` holds its kernel to.  In bf16 all three carry
  f32 and round once at the end; the 2e-4 holds the f32 results on the
  bf16 inputs (widened exactly), and the bf16 outputs must be those
  results rounded once.  The bf16 outputs themselves cannot be held to
  2e-4: where the f32 results of two libraries' ``exp`` differ in the
  last bit, a few elements round to neighbouring bf16 values (4 or 5 of
  65536 at [2, 256, 128], one bf16 step apart);
* ``ops.rglru_scan`` (sequential, coefficient from ``a * a``) against the
  model's ``rg_lru_scan_chunked`` (associative scan, ``exp(2 log a)``)
  and the recurrent block, the hybrid stack, prefill, decode and every
  cache leaf against the reference model: 1e-5 in f32, relative to the
  largest value (sums in another order).

The reference runs jitted and compiled at LLVM optimisation level 0
(``_compiled``): each graph runs a few times on small inputs, so its
compile time is the test's time.  The CUDA kernel cannot run here; it is
held to ``rglru_plain`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.kernels.ref import rg_lru_ref
from repro.kernels.rglru import rglru_scan as pallas_rglru
from repro.models import LM as RefLM
from repro.models import recurrent as ref_rec
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.rglru import rglru_plain
from repro_torch.launch import serve
from repro_torch.models import recurrent as rec
from repro_torch.models.lm import LM
from repro_torch.utils.trees import tree_leaves

CFG_REF = ref_arch("recurrentgemma-2b").smoke
CFG = get_arch("recurrentgemma-2b").smoke
PROMPT, GEN = 12, 8          # the prompt outgrows the smoke window of 8


def _compiled(fn, *args):
    """``fn`` of the reference jitted for ``args``' shapes and compiled at
    LLVM optimisation level 0 (the same HLO; a few times faster to build)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _ref_run(fn, *args):
    return _compiled(fn, *args)(*args)


_SCANS = {}


def _ref_scans(*args):
    """(``rg_lru_ref``, Pallas ``rglru_scan`` in interpret mode) on
    ``args``, each compiled once per signature."""
    key = tuple((a.shape, str(a.dtype)) for a in args)
    if key not in _SCANS:
        _SCANS[key] = [_compiled(fn, *args) for fn in (
            lambda *a: rg_lru_ref(*a),
            lambda *a: pallas_rglru(*a, interpret=True))]
    return [fn(*args) for fn in _SCANS[key]]


def _close(got, want, tol):
    """Within ``tol`` relative to the largest value."""
    got = np.asarray(torch.as_tensor(got).detach().float() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _scan_inputs(b, s, r, seed):
    """x, log a (the reference sweep's draws) and h0, numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, r)).astype(np.float32)
    la = (-np.exp(rng.uniform(-5, 0, (b, s, r)))).astype(np.float32)
    h0 = (0.2 * rng.standard_normal((b, r))).astype(np.float32)
    return x, la, h0


# ------------------------------------------------------------ the scan


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_plain_matches_ref_and_pallas(dt, with_h0):
    x, la, h0 = _scan_inputs(2, 256, 128, seed=1 + with_h0)
    ins = [torch.from_numpy(a).to(getattr(torch, dt))
           for a in (x, la) + ((h0,) if with_h0 else ())]
    h, last = rglru_plain(*ins)
    assert h.dtype == last.dtype == ins[0].dtype
    wide = [t.float() for t in ins]            # bf16 values, exactly
    hf, lastf = rglru_plain(*wide)
    assert torch.equal(h, hf.to(h.dtype)) and \
        torch.equal(last, lastf.to(last.dtype))
    for want_h, want_last in _ref_scans(*(jnp.asarray(t.numpy())
                                          for t in wide)):
        _close(hf, want_h, 2e-4)
        _close(lastf, want_last, 2e-4)


def test_ops_rglru_scan_matches_chunked_scan():
    x, la, _ = _scan_inputs(2, 300, 64, seed=3)
    la = la * 0.02              # the model's range: log a in (-0.105, 0)
    want_h, want_last = _ref_run(ref_rec.rg_lru_scan_chunked,
                                 jnp.asarray(x), jnp.asarray(la))
    ops.reset_launches()
    h, last = ops.rglru_scan(torch.from_numpy(x), torch.from_numpy(la))
    assert sum(ops.LAUNCHES.values()) == 0         # the CPU takes the plain
    _close(h, want_h, 1e-5)
    _close(last, want_last, 1e-5)


# ------------------------------------------------------------ the block


@pytest.fixture(scope="module")
def rec_params(smoke):
    """The first recurrent layer of the SMOKE model's reference init, with
    a conv bias drawn (the reference inits it to 0)."""
    tree = dict(smoke[0]["blocks"][0]["rec"])
    tree["conv_b"] = (0.1 * np.random.default_rng(6).standard_normal(
        tree["conv_b"].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_jax(tree)


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = _ref_run(ref_rec.causal_conv1d, jnp.asarray(x), jnp.asarray(w),
                    jnp.asarray(b))
    got = rec.causal_conv1d(*map(torch.from_numpy, (x, w, b)))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("s", [2, 20])     # shorter than the conv, longer
def test_apply_recurrent_matches_reference(rec_params, s):
    ref_p, p = rec_params
    x = np.random.default_rng(s).standard_normal(
        (2, s, CFG.d_model)).astype(np.float32)
    want, want_st = _ref_run(lambda p_, x_: ref_rec.apply_recurrent(
        p_, x_, dt=jnp.float32, return_state=True), ref_p, jnp.asarray(x))
    got, st = rec.apply_recurrent(p, torch.from_numpy(x), dt=torch.float32,
                                  return_state=True)
    _close(got, want, 1e-5)
    for name in ("h", "conv"):
        assert st[name].dtype == torch.float32
        _close(st[name], want_st[name], 1e-5)


def test_apply_recurrent_decode_matches_reference(rec_params):
    ref_p, p = rec_params
    rng = np.random.default_rng(8)
    d, r = CFG.d_model, CFG.r_width
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    state = {"h": rng.standard_normal((2, r)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, r)).astype(np.float32)}
    want, want_st = _ref_run(
        lambda p_, x_, s_: ref_rec.apply_recurrent_decode(
            p_, x_, s_, dt=jnp.float32),
        ref_p, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    got, st = rec.apply_recurrent_decode(
        p, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in state.items()},
        dt=torch.float32)
    _close(got, want, 1e-5)
    for name in ("h", "conv"):
        _close(st[name], want_st[name], 1e-5)


# ------------------------------------------------------------ the LM


def test_hybrid_hidden_matches_period_stacked_reference(smoke):
    """Six layers, two periods of (rglru, rglru, local): the reference
    scans over the period-stacked units; the port loops over the layers.
    The SMOKE model's reference init, its three layers drawn again with
    each leaf scaled by a random factor for the second period."""
    cfg_ref = dataclasses.replace(CFG_REF, name="hybrid-6", num_layers=6,
                                  pattern=CFG_REF.pattern * 2, window=4)
    cfg = dataclasses.replace(CFG, name="hybrid-6", num_layers=6,
                              pattern=CFG.pattern * 2, window=4)
    ref = RefLM(cfg_ref)
    rng = np.random.default_rng(11)
    tree = dict(smoke[0])
    tree["blocks"] = tree["blocks"] + jax.tree.map(
        lambda a: (a * rng.uniform(0.5, 1.5)).astype(a.dtype),
        tree["blocks"])
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 10)).astype(
        np.int32)
    want = _ref_run(ref.hidden, jax.tree.map(jnp.asarray, tree),
                    {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = LM(cfg, "cpu").hidden(bridge.params_from_jax(tree),
                                    {"tokens": torch.from_numpy(toks)})
    _close(got, want, 1e-5)


def test_hybrid_training_forward_and_backward_on_the_cpu(smoke):
    """The training forward keeps one activation checkpoint per block, so
    the backward recomputes each layer, which must take its own kind.
    Its loss equals the cross entropy of the tied, soft-capped head on
    the no-grad hidden states (held to the reference above)."""
    params = bridge.params_from_jax(smoke[0])
    rng = np.random.default_rng(12)
    toks, labs = (torch.from_numpy(rng.integers(0, CFG.vocab, (2, 10)))
                  for _ in range(2))
    model = LM(CFG, "cpu")
    with torch.no_grad():
        h = model.hidden(params, {"tokens": toks})
        logits = CFG.logit_softcap * torch.tanh(
            h @ params["embed"].t() / CFG.logit_softcap)
        want = torch.nn.functional.cross_entropy(logits.flatten(0, 1),
                                                 labs.flatten())
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = model.forward(params, {"tokens": toks, "labels": labs})
    _close(float(loss.detach()), float(want), 1e-5)
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.fixture(scope="module")
def smoke():
    """The reference's greedy loop on the SMOKE model: prefill a 12-token
    prompt, then 8 decode steps, each fed the argmax of the last logits.
    Returns the bridged weights and every logit, token and cache."""
    ref = RefLM(CFG_REF)
    tree = jax.tree.map(np.asarray, _ref_run(ref.init, jax.random.key(0)))
    rp = jax.tree.map(jnp.asarray, tree)
    prompts = np.random.default_rng(10).integers(
        0, CFG.vocab, (2, PROMPT)).astype(np.int32)
    cache_len = PROMPT + GEN
    logits, st = _ref_run(
        lambda p, t: ref.prefill_with_cache(p, {"tokens": t}, cache_len,
                                            jnp.float32),
        rp, jnp.asarray(prompts))
    out = {"prefill_logits": np.asarray(logits),
           "prefill_cache": jax.tree.map(np.asarray, st["cache"]),
           "logits": [], "tokens": []}
    cache = st["cache"]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    decode = _compiled(ref.decode_step, rp, tok, cache,
                       jnp.asarray(PROMPT, jnp.int32))
    for pos in range(PROMPT, PROMPT + GEN):
        out["tokens"].append(np.asarray(tok[:, 0]))
        logits, cache = decode(rp, tok, cache, jnp.asarray(pos, jnp.int32))
        out["logits"].append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out["tokens"].append(np.asarray(tok[:, 0]))
    out["cache"] = jax.tree.map(np.asarray, cache)
    return tree, prompts, out


def _close_cache(got, want, tol=1e-5):
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in g:
            _close(g[name], w[name], tol)


def test_smoke_prefill_decode_and_cache_match_reference(smoke):
    tree, prompts, ref = smoke
    port, params = LM(CFG, "cpu"), bridge.params_from_jax(tree)
    cache_len = PROMPT + GEN
    logits, st = port.prefill_with_cache(
        params, {"tokens": torch.from_numpy(prompts).long()}, cache_len,
        torch.float32)
    _close(logits, ref["prefill_logits"], 1e-5)
    assert st["position"] == PROMPT
    _close_cache(st["cache"], ref["prefill_cache"])
    assert st["cache"][2]["k"].shape[1] == CFG.window  # the local ring
    cache = st["cache"]
    for i, pos in enumerate(range(PROMPT, PROMPT + GEN)):
        tok = torch.tensor(ref["tokens"][i]).long()[:, None]
        logits, cache = port.decode_step(params, tok, cache, pos)
        _close(logits, ref["logits"][i], 1e-5)
    _close_cache(cache, ref["cache"])


def test_bridge_round_trip_of_tuple_blocks_and_tied_embeddings(smoke):
    tree = smoke[0]
    params = bridge.params_from_jax(tree)
    assert isinstance(params["blocks"], tuple) and "head" not in params
    assert [sorted(b) for b in params["blocks"]] == [
        ["ln1", "ln2", "mlp", "rec"], ["ln1", "ln2", "mlp", "rec"],
        ["attn", "ln1", "ln2", "mlp"]]
    back = bridge.params_to_jax(params)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] \
        == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    fresh = bridge.params_to_jax(
        LM(CFG, "cpu").init(torch.Generator().manual_seed(0)))
    assert jax.tree.map(np.shape, fresh) == jax.tree.map(np.shape, tree)


def test_port_greedy_loop_emits_the_reference_tokens(smoke):
    """The port's static greedy loop (``_static_serve``: prefill, then
    argmax after each decode) on the bridged weights."""
    tree, prompts, ref = smoke
    port, params = LM(CFG, "cpu"), bridge.params_from_jax(tree)
    with torch.inference_mode():
        logits, st = port.prefill_with_cache(
            params, {"tokens": torch.from_numpy(prompts).long()},
            PROMPT + GEN, torch.float32)
        tok = torch.argmax(logits, -1, keepdim=True)
        cache, toks = st["cache"], []
        for pos in range(PROMPT, PROMPT + GEN):
            logits, cache = port.decode_step(params, tok, cache, pos)
            tok = torch.argmax(logits, -1, keepdim=True)
            toks.append(tok[:, 0])
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(),
                                  np.stack(ref["tokens"][1:], 1))


def test_serve_cli_on_the_cpu_and_split_cut_refused():
    argv = ["--arch", "recurrentgemma-2b", "--size", "smoke", "--device",
            "cpu", "--batch", "2", "--prompt-len", str(PROMPT), "--gen",
            str(GEN)]
    res = serve.main(argv)
    assert tuple(res["tokens"].shape) == (2, GEN)
    assert 0 <= int(res["tokens"].min()) <= int(res["tokens"].max()) \
        < CFG.vocab
    with pytest.raises(ValueError, match="homogeneous"):
        serve.main(argv + ["--split-cut", "1"])
