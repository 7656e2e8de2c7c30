"""The port's MoE path against the JAX package's, on the CPU.

Inputs come from numpy seeds; parameters from the reference's ``init``
through ``bridge.py``.  Tolerances and their reasons:

* ``moe_gmm_plain`` against the Pallas ``moe_gmm`` in interpret mode and
  ``kernels/ref.py::moe_gmm_ref``: 2e-4 in f32 (sums over D in another
  order), 5e-2 in bf16 (the output rounded to bf16 once), relative to the
  largest value;
* the dispatch (``_moe_local``, with and without dropped tokens), the
  granite SMOKE model's prefill, decode, cache and loss, and the
  qwen3-moe SMOKE split halves: 1e-5 in f32, relative to the largest
  value (sums in another order).

The reference runs jitted and compiled at LLVM optimisation level 0
(``_compiled``): each graph runs a few times on small inputs, so its
compile time is the test's time.  The CUDA kernel cannot run here; it is
held to ``moe_gmm_plain`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.kernels.moe_gmm import moe_gmm as pallas_gmm
from repro.kernels.ref import moe_gmm_ref
from repro.models import LM as RefLM
from repro.models import moe as ref_moe
from repro.serving import infer as ref_infer
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gmm import moe_gmm_plain
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models.lm import LM
from repro_torch.serving import infer
from repro_torch.utils.trees import tree_leaves

GRANITE = "granite-moe-3b-a800m"
QWEN_MOE = "qwen3-moe-30b-a3b"
CFG_REF = ref_arch(GRANITE).smoke
CFG = get_arch(GRANITE).smoke
PROMPT, GEN = 12, 8


def _compiled(fn, *args):
    """``fn`` of the reference jitted for ``args``' shapes and compiled at
    LLVM optimisation level 0 (the same HLO; a few times faster to build)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _ref_run(fn, *args):
    return _compiled(fn, *args)(*args)


def _close(got, want, tol):
    """Within ``tol`` relative to the largest value."""
    got = np.asarray(torch.as_tensor(got).detach().float() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _gmm_inputs(e, c, d, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, c, d)).astype(np.float32),
            (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32))


# ------------------------------------------------------------ the kernel


@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_moe_gmm_plain_matches_pallas_and_ref(dt, tol):
    h, w = _gmm_inputs(2, 128, 256, 128, seed=1)
    th, tw = (torch.from_numpy(a).to(getattr(torch, dt)) for a in (h, w))
    jh, jw = (jnp.asarray(a).astype(dt) for a in (h, w))
    got = moe_gmm_plain(th, tw)
    assert got.dtype == th.dtype and tuple(got.shape) == (2, 128, 128)
    for fn in (lambda a, b: pallas_gmm(a, b, interpret=True), moe_gmm_ref):
        want = _ref_run(fn, jh, jw)
        assert want.dtype == jh.dtype
        _close(got, np.asarray(want.astype(jnp.float32)), tol)


def test_moe_gmm_plain_ragged_matches_ref():
    """A shape the Pallas kernel refuses (C, D, F not multiples of its
    blocks): the port's kernel and its plain version take any."""
    h, w = _gmm_inputs(5, 37, 200, 72, seed=2)
    want = _ref_run(moe_gmm_ref, jnp.asarray(h), jnp.asarray(w))
    _close(moe_gmm_plain(torch.from_numpy(h), torch.from_numpy(w)), want,
           2e-4)


def test_ops_moe_gmm_keeps_autograd_on_the_cpu():
    h, w = (torch.from_numpy(a).requires_grad_(True)
            for a in _gmm_inputs(3, 5, 7, 4, seed=3))
    ops.reset_launches()
    out = ops.moe_gmm(h, w)
    assert sum(ops.LAUNCHES.values()) == 0       # the CPU takes the plain
    gh, gw = torch.autograd.grad(out.sum(), (h, w))
    torch.testing.assert_close(gh, w.sum(-1)[:, None, :].expand_as(h))
    torch.testing.assert_close(gw, h.sum(1)[:, :, None].expand_as(w))


# ------------------------------------------------------------ the dispatch


@pytest.mark.parametrize("args", [(2048, 8, 40, 1.25), (4, 8, 40, 1.25),
                                  (24, 2, 5, 1.25), (100, 3, 7, 0.5)])
def test_capacity_matches_reference(args):
    assert moe._capacity(*args) == ref_moe._capacity(*args)


@pytest.mark.parametrize("capacity", [128, 8], ids=["none-dropped",
                                                    "dropping"])
def test_moe_local_matches_reference(capacity):
    """64 tokens, top 2 of 5 experts: a capacity of 128 keeps every
    assignment, 8 drops most of them.  Outputs and aux within 1e-5; the
    keep mask is the reference's rule (rank in the token-major, k-minor
    order below the capacity), counted here in numpy."""
    t, d, f, e, k = 64, 16, 24, 5, 2
    rng = np.random.default_rng(4)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    w1, w3 = (rng.standard_normal((e, d, f)).astype(np.float32) / 4
              for _ in range(2))
    w2 = rng.standard_normal((e, f, d)).astype(np.float32) / 5
    ins = (x, router, w1, w3, w2)
    want, want_aux = _ref_run(
        lambda *a: ref_moe._moe_local(*a, topk=k, capacity=capacity,
                                      act="silu"),
        *map(jnp.asarray, ins))
    tins = [torch.from_numpy(a) for a in ins]
    got, aux = moe._moe_local(*tins, topk=k, capacity=capacity, act="silu")
    _close(got, want, 1e-5)
    _close(aux, want_aux, 1e-5)

    _, _, idx = moe._route(tins[0], tins[1], k)
    _, keep = moe._slots(idx, e, capacity)
    eid = idx.reshape(-1).numpy()
    rank = np.array([np.sum(eid[:i] == eid[i]) for i in range(eid.size)])
    np.testing.assert_array_equal(keep.numpy(), rank < capacity)
    assert bool(keep.all()) == (capacity == 128)


# ------------------------------------------------------------ granite SMOKE


@pytest.fixture(scope="module")
def smoke():
    """The reference's greedy loop on the granite SMOKE model: prefill a
    12-token prompt, then 8 decode steps, each fed the argmax of the last
    logits.  Returns the weights and every logit, token and cache."""
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
    assert sorted(got) == sorted(want)
    for name in got:
        _close(got[name], want[name], tol)


def test_smoke_prefill_decode_cache_and_tokens_match_reference(smoke):
    """Prefill logits and cache, 8 decode steps' logits and the final
    cache at 1e-5; the port's greedy tokens equal the reference's."""
    tree, prompts, ref = smoke
    port, params = LM(CFG, "cpu"), bridge.params_from_jax(tree)
    with torch.inference_mode():
        logits, st = port.prefill_with_cache(
            params, {"tokens": torch.from_numpy(prompts).long()},
            PROMPT + GEN, torch.float32)
        _close(logits, ref["prefill_logits"], 1e-5)
        assert st["position"] == PROMPT
        _close_cache(st["cache"], ref["prefill_cache"])
        cache, toks = st["cache"], []
        tok = torch.argmax(logits, -1, keepdim=True)
        for i, pos in enumerate(range(PROMPT, PROMPT + GEN)):
            np.testing.assert_array_equal(tok[:, 0].numpy(), ref["tokens"][i])
            logits, cache = port.decode_step(params, tok, cache, pos)
            _close(logits, ref["logits"][i], 1e-5)
            tok = torch.argmax(logits, -1, keepdim=True)
            toks.append(tok[:, 0])
    _close_cache(cache, ref["cache"])
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(),
                                  np.stack(ref["tokens"][1:], 1))


def test_smoke_forward_loss_with_aux_matches_reference(smoke):
    """``LM.forward``: cross entropy of the tied head plus 0.01 times the
    summed load-balance aux of the two MoE layers, at 1e-5; the backward
    reaches every parameter, the router through the aux."""
    tree = smoke[0]
    rng = np.random.default_rng(12)
    toks, labs = (rng.integers(0, CFG.vocab, (2, 10)).astype(np.int32)
                  for _ in range(2))
    want, mets = _ref_run(
        lambda p, t, y: RefLM(CFG_REF).forward(p, {"tokens": t,
                                                   "labels": y}),
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), jnp.asarray(labs))
    params = bridge.params_from_jax(tree)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, got = LM(CFG, "cpu").forward(
        params, {"tokens": torch.from_numpy(toks).long(),
                 "labels": torch.from_numpy(labs).long()})
    _close(float(loss.detach()), float(want), 1e-5)
    _close(float(got["aux"].detach()), float(mets["aux"]), 1e-5)
    assert float(got["aux"].detach()) > 0
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
               for g in grads)


def test_bridge_round_trip_of_the_moe_tree(smoke):
    """Stacked [L, E, D, F] expert leaves, the f32 router and the tied
    embeddings (no head leaf) carry over unchanged and back; the port's
    own init draws the same shapes, and its bf16 serving storage keeps the
    router f32."""
    tree = smoke[0]
    params = bridge.params_from_jax(tree)
    assert "head" not in params and sorted(params["blocks"]) == [
        "attn", "ln1", "ln2", "moe"]
    e, d, f = CFG.moe_experts, CFG.d_model, CFG.d_ff
    assert {k: tuple(v.shape) for k, v in params["blocks"]["moe"].items()} \
        == {"router": (2, d, e), "w1": (2, e, d, f), "w3": (2, e, d, f),
            "w2": (2, e, f, d)}
    back = bridge.params_to_jax(params)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] \
        == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    fresh = LM(CFG, "cpu").init(torch.Generator().manual_seed(0))
    assert jax.tree.map(np.shape, bridge.params_to_jax(fresh)) \
        == jax.tree.map(np.shape, tree)
    served = LM(dataclasses.replace(CFG, dtype="bfloat16"), "cpu").init(
        torch.Generator().manual_seed(0))["blocks"]["moe"]
    assert served["router"].dtype == torch.float32
    assert {served[n].dtype for n in ("w1", "w2", "w3")} == {torch.bfloat16}


# ------------------------------------------------------------ qwen3-moe split


def test_qwen3_moe_split_halves_match_reference():
    """The qwen3-moe SMOKE model (untied head) cut at 1: each half's
    prefill and two decode steps against the reference's ``SplitDecode``."""
    cfg_ref = ref_arch(QWEN_MOE).smoke
    ref = RefLM(cfg_ref)
    ref_params = _ref_run(ref.init, jax.random.key(1))
    port = LM(get_arch(QWEN_MOE).smoke, "cpu")
    params = bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))
    prompts = np.random.default_rng(3).integers(
        0, cfg_ref.vocab, (2, 5)).astype(np.int32)
    cache = 10
    rsplit, psplit = ref_infer.SplitDecode(ref, 1), infer.SplitDecode(port, 1)
    rue, rbs = rsplit.split_params(ref_params)
    pue, pbs = psplit.split_params(params)
    racts, rue_c = _ref_run(
        lambda p, t: rsplit.ue_prefill(p, t, cache_len=cache), rue,
        jnp.asarray(prompts))
    pacts, pue_c = psplit.ue_prefill(pue, torch.from_numpy(prompts).long(),
                                     cache_len=cache)
    _close(pacts, racts, 1e-5)
    rl, rbs_c = _ref_run(
        lambda p, a: rsplit.bs_prefill(p, a, cache_len=cache), rbs, racts)
    pl_, pbs_c = psplit.bs_prefill(pbs, pacts, cache_len=cache)
    _close(pl_, rl, 1e-5)
    tok = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]
    pos0 = jnp.asarray(prompts.shape[1], jnp.int32)
    ue_dec = _compiled(rsplit.ue_decode, rue, jnp.asarray(tok), rue_c, pos0)
    bs_dec = _compiled(rsplit.bs_decode, rbs, racts[:, :1], rbs_c, pos0)
    for pos in range(prompts.shape[1], prompts.shape[1] + 2):
        ra, rue_c = ue_dec(rue, jnp.asarray(tok), rue_c,
                           jnp.asarray(pos, jnp.int32))
        pa, pue_c = psplit.ue_decode(pue, torch.from_numpy(tok).long(),
                                     pue_c, pos)
        _close(pa, ra, 1e-5)
        rl, rbs_c = bs_dec(rbs, ra, rbs_c, jnp.asarray(pos, jnp.int32))
        pl_, pbs_c = psplit.bs_decode(pbs, pa, pbs_c, pos)
        _close(pl_, rl, 1e-5)
        tok = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]


def test_serve_cli_on_the_cpu():
    """granite static serving, its --split-cut refused (tied embeddings);
    qwen3-moe split at cut 1: 'none' tokens equal the static tokens, and
    the measured uplink bytes equal the billed bytes."""
    argv = ["--size", "smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", str(PROMPT), "--gen", "4"]
    res = serve.main(["--arch", GRANITE] + argv)
    assert tuple(res["tokens"].shape) == (2, 4)
    assert 0 <= int(res["tokens"].min()) <= int(res["tokens"].max()) \
        < CFG.vocab
    with pytest.raises(ValueError, match="tied"):
        serve.main(["--arch", GRANITE, "--split-cut", "1"] + argv)
    static = serve.main(["--arch", QWEN_MOE] + argv)
    for wire in ("none", "int8"):
        res = serve.main(["--arch", QWEN_MOE, "--split-cut", "1",
                          "--wire-dtype", wire] + argv)
        assert res["measured_payload_bytes"] == res["billed_payload_bytes"]
        if wire == "none":
            assert torch.equal(res["tokens"], static["tokens"])
