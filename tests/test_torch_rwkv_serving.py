"""RWKV serving of the port against the JAX package's, on the CPU.

The rwkv6 SMOKE model (f32) with the reference's weights (``bridge.py``):
``LM.prefill_with_cache`` (the last logits and the three decode-state
leaves, the WKV state ``s`` and the token shifts) and teacher-forced
decode steps against the reference's ``LM.prefill_with_cache`` and
``make_decode_step``, at 1e-5 relative to the largest value; the split
halves at cut 1 against the reference's ``SplitDecode``.  The launcher's
token-by-token prefill (``launch/serve.py::prefill_into_cache``) against
the one-pass prefill at the reference test's 3e-3
(``tests/test_models.py::test_chunked_prefill_matches_token_loop``: S
10, then G 4 decode steps from both states), for every family the port
serves.  The engine's RWKV lanes are held to the reference's engine and
to ``solo_decode`` in ``tests/test_torch_engine.py`` and
``tests/test_torch_engine_units.py``.

The reference runs through ``_ref_exe``: jitted, compiled once without
LLVM's optimisation passes (each graph runs a few times on small inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import LM as RefLM
from repro.parallel.steps import init_serve_state, make_decode_step
from repro.serving import infer as ref_infer
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.serve import prefill_into_cache
from repro_torch.models import blocks, moe
from repro_torch.models.lm import LM
from repro_torch.serving import infer

CFG_REF = ref_arch("rwkv6-3b").smoke
CFG = get_arch("rwkv6-3b").smoke
TOL = 1e-5
S, G = 10, 4                         # the reference test's prompt and steps
STATE = ("s", "shift_t", "shift_c")


def _ref_exe(fn, *args):
    """``fn`` of the reference, jitted and compiled for ``args``' shapes at
    LLVM optimisation level 0; call the result with arguments of those
    shapes."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _close(got, want, tol=TOL):
    """Within ``tol`` relative to the largest value."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.fixture(scope="module")
def models():
    ref = RefLM(CFG_REF)
    tree = jax.tree.map(np.asarray, _ref_exe(ref.init, jax.random.key(0))(
        jax.random.key(0)))
    return ref, jax.tree.map(jnp.asarray, tree), LM(CFG, "cpu"), \
        bridge.params_from_jax(tree)


def _prompts(b, s, seed=7):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("s", [S, 80])   # the scan and the chunked form
def test_prefill_and_teacher_forced_decode_match_reference(models, s):
    """The last logits and the three state leaves after the prefill, then
    G decode steps on the same forced tokens: logits and every leaf of
    the state after each step."""
    ref, ref_params, port, params = models
    toks = _prompts(2, s)
    cache_len = s + G
    prefill = _ref_exe(lambda p, t: ref.prefill_with_cache(
        p, {"tokens": t}, cache_len, cache_dtype=jnp.float32),
        ref_params, jnp.asarray(toks))
    rl, rstate = prefill(ref_params, jnp.asarray(toks))
    with torch.inference_mode():
        pl, pstate = port.prefill_with_cache(
            params, {"tokens": torch.from_numpy(toks).long()}, cache_len,
            torch.float32)
    assert pstate["position"] == s
    _close(pl, rl)
    cache = pstate["cache"]
    assert sorted(cache) == sorted(STATE)
    for name in STATE:
        assert tuple(cache[name].shape) == rstate["cache"][name].shape
        _close(cache[name], rstate["cache"][name])

    decode = make_decode_step(ref)
    forced = np.random.default_rng(s).integers(
        0, CFG.vocab, (G, 2, 1)).astype(np.int32)
    step = _ref_exe(decode, ref_params, rstate, jnp.asarray(forced[0]))
    for i in range(G):
        rl, rstate = step(ref_params, rstate, jnp.asarray(forced[i]))
        with torch.inference_mode():
            pl, cache = port.decode_step(
                params, torch.from_numpy(forced[i]).long(), cache, s + i)
        _close(pl, rl)
        for name in STATE:
            _close(cache[name], rstate["cache"][name])


def test_state_leaves_have_the_reference_layout(models):
    """``init_cache``: the WKV state [L, B, H, dh, dh] f32 and the token
    shifts [L, B, D] at the cache dtype, as the reference's
    ``init_serve_state`` lays them out."""
    ref, _rp, port, _params = models
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = port.init_cache(3, 16, dt)
        want = init_serve_state(ref, 3, 16, cache_dtype=jdt)["cache"]
        for name in STATE:
            assert tuple(got[name].shape) == want[name].shape
            assert str(got[name].dtype).split(".")[-1] == str(
                want[name].dtype)
            assert not got[name].any()


def test_split_halves_match_reference(models):
    """``SplitDecode`` at cut 1: the UE's cut activations and the BS's
    logits after the prefill and after 2 decode steps, against the
    reference's halves; the halves compose to the whole model bit for
    bit."""
    ref, ref_params, port, params = models
    toks = _prompts(2, S)
    cache_len = S + 2
    rsplit, psplit = ref_infer.SplitDecode(ref, 1), infer.SplitDecode(port, 1)
    rue, rbs = rsplit.split_params(ref_params)
    pue, pbs = psplit.split_params(params)
    racts, rue_c = rsplit.ue_prefill(rue, jnp.asarray(toks),
                                     cache_len=cache_len)
    rl, rbs_c = rsplit.bs_prefill(rbs, racts, cache_len=cache_len)
    with torch.inference_mode():
        ptoks = torch.from_numpy(toks).long()
        pacts, pue_c = psplit.ue_prefill(pue, ptoks, cache_len=cache_len)
        pl, pbs_c = psplit.bs_prefill(pbs, pacts, cache_len=cache_len)
        whole, state = port.prefill_with_cache(params, {"tokens": ptoks},
                                               cache_len, torch.float32)
    _close(pacts, racts)
    _close(pl, rl)
    assert torch.equal(pl, whole)
    tok = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]
    for pos in range(S, S + 2):
        ra, rue_c = rsplit.ue_decode(rue, jnp.asarray(tok), rue_c,
                                     jnp.asarray(pos, jnp.int32))
        rl, rbs_c = rsplit.bs_decode(rbs, ra, rbs_c,
                                     jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            ptok = torch.from_numpy(tok).long()
            pa, pue_c = psplit.ue_decode(pue, ptok, pue_c, pos)
            pl, pbs_c = psplit.bs_decode(pbs, pa, pbs_c, pos)
            whole, _ = port.decode_step(params, ptok, state["cache"], pos)
        _close(pa, ra)
        _close(pl, rl)
        assert torch.equal(pl, whole)
        tok = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]
    for name in STATE:
        assert torch.equal(torch.cat([pue_c[name], pbs_c[name]]),
                           state["cache"][name])


def _dropless_prefill(monkeypatch):
    """The MoE of a one-pass prefill routed dropless (capacity >= its
    tokens), as every decode step of the token loop routes."""
    orig = blocks.apply_moe
    monkeypatch.setattr(blocks, "apply_moe", lambda *a, dropless, **k:
                        orig(*a, dropless=True, **k))
    return orig


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_token_loop_prefill_matches_chunked_prefill(arch, monkeypatch):
    """The prompt through the decode step token by token against one
    full-sequence prefill: the last logits, then G greedy decode steps
    from both states, within the reference test's 3e-3.  An MoE's
    one-pass prefill runs dropless here: its capacity drops assignments
    that the loop, one token a step, never drops (ROADMAP Queue 3, fault
    18; ``test_moe_prefill_drops_what_the_token_loop_keeps``).  The
    encoder-decoder's prompts come with frames: the one-pass prefill
    encodes them, the loop starts from ``fill_cross_kv`` of their
    encoding, as the serve CLI's two paths do.  The vlm family's one-pass
    prefill takes an empty patch prefix, since the loop feeds tokens
    only, as its serve CLI does."""
    cfg = get_arch(arch).smoke
    model = LM(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, S))).long()
    batch = {"tokens": toks}
    if cfg.enc_layers:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros((2, 0, cfg.d_model))
    cache_len = S + G
    with torch.inference_mode():
        if cfg.is_moe:
            orig = _dropless_prefill(monkeypatch)
        la, sa = model.prefill_with_cache(params, batch, cache_len,
                                          torch.float32)
        if cfg.is_moe:
            monkeypatch.setattr(blocks, "apply_moe", orig)
        cache = model.init_cache(2, cache_len, torch.float32)
        if cfg.enc_layers:
            model.fill_cross_kv(params, model._encode(params,
                                                      batch["frames"]),
                                cache)
        lb, sb = prefill_into_cache(model, params, toks, cache)
        assert sa["position"] == sb["position"] == S
        np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=3e-3,
                                   atol=3e-3)
        for i in range(G):
            tok = torch.argmax(la, -1, keepdim=True)
            la, _ = model.decode_step(params, tok, sa["cache"], S + i)
            lb, _ = model.decode_step(params, tok, sb["cache"], S + i)
        np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=3e-3,
                                   atol=3e-3)


def test_moe_prefill_drops_what_the_token_loop_keeps(monkeypatch):
    """Fault 18: qwen3-moe SMOKE (8 experts, top 2) at B 2 x S 10 from
    ``torch.Generator`` seed 0.  The one-pass prefill's capacity is
    max(8, ceil(20 * 2 * 1.25 / 8)) = 8 a expert, and it drops the
    assignments ranked past it (1 in layer 0, 2 in layer 1), as the
    reference's prefill does (its logits equal the port's at 1e-5); the
    token loop routes 2 tokens a step and drops none.  The last logits
    then differ by more than 0.1, and agree within 3e-3 once the
    one-pass prefill routes dropless."""
    cfg_ref = ref_arch("qwen3-moe-30b-a3b").smoke
    ref = RefLM(cfg_ref)
    model = LM(get_arch("qwen3-moe-30b-a3b").smoke, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tree = jax.tree.map(jnp.asarray, bridge.params_to_jax(params))
    toks = np.random.default_rng(7).integers(
        0, cfg_ref.vocab, (2, S)).astype(np.int32)
    kept = []
    orig_slots = moe._slots

    def slots(*a):
        out = orig_slots(*a)
        kept.append(out[1])
        return out

    monkeypatch.setattr(moe, "_slots", slots)
    with torch.inference_mode():
        ptoks = torch.from_numpy(toks).long()
        la, _ = model.prefill_with_cache(params, {"tokens": ptoks}, S,
                                         torch.float32)
        dropped = [int((~k).sum()) for k in kept]
        kept.clear()
        lb, _ = prefill_into_cache(model, params, ptoks, model.init_cache(
            2, S, torch.float32))
        assert len(kept) == S * cfg_ref.num_layers
        assert all(bool(k.all()) for k in kept)
        _dropless_prefill(monkeypatch)
        lc, _ = model.prefill_with_cache(params, {"tokens": ptoks}, S,
                                         torch.float32)
    rl, _ = _ref_exe(lambda p, t: ref.prefill_with_cache(
        p, {"tokens": t}, S, cache_dtype=jnp.float32),
        tree, jnp.asarray(toks))(tree, jnp.asarray(toks))
    _close(la, rl)
    assert dropped == [1, 2]                  # layer 0's reaches layer 1
    assert float((la - lb).abs().max()) > 0.1
    np.testing.assert_allclose(lc.numpy(), lb.numpy(), rtol=3e-3, atol=3e-3)
