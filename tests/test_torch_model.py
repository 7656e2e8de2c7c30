"""The port's model against the JAX package's, on the same weights.

Parameters come from the reference's ``init`` (with the biases and norm
weights perturbed so those paths carry numbers) and cross through
``bridge.py``; inputs come from a numpy seed.  Prefill logits and cache
and three decode steps are held to the reference at 1e-5 in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LM as RefLM
from repro.models import LMConfig as RefLMConfig
from repro.models import common as ref_common
from repro_torch import bridge
from repro_torch.models import LM, LMConfig
from repro_torch.models import common

CFG = RefLMConfig(name="torch-port-test", num_layers=2, d_model=64,
                  n_heads=4, n_kv=2, d_ff=96, vocab=128, qkv_bias=True,
                  rope_theta=1_000_000.0, dtype="float32")
PORT_CFG = LMConfig(**dataclasses.asdict(CFG))
TOL = dict(atol=1e-5, rtol=1e-5)


def _perturb(params, rng):
    """Random biases and norm weights (the reference inits them to 0)."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if path[-1] in ("qb", "kb", "vb") or path[-2:-1] in (("ln1",),
                                                             ("ln2",),
                                                             ("final_norm",)):
            return (0.1 * rng.standard_normal(tree.shape)).astype(np.float32)
        return tree
    return walk(params)


@pytest.fixture(scope="module")
def models():
    ref = RefLM(CFG)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    tree = _perturb(tree, np.random.default_rng(1))
    ref_params = jax.tree.map(jnp.asarray, tree)
    return ref, ref_params, LM(PORT_CFG, "cpu"), bridge.params_from_jax(tree)


def test_bridge_round_trip(models):
    ref, ref_params, _port, params = models
    back = bridge.params_to_jax(params)
    want = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] \
        == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert params["blocks"]["attn"]["q"].shape == (2, 64, 64)


def test_init_matches_reference_layout(models):
    _ref, ref_params, port, _params = models
    fresh = port.init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref_params)
    assert jax.tree.map(lambda a: tuple(a.shape),
                        bridge.params_to_jax(fresh)) == shapes


def test_prefill_and_decode_match_reference(models):
    ref, ref_params, port, params = models
    tokens = np.random.default_rng(2).integers(0, CFG.vocab, (2, 9))
    cache_len = 13
    rl, rs = jax.jit(ref.prefill_with_cache,
                     static_argnames=("cache_len", "cache_dtype"))(
        ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)},
        cache_len=cache_len, cache_dtype=jnp.float32)
    pl_, ps = port.prefill_with_cache(
        params, {"tokens": torch.from_numpy(tokens)}, cache_len=cache_len,
        cache_dtype=torch.float32)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(rl), **TOL)
    assert ps["position"] == int(rs["position"])
    for name in ("k", "v"):
        np.testing.assert_allclose(ps["cache"][name].numpy(),
                                   np.asarray(rs["cache"][name]), **TOL)
    decode = jax.jit(ref.decode_step)
    rcache, pcache = rs["cache"], ps["cache"]
    tok = np.argmax(np.asarray(rl), -1)[:, None]
    for pos in range(9, 12):
        rl, rcache = decode(ref_params, jnp.asarray(tok, jnp.int32), rcache,
                            jnp.asarray(pos, jnp.int32))
        pl_, pcache = port.decode_step(params, torch.from_numpy(tok),
                                       pcache, pos)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(rl), **TOL)
        tok = np.argmax(np.asarray(rl), -1)[:, None]
    for name in ("k", "v"):
        np.testing.assert_allclose(pcache[name].numpy(),
                                   np.asarray(rcache[name]), **TOL)


@pytest.mark.parametrize("causal,window,hkv", [(True, 0, 4), (True, 0, 2),
                                               (True, 5, 2), (False, 0, 1)])
def test_chunked_attention_matches_reference(causal, window, hkv):
    rng = np.random.default_rng(3)
    b, s, hq, dh = 2, 11, 4, 16
    q = rng.standard_normal((b, s, hq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
            for _ in range(2))
    pos = jnp.arange(s)
    want = ref_common.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=pos,
        kv_positions=pos, causal=causal, window=window)
    got = common.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   window=window)
    assert got.shape == (b, s, hq, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
              for _ in range(2))
    want = ref_common.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), position=6)
    got = common.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc), position=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_norms_rope_and_activations_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, bias))
    pairs = [
        (common.rmsnorm(xt, wt), ref_common.rmsnorm(x, w)),
        (common.layernorm(xt, wt, bt), ref_common.layernorm(x, w, bias)),
        (common.apply_rope(xt, torch.arange(7), 1e6),
         ref_common.apply_rope(jnp.asarray(x), jnp.arange(7), 1e6)),
    ] + [(common.activation(xt, kind), ref_common.activation(x, kind))
         for kind in ("silu", "gelu", "relu", "sqrelu")]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unported_kinds_raise():
    with pytest.raises(NotImplementedError, match="xattn"):
        LM(dataclasses.replace(PORT_CFG, family="hybrid",
                               pattern=("local", "xattn")), "cpu")
    with pytest.raises(NotImplementedError):
        LM(dataclasses.replace(PORT_CFG, tie_embeddings=True), "cpu")
