"""The port's continuous-batching engine against the JAX package's.

The reference's guarantee: continuous batching changes WHEN work runs
(requests join and leave the slot arena at any step, slots are reused,
prefill is chunked) but never WHAT it computes.  Here the port's engine
must emit, greedy, exactly the tokens of the reference's
``ServingEngine`` on the same weights (``bridge.py``) and of the port's
own batch-1 ``solo_decode``, on a dense model (the small config of
``tests/test_serving.py``), the recurrentgemma SMOKE model (RG-LRU state,
a local-attention ring that wraps), the granite-moe SMOKE model (5
experts, top 2) and the rwkv6 SMOKE model (the WKV state and token
shifts), under staggered submits, slot reuse and chunked
prefill; the slot arena's helpers and the admission counts are held to
the reference's too.  ``tests/test_torch_engine_units.py`` (no JAX)
holds the rest to ``solo_decode`` and to the reference's numpy-only
modules: sampled tokens follow the port's own keys, not JAX's.

The reference engines run at LLVM optimisation level 0 (``_ref_engine``),
as the other ``test_torch_*`` files compile the reference.  The CUDA
graph of the step runs only on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import LM as RefLM
from repro.models import LMConfig as RefLMConfig
from repro.serving import kv as ref_kv
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.scheduler import Request as RefRequest
from repro_torch import bridge
from repro_torch.models.config import LMConfig
from repro_torch.models.lm import LM
from repro_torch.serving import kv
from repro_torch.serving.engine import ServingEngine, solo_decode
from repro_torch.serving.scheduler import Request
from repro_torch.utils.trees import tree_leaves, tree_map

DENSE = RefLMConfig(name="serve-test", num_layers=2, d_model=32, n_heads=2,
                    n_kv=1, d_ff=32, vocab=64, dtype="float32")
CONFIGS = {"dense": DENSE,
           "hybrid": ref_arch("recurrentgemma-2b").smoke,
           "moe": ref_arch("granite-moe-3b-a800m").smoke,
           "rwkv": ref_arch("rwkv6-3b").smoke}
# (prompt, gen) of the staggered runs: the first two are submitted, then
# three engine steps run (the second request leaves), then the rest join.
# The dense run is the reference test's; the others keep one prompt
# length (one prefill shape for the reference to compile) under a
# 4-token budget (one prompt a chunk)
STAGGER = {"dense": [(3, 4), (5, 2), (3, 6), (4, 3), (5, 5)],
           "hybrid": [(4, 4), (4, 2), (4, 6), (4, 3), (4, 5)]}
STAGGER["moe"] = STAGGER["rwkv"] = STAGGER["hybrid"]
BUDGET = {"dense": 256, "hybrid": 4, "moe": 4, "rwkv": 4}
CACHE = 16


class _O0:
    """A jitted function of the reference, compiled at LLVM optimisation
    level 0 once per argument signature."""

    def __init__(self, fn):
        self.fn, self.exe = fn, {}

    def __call__(self, *args):
        key = str(jax.tree.map(lambda a: (np.shape(a), str(np.asarray(
            a).dtype) if np.isscalar(a) else str(a.dtype)), args))
        if key not in self.exe:
            self.exe[key] = self.fn.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return self.exe[key](*args)


def _ref_engine(model, params, **kw):
    eng = RefEngine(model, params, **kw)
    for name in ("_step", "_prefill", "_take_row", "_put_row"):
        setattr(eng, name, _O0(getattr(eng, name)))
    return eng


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def family(request):
    """(name, reference model, its params, port model, bridged params)."""
    cfg = CONFIGS[request.param]
    ref = RefLM(cfg)
    ref_params = _O0(jax.jit(ref.init))(jax.random.key(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))
    port = LM(LMConfig(**dataclasses.asdict(cfg)), "cpu")
    return request.param, ref, ref_params, port, params


def _specs(specs, vocab, cls=Request):
    rng = np.random.default_rng(11)
    return [cls(rid=i, prompt=rng.integers(0, vocab, plen),
                max_new_tokens=gen)
            for i, (plen, gen) in enumerate(specs)]


def _staggered(eng, reqs):
    for r in reqs[:2]:
        assert eng.submit(r)
    for _ in range(3):
        eng.step_once()
    for r in reqs[2:]:
        assert eng.submit(r)
    return eng.run()


def _leaves(tree):
    """A port tree's leaves in ``jax.tree.leaves``' order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


# ---------------------------------------------------------------- engines


def test_engine_matches_reference_engine_and_solo(family):
    """Staggered submits and slot reuse on 2 slots (the hybrid and MoE
    runs one prompt a prefill chunk): every request's greedy tokens equal
    the reference engine's and the port's solo decode, and the engines
    did the same work."""
    name, ref, ref_params, port, params = family
    vocab = port.cfg.vocab
    ref_eng = _ref_engine(ref, ref_params, slots=2, cache_len=CACHE,
                          prefill_chunk_tokens=BUDGET[name])
    want = _staggered(ref_eng, _specs(STAGGER[name], vocab, RefRequest))
    eng = ServingEngine(port, params, slots=2, cache_len=CACHE,
                        prefill_chunk_tokens=BUDGET[name])
    reqs = _specs(STAGGER[name], vocab)
    got = _staggered(eng, reqs)
    assert set(got) == set(want) == {r.rid for r in reqs}
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], np.asarray(want[r.rid]))
        np.testing.assert_array_equal(
            got[r.rid], solo_decode(port, params, r.prompt, r.max_new_tokens,
                                    cache_len=CACHE))
    mine, theirs = eng.stats(), ref_eng.stats()
    for key in ("decode_steps", "prefill_chunks", "engine_units",
                "occupancy_trace_sum"):
        assert mine[key] == theirs[key], key
    assert mine["qos"]["completed"] == len(reqs)
    assert not mine["graph"] and mine["capture_ms"] is None


def test_rejections_and_counts_match_reference(family):
    """prompt + gen > cache_len and a full queue are rejected, counted as
    the reference counts them."""
    _name, ref, ref_params, port, params = family
    snaps = []
    for eng, cls in ((_ref_engine(ref, ref_params, slots=2, cache_len=8,
                                  max_queue=2), RefRequest),
                     (ServingEngine(port, params, slots=2, cache_len=8,
                                    max_queue=2), Request)):
        oks = [eng.submit(cls(rid=i, prompt=np.zeros(p, np.int32),
                              max_new_tokens=g))
               for i, (p, g) in enumerate([(6, 4), (2, 2), (2, 2), (2, 2)])]
        assert oks == [False, True, True, False]
        snaps.append(eng.qos.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["rejected"] == 2 and snaps[1]["admitted"] == 0


# ------------------------------------------------------------- slot arena


def test_slot_axes_and_round_trips_match_reference(family):
    """``slot_axes`` (meta-device probes) equals the reference's
    (``eval_shape`` probes); take/put round trips, expand/squeeze invert
    each other, and ``where_slots`` merges as the reference's does."""
    _name, ref, _rp, port, _params = family
    want = ref_kv.slot_axes(ref, 8)
    axes = kv.slot_axes(port, 8)
    assert _leaves(axes) == jax.tree.leaves(want)
    cache = tree_map(lambda a: torch.arange(a.numel(), dtype=a.dtype)
                     .reshape(a.shape), port.init_cache(3, 8, torch.float32))
    ref_cache = jax.tree.map(lambda a: np.arange(a.size, dtype=np.float32)
                             .reshape(a.shape),
                             ref.init_cache(3, 8, np.float32))
    for a, b in zip(_leaves(cache), jax.tree.leaves(ref_cache),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), b)
    row = kv.take_slot(cache, axes, 1)
    for a, b in zip(_leaves(row),
                    jax.tree.leaves(ref_kv.take_slot(ref_cache, want, 1)),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    arena = tree_map(torch.zeros_like, cache)
    kv.put_slot(arena, axes, row, 2)
    back = kv.take_slot(arena, axes, 2)
    for a, b in zip(tree_leaves(row), tree_leaves(back)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(row), tree_leaves(
            kv.squeeze_slot(kv.expand_slot(row, axes), axes))):
        assert torch.equal(a, b)
    mask = torch.tensor([True, False, True])
    got = kv.where_slots(mask, cache, arena, axes)
    ref_got = ref_kv.where_slots(np.asarray(mask), ref_cache,
                                 jax.tree.map(np.zeros_like, ref_cache), want)
    for a, b in zip(_leaves(got), jax.tree.leaves(ref_got), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
