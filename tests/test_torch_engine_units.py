"""The port's continuous-batching engine on the CPU, without JAX.

The lanes of the engine's one batched step (``models/blocks.py``) held to
the port's batch-1 ``solo_decode``: MoE routing at 16 slots (dropless,
where the naive capacity would drop tokens), a request whose prompt + gen
equals ``cache_len``, inactive slots unchanged bit for bit, sampled
tokens independent of the arena size, the prefill budget; the port's
sampling keys (``engine.sample_tokens``); and the host-side pieces held
to the reference's numpy-only modules (``serving/scheduler.py``,
``runtime/qos.py``, the serving planner of ``analysis/autotune.py``),
which import no JAX.  ``tests/test_torch_engine.py`` holds the engine's
tokens to the reference's ``ServingEngine``.
"""
import math

import numpy as np
import pytest
import torch

from repro.analysis import autotune as ref_autotune
from repro.runtime import qos as ref_qos
from repro.serving import scheduler as ref_scheduler
from repro_torch.analysis import autotune
from repro_torch.configs import get_arch
from repro_torch.models import blocks
from repro_torch.models.config import LMConfig
from repro_torch.models.lm import LM
from repro_torch.runtime import qos
from repro_torch.serving import kv, scheduler
from repro_torch.serving.engine import (ServingEngine, _mul32, convoy_units,
                                        gumbel_noise, sample_tokens,
                                        solo_decode)
from repro_torch.serving.scheduler import Request
from repro_torch.utils.trees import tree_leaves

# the small dense config of tests/test_serving.py
DENSE = LMConfig(name="serve-test", num_layers=2, d_model=32, n_heads=2,
                 n_kv=1, d_ff=32, vocab=64, dtype="float32")
CACHE = 16


def _model(name):
    cfg = {"dense": DENSE,
           "hybrid": get_arch("recurrentgemma-2b").smoke,
           "moe": get_arch("granite-moe-3b-a800m").smoke,
           "rwkv": get_arch("rwkv6-3b").smoke}[name]
    port = LM(cfg, "cpu")
    return port, port.init(torch.Generator().manual_seed(0))


def _specs(specs, vocab):
    rng = np.random.default_rng(11)
    return [Request(rid=i, prompt=rng.integers(0, vocab, plen),
                    max_new_tokens=gen)
            for i, (plen, gen) in enumerate(specs)]


def _arena_rows(cache, axes, slot):
    return [t.clone() for t in tree_leaves(kv.take_slot(cache, axes, slot))]


# ------------------------------------------------------------------ lanes


def test_moe_at_16_slots_routes_dropless(monkeypatch):
    """16 lanes of the granite-moe SMOKE model (5 experts, top 2): the
    batched step's naive capacity max(8, ceil(16 * 2 * 1.25 / 5)) = 8
    drops tokens that a lone lane keeps (the run with it differs), so the
    engine routes dropless, as the reference's vmapped lanes do (each at
    capacity 8 for its one token), and equals the solo decodes."""
    port, params = _model("moe")
    specs = [(4, 3)] * 16
    reqs = _specs(specs, port.cfg.vocab)
    got = ServingEngine(port, params, slots=16, cache_len=CACHE).run(reqs)
    solo = {r.rid: solo_decode(port, params, r.prompt, r.max_new_tokens,
                               cache_len=CACHE) for r in reqs}
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], solo[r.rid])

    orig = blocks.apply_moe
    monkeypatch.setattr(blocks, "apply_moe", lambda *a, dropless, **k:
                        orig(*a, dropless=False, **k))
    naive = ServingEngine(port, params, slots=16, cache_len=CACHE).run(
        _specs(specs, port.cfg.vocab))
    assert any(not np.array_equal(naive[r.rid], solo[r.rid]) for r in reqs)


@pytest.mark.parametrize("name", ["dense", "hybrid", "rwkv"])
def test_prompt_plus_gen_equal_to_cache_len(name):
    """A request whose prompt + gen fills the cache exactly (its lane's
    position reaches cache_len once it finishes, while the other lane
    still decodes): the inactive lane's write index is clamped, and both
    requests equal their solo decodes."""
    port, params = _model(name)
    reqs = _specs([(5, CACHE - 5), (3, CACHE - 3)], port.cfg.vocab)
    eng = ServingEngine(port, params, slots=2, cache_len=CACHE)
    out = eng.run(reqs)
    for r in reqs:
        assert r.prompt_len + r.max_new_tokens <= CACHE
        np.testing.assert_array_equal(
            out[r.rid], solo_decode(port, params, r.prompt,
                                    r.max_new_tokens, cache_len=CACHE))
    assert eng.positions.max() == CACHE


@pytest.mark.parametrize("name", ["dense", "hybrid", "rwkv"])
def test_inactive_slots_unchanged_bit_for_bit(name):
    """A decode step changes only the active lanes' rows: every leaf of
    the inactive slots (K/V, the ring, the RG-LRU h and conv states,
    RWKV's WKV state and token shifts) keeps its bytes, including a slot
    whose tenant just finished."""
    port, params = _model(name)
    eng = ServingEngine(port, params, slots=3, cache_len=CACHE)
    for r in _specs([(5, 1), (5, 5)], port.cfg.vocab):
        eng.submit(r)
    eng.step_once()             # both admitted; rid 0 finishes in slot 0
    assert list(eng.active) == [False, True, False]
    before = [_arena_rows(eng.cache, eng.axes, s) for s in range(3)]
    eng.step_once()
    after = [_arena_rows(eng.cache, eng.axes, s) for s in range(3)]
    for s in (0, 2):
        for a, b in zip(before[s], after[s]):
            assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(before[1], after[1]))


@pytest.mark.parametrize("name", ["dense", "hybrid", "moe", "rwkv"])
def test_sampled_tokens_slot_independent_and_solo(name):
    """Sampling at T = 0.7 with the port's keys: each request's tokens are
    the same at 1 and 3 slots and equal to its solo decode's."""
    port, params = _model(name)
    cfg = port.cfg
    specs = [(4, 5), (4, 3), (4, 6), (4, 4)]
    outs = {slots: ServingEngine(port, params, slots=slots, cache_len=CACHE,
                                 temperature=0.7, seed=9).run(
                                     _specs(specs, cfg.vocab))
            for slots in (1, 3)}
    for r in _specs(specs, cfg.vocab):
        solo = solo_decode(port, params, r.prompt, r.max_new_tokens,
                           cache_len=CACHE, temperature=0.7, seed=9,
                           rid=r.rid)
        np.testing.assert_array_equal(outs[1][r.rid], solo)
        np.testing.assert_array_equal(outs[3][r.rid], solo)
    greedy = ServingEngine(port, params, slots=3, cache_len=CACHE).run(
        _specs(specs, cfg.vocab))
    assert any(not np.array_equal(greedy[r], outs[3][r]) for r in greedy)


def test_prefill_chunk_budget_equivalence():
    """A 6-token budget admits one prompt a chunk (5 chunks); the tokens
    equal those of an unconstrained run."""
    port, params = _model("dense")
    specs = [(6, 3)] * 5
    outs, chunks = {}, {}
    for budget in (6, 512):
        eng = ServingEngine(port, params, slots=5, cache_len=CACHE,
                            prefill_chunk_tokens=budget)
        outs[budget] = eng.run(_specs(specs, port.cfg.vocab))
        chunks[budget] = eng.prefill_chunks
    assert chunks == {6: 5, 512: 1}
    assert outs[6].keys() == outs[512].keys()
    for rid in outs[6]:
        np.testing.assert_array_equal(outs[6][rid], outs[512][rid])



# ---------------------------------------------------------------- refusals


def test_engine_refuses_what_it_cannot_serve():
    """A graph needs the card; the slot count must be positive; the card
    is used unless the CPU is asked for."""
    port, params = _model("dense")
    with pytest.raises(ValueError, match="graph=True"):
        ServingEngine(port, params, slots=2, cache_len=8, graph=True)
    with pytest.raises(ValueError, match="slots"):
        ServingEngine(port, params, slots=0, cache_len=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingEngine(LM(port.cfg, "cuda"), params, slots=2,
                          cache_len=8)


# --------------------------------------------------------------- sampling


def test_mul32_is_the_product_mod_2_32():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    for c in (0x7FEB352D, 0x846CA68B, 1, 0xFFFFFFFF):
        got = _mul32(torch.as_tensor(x.astype(np.int64)), c).numpy()
        want = [(int(v) * c) % 2 ** 32 for v in x]
        np.testing.assert_array_equal(got, np.asarray(want, np.int64))


def test_gumbel_noise_is_keyed_by_request_and_index_only():
    """A row of noise depends on (seed, rid, tok_idx) and nothing else:
    not on the row it sits in or on the other rows."""
    a = gumbel_noise(3, torch.tensor([5, 7, 5]), torch.tensor([0, 0, 1]),
                     1000, "cpu")
    b = gumbel_noise(3, torch.tensor([7]), torch.tensor([0]), 1000, "cpu")
    assert torch.equal(a[1], b[0])
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    assert not torch.equal(
        a[1], gumbel_noise(4, torch.tensor([7]), torch.tensor([0]), 1000,
                           "cpu")[0])
    assert torch.isfinite(a).all()


def test_sampling_follows_the_softmax_and_greedy_takes_the_first_max():
    """Gumbel-max draws, over 20,000 token indices of one request, land on
    each id with probability softmax(logits / T) (within 0.015); the
    noise's mean is Euler's constant (within 0.01).  Greedy ties go to
    the first index, as in ``jnp.argmax``."""
    logits = torch.tensor([[1.0, 0.5, -0.3, 1.0, 0.0]])
    n, temp = 20_000, 0.7
    idx = torch.arange(n)
    draws = sample_tokens(logits.expand(n, -1), temp, 1,
                          torch.zeros(n, dtype=torch.int64), idx)
    freq = torch.bincount(draws, minlength=5).double() / n
    want = torch.softmax(logits[0].double() / temp, -1)
    assert float((freq - want).abs().max()) < 0.015
    g = gumbel_noise(1, torch.zeros(64, dtype=torch.int64), torch.arange(64),
                     5000, "cpu")
    assert abs(float(g.double().mean()) - 0.5772156649) < 0.01
    assert sample_tokens(logits, 0.0, 1, [0], [0]).tolist() == [0]


# ------------------------------------------- host pieces, against numpy ref


def test_freelist_lifo_and_double_free():
    """The reference test's sequence (``tests/test_serving.py``)."""
    fl = kv.FreeList(3)
    assert [fl.alloc(), fl.alloc()] == [0, 1]
    fl.free(0)
    assert fl.alloc() == 0                   # LIFO: immediate reuse
    fl.free(0)
    with pytest.raises(ValueError):
        fl.free(0)                           # double free
    with pytest.raises(ValueError):
        fl.free(7)                           # out of range
    assert len(fl) == 2 and fl.alloc() == 0 and fl.alloc() == 2
    with pytest.raises(IndexError):
        fl.alloc()


def _schedule(mod):
    """The reference test's scheduler script, on ``mod``'s Scheduler:
    (submit results, chunks' rids, rejected, the over-budget head)."""
    s = mod.Scheduler(cache_len=32, prefill_chunk_tokens=8,
                      policy="longest_first")
    oks = [s.submit(mod.Request(rid=rid, prompt=np.zeros(plen, np.int32),
                                max_new_tokens=gen))
           for rid, (plen, gen) in enumerate(
               [(30, 4), (4, 2), (4, 9), (6, 5), (4, 9)])]
    chunks = [[r.rid for r in s.next_chunk(free_slots=4)]
              for _ in range(4)]
    s2 = mod.Scheduler(cache_len=64, prefill_chunk_tokens=4)
    s2.submit(mod.Request(rid=0, prompt=np.zeros(10, np.int32),
                          max_new_tokens=1))
    fifo = mod.Scheduler(cache_len=32, prefill_chunk_tokens=100,
                         max_queue=3)
    queued = [fifo.submit(mod.Request(rid=i, prompt=np.zeros(3, np.int32),
                                      max_new_tokens=g))
              for i, g in enumerate([1, 9, 4, 2])]
    return (oks, chunks, s.rejected, [r.rid for r in s2.next_chunk(2)],
            queued, [r.rid for r in fifo.next_chunk(2)], fifo.rejected)


def test_scheduler_buckets_policies_and_rejects():
    got = _schedule(scheduler)
    assert got == _schedule(ref_scheduler)
    assert got[:4] == ([False, True, True, True, True],
                       [[2, 4], [3], [1], []], 1, [0])
    assert got[4:] == ([True, True, True, False], [0, 1], 1)
    assert scheduler.POLICIES == ref_scheduler.POLICIES
    with pytest.raises(ValueError):
        scheduler.Scheduler(cache_len=8, policy="shortest_first")
    with pytest.raises(ValueError):
        Request(rid=0, prompt=np.zeros(0, np.int32), max_new_tokens=1)


def test_convoy_units():
    reqs = _specs([(4, 8), (4, 2), (4, 2), (4, 2)], DENSE.vocab)
    # batch 2: groups (8, 2) and (2, 2) -> 16 + 2*8 + 2*2
    assert convoy_units(reqs, 2) == 16 + 2 * 8 + 2 * 2


def test_percentile_nearest_rank():
    xs = [10.0, 20.0, 30.0, 40.0]
    for q in (0, 25, 50, 99, 100):
        assert qos.percentile(xs, q) == ref_qos.percentile(xs, q)
    assert qos.percentile(xs, 50) == 20.0 and qos.percentile(xs, 99) == 40.0
    assert qos.percentile([], 50) is None
    with pytest.raises(ValueError):
        qos.percentile(xs, 150)


def _scripted(mod):
    t = {"now": 0.0}
    q = mod.ServingQoS(clock=lambda: t["now"])
    for rid, (ttft, per_tok, n) in enumerate([(1.0, 0.5, 3), (2.0, 0.25, 5),
                                              (4.0, 1.0, 2)]):
        t["now"] = 0.0
        q.record_submit(rid)
        q.record_admit(rid, step=0)
        t["now"] = ttft
        q.record_token(rid, step=1)
        for i in range(1, n):
            t["now"] = ttft + i * per_tok
            q.record_token(rid, step=1 + i)
        q.record_done(rid, step=n)
    q.record_submit(99)
    q.record_submit(98)
    q.record_reject(98)
    return q


def test_serving_qos_scripted_clock():
    q = _scripted(qos)
    snap = q.snapshot()
    assert snap == _scripted(ref_qos).snapshot()
    assert snap["admitted"] == 3 and snap["completed"] == 3
    assert snap["rejected"] == 1 and snap["queued"] == 1
    assert snap["tokens_emitted"] == 10
    assert snap["latency"] == {"p50_ttft_s": 2.0, "p99_ttft_s": 4.0,
                               "p50_tok_s": 0.5, "p99_tok_s": 1.0}
    with pytest.raises(ValueError):
        q.record_submit(99)
    with pytest.raises(KeyError):
        q.record_token(1234, step=0)


# ---------------------------------------------------------- serving planner


def _inputs(mod, **kw):
    base = dict(decode_lane_s=1e-3, prefill_s_per_token=1e-3,
                arrival_hz=2.0, prompt_tokens=8.0, gen_tokens=32.0,
                step_overhead_s=5e-3)
    base.update(kw)
    return mod.ServingInputs(**base)


@pytest.mark.parametrize("kw", [{}, {"arrival_hz": 50.0},
                                {"d_model": 256, "act_bytes": 4.0,
                                 "link_bw_Bps": 2e6, "hop_overhead_s": 1e-4,
                                 "wire_dtype": "int8"}])
def test_serving_wall_matches_reference(kw):
    for slots in (1, 4, 8, 32):
        assert autotune.serving_wall(_inputs(autotune, **kw), slots) ==             ref_autotune.serving_wall(_inputs(ref_autotune, **kw), slots)
    ev = autotune.serving_wall(_inputs(autotune), 8)
    assert ev["rho"] < 1 and math.isfinite(ev["p99_ttft_s"])
    assert autotune.serving_wall(_inputs(autotune), 32)["per_token_s"]         > autotune.serving_wall(_inputs(autotune), 4)["per_token_s"]
    with pytest.raises(ValueError):
        autotune.serving_wall(_inputs(autotune), 0)


def test_choose_serving_plan_interior_and_errors():
    inp = _inputs(autotune)
    plan = autotune.choose_serving_plan(inp)
    assert plan.to_dict() == ref_autotune.choose_serving_plan(
        _inputs(ref_autotune)).to_dict()
    assert 1 < plan.slots < max(inp.slot_candidates) and plan.rho < 1
    for s in inp.slot_candidates:
        assert plan.p99_ttft_s <= autotune.serving_wall(
            inp, s)["p99_ttft_s"] * (1 + 1e-8)
    with pytest.raises(ValueError):          # every candidate overloaded
        autotune.choose_serving_plan(_inputs(autotune, arrival_hz=1e6))
    with pytest.raises(ValueError):          # top-k is illegal on INFER
        autotune.choose_serving_plan(inp, wire_candidates=["int8+topk0.25"])
    split = dict(d_model=256, act_bytes=4.0, link_bw_Bps=2e6,
                 hop_overhead_s=1e-4)
    coded = autotune.choose_serving_plan(
        _inputs(autotune, **split), wire_candidates=["none", "int8", "fp8"])
    assert coded.to_dict() == ref_autotune.choose_serving_plan(
        _inputs(ref_autotune, **split),
        wire_candidates=["none", "int8", "fp8"]).to_dict()
    assert coded.wire_dtype == "int8"
