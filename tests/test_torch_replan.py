"""The port's training planner, watchdog and online re-planner against the
JAX package's numpy-only modules (``analysis/autotune.py``,
``training/fault.py``, ``training/replan.py``; importing them loads no
JAX): the same inputs give the same plans, walls, bubbles, neighbours,
sweeps, estimates, hints and switch logs.
"""
import dataclasses
import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.analysis import autotune as ref_at
from repro.training import fault as ref_fault
from repro.training import replan as ref_rp
from repro_torch.analysis import autotune as at
from repro_torch.analysis import roofline
from repro_torch.training import fault
from repro_torch.training import replan as rp

CODECS = ("none", "int8", "fp8", "int8+topk0.25")


def _inputs(mod, **kw):
    base = dict(num_stages=2, stage_fwd_s=0.1, stage_bwd_s=0.2,
                link_s=0.01, hop_overhead_s=0.002, k_cap=16, v_cap=4,
                num_layers=8, act_bytes=2.0, act_hop_bytes=4.0e8,
                d_model=1024)
    base.update(kw)
    return mod.PlanInputs(**base)


def _same_autoplan(a, r):
    assert a.to_dict() == r.to_dict()


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(stages=st.integers(1, 8), k=st.integers(1, 64), v=st.integers(1, 4),
       wire=st.sampled_from(["none", " INT8 ", "fp8", "int8+topk0.50",
                             "fp8+topk0.1", "int8+topk1.0"]))
def test_plan_json_and_normalisation_match_reference(stages, k, v, wire):
    p = at.Plan(stages=stages, k=k, v=v, wire_dtype=wire)
    r = ref_at.Plan(stages=stages, k=k, v=v, wire_dtype=wire)
    assert p.to_json() == r.to_json()
    assert p.cell() == r.cell() and str(p) == str(r)
    assert at.Plan.from_json(json.loads(json.dumps(p.to_json()))) == p


@pytest.mark.parametrize("bad", [
    dict(stages=0, k=1), dict(stages=1, k=0), dict(stages=1, k=1, v=0),
    dict(stages=True, k=1), dict(stages=1.5, k=1),
    dict(stages=1, k=1, wire_dtype="int4"),
    dict(stages=1, k=1, wire_dtype="none+topk0.5")])
def test_plan_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        ref_at.Plan(**bad)
    with pytest.raises(ValueError):
        at.Plan(**bad)


def test_plan_schema_gate():
    with pytest.raises(ValueError, match="schema"):
        at.Plan.from_json({"schema": 2, "stages": 2, "k": 4})
    with pytest.raises(ValueError, match="missing"):
        at.Plan.from_json({"stages": 2})
    assert at.Plan.from_json({"stages": 2, "k": 4}) == at.Plan(2, 4)


# ---------------------------------------------------------------------------
# The objective and the argmin
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(stage_ms=st.integers(1, 500), link_ms=st.integers(1, 200),
       ovh_us=st.integers(0, 5000), stages=st.sampled_from([1, 2, 4]),
       layers=st.sampled_from([8, 12, 16]), codec_ns=st.integers(0, 50),
       d_model=st.sampled_from([64, 1024, 2560]))
def test_planner_matches_reference_on_drawn_inputs(
        stage_ms, link_ms, ovh_us, stages, layers, codec_ns, d_model):
    kw = dict(num_stages=stages, stage_fwd_s=stage_ms * 1e-3,
              stage_bwd_s=2 * stage_ms * 1e-3, link_s=link_ms * 1e-3,
              hop_overhead_s=ovh_us * 1e-6, num_layers=layers, k_cap=12,
              codec_s_per_byte=codec_ns * 1e-12, act_hop_bytes=1e8,
              d_model=d_model, wire_block=at.wire_block_for(d_model))
    inp, ref = _inputs(at, **kw), _inputs(ref_at, **kw)
    assert inp.to_dict() == ref.to_dict()
    for wire in CODECS:
        iw, rw = inp.with_wire(wire), ref.with_wire(wire)
        for v in iw.feasible_v():
            for k in (1, 3, 7):
                assert at.plan_wall_time(iw, k, v) == \
                    ref_at.plan_wall_time(rw, k, v)
                assert at.plan_bubble(iw, k, v) == \
                    ref_at.plan_bubble(rw, k, v)
                assert at.neighbor_plans(iw, k, v) == \
                    ref_at.neighbor_plans(rw, k, v)
    _same_autoplan(at.choose_plan(inp, wire_candidates=at.WIRE_AUTO),
                   ref_at.choose_plan(ref, wire_candidates=ref_at.WIRE_AUTO))
    _same_autoplan(at.choose_plan(inp, stage_candidates=[1, 2, 4]),
                   ref_at.choose_plan(ref, stage_candidates=[1, 2, 4]))
    assert at.wire_plan_sweep(inp) == ref_at.wire_plan_sweep(ref)


def test_choose_plan_pins_and_refusals_match_reference():
    inp, ref = _inputs(at), _inputs(ref_at)
    for kw in (dict(k_fixed=5), dict(v_fixed=2), dict(k_fixed=40, v_fixed=4)):
        _same_autoplan(at.choose_plan(inp, **kw),
                       ref_at.choose_plan(ref, **kw))
    for kw in (dict(k_fixed=0), dict(v_fixed=0), dict(v_fixed=3),
               dict(stage_candidates=[3])):
        with pytest.raises(ValueError):
            ref_at.choose_plan(ref, **kw)
        with pytest.raises(ValueError):
            at.choose_plan(inp, **kw)


def test_as_wireless_reproduces_plan_wall_time():
    from repro_torch.sl.c2p2sl import batch_wall_time
    inp = _inputs(at, wire_dtype="int8", codec_s_per_byte=1e-11)
    for k, v in ((1, 1), (4, 2), (9, 4)):
        assert batch_wall_time(*at.as_wireless(inp, k, v)) == \
            pytest.approx(at.plan_wall_time(inp, k, v), rel=1e-12)
    with pytest.raises(ValueError, match="topk"):
        at.as_wireless(inp.with_wire("int8+topk0.25"), 2, 1)
    with pytest.raises(ValueError, match="2-stage"):
        at.as_wireless(inp.with_stages(4), 2, 1)


def test_wire_byte_model_matches_reference():
    for wire in CODECS:
        for act in (2.0, 4.0):
            for block in (1, 7, 256):
                assert at.wire_link_scale(wire, act, block) == \
                    ref_at.wire_link_scale(wire, act, block)
                for d in (None, 263, 2560, 40000):
                    assert at.wire_link_scale_bwd(wire, act, block, d) == \
                        ref_at.wire_link_scale_bwd(wire, act, block, d)


def test_hw_table_holds_the_h100_and_no_tpu_constant():
    assert roofline.HW["peak_flops_bf16"] == 989e12
    assert roofline.HW["hbm_bw"] == 3.35e12
    assert "dcn_bw" not in roofline.HW and "ici_bw" not in roofline.HW
    assert at.LINK_PRIOR_BPS > 0 and at.HOP_OVERHEAD_PRIOR_S == 10e-3


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "rwkv6-3b"])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_plan_inputs_from_cfg_matches_reference_under_its_constants(
        arch, size, monkeypatch):
    """With the reference's ``HW`` peak and link constants patched into
    the port's module, the estimate equals the reference's field for
    field (bf16 configs: the reference resolves the width through numpy,
    which needs ml_dtypes' bfloat16)."""
    import ml_dtypes  # noqa: F401  (registers bfloat16 with numpy)

    from repro.configs import get_arch as ref_arch
    from repro_torch.configs import get_arch
    port_cfg = getattr(get_arch(arch), size)
    ref_cfg = getattr(ref_arch(arch), size)
    monkeypatch.setattr(at, "HW", dict(ref_at.HW))
    monkeypatch.setattr(at, "LINK_PRIOR_BPS", ref_at.HW["dcn_bw"])
    monkeypatch.setattr(at, "HOP_OVERHEAD_PRIOR_S",
                        ref_at.HW["dcn_latency_s"])
    for kw in (dict(), dict(link_bw_Bps=2e9, hop_overhead_s=1e-4,
                            k_cap=6, codec_s_per_byte=1e-12)):
        got = at.plan_inputs_from_cfg(port_cfg, batch=8, seq=128,
                                      num_stages=2, **kw)
        want = ref_at.plan_inputs_from_cfg(ref_cfg, batch=8, seq=128,
                                           num_stages=2, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_watchdog_matches_reference():
    clocks = _Clock(), _Clock()
    dogs = [mod.Watchdog(4, timeout_s=5.0, clock=c)
            for mod, c in zip((fault, ref_fault), clocks)]
    rng = np.random.default_rng(0)
    for step in range(30):
        for c in clocks:
            c.t = float(step)
        for w in range(4):
            if w == 3 and step > 10:
                continue                         # worker 3 dies
            t = float(rng.uniform(0.1, 0.2) * (3.0 if w == 1 else 1.0))
            for dog in dogs:
                dog.heartbeat(w, step_time=t)
    a, b = dogs
    assert a.dead_workers() == b.dead_workers() == [3]
    assert a.stragglers() == b.stragglers() == [1]
    assert dataclasses.astuple(a.telemetry()) == \
        dataclasses.astuple(b.telemetry())
    np.testing.assert_array_equal(a.throughputs(), b.throughputs())
    tel, rtel = a.telemetry(), b.telemetry()
    assert tel.median_s == rtel.median_s and tel.max_s == rtel.max_s
    assert tel.extra_hints(0.1) == rtel.extra_hints(0.1)
    for batch, mult in ((64, 1), (100, 4), (7, 1)):
        np.testing.assert_array_equal(
            fault.rebalance_batches(a.throughputs(), batch, mult),
            ref_fault.rebalance_batches(b.throughputs(), batch, mult))
    shape = {"pod": 4, "data": 8, "model": 2}
    assert fault.plan_rescale(shape, 1) == ref_fault.plan_rescale(shape, 1)
    assert fault.plan_rescale(shape, 9) == ref_fault.plan_rescale(shape, 9)


# ---------------------------------------------------------------------------
# The re-planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", [None, "off", "on", "every:7",
                                  "every:3,hysteresis:0.25,cooldown:9",
                                  "ewma:0.5,every:2"])
def test_replan_config_parse_and_describe_match_reference(text):
    a, b = rp.ReplanConfig.parse(text), ref_rp.ReplanConfig.parse(text)
    if b is None:
        assert a is None
        return
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.describe() == b.describe()
    assert rp.ReplanConfig.parse(a.describe()) == a


@pytest.mark.parametrize("bad", ["every", "every:0", "foo:1",
                                 "hysteresis:1.0", "ewma:1.5"])
def test_replan_config_refusals(bad):
    with pytest.raises(ValueError):
        ref_rp.ReplanConfig.parse(bad)
    with pytest.raises(ValueError):
        rp.ReplanConfig.parse(bad)


@pytest.mark.parametrize("feed", ["affine", "one_size", "bandwidth",
                                  "windowed"])
def test_link_estimator_matches_reference(feed):
    a, b = rp.LinkEstimator(ewma=0.6, window=5), \
        ref_rp.LinkEstimator(ewma=0.6, window=5)
    rng = np.random.default_rng(4)
    for i in range(12):
        if feed == "bandwidth":
            bw = float(rng.uniform(1e8, 2e8))
            oh = float(rng.uniform(0, 1e-3)) if i % 2 else None
            a.observe_bandwidth(bw, oh)
            b.observe_bandwidth(bw, oh)
            continue
        n = 1e6 if feed == "one_size" else float(rng.choice([1e6, 4e6, 9e6]))
        t = 2e-3 + n / 1e9 + (float(rng.normal(0, 1e-5))
                              if feed == "windowed" else 0.0)
        a.observe_hop(n, t)
        b.observe_hop(n, t)
    a.observe(0.0, 1.0)                  # junk samples are dropped
    b.observe(0.0, 1.0)
    assert a.hints() == b.hints()
    assert a.samples == b._samples


def test_apply_hints_matches_reference():
    inp, ref = _inputs(at), _inputs(ref_at)
    for hints in ({"link_bw_Bps": 4e10}, {"stage_time_scale": 2.0},
                  {"stage_time_scale": 2.0, "stage_fwd_s": 0.7},
                  {"hop_overhead_s": 1e-3, "codec_s_per_byte": 2e-12,
                   "step_time_ewma_s": 1.0}, {}):
        assert dataclasses.asdict(rp.apply_hints(inp, hints)) == \
            dataclasses.asdict(ref_rp.apply_hints(ref, hints))
    assert rp.apply_hints(inp, {"step_time_ewma_s": 1.0}) is inp


def _drive(mod, at_mod, bandwidth, steps, config, step_times=None):
    inp = _inputs(at_mod)
    r = mod.Replanner(inp, at_mod.choose_plan(
        inp, wire_candidates=at_mod.WIRE_AUTO).plan, config(mod))
    for step in range(1, steps + 1):
        r.observe_bandwidth(bandwidth(step))
        if step_times is not None:
            r.observe_step(0, step_times(step))
        r.maybe_replan(step)
    return r


def _bw0():
    inp = _inputs(at)
    return inp.act_hop_bytes / inp.link_s


@pytest.mark.parametrize("scenario", ["no_flap", "single_drift", "cooldown",
                                      "watchdog_drift"])
def test_replanner_matches_reference(scenario):
    """The reference's four regimes, on both re-planners: stationary noise
    (no switch), one 8x drop (exactly one switch), a drop inside a long
    cooldown, and compute drift through the watchdog."""
    rng = np.random.default_rng(11)
    noise = rng.standard_normal(200)
    bw0 = _bw0()
    step_times = None
    if scenario == "no_flap":
        bandwidth = lambda s: bw0 * (1.0 + 0.1 * noise[s - 1])   # noqa: E731
        config = lambda m: m.ReplanConfig(every=5, hysteresis=0.1)  # noqa
    elif scenario == "single_drift":
        bandwidth = lambda s: bw0 if s < 80 else bw0 / 8.0        # noqa
        config = lambda m: m.ReplanConfig(every=5, hysteresis=0.1)  # noqa
    elif scenario == "cooldown":
        bandwidth = lambda s: bw0 if s < 20 else bw0 / 8.0        # noqa
        config = lambda m: m.ReplanConfig(every=5, hysteresis=0.1,  # noqa
                                          cooldown=1000)
    else:
        bandwidth = lambda s: bw0                                  # noqa
        config = lambda m: m.ReplanConfig(every=10)                # noqa
        step_times = lambda s: 0.1 if s < 60 else 0.4             # noqa
    a = _drive(rp, at, bandwidth, 200, config, step_times)
    b = _drive(ref_rp, ref_at, bandwidth, 200, config, step_times)
    assert a.to_json() == b.to_json()
    assert dataclasses.asdict(a.refreshed_inputs()) == \
        dataclasses.asdict(b.refreshed_inputs())
    if scenario == "no_flap":
        assert a.switches == [] and a.evals == 40
    if scenario == "single_drift":
        assert len(a.switches) == 1 and a.switches[0].step >= 80
        assert a.switches[0].gain > 0.1


def test_replanner_pins_the_stage_count():
    with pytest.raises(ValueError, match="S=4"):
        rp.Replanner(_inputs(at), at.Plan(stages=4, k=8))


@pytest.mark.parametrize("layers", [None, 8, 12])
def test_reachable_cells_and_plans_match_reference(layers):
    kw = dict(num_stages=2, num_layers=layers, v_cap=4,
              wire_candidates=("none", "INT8", "int8", "int8+topk0.25"))
    assert rp.reachable_cells(**kw) == ref_rp.reachable_cells(**kw)
    inp = _inputs(at, num_layers=layers, k_cap=5)
    ref = _inputs(ref_at, num_layers=layers, k_cap=5)
    assert [p.to_json() for p in rp.reachable_plans(inp)] == \
        [p.to_json() for p in ref_rp.reachable_plans(ref)]
