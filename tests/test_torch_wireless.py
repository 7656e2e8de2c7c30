"""The port's wireless model, schedule simulators and Algorithm 1 against
the JAX package's, on the CPU, and the wireless C²P²SL CLI.

The reference's ``repro.core`` and ``repro.wireless`` are numpy and scipy
only, so this file loads no JAX.  Tolerances: rates, traces, fleets and
profiles equal; task times, bubble rates and the four simulators within
1e-12 relative on seeded random plans; Algorithm 1 the same (l, k, v)
and history length, and b and tau within 1e-9 relative (both sides call
the same scipy solvers with the same options in one process).
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from repro.core import ao as ref_ao
from repro.core import costs as ref_costs
from repro.core import schedule as ref_schedule
from repro.wireless import channel as ref_channel
from repro.wireless import fleet as ref_fleet
from repro_torch.core import ao, costs, schedule
from repro_torch.launch import wireless_sl
from repro_torch.wireless import channel, fleet

REL = 1e-12


@pytest.fixture
def one_thread():
    """Torch on one CPU thread: beside the other test workers, more
    threads oversubscribe the cores and run the ResNet slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rel, atol=0)


def test_channel_rates_and_path_loss_match_reference():
    ch, ref_ch = channel.ChannelParams(), ref_channel.ChannelParams()
    assert dataclasses.asdict(ch) == dataclasses.asdict(ref_ch)
    assert ch.noise_w == ref_ch.noise_w
    d = np.linspace(10.0, 900.0, 37)
    p = np.linspace(0.0, 30.0, 37)
    np.testing.assert_array_equal(channel.pathloss_db(d, 3.5),
                                  ref_channel.pathloss_db(d, 3.5))
    narrow = channel.ChannelParams(bandwidth_hz=20e6, frame_s=5e-3)
    ref_narrow = ref_channel.ChannelParams(bandwidth_hz=20e6, frame_s=5e-3)
    for c, rc in ((ch, ref_ch), (narrow, ref_narrow)):
        np.testing.assert_array_equal(channel.shannon_rate(p, d, c),
                                      ref_channel.shannon_rate(p, d, rc))
        for a, b in zip(channel.ue_rates(p, d, c),
                        ref_channel.ue_rates(p, d, rc)):
            np.testing.assert_array_equal(a, b)


def test_traces_and_link_shaper_match_reference():
    tr = channel.BandwidthTrace(steps=(3, 10, 20), bw_Bps=(5e6, 5e6, 1e6))
    ref = ref_channel.BandwidthTrace(steps=(3, 10, 20),
                                     bw_Bps=(5e6, 5e6, 1e6))
    assert [tr.at(s) for s in range(25)] == [ref.at(s) for s in range(25)]
    assert tr.change_points == ref.change_points == (20,)
    step = channel.bandwidth_step_trace(8e6, 2e6, 7)
    assert step == channel.BandwidthTrace(steps=(0, 7), bw_Bps=(8e6, 2e6))
    assert dataclasses.astuple(step) == dataclasses.astuple(
        ref_channel.bandwidth_step_trace(8e6, 2e6, 7))
    for bad in (((), ()), ((2, 1), (1.0, 1.0)), ((0,), (0.0,))):
        with pytest.raises(ValueError):
            channel.BandwidthTrace(*bad)
    chs = {0: channel.ChannelParams(),
           5: channel.ChannelParams(bandwidth_hz=40e6),
           9: channel.ChannelParams(noise_psd_dbm_hz=-160.0)}
    ref_chs = {s: ref_channel.ChannelParams(**dataclasses.asdict(c))
               for s, c in chs.items()}
    got = channel.shannon_trace(chs, 20.0, 250.0, efficiency=0.7)
    want = ref_channel.shannon_trace(ref_chs, 20.0, 250.0, efficiency=0.7)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    sh = channel.LinkShaper.from_channel(chs[5], 18.0, 300.0, 0.5, 2e-3)
    rsh = ref_channel.LinkShaper.from_channel(ref_chs[5], 18.0, 300.0, 0.5,
                                              2e-3)
    assert [sh.delay_s(n) for n in (-5, 0, 1, 4096, 10 ** 7)] \
        == [rsh.delay_s(n) for n in (-5, 0, 1, 4096, 10 ** 7)]
    sh.set_rate(1e5)
    rsh.set_rate(1e5)
    assert sh.delay_s(1000) == rsh.delay_s(1000) and repr(sh) == repr(rsh)
    with pytest.raises(ValueError):
        sh.set_rate(0.0)
    with pytest.raises(ValueError):
        sh.set_rate(1.0, latency_s=-1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_sample_fleet_matches_reference_draw_for_draw(n, seed):
    got, want = fleet.sample_fleet(n, seed=seed), ref_fleet.sample_fleet(
        n, seed=seed)
    assert [dataclasses.astuple(u) for u in got.ues] \
        == [dataclasses.astuple(u) for u in want.ues]
    assert got.n == want.n == n
    np.testing.assert_array_equal(got.ue_flops, want.ue_flops)
    np.testing.assert_array_equal(got.storage, want.storage)
    for a, b in zip(got.rates(), want.rates()):
        np.testing.assert_array_equal(a, b)
    assert (got.bs_flops, fleet.K_UE, fleet.K_BS, fleet.F_BS) \
        == (want.bs_flops, ref_fleet.K_UE, ref_fleet.K_BS, ref_fleet.F_BS)


def _lm_kwargs(moe):
    return dict(num_layers=6, d_model=256, d_ff=704, n_heads=8, n_kv=2,
                vocab=1000, seq_len=128, moe_experts=8 if moe else 0,
                moe_topk=2 if moe else 0)


@pytest.mark.parametrize("which", ["resnet18", "lm_dense", "lm_moe"])
def test_profiles_match_reference(which):
    if which == "resnet18":
        got, want = costs.resnet18_profile(), ref_costs.resnet18_profile()
        np.testing.assert_array_equal(costs.resnet18_params(),
                                      ref_costs.resnet18_params())
    else:
        kw = _lm_kwargs(which == "lm_moe")
        got = costs.lm_profile("t", **kw)
        want = ref_costs.lm_profile("t", **kw)
    assert (got.name, got.layer_names, got.label_bytes, got.num_layers) \
        == (want.name, want.layer_names, want.label_bytes, want.num_layers)
    for f in ("fwd_flops", "bwd_flops", "act_bytes"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for l in range(1, got.num_layers + 1):
        assert (got.ue_fwd(l), got.ue_bwd(l), got.bs_fwd(l), got.bs_bwd(l),
                got.cut_bytes(l), got.ue_total(l)) \
            == (want.ue_fwd(l), want.ue_bwd(l), want.bs_fwd(l),
                want.bs_bwd(l), want.cut_bytes(l), want.ue_total(l))


def _random_plan(seed, n=6, zero=True):
    """A seeded (l, k, b, tau) with ragged real b, one zero-batch UE when
    ``zero``, and slots not filling the frame."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(5.0, 120.0, n)
    if zero:
        b[rng.integers(n)] = 0.0
    tau = rng.uniform(0.2, 1.0, n)
    tau *= rng.uniform(0.6, 1.0) * 10e-3 / tau.sum()
    return dict(l=int(rng.integers(1, 6)), k=int(rng.integers(1, 12)),
                b=b, tau=tau)


def _both(seed, n=6, zero=True):
    kw = _random_plan(seed, n, zero)
    return ((costs.resnet18_profile(), fleet.sample_fleet(n, seed=seed),
             schedule.Plan(**kw)),
            (ref_costs.resnet18_profile(), ref_fleet.sample_fleet(n, seed=seed),
             ref_schedule.Plan(**kw)))


@pytest.mark.parametrize("seed", range(4))
def test_task_times_bubble_rate_and_steady_state_match_reference(seed):
    (prof, flt, plan), (rprof, rflt, rplan) = _both(seed, zero=seed % 2 == 0)
    t = schedule.task_times(prof, flt, plan)
    rt = ref_schedule.task_times(rprof, rflt, rplan)
    for f in ("ue_fwd", "uplink", "downlink", "ue_bwd"):
        _close(getattr(t, f), getattr(rt, f))
    _close([t.bs_fwd, t.bs_bwd, t.bs_work], [rt.bs_fwd, rt.bs_bwd,
                                             rt.bs_work])
    for v in (1, 2, 3):
        _close(schedule.bubble_rate(t, plan.k, v),
               ref_schedule.bubble_rate(rt, rplan.k, v))
    assert schedule.steady_state_ok(t, plan.k) \
        == ref_schedule.steady_state_ok(rt, rplan.k)
    assert plan.batch == rplan.batch
    with pytest.raises(ValueError):
        schedule.bubble_rate(t, plan.k, 0)


@pytest.mark.parametrize("v", [1, 2])
@pytest.mark.parametrize("seed", range(3))
def test_simulators_match_reference(seed, v):
    (prof, flt, plan), (rprof, rflt, rplan) = _both(10 + seed,
                                                     zero=seed == 1)
    t = schedule.task_times(prof, flt, plan)
    rt = ref_schedule.task_times(rprof, rflt, rplan)
    ms, tl = schedule.simulate_c2p2sl(t, plan.k, collect_timeline=True,
                                      virtual_stages=v)
    rms, rtl = ref_schedule.simulate_c2p2sl(rt, rplan.k,
                                            collect_timeline=True,
                                            virtual_stages=v)
    _close(ms, rms)
    assert len(tl) == len(rtl) == 4 * flt.n * plan.k * v + 2 * plan.k * v
    assert [e[:3] for e in tl] == [e[:3] for e in rtl]
    _close([e[3:] for e in tl], [e[3:] for e in rtl])
    assert schedule.simulate_c2p2sl(t, plan.k, virtual_stages=v)[1] is None
    t1 = schedule.task_times(prof, flt, dataclasses.replace(plan, k=1))
    rt1 = ref_schedule.task_times(rprof, rflt,
                                  dataclasses.replace(rplan, k=1))
    _close(schedule.simulate_psl(t1), ref_schedule.simulate_psl(rt1))
    _close(schedule.simulate_sl(prof, flt, plan),
           ref_schedule.simulate_sl(rprof, rflt, rplan))
    for agg in (None, 0.5):
        _close(schedule.simulate_epsl(t1, flt.n, agg),
               ref_schedule.simulate_epsl(rt1, rflt.n, agg))


@pytest.mark.parametrize("seed", range(3))
def test_k_rules_and_feasible_cuts_match_reference(seed):
    (prof, flt, plan), (rprof, rflt, rplan) = _both(20 + seed)
    for l in range(1, 6):
        for cap, v in ((None, 1), (4, 1), (64, 2), (None, 3)):
            assert ao.lemma1_k(prof, flt, l, plan.b, plan.tau, k_cap=cap,
                               virtual_stages=v) \
                == ref_ao.lemma1_k(rprof, rflt, l, rplan.b, rplan.tau,
                                   k_cap=cap, virtual_stages=v)
        for v in (1, 2):
            k, ms = ao.makespan_k(prof, flt, l, plan.b, plan.tau, k_cap=32,
                                  virtual_stages=v)
            rk, rms = ref_ao.makespan_k(rprof, rflt, l, rplan.b, rplan.tau,
                                        k_cap=32, virtual_stages=v)
            assert k == rk
            _close(ms, rms)
    for b in (plan.b, plan.b * 40, np.full(flt.n, 1e6)):
        assert ao.feasible_l(prof, flt, b) == ref_ao.feasible_l(rprof, rflt, b)
    rng = np.random.default_rng(seed)
    for _ in range(20):
        comp, link = rng.uniform(0, 2, 2)
        cap, v = int(rng.integers(1, 40)), int(rng.integers(1, 4))
        assert ao.pipeline_k_auto(comp, link, cap, v) \
            == ref_ao.pipeline_k_auto(comp, link, cap, v)
    assert ao.pipeline_k_auto(1.0, 0.0, 7) == ref_ao.pipeline_k_auto(1.0, 0.0,
                                                                     7)


@pytest.mark.parametrize("strict", [True, False])
def test_batch_and_slot_subproblems_match_reference(strict):
    (prof, flt, plan), (rprof, rflt, rplan) = _both(30, n=8, zero=False)
    for l, k in ((1, 8), (2, 4), (4, 1)):
        b = ao.solve_batch_p3(prof, flt, l, k, plan.tau, 512, strict=strict)
        rb = ref_ao.solve_batch_p3(rprof, rflt, l, k, rplan.tau, 512,
                                   strict=strict)
        assert (b is None) == (rb is None)
        if b is None:
            continue
        np.testing.assert_array_equal(b, rb)
        _close(ao.solve_tau_p5(prof, flt, l, k, b),
               ref_ao.solve_tau_p5(rprof, rflt, l, k, rb), 1e-9)


ALGO_CASES = [  # (n UEs, fleet seed, k_policy, v_cap)
    (8, 0, "auto", 1), (8, 1, "auto", 1), (8, 2, "auto", 1),
    (4, 0, "auto", 1), (8, 0, "lemma1", 1), (8, 2, "auto", 2)]


@pytest.mark.parametrize("case", ALGO_CASES, ids=str)
def test_algorithm1_returns_the_reference_plan(case):
    n, seed, policy, v_cap = case
    got = ao.algorithm1(costs.resnet18_profile(),
                        fleet.sample_fleet(n, seed=seed), batch=512,
                        k_policy=policy, v_cap=v_cap)
    want = ref_ao.algorithm1(ref_costs.resnet18_profile(),
                             ref_fleet.sample_fleet(n, seed=seed), batch=512,
                             k_policy=policy, v_cap=v_cap)
    p, rp = got.plan, want.plan
    assert (p.l, p.k, p.v, len(got.history)) \
        == (rp.l, rp.k, rp.v, len(want.history))
    _close(p.b, rp.b, 1e-9)
    _close(p.tau, rp.tau, 1e-9)
    _close(got.history, want.history, 1e-9)
    _close(got.bubble, want.bubble, 1e-9)
    assert p.b.sum() == 512 and (p.b >= 0).all()
    assert p.tau.sum() <= 10e-3 * (1 + 1e-12)


def test_integer_allocation_and_training_k():
    rng = np.random.default_rng(0)
    for batch in (16, 32, 64, 512):
        b = rng.uniform(0, 100, 8)
        b[3] = 0.0
        alloc = wireless_sl.integer_allocation(b, batch)
        assert alloc.sum() == batch and (alloc >= 1).all()
        k = wireless_sl.train_k(32, alloc)
        assert 1 <= k <= min(32, alloc.min())
    plan_b = np.array([89., 61., 67., 43., 85., 52., 47., 68.])
    np.testing.assert_array_equal(
        wireless_sl.integer_allocation(plan_b, 512), plan_b)
    assert wireless_sl.train_k(32, plan_b.astype(int)) == 32


def test_cli_prints_the_reference_plan_and_trains(one_thread, monkeypatch):
    """``--device cpu --steps 1 --batch 16 --ues 4``: the printed plan is
    the reference's, and the C²P²SL and PSL first losses agree (the same
    forward, micro-batched or not).  The held-out batch is cut from 256
    to 32 samples to keep the test short."""
    monkeypatch.setattr(wireless_sl, "EVAL_BATCH", 32)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = wireless_sl.main(["--device", "cpu", "--steps", "1",
                                "--batch", "16", "--ues", "4"])
    lines = out.getvalue().splitlines()
    plan = json.loads(next(s for s in lines
                           if s.startswith("plan "))[len("plan "):])
    want = ref_ao.algorithm1(ref_costs.resnet18_profile(),
                             ref_fleet.sample_fleet(4, seed=0), batch=512)
    assert (plan["l"], plan["k"], plan["v"], len(plan["history"])) \
        == (want.plan.l, want.plan.k, want.plan.v, len(want.history))
    _close(plan["b"], want.plan.b, 1e-9)
    _close(plan["tau"], want.plan.tau, 1e-9)
    assert any(s.startswith("simulated batch time (Table I system model "
                            "seconds)") for s in lines)
    rows = [json.loads(s) for s in lines if s.startswith("{")]
    assert [(r["scheme"], r["step"], r["device"]) for r in rows] \
        == [("C2P2SL", 1, "cpu"), ("PSL", 1, "cpu")]
    assert res["alloc"].sum() == 16 and res["k"] == min(want.plan.k,
                                                        res["alloc"].min())
    np.testing.assert_allclose(rows[0]["loss"], rows[1]["loss"], rtol=1e-5)
    assert set(res["acc"]) == {"C2P2SL", "PSL"}


def test_cli_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wireless_sl.main(["--steps", "1"])
