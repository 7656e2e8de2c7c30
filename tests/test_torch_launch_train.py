"""The port's training launcher surface against the JAX package's, on the
CPU: the shared plan flags (``launch/plan_args.py``), the plan resolution
(``resolve_pipeline_plan``, under the reference's constants), the
re-planner's step cache and state carry-over (``PlanCellCache``,
``carry_state``), checkpoint and resume through ``launch/train.py`` (a
resumed run equals the uninterrupted one bit for bit; ROADMAP Queue 3
fault 16 shows the reference's does not), the online switch on a SMOKE
run, and the FULL-width plan and switch that ``chip_smoke.py`` asserts on
the card, computed by the planner alone.
"""
import argparse
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from repro.analysis import autotune as ref_at
from repro_torch.analysis import autotune as at
from repro_torch.analysis.autotune import Plan
from repro_torch.configs import get_arch
from repro_torch.launch import plan_args, train
from repro_torch.parallel.pipeline import PipelineSpec, wire_ef_zeros
from repro_torch.runtime import protocol
from repro_torch.training.replan import (PlanCellCache, ReplanConfig,
                                         Replanner, carry_state)
from repro_torch.utils.trees import tree_leaves
from repro_torch.wireless.channel import BandwidthTrace

ARCH = "qwen1.5-4b"
SMOKE = ["--arch", ARCH, "--size", "smoke", "--device", "cpu", "--batch",
         "4", "--seq", "16", "--log-every", "0"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: on several CPU threads a sum's order
    varies from run to run, so two identical runs already differ by
    ~1e-9, and the resume tests compare bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    """``chip_smoke.py`` as a module (its constants; main() not run)."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# The shared flag group
# ---------------------------------------------------------------------------


def _parse(mod, flavor, argv):
    ap = argparse.ArgumentParser()
    mod.add_plan_args(ap, flavor=flavor)
    return vars(ap.parse_args(argv))


@pytest.mark.parametrize("flavor,argv", [
    ("train", []),
    ("train", ["--pipeline-stages", "2", "--pipeline-k", "auto",
               "--pipeline-v", "2", "--wire-dtype", "auto",
               "--plan-hints", "h.json", "--plan-out", "p.json",
               "--replan", "every:3,hysteresis:0.05"]),
    ("train", ["--pipeline-stages", "4", "--pipeline-k", "8",
               "--virtual-stages", "auto", "--wire-dtype", "int8+topk0.25"]),
    ("serve", []),
    ("serve", ["--wire-dtype", "fp8", "--plan-out", "s.json"])])
def test_add_plan_args_parses_like_the_reference(flavor, argv):
    """Same argv, same namespace (the reference's ``--plan-roofline``,
    which reads XLA dry-run records, is not ported)."""
    from repro.launch import plan_args as ref_plan_args
    want = _parse(ref_plan_args, flavor, argv)
    want.pop("plan_roofline", None)
    assert _parse(plan_args, flavor, argv) == want


def test_pipeline_v_alias_and_replan_config_exit():
    old = _parse(plan_args, "train", ["--pipeline-v", "2"])
    new = _parse(plan_args, "train", ["--virtual-stages", "2"])
    assert old["virtual_stages"] == new["virtual_stages"] == "2"
    ap = argparse.ArgumentParser()
    plan_args.add_plan_args(ap, flavor="train")
    cfg = plan_args.replan_config(
        ap.parse_args(["--replan", "every:3,hysteresis:0.05"]))
    assert (cfg.every, cfg.hysteresis) == (3, 0.05)
    assert plan_args.replan_config(ap.parse_args([])) is None
    with pytest.raises(SystemExit, match="--replan"):
        plan_args.replan_config(ap.parse_args(["--replan", "bogus:1"]))
    with pytest.raises(ValueError, match="lower"):
        plan_args.add_plan_args(argparse.ArgumentParser(), flavor="lower")


# ---------------------------------------------------------------------------
# resolve_pipeline_plan under the reference's constants (fault 15)
# ---------------------------------------------------------------------------


@pytest.fixture
def reference_constants(monkeypatch):
    """The reference's peak and link constants in the port's planner, as
    ``tests/test_torch_replan.py`` holds ``plan_inputs_from_cfg``."""
    import ml_dtypes  # noqa: F401  (registers bfloat16 with numpy)
    monkeypatch.setattr(at, "HW", dict(ref_at.HW))
    monkeypatch.setattr(at, "LINK_PRIOR_BPS", ref_at.HW["dcn_bw"])
    monkeypatch.setattr(at, "HOP_OVERHEAD_PRIOR_S",
                        ref_at.HW["dcn_latency_s"])


@pytest.mark.parametrize("size,batch,seq", [("smoke", 8, 16),
                                            ("full", 8, 512)])
@pytest.mark.parametrize("k,v,wire", [
    (None, None, "none"),                # fault 15: unset k is planned
    (None, None, "int8"),
    ("auto", "auto", "auto"),
    ("auto", 1, "int8+topk0.25"),
    (4, None, "int8"),
    (2, "auto", "fp8"),
    ("4", "2", "none")])
@pytest.mark.parametrize("hints", [None, {"planner_hints": {
    "link_bw_Bps": 5e8, "hop_overhead_s": 3e-3}}])
def test_resolve_pipeline_plan_matches_reference(reference_constants,
                                                 tmp_path, size, batch, seq,
                                                 k, v, wire, hints):
    from repro.configs import get_arch as ref_arch
    from repro.launch import train as ref_train
    path = None
    if hints is not None:
        path = str(tmp_path / "hints.json")
        with open(path, "w") as f:
            json.dump(hints, f)
    kw = dict(pipeline_stages=2, pipeline_k=k, virtual_stages=v,
              batch=batch, seq=seq, wire_dtype=wire, plan_hints=path)
    spec, info = train.resolve_pipeline_plan(
        cfg=getattr(get_arch(ARCH), size), **kw)
    ref_spec, ref_info = ref_train.resolve_pipeline_plan(
        cfg=getattr(ref_arch(ARCH), size), plan_roofline=None, **kw)
    assert (spec.num_stages, spec.microbatches, spec.virtual_stages,
            spec.wire_dtype) == (ref_spec.num_stages, ref_spec.microbatches,
                                 ref_spec.virtual_stages, ref_spec.wire_dtype)
    assert json.loads(json.dumps(info)) == json.loads(json.dumps(ref_info))
    if k is None:
        assert info["k_source"] == "auto:default" and info["plan"]
    assert spec.plan == Plan.from_json(info["plan_cell"])
    assert PipelineSpec.from_plan(Plan.from_json(info["plan_cell"])) == spec


@pytest.mark.parametrize("kw,match", [
    (dict(pipeline_stages=1, pipeline_k=4), "--pipeline-k"),
    (dict(pipeline_stages=0, virtual_stages="2"), "--virtual-stages"),
    (dict(pipeline_stages=1, wire_dtype="int8"), "--wire-dtype"),
    (dict(pipeline_stages=2, pipeline_k="four"), "--pipeline-k"),
    (dict(pipeline_stages=2, pipeline_k=0), "--pipeline-k"),
    (dict(pipeline_stages=2, wire_dtype="int4"), "--wire-dtype"),
    (dict(pipeline_stages=3, pipeline_k=2), "divisible|stages")])
def test_resolve_pipeline_plan_exits_like_the_reference(kw, match):
    from repro.configs import get_arch as ref_arch
    from repro.launch import train as ref_train
    kw = dict(dict(pipeline_k=None, virtual_stages=None, batch=4, seq=16,
                   wire_dtype="none"), **kw)
    if kw.get("pipeline_stages") == 3:   # S must divide the 2 layers
        kw["pipeline_k"] = "auto"
    for mod, arch in ((train, get_arch), (ref_train, ref_arch)):
        extra = {"plan_roofline": None} if mod is ref_train else {}
        with pytest.raises(SystemExit, match=match):
            mod.resolve_pipeline_plan(cfg=arch(ARCH).smoke, **kw, **extra)
    assert train.resolve_pipeline_plan(
        cfg=get_arch(ARCH).smoke, **dict(kw, pipeline_stages=1,
                                         pipeline_k=None, virtual_stages=1,
                                         wire_dtype="none")) \
        == (None, {"enabled": False})


def test_plan_hints_errors_exit(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    for path, match in ((str(bad), "planner_hints"),
                        (str(tmp_path / "absent.json"), "--plan-hints")):
        with pytest.raises(SystemExit, match=match):
            train.plan_inputs_for(cfg=get_arch(ARCH).smoke, batch=4, seq=16,
                                  pipeline_stages=2, plan_hints=path)


def test_pipeline_spec_plan_round_trip_and_auto_plan():
    p = Plan(stages=2, k=3, v=1, wire_dtype=" INT8+topk0.25 ")
    spec = PipelineSpec.from_plan(p)
    assert spec.plan == p
    assert PipelineSpec.from_plan(Plan.from_json(p.to_json())) == spec
    with pytest.raises(TypeError, match="Plan"):
        PipelineSpec.from_plan((2, 3))
    inp = at.plan_inputs_from_cfg(get_arch(ARCH).full, batch=8, seq=512,
                                  num_stages=2)
    spec, auto = PipelineSpec.auto_plan(inp, v_fixed=1, wire_dtype="auto")
    assert spec.plan == auto.plan
    assert auto.to_dict() == at.choose_plan(
        inp, v_fixed=1, wire_candidates=list(at.WIRE_AUTO)).to_dict()
    spec2, _ = PipelineSpec.auto_plan(inp, k_fixed=4, wire_dtype="fp8")
    assert (spec2.microbatches, spec2.wire_dtype) == (4, "fp8")


# ---------------------------------------------------------------------------
# PlanCellCache and carry_state (the reference's four EF transitions)
# ---------------------------------------------------------------------------


def test_plan_cell_cache_keys_on_the_cell():
    built = []
    cache = PlanCellCache(lambda p: built.append(p) or f"step:{p}")
    a = Plan(stages=2, k=4, v=2, wire_dtype="int8+topk0.25")
    alias = Plan(stages=2, k=4, v=2, wire_dtype="INT8+TOPK0.250")
    other = Plan(stages=2, k=4, v=1, wire_dtype="int8+topk0.25")
    assert cache.get(a) == cache.get(alias)          # one build
    cache.get(other)
    cache.get(a)
    assert (cache.misses, cache.hits) == (2, 2)
    assert len(cache) == 2 and a in cache and alias in cache
    assert built == [a, other]
    cfg = _carry_fixture()[0]
    calls = []

    def ef_of(plan):
        calls.append(plan)
        return wire_ef_zeros(cfg, PipelineSpec.from_plan(plan), 6, 16)
    t = cache.state_template(a, ef_of, a)
    assert t.device.type == "meta" and tuple(t.shape) == (2, 9, 2, 16, 64)
    assert cache.state_template(alias, ef_of, alias) is t
    assert calls == [a]


def _carry_fixture():
    from repro_torch.models.config import LMConfig
    cfg = LMConfig(name="t", num_layers=4, d_model=64, n_heads=4, n_kv=4,
                   d_ff=128, vocab=128)
    state = {"params": {"w": torch.ones((2, 2))},
             "opt_state": {"m": torch.zeros((2, 2))}, "step": 0}
    return cfg, state, 6, 16                     # batch 6 -> ragged at k=4


def _with_ef(state, cfg, plan, batch, seq, fill=0.0):
    ef = wire_ef_zeros(cfg, PipelineSpec.from_plan(plan), batch, seq)
    assert ef is not None
    return dict(state, wire_ef=ef + fill), tuple(ef.shape)


def test_carry_state_dense_to_topk_creates_fresh_ef():
    cfg, state, batch, seq = _carry_fixture()
    out = carry_state(state, Plan(stages=2, k=2, wire_dtype="int8+topk0.25"),
                      cfg=cfg, batch=batch, seq=seq)
    assert float(out["wire_ef"].abs().max()) == 0.0
    assert out["params"] is state["params"]      # everything else carried
    assert out["opt_state"] is state["opt_state"]


def test_carry_state_same_shape_carries_exactly():
    """A codec change at equal (k, v): the residual survives the switch."""
    cfg, state, batch, seq = _carry_fixture()
    old = Plan(stages=2, k=3, wire_dtype="int8+topk0.25")
    state, shape = _with_ef(state, cfg, old, batch, seq, fill=1.5)
    out = carry_state(state, Plan(stages=2, k=3, wire_dtype="fp8+topk0.5"),
                      cfg=cfg, batch=batch, seq=seq)
    assert out["wire_ef"] is state["wire_ef"]
    assert tuple(out["wire_ef"].shape) == shape
    assert float(out["wire_ef"].min()) == 1.5


def test_carry_state_shape_change_resets_to_zero():
    cfg, state, batch, seq = _carry_fixture()
    old = Plan(stages=2, k=3, wire_dtype="int8+topk0.25")
    state, old_shape = _with_ef(state, cfg, old, batch, seq, fill=1.5)
    out = carry_state(state, Plan(stages=2, k=4, wire_dtype="int8+topk0.25"),
                      cfg=cfg, batch=batch, seq=seq)
    assert tuple(out["wire_ef"].shape) != old_shape
    assert float(out["wire_ef"].abs().max()) == 0.0


def test_carry_state_topk_to_dense_drops_the_ef():
    cfg, state, batch, seq = _carry_fixture()
    old = Plan(stages=2, k=3, wire_dtype="int8+topk0.25")
    state, _ = _with_ef(state, cfg, old, batch, seq, fill=1.5)
    out = carry_state(state, Plan(stages=2, k=3, wire_dtype="int8"),
                      cfg=cfg, batch=batch, seq=seq)
    assert "wire_ef" not in out and "wire_ef" in state
    assert out["params"] is state["params"]


# ---------------------------------------------------------------------------
# Checkpoint and resume through the launcher
# ---------------------------------------------------------------------------


def _same_state(a, b):
    assert a.keys() == b.keys()
    for key in a:
        la, lb = tree_leaves(a[key]), tree_leaves(b[key])
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert torch.equal(x, y) if isinstance(x, torch.Tensor) \
                else x == y


@pytest.mark.parametrize("extra", [
    ["--pipeline-k", "2", "--wire-dtype", "int8"],
    ["--pipeline-k", "2", "--wire-dtype", "int8+topk0.25",
     "--compress-grads"]])
def test_resumed_run_equals_the_uninterrupted_run(tmp_path, extra):
    """Steps 1-2, a checkpoint at 2, then step 3 from it: the losses and
    every leaf of the final state (parameters, AdamW's m and v, the EF
    buffers) equal the 3-step run's bit for bit."""
    argv = SMOKE + ["--pipeline-stages", "2", "--steps", "3"] + extra
    whole = train.main(argv)
    ck = str(tmp_path / "ck")
    first = train.main(argv + ["--ckpt-dir", ck, "--ckpt-every", "2",
                               "--metrics-out", str(tmp_path / "m.json")])
    assert sorted(os.listdir(ck)) == ["step_2"]
    assert first["ckpt"]["resumed_from"] is None
    assert list(first["ckpt"]["save_s"]) == [2]
    with open(tmp_path / "m.json") as f:
        assert [r["step"] for r in json.load(f)] == [1, 2, 3]
    resumed = train.main(argv + ["--ckpt-dir", ck])
    assert resumed["ckpt"]["resumed_from"] == 2
    assert [r["step"] for r in resumed["rows"]] == [3]
    assert resumed["rows"][0]["loss"] == whole["rows"][2]["loss"]
    assert [r["loss"] for r in first["rows"]] \
        == [r["loss"] for r in whole["rows"]]
    _same_state(resumed["state"], whole["state"])
    assert set(whole["state"]) >= ({"error_fb", "wire_ef"}
                                   if "--compress-grads" in extra else set())


@pytest.mark.parametrize("later,key", [
    (["--compress-grads"], "error_fb"),
    (["--wire-dtype", "int8+topk0.25"], "wire_ef")])
def test_checkpoint_from_before_the_flag_resumes(tmp_path, capsys, later,
                                                 key):
    """A checkpoint taken before --compress-grads / a top-k codec carries
    no error feedback: the rest restores and the residual restarts at
    zero (the reference's ``test_integration.py`` case)."""
    ck = str(tmp_path / "ck")
    argv = SMOKE + ["--pipeline-stages", "2", "--pipeline-k", "2",
                    "--ckpt-dir", ck, "--ckpt-every", "1"]
    train.main(argv + ["--steps", "1"])
    res = train.main(argv + ["--steps", "2"] + later)
    out = capsys.readouterr().out
    assert f"checkpoint predates {key} — error feedback restarts at zero" \
        in out and "resumed from step 1" in out
    assert [r["step"] for r in res["rows"]] == [2]
    assert np.isfinite(res["rows"][0]["loss"]) and key in res["state"]
    assert sorted(os.listdir(ck)) == ["step_1", "step_2"]


def test_checkpoint_of_another_cell_moves_onto_the_flags_cell(tmp_path,
                                                              capsys):
    """Without --replan the flags give the cell: a top-k checkpoint
    resumed under the raw int8 hop is read in its own layout (its EF
    buffer included) and moved over by ``carry_state``, which drops the
    buffer, and both moves are printed."""
    ck = str(tmp_path / "ck")
    argv = SMOKE + ["--pipeline-stages", "2", "--pipeline-k", "2",
                    "--ckpt-dir", ck, "--ckpt-every", "1"]
    train.main(argv + ["--steps", "1", "--wire-dtype", "int8+topk0.25"])
    res = train.main(argv + ["--steps", "2", "--wire-dtype", "int8"])
    out = capsys.readouterr().out
    assert "state carried over (carry_state)" in out
    assert "checkpoint's wire_ef has no place in this run's state — " \
        "dropped" in out
    assert "wire_ef" not in res["state"]
    assert np.isfinite(res["rows"][0]["loss"])
    assert res["rows"][0]["cell"] == [2, 2, 1, "int8"]
    assert train.ckpt_lib.manifest(ck, 2)["plan_cell"] == Plan(
        stages=2, k=2, v=1, wire_dtype="int8").to_json()


def test_replan_run_resumed_after_its_switch_equals_the_whole_run(
        tmp_path, capsys):
    """A --replan run whose link drops at step 3 switches to the top-k
    hop at step 4 (a short link average, so the switch comes at the first
    evaluation after the drop) and checkpoints at step 6, after it; it runs on to step 8
    as the uninterrupted run.  Resumed from step 6 on the same flags, the
    run continues on the checkpoint's top-k cell (not the flags' planned
    one) with its EF buffer, makes no switch, and its steps 7-8 and final
    state equal the uninterrupted run's bit for bit."""
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"steps": [0, 3], "bw_Bps": [1e8, 1e4]}))
    ck = str(tmp_path / "ck")
    argv = SMOKE + ["--steps", "8", "--pipeline-stages", "2", "--replan",
                    "every:3,hysteresis:0.05,ewma:0.3", "--replan-trace",
                    str(trace), "--ckpt-dir", ck, "--ckpt-every", "6"]
    whole = train.main(argv)
    switches = whole["plan_info"]["replan"]["switches"]
    new = Plan(stages=2, k=1, wire_dtype="int8+topk0.25")
    assert [(s["step"], Plan.from_json(s["new"])) for s in switches] \
        == [(4, new)]
    assert sorted(os.listdir(ck)) == ["step_6"]
    assert train.ckpt_lib.manifest(ck, 6)["plan_cell"] == new.to_json()
    capsys.readouterr()
    resumed = train.main(argv)
    out = capsys.readouterr().out
    assert f"resuming on the checkpoint's cell {new}" in out
    assert "carry_state" not in out and "predates" not in out
    assert resumed["ckpt"]["resumed_from"] == 6
    assert resumed["plan_info"]["replan"]["switches"] == []
    assert [r["step"] for r in resumed["rows"]] == [7, 8]
    assert [(r["loss"], r["cell"]) for r in resumed["rows"]] \
        == [(r["loss"], r["cell"]) for r in whole["rows"][6:]]
    assert resumed["pipeline"].plan == new
    _same_state(resumed["state"], whole["state"])
    assert bool(resumed["state"]["wire_ef"].any())


def test_fault_16_reference_resume_restarts_the_batch_stream(tmp_path):
    """ROADMAP Queue 3 fault 16, standing record.  The reference's
    launcher restores ``step`` and rebuilds its batch stream from batch 0
    (``src/repro/launch/train.py:351`` and ``:357``), so its step 2
    resumed from a step-1 checkpoint trains on batch 0, and its loss is
    not the uninterrupted run's.  Skipping the consumed batch (what the
    port's launcher does) makes the two equal."""
    from repro.launch import train as ref_train
    argv = ["--arch", ARCH, "--size", "smoke", "--batch", "2", "--seq",
            "8", "--log-every", "1"]
    ck = str(tmp_path / "ck")
    whole = ref_train.main(argv + ["--steps", "2"])
    ref_train.main(argv + ["--steps", "1", "--ckpt-dir", ck,
                           "--ckpt-every", "1"])
    resumed = ref_train.main(argv + ["--steps", "2", "--ckpt-dir", ck])
    assert [r["step"] for r in resumed] == [2]
    gap = abs(resumed[0]["loss"] - whole[1]["loss"])
    assert gap > 1e-3, gap
    build = ref_train.build_batch_iter

    def skipping(*a, **kw):
        it = build(*a, **kw)
        next(it)                       # the batch step 1 trained on
        return it
    ref_train.build_batch_iter = skipping
    try:
        fixed = ref_train.main(argv + ["--steps", "2", "--ckpt-dir", ck])
    finally:
        ref_train.build_batch_iter = build
    assert fixed[0]["loss"] == whole[1]["loss"]


# ---------------------------------------------------------------------------
# The online switch: SMOKE on the CPU, and the chip phase's FULL plan
# ---------------------------------------------------------------------------


def _bill(row, d):
    """The hop bytes a step of the row's cell is billed, up and down."""
    s, k, v, wire = row["cell"]
    hops, n = s * v - 1, 4 * 16 * d
    return tuple(hops * protocol.billed_hop_bytes(n, d, wire, 4,
                                                  backward=bwd)
                 for bwd in (False, True))


def test_bandwidth_drop_replans_once_on_the_cpu(tmp_path, capsys):
    """The counterpart of the reference's
    ``test_e2e_bandwidth_drop_replans_once`` at the port's constants (an
    H100 stage, the Table I link prior): a scripted drop at step 6 from
    1e8 to 1e4 B/s makes the re-planner switch the live pipeline exactly
    once, from the raw hop to the top-k hop, after the drop; the EF
    buffer is created, every loss is finite and every step's hop bytes
    are its own cell's bill."""
    trace, plan_out = tmp_path / "trace.json", tmp_path / "plan.json"
    trace.write_text(json.dumps({"steps": [0, 6], "bw_Bps": [1e8, 1e4]}))
    res = train.main(SMOKE + [
        "--steps", "12", "--pipeline-stages", "2",
        "--replan", "every:3,hysteresis:0.05", "--replan-trace", str(trace),
        "--plan-out", str(plan_out),
        "--metrics-out", str(tmp_path / "metrics.json")])
    out = capsys.readouterr().out
    doc = json.loads(plan_out.read_text())
    assert doc["k_source"] == "auto:default"
    replan = doc["replan"]
    assert len(replan["switches"]) == 1 and replan["evals"] == 4
    sw = replan["switches"][0]
    assert sw["step"] > 6 and sw["gain"] > 0.05
    old, new = Plan.from_json(sw["old"]), Plan.from_json(sw["new"])
    assert old == Plan(stages=2, k=1, wire_dtype="none")
    assert new == Plan(stages=2, k=1, wire_dtype="int8+topk0.25")
    assert Plan.from_json(replan["current"]) == new
    assert "2 cell compile(s)" in out and "1 switch(es)" in out
    rows = json.loads((tmp_path / "metrics.json").read_text())
    assert rows == json.loads(json.dumps(res["rows"])) and len(rows) == 12
    assert all(np.isfinite(r["loss"]) for r in rows)
    d = get_arch(ARCH).smoke.d_model
    for r in rows:
        assert tuple(r["cell"]) == (old if r["step"] <= sw["step"]
                                    else new).cell()
        assert (r["hop_bytes_up"], r["hop_bytes_down"]) == _bill(r, d)
    ef = res["state"]["wire_ef"]
    assert tuple(ef.shape) == (2, 2, 4, 16, d) and bool(ef.any())
    assert res["pipeline"].plan == new


def _full_run(hints, trace, spec, steps, step_times):
    """``launch/train.py``'s plan and re-planner at qwen1.5-4b FULL, batch
    8 x 512, fed ``step_times`` as the launcher feeds measured ones."""
    cfg = get_arch(ARCH).full
    pipeline, info = train.resolve_pipeline_plan(
        pipeline_stages=2, pipeline_k="auto", virtual_stages=1, cfg=cfg,
        batch=8, seq=512, wire_dtype="int8", plan_hints=hints)
    inp, _ = train.plan_inputs_for(cfg=cfg, batch=8, seq=512,
                                   pipeline_stages=2, plan_hints=hints)
    rp = Replanner(inp, pipeline.plan, ReplanConfig.parse(spec))
    warm = False
    for i in range(steps):
        sw = train.observe_and_replan(rp, trace, i + 1,
                                      step_times[i] if warm else None)
        warm = sw is None
    return pipeline.plan, info, rp


@pytest.mark.parametrize("drift", [1.0, 0.8, 1.25, "noisy"])
def test_full_width_plan_and_switch_of_the_chip_phase(tmp_path, drift):
    """The plan and the switch ``chip_smoke.py``'s phase "qwen1.5-4b
    checkpoint, resume and replan" asserts on the card: with the hints
    (a 5e8 B/s link, 3 ms a message) the planner picks k 4 for int8; the
    trace's drop to 1e7 B/s at step 3 switches the codec to the top-k hop
    at step 3, once.  Both decisions precede any step-time drift (the
    Watchdog's anchor is taken at step 3); after the switch, step times
    that drift by 0.8x, 1.25x or noisily make no second switch."""
    chip = _chip_smoke()
    hints = tmp_path / "hints.json"
    hints.write_text(json.dumps({"planner_hints": chip.RP_HINTS}))
    trace = BandwidthTrace(steps=tuple(chip.RP_TRACE["steps"]),
                           bw_Bps=tuple(chip.RP_TRACE["bw_Bps"]))
    assert chip.RP_HINTS == {"link_bw_Bps": 5e8, "hop_overhead_s": 3e-3}
    assert chip.RP_TRACE == {"steps": [0, 3], "bw_Bps": [5e8, 1e7]}
    rng = np.random.default_rng(0)
    times = 1.5 * np.ones(chip.RP_STEPS)
    if drift == "noisy":
        times *= rng.uniform(0.85, 1.2, chip.RP_STEPS)
    else:
        times[3:] *= drift
    plan, info, rp = _full_run(str(hints), trace, chip.RP_SPEC,
                               chip.RP_STEPS, times)
    assert plan == Plan(*chip.RP_PLAN) == Plan(stages=2, k=4, v=1,
                                               wire_dtype="int8")
    assert (info["k_source"], info["v_source"], info["wire_source"]) \
        == ("auto", "flag", "flag")
    assert [(s.step, s.old, s.new) for s in rp.switches] == [
        (chip.RP_SWITCH[0], Plan(*chip.RP_SWITCH[1]),
         Plan(*chip.RP_SWITCH[2]))] == [
        (3, plan, Plan(stages=2, k=4, v=1, wire_dtype="int8+topk0.25"))]
    assert rp.evals == 4
    assert rp.switches[0].gain > 0.05
    assert dataclasses.asdict(rp.config)["every"] == 2
