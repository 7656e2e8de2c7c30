"""The planners of the JAX package's ``analysis/autotune.py``: the wire
byte model of the hop, the training planner and the serving planner.

* The wire byte model the hop audits bill with (``wire_block_for``,
  ``wire_bytes_per_element`` and ``wire_link_scale`` forward,
  ``wire_bytes_per_element_bwd`` and ``wire_link_scale_bwd`` backward).
  The codec grammar and block rule are the port's own
  (``parallel/wire.py``), so the billing cannot drift from the codec.
* The training planner: ``Plan`` (the pipeline cell ``(stages, k, v,
  wire_dtype)`` and its versioned JSON), ``PlanInputs`` (one cell's
  measured or estimated costs), ``plan_wall_time`` / ``plan_bubble``
  (the 2-stage event simulator of ``core/schedule.py`` on hop-billed
  task times, a tick model for other stage counts), ``choose_plan`` (the
  exhaustive argmin over (S, wire, v, k)), ``neighbor_plans``,
  ``wire_plan_sweep``, ``as_wireless`` (the same candidate as the
  wireless model's (profile, fleet, plan)) and ``plan_inputs_from_cfg``
  (a compile-free estimate from a model config at the card's peaks,
  ``analysis/roofline.py::HW``).  The reference's extraction from XLA
  dry-run records and its CLI are not ported.
* The continuous-batching engine's slot planner (``ServingInputs``,
  ``serving_wall``, ``ServingPlan``, ``choose_serving_plan``).

numpy only.  The interleaved (v > 1) trade is modeled explicitly:
interleaving shrinks the warm-up/drain bubble from ``(S-1)`` to
``(S-1)/v`` stage-passes a direction, but a micro-batch then pays
``S*v - 1`` cut-activation hops instead of ``S - 1``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.analysis.roofline import HW
from repro_torch.core import schedule as _sched
from repro_torch.core.costs import LayerProfile
from repro_torch.core.schedule import TaskTimes, bubble_rate, simulate_c2p2sl
from repro_torch.parallel.wire import (parse_wire_dtype, validate_wire_dtype,
                                       wire_block)
from repro_torch.wireless.channel import ChannelParams, shannon_rate

# The link the planner assumes until one is measured: the paper's Table I
# uplink (wireless/channel.py defaults, the full 100 MHz band) of a UE at
# the middle of the fleet's transmit-power and distance ranges
# (wireless/fleet.py::sample_fleet: 18 dBm, 300 m), in bytes/s; and one
# TDMA frame (10 ms) as the fixed cost of a hop's message.  The streaming
# runtime's LinkEstimator replaces both with measured hops
# (training/replan.py::apply_hints).
LINK_PRIOR_BPS = float(shannon_rate(18.0, 300.0, ChannelParams())) / 8.0
HOP_OVERHEAD_PRIOR_S = ChannelParams().frame_s

# Codec enumeration order for ``wire_dtype='auto'``: ties keep the first
# entry, so an uncoded hop wins unless quantizing strictly pays, int8 wins
# a tie against fp8, and the sparsified gradient hop must STRICTLY beat
# every dense codec to be chosen (it is lossier and carries EF state).
WIRE_AUTO = ("none", "int8", "fp8", "int8+topk0.25")

# relative tie tolerance of both argmins: a later candidate must beat the
# best by more than this to replace it
_TIE_RTOL = 1e-9

WIRE_BLOCK = 256


def wire_block_for(d_model, block: int = WIRE_BLOCK) -> int:
    """Effective codec block for a model width: the largest divisor of
    ``d_model`` that is <= ``block``.  Unknown ``d_model`` assumes the
    nominal block."""
    if d_model is None or int(d_model) <= 0:
        return block
    return wire_block(int(d_model), block)


def wire_bytes_per_element(wire_dtype: str, act_bytes: float,
                           block: int = WIRE_BLOCK) -> float:
    """Wire bytes one activation element costs on the FORWARD hop:
    ``act_bytes`` raw for 'none', else one payload byte plus the
    per-block fp32 scale at the EFFECTIVE block."""
    base, _frac = parse_wire_dtype(wire_dtype)
    if base == "none":
        return float(act_bytes)
    return 1.0 + 4.0 / max(1, int(block))


def wire_link_scale(wire_dtype: str, act_bytes: float,
                    block: int = WIRE_BLOCK) -> float:
    """Multiplier on the uncompressed FORWARD link time under a codec (< 1
    for int8/fp8 at healthy blocks, 1 for 'none', above 1 at a degenerate
    block, where the planner should keep 'none')."""
    return wire_bytes_per_element(wire_dtype, act_bytes, block) \
        / float(act_bytes)


def wire_bytes_per_element_bwd(wire_dtype: str, act_bytes: float,
                               block: int = WIRE_BLOCK,
                               d_model=None) -> float:
    """Wire bytes one activation-GRADIENT element costs on the backward
    hop.  Dense codecs are direction-symmetric; a ``+topk<frac>`` codec
    ships ``frac*d`` base-quantized values, their int16 indices (int32
    above 32767 columns) and one fp32 per-row scale:
    ``frac*(1 + idx_bytes) + 4/d`` bytes/element.  Unknown ``d_model``
    assumes int16 indices and drops the amortized-scale term.  At a
    degenerate block (dense codec >= raw, ``wire.codec_net_loss``) the
    hop goes raw both ways, so the dense bytes are billed."""
    _base, frac = parse_wire_dtype(wire_dtype)
    dense = wire_bytes_per_element(wire_dtype, act_bytes, block)
    if frac is None or dense >= float(act_bytes):
        return dense
    d = None if d_model is None or int(d_model) <= 0 else int(d_model)
    idx_bytes = 2.0 if d is None or d <= 32767 else 4.0
    scale_amort = 4.0 / d if d else 0.0
    return frac * (1.0 + idx_bytes) + scale_amort


def wire_link_scale_bwd(wire_dtype: str, act_bytes: float,
                        block: int = WIRE_BLOCK, d_model=None) -> float:
    """Multiplier on the uncompressed BACKWARD link time under a codec
    (smaller than the forward's under a ``+topk`` codec)."""
    return wire_bytes_per_element_bwd(wire_dtype, act_bytes, block,
                                      d_model) / float(act_bytes)


# ---------------------------------------------------------------------------
# The training planner: (stages, k, v, wire) of the C2P2SL pipeline.
# ---------------------------------------------------------------------------


def _sigma(m: int, num_stages: int, virtual_stages: int) -> int:
    """Pipeline-entry tick of micro-batch m (``parallel.pipeline._sigma``)."""
    return (m // num_stages) * num_stages * virtual_stages + (m % num_stages)


def schedule_ticks(k: int, num_stages: int, virtual_stages: int) -> int:
    """Total tick count of the interleaved 1F1B schedule (one direction)."""
    return _sigma(k - 1, num_stages, virtual_stages) \
        + num_stages * virtual_stages


def hop_ratio(num_stages: int, virtual_stages: int) -> float:
    """Cut-activation volume of a ``v``-interleaved micro-batch relative to
    plain 1F1B: ``(S*v - 1) / (S - 1)`` boundary hops (the chunk chain
    wraps from stage S-1 back to stage 0).  0 for S=1 (no hop)."""
    if num_stages <= 1:
        return 0.0
    return (num_stages * virtual_stages - 1.0) / (num_stages - 1.0)


#: Version of the ``Plan.to_json`` schema; ``Plan.from_json`` refuses
#: any other.
PLAN_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """One pipeline execution cell: ``stages`` (S), ``k`` (micro-batches
    per batch), ``v`` (interleaved virtual stages) and ``wire_dtype`` (the
    hop codec, ``parallel/wire.py`` grammar).

    Frozen and normalized at construction: the codec name canonicalizes
    through the wire grammar, so ``" INT8+topk0.50 "`` and
    ``"int8+topk0.5"`` are one plan and hash alike.  Not the wireless
    side's ``core.schedule.Plan`` (the paper's (l, k, b, tau)).
    """

    stages: int
    k: int
    v: int = 1
    wire_dtype: str = "none"

    def __post_init__(self):
        for name in ("stages", "k", "v"):
            val = getattr(self, name)
            if not isinstance(val, (int, np.integer)) or isinstance(val, bool):
                raise ValueError(f"Plan.{name} must be an int, got {val!r}")
            if val < 1:
                raise ValueError(f"Plan.{name}={val} must be >= 1")
            object.__setattr__(self, name, int(val))
        object.__setattr__(self, "wire_dtype",
                           validate_wire_dtype(self.wire_dtype))

    def cell(self) -> tuple:
        """Hashable key of the cell."""
        return (self.stages, self.k, self.v, self.wire_dtype)

    def to_json(self) -> dict:
        return {"schema": PLAN_SCHEMA, "stages": self.stages, "k": self.k,
                "v": self.v, "wire_dtype": self.wire_dtype}

    @classmethod
    def from_json(cls, doc: dict) -> "Plan":
        """Inverse of ``to_json``.  Unknown schema versions fail; a missing
        ``schema`` reads as version 1."""
        if not isinstance(doc, dict):
            raise ValueError(f"Plan.from_json expects a dict, got {doc!r}")
        schema = doc.get("schema", 1)
        if schema != PLAN_SCHEMA:
            raise ValueError(
                f"Plan schema {schema!r} not supported (this build reads "
                f"schema {PLAN_SCHEMA}) — regenerate the plan JSON")
        missing = [key for key in ("stages", "k") if key not in doc]
        if missing:
            raise ValueError(f"Plan JSON missing {missing}: {doc!r}")
        return cls(stages=doc["stages"], k=doc["k"], v=doc.get("v", 1),
                   wire_dtype=doc.get("wire_dtype", "none"))

    def __str__(self):
        return (f"Plan(S={self.stages}, k={self.k}, v={self.v}, "
                f"wire={self.wire_dtype})")


@dataclasses.dataclass(frozen=True)
class PlanInputs:
    """Measured (or estimated) costs of one pipeline cell, per batch.

    ``stage_fwd_s`` / ``stage_bwd_s``: seconds for ONE stage to push the
    whole batch through its layers (the paper's t_b^F / t_b^B).
    ``link_s``: seconds of one UNCOMPRESSED full-batch cut-activation hop
    at v=1, per direction.  ``hop_overhead_s``: the fixed cost of one
    micro-batch message.  ``wire_dtype`` / ``act_bytes`` bill the codec:
    ``wire_link_s`` forward, ``wire_link_bwd_s`` backward (smaller under a
    ``+topk`` codec).  ``codec_s_per_byte`` bills the codec's compute:
    ``codec_s = act_hop_bytes * codec_s_per_byte`` a full-batch coded hop.
    ``fixed_chip_budget`` keeps the per-stage time S-independent; False
    divides the total by S.
    """

    num_stages: int
    stage_fwd_s: float
    stage_bwd_s: float
    link_s: float
    hop_overhead_s: float = 0.0
    k_cap: int = 32
    v_cap: int = 4
    num_layers: int | None = None
    fixed_chip_budget: bool = True
    wire_dtype: str = "none"
    act_bytes: float = 2.0
    wire_block: int = WIRE_BLOCK
    codec_s_per_byte: float = 0.0
    act_hop_bytes: float = 0.0
    d_model: int | None = None

    @property
    def wire_link_s(self) -> float:
        """Link seconds of one full-batch FORWARD hop as billed (a
        ``+topk`` codec's forward hop is its dense base)."""
        return self.link_s * wire_link_scale(self.wire_dtype,
                                             self.act_bytes, self.wire_block)

    @property
    def wire_link_bwd_s(self) -> float:
        """Link seconds of one full-batch BACKWARD (gradient) hop."""
        return self.link_s * wire_link_scale_bwd(
            self.wire_dtype, self.act_bytes, self.wire_block, self.d_model)

    @property
    def codec_s(self) -> float:
        """Encode + decode seconds of one full-batch coded hop (0 for
        'none' and when no throughput was measured)."""
        if parse_wire_dtype(self.wire_dtype)[0] == "none":
            return 0.0
        return float(self.act_hop_bytes) * float(self.codec_s_per_byte)

    def with_stages(self, num_stages: int) -> "PlanInputs":
        if num_stages == self.num_stages:
            return self
        scale = 1.0 if self.fixed_chip_budget \
            else self.num_stages / num_stages
        return dataclasses.replace(
            self, num_stages=num_stages,
            stage_fwd_s=self.stage_fwd_s * scale,
            stage_bwd_s=self.stage_bwd_s * scale)

    def with_wire(self, wire_dtype: str) -> "PlanInputs":
        w = validate_wire_dtype(wire_dtype)
        if w == self.wire_dtype:
            return self
        return dataclasses.replace(self, wire_dtype=w)

    def feasible_v(self) -> list:
        """Interleave counts with ``S*v`` dividing the layer count."""
        out = []
        for v in range(1, max(1, self.v_cap) + 1):
            if self.num_layers is not None \
                    and self.num_layers % (self.num_stages * v) != 0:
                continue
            out.append(v)
        return out or [1]

    def to_dict(self) -> dict:
        return {
            "num_stages": self.num_stages,
            "stage_fwd_s": self.stage_fwd_s,
            "stage_bwd_s": self.stage_bwd_s,
            "link_s": self.link_s,
            "wire_dtype": self.wire_dtype,
            "act_bytes": self.act_bytes,
            "wire_block": self.wire_block,
            "wire_link_s": self.wire_link_s,
            "wire_link_bwd_s": self.wire_link_bwd_s,
            "codec_s_per_byte": self.codec_s_per_byte,
            "codec_s": self.codec_s,
            "act_hop_bytes": self.act_hop_bytes,
            "d_model": self.d_model,
            "hop_overhead_s": self.hop_overhead_s,
            "k_cap": self.k_cap,
            "v_cap": self.v_cap,
            "num_layers": self.num_layers,
        }


def plan_task_times(inp: PlanInputs, k: int, v: int) -> TaskTimes:
    """The candidate plan as per-micro-batch ``TaskTimes`` (stage 0 the
    "UE", stage 1 the "BS": exact for S=2).  Each of the ``hop_ratio``
    crossings of a leg pays the codec-billed volume / k, the per-message
    overhead and the codec's compute share ``codec_s / k``."""
    h = hop_ratio(inp.num_stages, v)
    codec = inp.codec_s / k
    up = h * (inp.wire_link_s / k + inp.hop_overhead_s + codec)
    down = h * (inp.wire_link_bwd_s / k + inp.hop_overhead_s + codec)
    return TaskTimes(
        ue_fwd=np.array([inp.stage_fwd_s / k]),
        uplink=np.array([up]),
        bs_fwd=inp.stage_fwd_s / k,
        bs_bwd=inp.stage_bwd_s / k,
        downlink=np.array([down]),
        ue_bwd=np.array([inp.stage_bwd_s / k]),
    )


@dataclasses.dataclass(frozen=True)
class _UnitChannel:
    frame_s: float = 1.0


@dataclasses.dataclass(frozen=True)
class _PodFleet:
    """Duck-typed ``wireless.Fleet`` stand-in: one unit-rate UE."""

    channel: _UnitChannel = _UnitChannel()
    n: int = 1
    bs_flops: float = 1.0

    def rates(self):
        return np.ones(1), np.ones(1)

    @property
    def ue_flops(self) -> np.ndarray:
        return np.ones(1)

    @property
    def storage(self) -> np.ndarray:
        return np.full(1, 1e30)


_POD_FLEET = _PodFleet()


def as_wireless(inp: PlanInputs, k: int, v: int):
    """The candidate as ``(profile, fleet, plan)`` such that
    ``sl.c2p2sl.batch_wall_time(profile, fleet, plan)`` reproduces
    ``plan_wall_time(inp, k, v)`` (S=2 only): one UE at 1 FLOP/s, unit
    frame, slot and rates, batch ``B = k``, the cut bytes folding in the
    hop inflation.  The wireless model ships the same cut bytes both
    ways, so a ``+topk`` codec raises."""
    if inp.num_stages != 2:
        raise ValueError(
            f"as_wireless maps the 2-stage (UE/BS) pipeline; got "
            f"num_stages={inp.num_stages}")
    if parse_wire_dtype(inp.wire_dtype)[1] is not None:
        raise ValueError(
            f"as_wireless cannot express wire_dtype {inp.wire_dtype!r}: "
            "the wireless eq-(8) model ships the same cut bytes up and "
            "down, but a '+topk' codec sparsifies only the downlink — "
            "evaluate with plan_wall_time instead")
    B = float(max(k, 1))
    h = hop_ratio(2, v)
    cut_bytes = h * (inp.wire_link_s + k * inp.hop_overhead_s
                     + inp.codec_s) / (8.0 * B)
    profile = LayerProfile(
        name="pod-roofline",
        layer_names=("ue_stage", "bs_stage"),
        fwd_flops=np.array([inp.stage_fwd_s / B, inp.stage_fwd_s / B]),
        bwd_flops=np.array([inp.stage_bwd_s / B, inp.stage_bwd_s / B]),
        act_bytes=np.array([cut_bytes, 4.0]),
        label_bytes=0.0,
    )
    plan = _sched.Plan(l=1, k=k, b=np.array([B]), tau=np.array([1.0]), v=v)
    return profile, _POD_FLEET, plan


def tick_wall_time(inp: PlanInputs, k: int, v: int) -> float:
    """Tick model for any S: ``ticks x per-tick cost``, each direction's
    hop overlapped with the next tick's chunk compute."""
    ticks = schedule_ticks(k, inp.num_stages, v)
    comm_f = comm_b = 0.0
    if inp.num_stages > 1:
        codec = inp.codec_s / k
        comm_f = inp.wire_link_s / k + inp.hop_overhead_s + codec
        comm_b = inp.wire_link_bwd_s / k + inp.hop_overhead_s + codec
    comp_f = inp.stage_fwd_s / (k * v)
    comp_b = inp.stage_bwd_s / (k * v)
    return ticks * (max(comp_f, comm_f) + max(comp_b, comm_b))


def plan_wall_time(inp: PlanInputs, k: int, v: int) -> float:
    """Modeled wall seconds of one batch under ``(k, v)``: the event
    simulator on the hop-billed task times for S=2, the tick model
    otherwise."""
    if inp.num_stages == 2:
        ms, _ = simulate_c2p2sl(plan_task_times(inp, k, v), k,
                                virtual_stages=v)
        return float(ms)
    return tick_wall_time(inp, k, v)


def plan_bubble(inp: PlanInputs, k: int, v: int) -> float:
    """Bubble rate of whichever model scores the plan: eq (16) on the
    2-actor task times for S=2, the idle-tick share otherwise."""
    if inp.num_stages == 2:
        return bubble_rate(plan_task_times(inp, k, v), k, v)
    ticks = schedule_ticks(k, inp.num_stages, v)
    return (ticks - k * v) / ticks


@dataclasses.dataclass(frozen=True)
class AutoPlan:
    """A planner decision plus the evidence it was made on."""

    num_stages: int
    k: int
    v: int
    wall_s: float          # modeled batch time at (S, k, v)
    baseline_s: float      # modeled batch time at (S, 1, 1)
    bubble: float
    inputs: PlanInputs
    wire_dtype: str = "none"

    @property
    def speedup(self) -> float:
        return self.baseline_s / self.wall_s if self.wall_s > 0 else 1.0

    @property
    def plan(self) -> Plan:
        return Plan(stages=self.num_stages, k=self.k, v=self.v,
                    wire_dtype=self.wire_dtype)

    def to_dict(self) -> dict:
        return {
            "num_stages": self.num_stages,
            "k": self.k,
            "v": self.v,
            "plan": self.plan.to_json(),
            "wire_dtype": self.wire_dtype,
            "wall_s": self.wall_s,
            "baseline_s": self.baseline_s,
            "speedup": self.speedup,
            "bubble": self.bubble,
            "inputs": self.inputs.to_dict(),
        }


def neighbor_plans(inp: PlanInputs, k: int, v: int) -> list:
    """Feasible ``(k', v')`` neighbors: k±1 within [1, k_cap], v/2 and 2v
    within the layer-divisible interleave set."""
    vs = set(inp.feasible_v())
    out = []
    for kk in (k - 1, k + 1):
        if 1 <= kk <= max(1, inp.k_cap):
            out.append((kk, v))
    for vv in (v // 2, v * 2):
        if vv >= 1 and vv != v and vv in vs:
            out.append((k, vv))
    return out


def choose_plan(inp: PlanInputs, *, stage_candidates=None,
                k_fixed: int | None = None, v_fixed: int | None = None,
                wire_candidates=None) -> AutoPlan:
    """Exhaustive argmin of ``plan_wall_time`` over the feasible grid.

    ``stage_candidates`` adds S to the search (default: pinned);
    ``wire_candidates`` the hop codec (e.g. ``WIRE_AUTO``; default:
    ``inp.wire_dtype``).  ``k_fixed`` / ``v_fixed`` pin one coordinate;
    pins are checked for positivity and layer divisibility, not clamped
    to ``k_cap``.  Ties (within ``_TIE_RTOL``) keep the first candidate
    enumerated: smallest S, earlier codec, smallest v, smallest k.
    """
    if k_fixed is not None and k_fixed < 1:
        raise ValueError(f"k={k_fixed} must be >= 1")
    if v_fixed is not None and v_fixed < 1:
        raise ValueError(f"virtual_stages={v_fixed} must be >= 1")
    stages = list(stage_candidates) if stage_candidates \
        else [inp.num_stages]
    wires = list(wire_candidates) if wire_candidates \
        else [inp.wire_dtype]
    for w_cand in wires:
        wire_bytes_per_element(w_cand, inp.act_bytes)   # validate early
    best = None
    for S in sorted(stages):
        if S < 1:
            raise ValueError(f"stage candidate {S} must be >= 1")
        inp_s = inp.with_stages(S)
        if inp_s.num_layers is not None and inp_s.num_layers % S != 0:
            continue
        if v_fixed is not None:
            if inp_s.num_layers is not None \
                    and inp_s.num_layers % (S * v_fixed) != 0:
                continue
            vs = [v_fixed]
        else:
            vs = inp_s.feasible_v()
        ks = [k_fixed] if k_fixed is not None \
            else range(1, max(1, inp_s.k_cap) + 1)
        for wd in wires:
            inp_sw = inp_s.with_wire(wd)
            for v in vs:
                for k in ks:
                    w = plan_wall_time(inp_sw, k, v)
                    if best is None or w < best[0] * (1.0 - _TIE_RTOL):
                        best = (w, k, v, S, inp_sw)
    if best is None:
        raise ValueError(
            f"no feasible (S, k, v): stages {stages}"
            + (f" x v={v_fixed}" if v_fixed is not None else "")
            + f" incompatible with num_layers={inp.num_layers} "
            "(the pipeline needs S*v dividing the layer count)")
    w, k, v, S, inp_sw = best
    return AutoPlan(num_stages=S, k=k, v=v, wall_s=w,
                    baseline_s=plan_wall_time(inp_sw, 1, 1),
                    bubble=plan_bubble(inp_sw, k, v), inputs=inp_sw,
                    wire_dtype=inp_sw.wire_dtype)


def wire_plan_sweep(inp: PlanInputs, wire_candidates=WIRE_AUTO,
                    **choose_kwargs) -> dict:
    """Each codec's best plan and the joint winner: ``{"chosen": AutoPlan
    dict, "sweep": {codec: {k, v, wall_s, wire_link_s, wire_link_bwd_s,
    codec_s, speedup_vs_none}}}``."""
    sweep = {}
    for wd in wire_candidates:
        p = choose_plan(inp.with_wire(wd), **choose_kwargs)
        sweep[wd] = {"k": p.k, "v": p.v, "wall_s": p.wall_s,
                     "wire_link_s": p.inputs.wire_link_s,
                     "wire_link_bwd_s": p.inputs.wire_link_bwd_s,
                     "codec_s": p.inputs.codec_s}
    none_wall = sweep.get("none", {}).get("wall_s")
    for row in sweep.values():
        row["speedup_vs_none"] = (none_wall / row["wall_s"]
                                  if none_wall and row["wall_s"] > 0
                                  else 1.0)
    chosen = choose_plan(inp, wire_candidates=list(wire_candidates),
                         **choose_kwargs)
    return {"chosen": chosen.to_dict(), "sweep": sweep}


# element widths of config dtype names (numpy has no bfloat16 or float8)
_DTYPE_BYTES = {
    "float64": 8.0, "float32": 4.0, "float16": 2.0, "bfloat16": 2.0,
    "float8_e4m3fn": 1.0, "float8_e5m2": 1.0,
}


def plan_inputs_from_cfg(cfg, *, batch: int, seq: int, num_stages: int,
                         k_cap: int | None = None, v_cap: int = 4,
                         hop_overhead_s: float | None = None,
                         bwd_fwd_ratio: float = 2.0,
                         link_bw_Bps: float | None = None,
                         codec_s_per_byte: float = 0.0) -> PlanInputs:
    """Planner inputs estimated from a model config, with nothing
    compiled or measured: 2N FLOPs a token forward at the card's bf16
    peak (``HW``), one card a stage, the cut activation
    ``batch*seq*d_model`` at the config dtype over ``link_bw_Bps`` (the
    ``LINK_PRIOR_BPS`` Table I uplink when None) with ``hop_overhead_s``
    (``HOP_OVERHEAD_PRIOR_S`` when None) a message.  Only the
    compute / link / overhead ratios steer the chosen (k, v)."""
    n_params = float(cfg.param_count())
    tokens = float(batch) * float(seq)
    total_fwd_s = 2.0 * n_params * tokens / HW["peak_flops_bf16"]
    elt_bytes = _DTYPE_BYTES[str(cfg.dtype)]
    act_bytes = float(batch) * float(seq) * float(cfg.d_model) * elt_bytes
    return PlanInputs(
        num_stages=num_stages,
        stage_fwd_s=total_fwd_s / num_stages,
        stage_bwd_s=bwd_fwd_ratio * total_fwd_s / num_stages,
        link_s=act_bytes / (LINK_PRIOR_BPS if link_bw_Bps is None
                            else float(link_bw_Bps)),
        hop_overhead_s=HOP_OVERHEAD_PRIOR_S if hop_overhead_s is None
        else hop_overhead_s,
        k_cap=max(1, min(batch, 64)) if k_cap is None else k_cap,
        v_cap=v_cap,
        num_layers=cfg.num_layers,
        fixed_chip_budget=False,
        act_bytes=elt_bytes,
        wire_block=wire_block_for(cfg.d_model),
        codec_s_per_byte=codec_s_per_byte,
        act_hop_bytes=act_bytes,
        d_model=int(cfg.d_model),
    )


# ---------------------------------------------------------------------------
# Serving objective: slot count (+ INFER-hop codec) for the continuous-
# batching engine (repro_torch.serving.engine) under an offered load.
# ---------------------------------------------------------------------------



@dataclasses.dataclass(frozen=True)
class ServingInputs:
    """Measured (or estimated) costs of one continuous-batching serving
    cell plus the offered load it must absorb.

    The engine's decode step is ONE fixed-shape program (a CUDA graph
    on the card) over the whole slot arena, so its cost is
    ``step_overhead_s + slots * decode_lane_s`` — per-lane compute plus
    the fixed dispatch cost — and every step advances every ACTIVE lane
    one token.  Prefill
    (``prefill_s_per_token``) time-shares the same engine, so the
    fraction ``f = arrival_hz * prompt_tokens * prefill_s_per_token`` of
    wall time is unavailable to decode.  Split serving adds the INFER
    uplink to each step: ``slots * d_model`` cut-activation elements at
    the codec's ``wire_bytes_per_element`` over ``link_bw_Bps`` plus the
    per-frame ``hop_overhead_s`` (``link_bw_Bps=None`` = co-located, no
    hop).  ``arrival_hz`` / ``prompt_tokens`` / ``gen_tokens`` describe
    the mean offered mix (e.g. from ``ServingQoS`` snapshots).
    """

    decode_lane_s: float           # decode seconds one slot lane adds/step
    prefill_s_per_token: float     # prefill engine seconds per prompt token
    arrival_hz: float              # mean request arrival rate (1/s)
    prompt_tokens: float           # mean prompt length
    gen_tokens: float              # mean generated tokens per request
    step_overhead_s: float = 0.0   # fixed per-decode-step dispatch cost
    slot_candidates: tuple = (1, 2, 4, 8, 16, 32, 64)
    wire_dtype: str = "none"       # INFER uplink codec (split serving)
    act_bytes: float = 2.0         # uncompressed activation element width
    d_model: int | None = None     # cut width (split serving hop volume)
    link_bw_Bps: float | None = None   # None = co-located UE+BS (no hop)
    hop_overhead_s: float = 0.0    # per-INFER-frame fixed cost

    def with_wire(self, wire_dtype: str) -> "ServingInputs":
        w = validate_wire_dtype(wire_dtype)
        if w == self.wire_dtype:
            return self
        return dataclasses.replace(self, wire_dtype=w)

    def hop_s(self, n_tokens: float) -> float:
        """INFER uplink seconds for ``n_tokens`` cut rows (one frame)."""
        if self.link_bw_Bps is None:
            return 0.0
        if self.d_model is None:
            raise ValueError(
                "ServingInputs: split serving (link_bw_Bps set) needs "
                "d_model for the INFER hop volume")
        block = wire_block_for(self.d_model)
        per = wire_bytes_per_element(self.wire_dtype, self.act_bytes,
                                     block)
        return (float(n_tokens) * self.d_model * per
                / float(self.link_bw_Bps)) + self.hop_overhead_s

    def step_s(self, slots: int) -> float:
        """Wall seconds of one engine decode step at an arena size: the
        fixed-shape program computes ALL lanes plus one INFER frame of
        ``slots`` cut rows when split."""
        return (self.step_overhead_s + slots * self.decode_lane_s
                + self.hop_s(slots))


# ln(100): the p99 quantile of an exponential residual wait.
_P99_EXP = 4.605170185988092


def serving_wall(inp: ServingInputs, slots: int) -> dict:
    """Score one slot-arena size under the offered load.

    Returns the serving twin of ``plan_wall_time``'s evidence: modeled
    ``tokens_per_s`` throughput, mean slot ``occupancy`` (Little's law:
    arrivals x per-request decode residency), utilization ``rho``
    against the arena's token capacity, and a ``p99_ttft_s`` estimate —
    prefill + first decode step plus an M/M/1-flavored queueing residual
    ``residency * rho / (1 - rho)`` at its exponential p99 quantile.
    An overloaded arena (``rho >= 1``, or prefill alone over-committing
    the engine) scores infinite latency rather than raising, so the
    argmin search can skip it.  Larger arenas trade the other way: the
    fixed-shape step computes every lane, so per-token latency grows
    with ``slots`` — the interior optimum ``choose_serving_plan`` finds.
    """
    if slots < 1:
        raise ValueError(f"slots={slots} must be >= 1")
    step_s = inp.step_s(slots)
    # engine-time fraction prefill steals (each prompt token also rides
    # one INFER prefill frame when split, amortized per token)
    prefill_req_s = inp.prompt_tokens * inp.prefill_s_per_token \
        + inp.hop_s(inp.prompt_tokens)
    f = inp.arrival_hz * prefill_req_s
    demand = inp.arrival_hz * inp.gen_tokens        # decode tokens/s
    if f >= 1.0:
        return {"slots": int(slots), "tokens_per_s": 0.0,
                "capacity_tokens_per_s": 0.0, "occupancy": float(slots),
                "rho": float("inf"), "p99_ttft_s": float("inf"),
                "per_token_s": float("inf"), "step_s": step_s}
    capacity = slots * (1.0 - f) / step_s
    # a lane's decode steps dilate by 1/(1-f): prefill chunks interleave
    per_token_s = step_s / (1.0 - f)
    residency_s = inp.gen_tokens * per_token_s      # one request's decode
    occupancy = inp.arrival_hz * residency_s        # mean busy slots
    rho = demand / capacity if capacity > 0 else float("inf")
    if rho >= 1.0:
        p99 = float("inf")
        served = capacity
    else:
        wait_s = residency_s * rho / (1.0 - rho)
        p99 = prefill_req_s + per_token_s + _P99_EXP * wait_s
        served = demand
    return {"slots": int(slots), "tokens_per_s": float(served),
            "capacity_tokens_per_s": float(capacity),
            "occupancy": float(occupancy), "rho": float(rho),
            "p99_ttft_s": float(p99), "per_token_s": float(per_token_s),
            "step_s": float(step_s)}


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """A serving-planner decision plus the evidence it was made on."""

    slots: int
    wire_dtype: str
    p99_ttft_s: float
    tokens_per_s: float
    occupancy: float
    rho: float
    inputs: ServingInputs

    def to_dict(self) -> dict:
        return {"slots": self.slots, "wire_dtype": self.wire_dtype,
                "p99_ttft_s": self.p99_ttft_s,
                "tokens_per_s": self.tokens_per_s,
                "occupancy": self.occupancy, "rho": self.rho}


def choose_serving_plan(inp: ServingInputs,
                        wire_candidates=None) -> ServingPlan:
    """Argmin of ``serving_wall``'s p99 latency over the slot candidates
    (and, optionally, the INFER-hop codec — only dense codecs are legal
    on the forward-only serving hop, so '+topk' candidates raise).

    Deterministic: ties keep the first-enumerated candidate (earlier
    wire candidate, then smaller arena).  Raises if EVERY candidate is
    overloaded — an infinite-latency plan is not a plan.
    """
    wires = list(wire_candidates) if wire_candidates \
        else [inp.wire_dtype]
    for w_cand in wires:
        if parse_wire_dtype(w_cand)[1] is not None:
            raise ValueError(
                f"serving wire candidate {w_cand!r}: the INFER hop is "
                "forward-only — dense codecs only (none/int8/fp8)")
    best = None
    for wd in wires:
        inp_w = inp.with_wire(wd)
        for slots in inp.slot_candidates:
            ev = serving_wall(inp_w, int(slots))
            key = ev["p99_ttft_s"]
            if np.isfinite(key) \
                    and (best is None or key < best[0] * (1.0 - _TIE_RTOL)):
                best = (key, ev, inp_w)
    if best is None:
        raise ValueError(
            f"every serving candidate is overloaded (arrival_hz="
            f"{inp.arrival_hz}, gen_tokens={inp.gen_tokens}) — no slot "
            f"count in {tuple(inp.slot_candidates)} keeps rho < 1")
    _key, ev, inp_w = best
    return ServingPlan(slots=ev["slots"], wire_dtype=inp_w.wire_dtype,
                       p99_ttft_s=ev["p99_ttft_s"],
                       tokens_per_s=ev["tokens_per_s"],
                       occupancy=ev["occupancy"], rho=ev["rho"],
                       inputs=inp_w)
