"""Wire byte model of the hop and the serving planner, from the JAX
package's ``analysis/autotune.py``.

The pieces the hop audits bill with (``wire_block_for``,
``wire_bytes_per_element`` forward, ``wire_bytes_per_element_bwd`` and
``wire_link_scale_bwd`` backward) and the continuous-batching engine's slot
planner (``ServingInputs``, ``serving_wall``, ``ServingPlan``,
``choose_serving_plan``), numpy only; the training planner is listed in
ROADMAP.md.  The codec grammar and block rule are the port's own
(``parallel/wire.py``), so the billing cannot drift from the codec.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.parallel.wire import (parse_wire_dtype, validate_wire_dtype,
                                       wire_block)

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
# Serving objective: slot count (+ INFER-hop codec) for the continuous-
# batching engine (repro_torch.serving.engine) under an offered load.
# ---------------------------------------------------------------------------

# relative tie tolerance of the argmin: a later candidate must beat the
# best by more than this to replace it
_TIE_RTOL = 1e-9


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
