"""Adaptive online re-planning: channel-tracking plan switches.

Port of the JAX package's ``training/replan.py`` (numpy only).  The
planner (``analysis/autotune.py``) picks ``(stages, k, v, wire_dtype)``
once, but over a wireless link the channel is not constant: the plan
must track link quality, and a codec only pays while the link it was
chosen for lasts.  This module closes the loop at run time::

    measured step times (Watchdog EWMAs) ─┐
    measured hop times  (LinkEstimator) ──┼─> apply_hints ─> PlanInputs
    channel telemetry / scripted traces ──┘        │
                                             choose_plan every N steps
                                                   │
                            hysteresis gate: switch only when the
                            projected wall-time gain clears the margin

The streaming runtime (``runtime/bs.py``) feeds ``observe_hop`` with the
measured (bytes, seconds) of every socket hop; the training launcher
(``launch/train.py --replan``) feeds step times and a scripted bandwidth
trace, and switches through the cheap-switch machinery at the end of the
module: ``PlanCellCache`` builds the step of each plan cell once, and
``carry_state`` moves the training state across a switch.  Carry-over
rules of the top-k hop's error-feedback buffer ``wire_ef``: it carries
over exactly when its shape is unchanged (a codec change at equal k and
v), resets to zero when k or v changes its shape, and is dropped or
created when the codec moves between top-k and dense.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.analysis.autotune import (WIRE_AUTO, Plan, PlanInputs,
                                           choose_plan, plan_wall_time)
from repro_torch.training.fault import Watchdog, WorkerState


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    """Knobs of the online re-planner (flag grammar: ``every:N,
    hysteresis:F[,cooldown:N][,ewma:F]`` or ``off``)."""

    every: int = 50          # re-evaluate the plan every N steps
    hysteresis: float = 0.1  # switch only if new wall < (1-h) * current
    cooldown: int = 0        # extra steps to hold after a switch
    #                          (0 = the `every` cadence is the cooldown)
    ewma: float = 0.7        # smoothing for link-bandwidth observations

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"replan every={self.every} must be >= 1")
        if not 0.0 <= self.hysteresis < 1.0:
            raise ValueError(
                f"replan hysteresis={self.hysteresis} must be in [0, 1)")
        if self.cooldown < 0:
            raise ValueError(f"replan cooldown={self.cooldown} must be >= 0")
        if not 0.0 <= self.ewma < 1.0:
            raise ValueError(f"replan ewma={self.ewma} must be in [0, 1)")

    @classmethod
    def parse(cls, text: str | None) -> "ReplanConfig | None":
        """Parse a flag value: ``None``/``"off"`` -> None (disabled);
        ``on`` -> the defaults; else comma-separated ``key:value`` over
        {every, hysteresis, cooldown, ewma}."""
        if text is None:
            return None
        text = text.strip().lower()
        if text in ("off", "none", "0", "false"):
            return None
        if text in ("on", "", "default"):
            return cls()
        kwargs = {}
        for item in text.split(","):
            if ":" not in item:
                raise ValueError(
                    f"--replan items must be key:value, got {item!r} "
                    f"(full value {text!r})")
            key, _, val = item.partition(":")
            key = key.strip()
            if key in ("every", "cooldown"):
                kwargs[key] = int(val)
            elif key in ("hysteresis", "ewma"):
                kwargs[key] = float(val)
            else:
                raise ValueError(
                    f"unknown --replan key {key!r}; expected one of "
                    "every, hysteresis, cooldown, ewma (or 'off')")
        return cls(**kwargs)

    def describe(self) -> str:
        """Canonical spelling: ``parse(describe()) == self``; every
        non-default field, floats by ``repr``."""
        out = f"every:{self.every},hysteresis:{self.hysteresis!r}"
        if self.cooldown:
            out += f",cooldown:{self.cooldown}"
        if self.ewma != type(self).ewma:
            out += f",ewma:{self.ewma!r}"
        return out


# ---------------------------------------------------------------------------
# Link estimation
# ---------------------------------------------------------------------------


class LinkEstimator:
    """Online estimate of the stage-boundary link from in-loop samples.

    * ``observe(nbytes, seconds)`` (alias ``observe_hop``, the streaming
      runtime's feed): a timed hop.  Samples at >= 2 distinct sizes fit
      ``t = overhead + bytes/bw`` by least squares; samples of one size
      give the bandwidth only.  The last ``window`` samples count.
    * ``observe_bandwidth(bw_Bps)``: a direct reading (channel telemetry,
      a scripted trace), EWMA-smoothed.

    ``hints()`` exports the estimate as the overlay ``apply_hints`` reads.
    """

    def __init__(self, ewma: float = 0.7, window: int = 64):
        self.ewma = ewma
        self.window = window
        self._samples: list = []       # (bytes, seconds)
        self._bw_Bps: float | None = None
        self._overhead_s: float | None = None

    def observe(self, nbytes: float, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        self._samples.append((float(nbytes), float(seconds)))
        del self._samples[:-self.window]
        self._refit()

    observe_hop = observe

    def observe_bandwidth(self, bw_Bps: float,
                          overhead_s: float | None = None) -> None:
        if bw_Bps <= 0:
            return
        self._bw_Bps = (bw_Bps if self._bw_Bps is None
                        else self.ewma * self._bw_Bps
                        + (1 - self.ewma) * bw_Bps)
        if overhead_s is not None:
            self._overhead_s = (overhead_s if self._overhead_s is None
                                else self.ewma * self._overhead_s
                                + (1 - self.ewma) * overhead_s)

    def _refit(self) -> None:
        b = np.array([s[0] for s in self._samples])
        t = np.array([s[1] for s in self._samples])
        if len(set(b.tolist())) >= 2:
            slope, intercept = (float(c) for c in np.polyfit(b, t, 1))
            if slope > 0:
                self._bw_Bps = 1.0 / slope
                self._overhead_s = max(0.0, intercept)
                return
        # degenerate fit: bill everything to bandwidth
        self._bw_Bps = float(b.sum() / t.sum())

    @property
    def bw_Bps(self) -> float | None:
        return self._bw_Bps

    @property
    def overhead_s(self) -> float | None:
        return self._overhead_s

    @property
    def samples(self) -> list:
        """The (bytes, seconds) samples of the current window."""
        return list(self._samples)

    def hints(self) -> dict:
        out = {}
        if self._bw_Bps is not None:
            out["link_bw_Bps"] = self._bw_Bps
        if self._overhead_s is not None:
            out["hop_overhead_s"] = self._overhead_s
        return out


def apply_hints(inputs: PlanInputs, hints: dict) -> PlanInputs:
    """Fold a measurement overlay into ``PlanInputs`` (unknown keys are
    ignored):

    * ``link_bw_Bps``: ``link_s = act_hop_bytes / bw`` (needs
      ``act_hop_bytes``);
    * ``hop_overhead_s``, ``codec_s_per_byte``: replaced;
    * ``stage_time_scale``: multiplies both stage times;
    * ``stage_fwd_s``, ``stage_bwd_s``: replaced (win over the scale).
    """
    kw = {}
    bw = hints.get("link_bw_Bps")
    if bw and bw > 0 and inputs.act_hop_bytes > 0:
        kw["link_s"] = float(inputs.act_hop_bytes) / float(bw)
    for key in ("hop_overhead_s", "codec_s_per_byte"):
        if hints.get(key) is not None:
            kw[key] = float(hints[key])
    scale = hints.get("stage_time_scale")
    if scale and scale > 0:
        kw["stage_fwd_s"] = inputs.stage_fwd_s * float(scale)
        kw["stage_bwd_s"] = inputs.stage_bwd_s * float(scale)
    for key in ("stage_fwd_s", "stage_bwd_s"):
        if hints.get(key) is not None:
            kw[key] = float(hints[key])
    return dataclasses.replace(inputs, **kw) if kw else inputs


# ---------------------------------------------------------------------------
# The re-planner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanSwitch:
    """One logged plan switch, with the evidence it was decided on."""

    step: int
    old: Plan
    new: Plan
    old_wall_s: float      # current plan's modeled wall on fresh inputs
    new_wall_s: float      # winner's modeled wall on the same inputs

    @property
    def gain(self) -> float:
        """Fractional projected wall-time saving (0.25 = 25% faster)."""
        return 1.0 - self.new_wall_s / self.old_wall_s \
            if self.old_wall_s > 0 else 0.0

    def to_json(self) -> dict:
        return {"step": self.step, "old": self.old.to_json(),
                "new": self.new.to_json(), "old_wall_s": self.old_wall_s,
                "new_wall_s": self.new_wall_s, "gain": self.gain}


class Replanner:
    """Hysteresis-gated online re-planner over a fixed stage count.

    Every ``config.every`` steps, re-runs ``choose_plan`` on the base
    ``PlanInputs`` refreshed with the current measurements, and switches
    to the winner only when its wall beats the CURRENT plan's wall on the
    same fresh inputs by more than the margin::

        new_wall < (1 - hysteresis) * current_wall

    Noise moves both walls together, so the gate opens only on a
    relative regime change.  S is pinned; switches move (k, v, wire).
    """

    def __init__(self, inputs: PlanInputs, initial: Plan,
                 config: ReplanConfig | None = None,
                 watchdog: Watchdog | None = None,
                 wire_candidates=WIRE_AUTO):
        config = config or ReplanConfig()
        if initial.stages != inputs.num_stages:
            raise ValueError(
                f"initial plan has S={initial.stages} but inputs model "
                f"S={inputs.num_stages}; the re-planner never moves the "
                "stage count")
        self.base_inputs = inputs
        self.config = config
        self.current = initial
        self.watchdog = watchdog
        self.wire_candidates = tuple(wire_candidates)
        self.link = LinkEstimator(ewma=config.ewma)
        self.extra_hints: dict = {}
        self.switches: list = []        # PlanSwitch log
        self.evals = 0                  # choose_plan invocations
        self._last_eval_step = None
        self._last_switch_step = None
        self._baseline_step_s = None    # watchdog calibration anchor

    # -- measurement feeds ---------------------------------------------------

    def observe_step(self, worker: int, step_time_s: float) -> None:
        """Per-step wall time feed (the Watchdog's EWMAs)."""
        if self.watchdog is None:
            self.watchdog = Watchdog(n_workers=worker + 1)
        if worker not in self.watchdog.workers:
            self.watchdog.workers[worker] = WorkerState(
                last_beat=self.watchdog.clock())
        self.watchdog.heartbeat(worker, step_time=step_time_s)

    def observe_hop(self, nbytes: float, seconds: float) -> None:
        self.link.observe(nbytes, seconds)

    def observe_bandwidth(self, bw_Bps: float,
                          overhead_s: float | None = None) -> None:
        self.link.observe_bandwidth(bw_Bps, overhead_s)

    # -- planning ------------------------------------------------------------

    def refreshed_inputs(self) -> PlanInputs:
        """Base inputs with every current measurement folded in.  The
        first healthy step-time EWMA anchors "no compute drift"; later
        medians scale the stage times relative to it (link drift is the
        LinkEstimator's to bill)."""
        hints = dict(self.link.hints())
        if self.watchdog is not None:
            tel = self.watchdog.telemetry()
            med = tel.median_s
            if med > 0:
                if self._baseline_step_s is None:
                    self._baseline_step_s = med
                hints.update(tel.extra_hints(self._baseline_step_s))
        hints.pop("step_time_ewma_s", None)   # informational only
        hints.update(self.extra_hints)
        return apply_hints(self.base_inputs, hints)

    def maybe_replan(self, step: int) -> PlanSwitch | None:
        """Run the cadence at ``step`` (call once a step): the
        ``PlanSwitch`` if the gate opened, else None."""
        if self._last_eval_step is not None \
                and step - self._last_eval_step < self.config.every:
            return None
        self._last_eval_step = step
        self.evals += 1
        inp = self.refreshed_inputs()
        cur = self.current
        cur_wall = plan_wall_time(inp.with_wire(cur.wire_dtype),
                                  cur.k, cur.v)
        best = choose_plan(inp, wire_candidates=self.wire_candidates)
        new = best.plan
        if new == cur:
            return None
        if self._last_switch_step is not None and self.config.cooldown \
                and step - self._last_switch_step < self.config.cooldown:
            return None
        if not best.wall_s < (1.0 - self.config.hysteresis) * cur_wall:
            return None
        switch = PlanSwitch(step=step, old=cur, new=new,
                            old_wall_s=float(cur_wall),
                            new_wall_s=float(best.wall_s))
        self.current = new
        self.switches.append(switch)
        self._last_switch_step = step
        return switch

    def to_json(self) -> dict:
        """Run summary for logs."""
        return {
            "config": dataclasses.asdict(self.config),
            "current": self.current.to_json(),
            "evals": self.evals,
            "switches": [s.to_json() for s in self.switches],
        }


# ---------------------------------------------------------------------------
# Reachable cells
# ---------------------------------------------------------------------------


def reachable_cells(*, num_stages: int, num_layers: int | None = None,
                    v_cap: int = 4, wire_candidates=WIRE_AUTO) -> list:
    """Every ``(wire_dtype, v)`` cell the re-planner can switch into (k
    only changes shapes, so cells collapse over k): v over
    ``PlanInputs.feasible_v``, the codec over ``wire_candidates``, each
    normalized through ``Plan`` so aliases add no duplicate."""
    probe = PlanInputs(num_stages=num_stages, stage_fwd_s=1.0,
                       stage_bwd_s=2.0, link_s=0.1, v_cap=v_cap,
                       num_layers=num_layers)
    seen, cells = set(), []
    for wd in wire_candidates:
        norm = Plan(stages=num_stages, k=1, wire_dtype=wd).wire_dtype
        for v in probe.feasible_v():
            cell = (norm, v)
            if cell not in seen:
                seen.add(cell)
                cells.append(cell)
    return cells


def reachable_plans(inputs: PlanInputs, wire_candidates=WIRE_AUTO) -> list:
    """Every ``Plan`` a ``Replanner`` over ``inputs`` can reach (the
    feasible grid's cartesian product)."""
    out = []
    for wd in wire_candidates:
        for v in inputs.feasible_v():
            for k in range(1, max(1, inputs.k_cap) + 1):
                out.append(Plan(stages=inputs.num_stages, k=k, v=v,
                                wire_dtype=wd))
    return out


# ---------------------------------------------------------------------------
# Step cache + state carry-over (the cheap-switch machinery)
# ---------------------------------------------------------------------------


class PlanCellCache:
    """Memoizes per-plan artifacts by plan **cell**.

    ``build(plan)`` is the caller's factory, typically the train step of
    that cell (``launch/train.py``).  Re-entering a visited cell is a dict
    hit.  ``state_template`` memoizes ``fn``'s result built on the
    ``meta`` device (shapes and dtypes, no memory and no FLOPs) under the
    cell, as the reference memoizes ``jax.eval_shape``.
    """

    def __init__(self, build):
        self._build = build
        self._entries: dict = {}
        self._templates: dict = {}
        self.hits = 0
        self.misses = 0

    def get(self, plan: Plan):
        key = plan.cell()
        if key in self._entries:
            self.hits += 1
        else:
            self.misses += 1
            self._entries[key] = self._build(plan)
        return self._entries[key]

    def state_template(self, plan: Plan, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` with factory functions on the ``meta``
        device, memoized under this plan's cell (``fn`` must be
        cell-deterministic)."""
        key = plan.cell()
        if key not in self._templates:
            import torch
            with torch.device("meta"):
                self._templates[key] = fn(*args, **kwargs)
        return self._templates[key]

    def __len__(self):
        return len(self._entries)

    def __contains__(self, plan: Plan):
        return plan.cell() in self._entries


def carry_state(state: dict, new_plan: Plan, *, cfg, batch: int,
                seq: int) -> dict:
    """Move a training state across a plan switch, checkpoint-free.

    Parameters, optimizer state and step carry over unchanged (the same
    objects); ``wire_ef`` follows the module docstring's rules, a new
    buffer on the parameters' device."""
    from repro_torch.parallel.pipeline import PipelineSpec, wire_ef_zeros
    from repro_torch.utils.trees import tree_leaves
    new_state = dict(state)
    old_ef = new_state.pop("wire_ef", None)
    new_ef = wire_ef_zeros(cfg, PipelineSpec.from_plan(new_plan), batch, seq,
                           tree_leaves(state["params"])[0].device)
    if new_ef is not None:
        if old_ef is not None and tuple(old_ef.shape) == tuple(new_ef.shape):
            new_ef = old_ef            # exact carry-over
        new_state["wire_ef"] = new_ef
    return new_state
