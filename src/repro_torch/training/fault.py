"""Fault tolerance and straggler mitigation (numpy only).

Copy of the JAX package's ``training/fault.py``; the port imports
nothing of it.  Three mechanisms:

1. **Heartbeat watchdog**: every worker stamps a heartbeat each step;
   ``dead_workers`` lists those silent past ``timeout_s``.
2. **Straggler re-balancing**: per-worker step-time EWMAs feed a
   proportional-to-speed batch split (``rebalance_batches``, the
   degenerate P3 of the paper's batch allocation with no comm terms;
   ``core.ao`` solves the full one).
3. **Elastic rescale**: ``plan_rescale`` maps a mesh shape to a smaller
   one after pod loss.

``Watchdog.telemetry`` is what the online re-planner
(``training/replan.py``) reads.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class WorkerState:
    last_beat: float
    step_time_ewma: float = 0.0


@dataclasses.dataclass(frozen=True)
class WatchdogTelemetry:
    """Typed snapshot of the watchdog's per-worker step-time EWMAs.

    The supported way for other subsystems (the online re-planner,
    re-balancing, dashboards) to read the watchdog — callers used to poke
    ``WorkerState.step_time_ewma`` directly, which coupled them to the
    internal dict layout.  ``step_time_ewma`` is ordered by worker id;
    workers that have not reported yet read 0.0.
    """

    step_time_ewma: tuple        # seconds, one entry per worker
    workers: tuple               # the matching worker ids

    @property
    def median_s(self) -> float:
        """Median over workers that have reported (0.0 if none have)."""
        t = np.array(self.step_time_ewma)
        t = t[t > 0]
        return float(np.median(t)) if t.size else 0.0

    @property
    def max_s(self) -> float:
        return float(max(self.step_time_ewma, default=0.0))

    def extra_hints(self, baseline_step_s: float | None = None) -> dict:
        """Planner-hint overlay for the online re-planner
        (``training/replan.py``): the measured step time, plus — when the
        caller knows what step time the current plan was *modeled* at —
        the ``stage_time_scale`` drift factor the re-planner multiplies
        into ``PlanInputs.stage_fwd_s/stage_bwd_s``."""
        med = self.median_s
        hints = {"step_time_ewma_s": med} if med > 0 else {}
        if baseline_step_s and baseline_step_s > 0 and med > 0:
            hints["stage_time_scale"] = med / baseline_step_s
        return hints


class Watchdog:
    """Coordinator-side liveness + straggler tracking."""

    def __init__(self, n_workers: int, timeout_s: float = 60.0,
                 ewma: float = 0.9, clock=time.monotonic):
        self.clock = clock
        self.timeout_s = timeout_s
        self.ewma = ewma
        now = clock()
        self.workers = {i: WorkerState(last_beat=now) for i in range(n_workers)}

    def heartbeat(self, worker: int, step_time: float | None = None):
        st = self.workers[worker]
        st.last_beat = self.clock()
        if step_time is not None:
            st.step_time_ewma = (self.ewma * st.step_time_ewma
                                 + (1 - self.ewma) * step_time
                                 if st.step_time_ewma else step_time)

    def dead_workers(self) -> list:
        now = self.clock()
        return [i for i, st in self.workers.items()
                if now - st.last_beat > self.timeout_s]

    def stragglers(self, factor: float = 1.5) -> list:
        times = np.array([st.step_time_ewma for st in self.workers.values()])
        if not times.any():
            return []
        med = np.median(times[times > 0])
        return [i for i, st in self.workers.items()
                if st.step_time_ewma > factor * med]

    def telemetry(self) -> WatchdogTelemetry:
        """Typed per-worker EWMA snapshot (see ``WatchdogTelemetry``) —
        use this instead of reading ``workers[i].step_time_ewma``."""
        ids = tuple(sorted(self.workers))
        return WatchdogTelemetry(
            step_time_ewma=tuple(self.workers[i].step_time_ewma
                                 for i in ids),
            workers=ids)

    def throughputs(self) -> np.ndarray:
        """Relative worker speeds (1/step-time), for re-balancing."""
        t = np.array([st.step_time_ewma or 1.0 for st in self.workers.values()])
        return 1.0 / t


def rebalance_batches(throughputs: np.ndarray, global_batch: int,
                      multiple: int = 1) -> np.ndarray:
    """Proportional-to-speed batch split (the degenerate P3: no comm terms).

    With wireless comm terms, use core.ao.solve_batch_p3 instead; on a
    homogeneous datacenter fabric the LP reduces to this proportional rule.
    """
    w = throughputs / throughputs.sum()
    b = np.floor(w * global_batch / multiple) * multiple
    rem = global_batch - int(b.sum())
    order = np.argsort(-w)
    i = 0
    while rem > 0:
        b[order[i % len(order)]] += multiple
        rem -= multiple
        i += 1
    return b.astype(int)


def plan_rescale(old_shape: dict, lost_pods: int) -> dict:
    """New mesh shape after losing ``lost_pods`` pods (elastic shrink)."""
    new = dict(old_shape)
    if "pod" in new:
        new["pod"] = max(1, new["pod"] - lost_pods)
    return new
