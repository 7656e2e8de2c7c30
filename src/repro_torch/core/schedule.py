"""Pipeline schedules and bubble-rate accounting (paper SII-C, SIII-A).

Port of the JAX package's ``core/schedule.py`` (numpy only).  Times are
seconds of the paper's Table I system model, not of any device.

Two views are provided:

* ``TaskTimes`` — the closed-form per-micro-batch durations of eqs (7)-(12).
* ``simulate_*`` — event-driven makespan simulators for C2P2SL and the three
  baselines (SL, PSL, EPSL).  The simulators do NOT assume the steady-state
  constraints C3/C4 hold, so they remain valid for arbitrary (l, k, b, tau);
  when C3/C4 do hold, ``c2p2sl`` reproduces the paper's
  ``t_total = t_idle + t_work`` decomposition (asserted in tests).
"""
from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.core.costs import LayerProfile
from repro_torch.wireless.fleet import Fleet


@dataclasses.dataclass(frozen=True)
class Plan:
    """A full C2P2SL decision: cut layer, micro-batches, batch + slot split.

    ``v`` is the interleaved virtual-stage count (1 = the paper's plain
    1F1B): each side's model is sliced into v chunks whose tasks run at
    1/v the duration, shrinking the pipeline warm-up/drain (the bubble)
    by a factor of v at the same k (see parallel/pipeline.py).
    """

    l: int                 # cut layer (1-based, cut AFTER layer l)
    k: int                 # number of micro-batches
    b: np.ndarray          # per-UE batch sizes, sum == global batch
    tau: np.ndarray        # per-UE TDMA slot lengths, sum <= frame T
    v: int = 1             # interleaved virtual stages per side

    @property
    def batch(self) -> int:
        return int(self.b.sum())


@dataclasses.dataclass(frozen=True)
class TaskTimes:
    """Per-micro-batch task durations, eqs (7)-(12).  Arrays are per-UE."""

    ue_fwd: np.ndarray     # t_i^F  (7)
    uplink: np.ndarray     # t_i^U  (8)
    bs_fwd: float          # t_b^F  (9)
    bs_bwd: float          # t_b^B  (10)
    downlink: np.ndarray   # t_i^D  (11)
    ue_bwd: np.ndarray     # t_i^B  (12)

    @property
    def bs_work(self) -> float:
        return self.bs_fwd + self.bs_bwd


def task_times(profile: LayerProfile, fleet: Fleet, plan: Plan) -> TaskTimes:
    """Evaluate eqs (7)-(12) for one (l, k, b, tau) decision."""
    l, k = plan.l, plan.k
    b_i = plan.b.astype(np.float64)
    tau = plan.tau.astype(np.float64)
    T = fleet.channel.frame_s
    r_u, r_d = fleet.rates()
    f_i = fleet.ue_flops
    f_b = fleet.bs_flops

    s_l = profile.cut_bytes(l) * 8.0     # bits
    s_0 = profile.label_bytes * 8.0      # bits

    with np.errstate(divide="ignore"):
        ue_fwd = b_i * profile.ue_fwd(l) / (k * f_i)                      # (7)
        uplink = b_i * (s_l + s_0) * T / (k * r_u * tau)                  # (8)
        downlink = b_i * s_l * T / (k * r_d * tau)                        # (11)
        ue_bwd = b_i * profile.ue_bwd(l) / (k * f_i)                      # (12)
    bs_fwd = b_i.sum() * profile.bs_fwd(l) / (k * f_b)                    # (9)
    bs_bwd = b_i.sum() * profile.bs_bwd(l) / (k * f_b)                    # (10)
    # UEs with zero batch contribute no time.
    zero = b_i <= 0
    for arr in (ue_fwd, uplink, downlink, ue_bwd):
        arr[zero] = 0.0
    return TaskTimes(ue_fwd=ue_fwd, uplink=uplink, bs_fwd=float(bs_fwd),
                     bs_bwd=float(bs_bwd), downlink=downlink, ue_bwd=ue_bwd)


def bubble_rate(t: TaskTimes, k: int, virtual_stages: int = 1) -> float:
    """BR = t_idle / (t_idle + t_work), eqs (16)-(18), generalized to
    interleaved virtual stages.

    With v > 1 every per-micro-batch task is sliced into v sub-chunk
    tasks of 1/v the duration, so the warm-up/drain critical path — the
    idle term ``max_i(t_i^F + t_i^U) + max_i(t_i^D + t_i^B)`` — shrinks
    by a factor of v while the steady-state work ``k * (t_b^F + t_b^B)``
    is unchanged: the ``(S-1)``-per-direction bubble of plain 1F1B
    becomes ``(S-1)/v``.  Strictly decreasing in v whenever t_idle > 0.
    """
    v = int(virtual_stages)
    if v < 1:
        raise ValueError(f"virtual_stages={virtual_stages} must be >= 1")
    t_idle = float(np.max(t.ue_fwd + t.uplink)
                   + np.max(t.downlink + t.ue_bwd)) / v
    t_work = k * t.bs_work
    return t_idle / (t_idle + t_work)


def steady_state_ok(t: TaskTimes, k: int) -> bool:
    """Constraints C3 (14) and C4 (15)."""
    c3 = max(float(np.max(t.ue_fwd)), float(np.max(t.uplink))) <= t.bs_work + 1e-12
    c4 = (k - 1) * (float(np.max(t.uplink)) + float(np.max(t.downlink))) \
        <= k * t.bs_work + 1e-12
    return c3 and c4


# ---------------------------------------------------------------------------
# Event-driven simulators.  Each returns (makespan_seconds, timeline) where
# timeline is a list of (actor, task, mb_index, start, end) for plotting.
# ---------------------------------------------------------------------------

def simulate_c2p2sl(t: TaskTimes, k: int, collect_timeline: bool = False,
                    virtual_stages: int = 1):
    """Makespan of one batch under the C2P2SL workflow (paper Fig 2).

    ``virtual_stages = v > 1`` models interleaved scheduling: each side's
    model is sliced into v chunks, so every per-micro-batch task becomes
    v sub-tasks of 1/v the duration streaming through the same event
    logic — i.e. the makespan of k*v work items of duration t/v.  Total
    work is unchanged; the warm-up/drain shrinks ~v-fold.  Unlike simply
    raising k (bounded by the per-UE sample granularity b_i/k >= 1), v
    subdivides the model depth, so it remains available when k is capped.
    Per-message overheads of the extra chunk boundaries are not modeled
    (same idealization as eqs (7)-(12)).  Timeline entries then carry
    slice indices m in [0, k*v).

    Semantics implemented exactly as SII-C:
      * each UE is a single processor running FP(0..k-1) then BP in arrival
        order of downlink gradients;
      * BS runs 1F1B: F(m) then immediately B(m);
      * BS FP(m) needs every UE's UT(m);
      * UT has priority over DT on the shared band: DT(m) may only start
        after ALL micro-batches' UT completed (the paper's ordering rule);
      * UE BP(m) needs DT(m) and the UE's previous task to be done.
    """
    v = int(virtual_stages)
    if v < 1:
        raise ValueError(f"virtual_stages={virtual_stages} must be >= 1")
    if v > 1:
        t = TaskTimes(ue_fwd=t.ue_fwd / v, uplink=t.uplink / v,
                      bs_fwd=t.bs_fwd / v, bs_bwd=t.bs_bwd / v,
                      downlink=t.downlink / v, ue_bwd=t.ue_bwd / v)
        k = k * v
    n = len(t.ue_fwd)
    tl = [] if collect_timeline else None

    fp_done = np.zeros((n, k))
    ut_done = np.zeros((n, k))
    for i in range(n):
        busy = 0.0
        link = 0.0
        for m in range(k):
            busy += t.ue_fwd[i]
            fp_done[i, m] = busy
            link = max(link, busy) + t.uplink[i]
            ut_done[i, m] = link
            if tl is not None:
                tl.append((f"ue{i}", "FP", m, busy - t.ue_fwd[i], busy))
                tl.append((f"ue{i}", "UT", m, link - t.uplink[i], link))
    all_ut_done = float(ut_done[:, -1].max()) if k > 0 else 0.0

    # BS 1F1B.
    bs_free = 0.0
    bsb_done = np.zeros(k)
    for m in range(k):
        start_f = max(bs_free, float(ut_done[:, m].max()))
        end_f = start_f + t.bs_fwd
        end_b = end_f + t.bs_bwd
        bs_free = end_b
        bsb_done[m] = end_b
        if tl is not None:
            tl.append(("bs", "FP", m, start_f, end_f))
            tl.append(("bs", "BP", m, end_f, end_b))

    # Downlink (after the last UT per the priority rule) then UE BP.
    ue_free = fp_done[:, -1].copy()
    dt_free = np.full(n, all_ut_done)
    end_time = 0.0
    for m in range(k):
        for i in range(n):
            start_d = max(bsb_done[m], dt_free[i])
            end_d = start_d + t.downlink[i]
            dt_free[i] = end_d
            start_b = max(end_d, ue_free[i])
            end_b = start_b + t.ue_bwd[i]
            ue_free[i] = end_b
            end_time = max(end_time, end_b)
            if tl is not None:
                tl.append((f"ue{i}", "DT", m, start_d, end_d))
                tl.append((f"ue{i}", "BP", m, start_b, end_b))
    return (end_time, tl)


def simulate_psl(t1: TaskTimes):
    """PSL [7]: all UEs in parallel, whole batch at once (k == 1 TaskTimes)."""
    ut = t1.ue_fwd + t1.uplink
    bs_done = float(np.max(ut)) + t1.bs_fwd + t1.bs_bwd
    return bs_done + float(np.max(t1.downlink + t1.ue_bwd))


def simulate_sl(profile: LayerProfile, fleet: Fleet, plan: Plan):
    """Classical SL [4]: strictly sequential over UEs, full band per UE."""
    r_u, r_d = fleet.rates()
    f_i = fleet.ue_flops
    s_l = profile.cut_bytes(plan.l) * 8.0
    s_0 = profile.label_bytes * 8.0
    total = 0.0
    for i in range(fleet.n):
        b_i = float(plan.b[i])
        if b_i <= 0:
            continue
        total += b_i * profile.ue_fwd(plan.l) / f_i[i]
        total += b_i * (s_l + s_0) / r_u[i]          # full band: sole user
        total += b_i * (profile.bs_fwd(plan.l) + profile.bs_bwd(plan.l)) / fleet.bs_flops
        total += b_i * s_l / r_d[i]
        total += b_i * profile.ue_bwd(plan.l) / f_i[i]
    return total


def simulate_epsl(t1: TaskTimes, n: int, agg_ratio: float | None = None):
    """EPSL [8]: PSL + last-layer gradient aggregation.

    Aggregation shrinks the BS-side backward batch and the downlink
    activation-gradient volume by ``agg_ratio`` (default 1/n), trading
    a little accuracy (paper Fig 3) for time.
    """
    rho = 1.0 / n if agg_ratio is None else agg_ratio
    ut = t1.ue_fwd + t1.uplink
    bs_done = float(np.max(ut)) + t1.bs_fwd + rho * t1.bs_bwd
    return bs_done + float(np.max(rho * t1.downlink + t1.ue_bwd))
