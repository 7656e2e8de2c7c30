"""Alternating-optimization split & allocation (paper SIII, Algorithm 1).

P1 (19) is decomposed into:
  1. (l, k): enumerate cut layers, pick micro-batch count by Lemma 1;
  2. b:      MILP P3 -> LP relaxation (scipy/HiGHS) + floor/ceil rounding,
             the branch-and-bound shortcut justified by C5;
  3. tau:    convex epigraph problem P5 solved by SLSQP.

P3/P5 use scipy.optimize (the paper only requires "available toolkits";
HiGHS is an LP/MILP solver of the same class).  Port of the JAX package's
``core/ao.py``: host-side numpy and scipy, the same solvers with the same
options, so one scipy gives the reference's plan.
"""
from __future__ import annotations

import dataclasses
import numpy as np
from scipy.optimize import linprog, minimize

from repro_torch.core.costs import LayerProfile
from repro_torch.core.schedule import (Plan, TaskTimes, bubble_rate,
                                       simulate_c2p2sl, task_times)
from repro_torch.wireless.fleet import Fleet


@dataclasses.dataclass
class AOResult:
    plan: Plan
    bubble: float
    history: list            # BR per AO iteration
    times: TaskTimes


def _coeffs(profile: LayerProfile, fleet: Fleet, l: int, k: int,
            tau: np.ndarray):
    """Per-unit-batch time coefficients for fixed (l, k, tau)."""
    r_u, r_d = fleet.rates()
    T = fleet.channel.frame_s
    s_l = profile.cut_bytes(l) * 8.0
    s_0 = profile.label_bytes * 8.0
    with np.errstate(divide="ignore"):
        cF = profile.ue_fwd(l) / (k * fleet.ue_flops)          # t_i^F / b_i
        cB = profile.ue_bwd(l) / (k * fleet.ue_flops)
        cU = (s_l + s_0) * T / (k * r_u * tau)                 # t_i^U / b_i
        cD = s_l * T / (k * r_d * tau)                         # t_i^D / b_i
    cBS = (profile.bs_fwd(l) + profile.bs_bwd(l)) / (k * fleet.bs_flops)
    return cF, cB, cU, cD, cBS


def lemma1_k(profile: LayerProfile, fleet: Fleet, l: int, b: np.ndarray,
             tau: np.ndarray, k_cap: int | None = None,
             virtual_stages: int = 1) -> int:
    """Optimal micro-batch count for fixed (l, b, tau) — Lemma 1.

    The lemma's eta is, written with per-batch (k-independent) times,
        eta = max_i  W / (T_i^U + T_i^D)  =  W / min_i (T_i^U + T_i^D)
    with W = T_b^F + T_b^B, and k* = floor(1/(1-eta)).  eta -> 1 (balanced
    communication/computation) drives k up; eta >= 1 (compute-bound BS) makes
    C4 non-binding so k is capped only by the micro-batch granularity
    (b_i/k >= 1) / the external cap.

    ``virtual_stages = v > 1`` (interleaved chunks, see schedule.py): eta
    is v-free (chunk work and chunk comm both scale 1/v) but the pipeline
    already runs at slice granularity k*v, so the k needed to reach the
    steady state divides by v: k* = ceil(floor(1/(1-eta)) / v).  The
    sample-granularity cap min_i b_i does NOT divide — v slices the model
    depth, not the batch.
    """
    v = max(1, int(virtual_stages))
    t1 = task_times(profile, fleet, Plan(l=l, k=1, b=b, tau=tau))
    active = b > 0
    comm = (t1.uplink + t1.downlink)[active]
    W = t1.bs_work
    cap = int(np.min(b[active])) if active.any() else 1
    if k_cap is not None:
        cap = min(cap, k_cap)
    cap = max(cap, 1)
    if comm.size == 0 or W <= 0.0:
        return 1
    eta = W / float(np.min(comm))
    if eta >= 1.0:
        return cap
    k = -(-int(np.floor(1.0 / (1.0 - eta))) // v)
    return int(np.clip(k, 1, cap))


def pipeline_k_auto(stage_compute_s: float, link_s: float, k_cap: int,
                    virtual_stages: int = 1) -> int:
    """Lemma 1 transplanted to the stage pipeline of ``parallel/pipeline.py``.

    ``stage_compute_s`` plays t_b^F + t_b^B (per-stage compute per batch),
    ``link_s`` plays t^U + t^D (the cut-activation transfer per batch over
    the stage link).  Both are batch-level times; per micro-batch each
    scales 1/k, so Lemma 1's eta = W / comm is k-free, exactly as in the
    wireless derivation.  ``k_cap`` is the granularity bound on k (a
    micro-batch must keep at least one sample).  ``virtual_stages = v > 1``
    divides the steady-state k by v (the pipeline streams k*v interleaved
    slices) but never relaxes ``k_cap`` — v slices layers, not samples.
    """
    v = max(1, int(virtual_stages))
    if link_s <= 0.0:
        return max(1, k_cap)
    eta = stage_compute_s / link_s
    if eta >= 1.0:
        return max(1, k_cap)
    k = -(-int(np.floor(1.0 / (1.0 - eta))) // v)
    return int(np.clip(k, 1, max(k_cap, 1)))


def makespan_k(profile: LayerProfile, fleet: Fleet, l: int, b: np.ndarray,
               tau: np.ndarray, k_cap: int = 64, virtual_stages: int = 1):
    """Pick k by direct makespan minimization (robust fallback).

    Lemma 1 presumes the steady-state constraint C3 is satisfiable (BS compute
    per micro-batch >= every UE's uplink time).  In strongly comm-bound
    settings no k satisfies C3 and the lemma collapses to k=1, yet larger k
    still shrinks the makespan by overlapping the comm pipe with BS compute —
    exactly the paper's Fig 5 low-bandwidth regime.  We simply evaluate the
    event simulator over a small candidate set (at ``virtual_stages``
    interleave when v > 1).
    """
    active = b > 0
    cap = max(1, min(int(np.min(b[active])) if active.any() else 1, k_cap))
    cands = sorted({k for k in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
                    if k <= cap})
    best_k, best_ms = 1, np.inf
    for k in cands:
        t = task_times(profile, fleet, Plan(l=l, k=k, b=b, tau=tau))
        ms, _ = simulate_c2p2sl(t, k, virtual_stages=virtual_stages)
        if ms < best_ms - 1e-12:
            best_k, best_ms = k, ms
    return best_k, best_ms


def feasible_l(profile: LayerProfile, fleet: Fleet, b: np.ndarray):
    """Cut layers admissible under the storage bound C2 (13)."""
    out = []
    for l in range(1, profile.num_layers):
        if np.all(profile.ue_total(l) * b <= fleet.storage + 1e-9):
            out.append(l)
    return out or [1]


def solve_batch_p3(profile: LayerProfile, fleet: Fleet, l: int, k: int,
                   tau: np.ndarray, batch: int,
                   strict: bool = True) -> np.ndarray:
    """P3 (21): batch-size partition via LP relaxation + rounding.

    ``strict=False`` drops the steady-state rows (C3/C4~) which are jointly
    infeasible with C5 in strongly comm-bound settings; the objective
    (min t1+t2 = the pipeline warm-up/drain critical path) is unchanged.
    """
    n = fleet.n
    cF, cB, cU, cD, cBS = _coeffs(profile, fleet, l, k, tau)
    # A UE with no slot (tau_i = 0 after a zero-batch AO round) cannot
    # transmit: pin its batch to zero and keep the LP finite.
    dead = ~(np.isfinite(cU) & np.isfinite(cD))
    cU = np.where(dead, 0.0, cU)
    cD = np.where(dead, 0.0, cD)
    W = batch * cBS                     # t_b^F + t_b^B (depends on total b only)

    # Variables x = [b_1..b_n, t1, t2, t3, t4].
    nv = n + 4
    c = np.zeros(nv)
    c[n], c[n + 1] = 1.0, 1.0           # min t1 + t2
    # Tiny pressure on the comm-pipe epigraphs: in the comm-bound (soft)
    # regime the makespan is k*max_i t_i^U, which t1 alone under-weights.
    c[n + 2] = c[n + 3] = 1e-3 if strict else 1.0

    A_ub, b_ub = [], []

    def row(bi_coefs, t_idx=None, t_coef=0.0, rhs=0.0):
        r = np.zeros(nv)
        r[:n] = bi_coefs
        if t_idx is not None:
            r[n + t_idx] = t_coef
        A_ub.append(r)
        b_ub.append(rhs)

    for i in range(n):
        e = np.zeros(n)
        e[i] = 1.0
        row(e * profile.ue_total(l), rhs=fleet.storage[i])        # C2
        if strict:
            row(e * cF[i], rhs=W)                                 # C3 (compute)
            row(e * cU[i], rhs=W)                                 # C3 (uplink)
        row(e * (cF[i] + cU[i]), t_idx=0, t_coef=-1.0)            # C7
        row(e * (cD[i] + cB[i]), t_idx=1, t_coef=-1.0)            # C8
        row(e * cU[i], t_idx=2, t_coef=-1.0)                      # C9
        row(e * cD[i], t_idx=3, t_coef=-1.0)                      # C10
    if strict:
        # C4~: (k-1)(t3+t4) <= k W
        r = np.zeros(nv)
        r[n + 2] = r[n + 3] = (k - 1)
        A_ub.append(r)
        b_ub.append(k * W)

    A_eq = np.zeros((1, nv))
    A_eq[0, :n] = 1.0                                             # C5
    b_eq = np.array([float(batch)])

    bounds = [(0, 0) if dead[i] else (0, batch) for i in range(n)] \
        + [(0, None)] * 4
    res = linprog(c, A_ub=np.array(A_ub), b_ub=np.array(b_ub),
                  A_eq=A_eq, b_eq=b_eq, bounds=bounds, method="highs")
    if not res.success:
        if strict:
            return solve_batch_p3(profile, fleet, l, k, tau, batch,
                                  strict=False)
        return None
    b_star = res.x[:n]

    # Branch-and-bound shortcut: floor, then hand back the remainder one
    # sample at a time to the UE with the smallest marginal latency slope.
    b_int = np.floor(b_star).astype(int)
    slope = (cF + cU) + (cD + cB)
    slope = np.where(dead, np.inf, slope)     # never hand remainder to dead UEs
    order = np.argsort(slope)
    rem = batch - int(b_int.sum())
    j = 0
    while rem > 0:
        i = order[j % n]
        if profile.ue_total(l) * (b_int[i] + 1) <= fleet.storage[i]:
            b_int[i] += 1
            rem -= 1
        j += 1
        if j > 10 * n * batch:          # degenerate storage bounds
            b_int[order[0]] += rem
            break
    return b_int.astype(np.float64)


def solve_tau_p5(profile: LayerProfile, fleet: Fleet, l: int, k: int,
                 b: np.ndarray) -> np.ndarray:
    """P5 (23): slot allocation via the convex epigraph reformulation.

    tau_i enters every constraint as a lower bound g_i(t1..t4); the frame
    budget sum_i g_i <= T is a sum of maxima of convex terms, hence convex.
    After solving we distribute the leftover frame proportionally (more slot
    time never hurts).
    """
    n = fleet.n
    r_u, r_d = fleet.rates()
    T = fleet.channel.frame_s
    s_l = profile.cut_bytes(l) * 8.0
    s_0 = profile.label_bytes * 8.0
    a = b * (s_l + s_0) * T / (k * r_u)      # tau_i * t_i^U
    d = b * s_l * T / (k * r_d)              # tau_i * t_i^D
    tF = b * profile.ue_fwd(l) / (k * fleet.ue_flops)
    tB = b * profile.ue_bwd(l) / (k * fleet.ue_flops)
    W = b.sum() * (profile.bs_fwd(l) + profile.bs_bwd(l)) / (k * fleet.bs_flops)

    eps = 1e-9
    # C3~ (tau_i >= a_i / W) is jointly infeasible with the frame budget when
    # sum_i a_i/W > T (strongly comm-bound); drop it then, keeping the
    # objective's pressure toward small t1+t2.
    strict = float(np.sum(a / max(W, eps))) <= T

    def g(x):
        t1, t2, t3, t4 = x
        lb = np.maximum(a / np.maximum(t1 - tF, eps),
                        d / np.maximum(t2 - tB, eps))
        lb = np.maximum(lb, a / max(t3, eps))
        lb = np.maximum(lb, d / max(t4, eps))
        if strict:
            lb = np.maximum(lb, a / max(W, eps))                 # C3~
        return lb

    def frame_con(x):
        return T - float(np.sum(g(x)))

    def c4_con(x):
        if k <= 1 or not strict:
            return 1.0
        return k / (k - 1) * W - (x[2] + x[3])

    x0 = np.array([float(np.max(tF)) * 2 + 1e-3,
                   float(np.max(tB)) * 2 + 1e-3, W, W])
    # A feasible warm start: scale x0 up until the frame budget holds.
    for _ in range(60):
        if frame_con(x0) >= 0:
            break
        x0 = x0 * 1.5
    res = minimize(
        lambda x: x[0] + x[1], x0, method="SLSQP",
        constraints=[{"type": "ineq", "fun": frame_con},
                     {"type": "ineq", "fun": c4_con}],
        bounds=[(float(np.max(tF)) + 1e-6, None),
                (float(np.max(tB)) + 1e-6, None),
                (1e-6, None), (1e-6, None)],
        options={"maxiter": 200, "ftol": 1e-12})
    x = res.x if res.success else x0
    tau = g(x)
    slack = T - float(tau.sum())
    if slack > 0:
        w = (a + d)
        w = w / w.sum() if w.sum() > 0 else np.full(n, 1.0 / n)
        tau = tau + slack * w
    else:                                   # infeasible fit: scale into frame
        tau = tau * (T / float(tau.sum()))
    return tau


def algorithm1(profile: LayerProfile, fleet: Fleet, batch: int,
               eps: float = 1e-4, max_iters: int = 20,
               k_cap: int | None = 64,
               k_policy: str = "auto",
               v_cap: int = 1) -> AOResult:
    """Split-and-allocation AO (paper Algorithm 1).

    ``k_policy``:
      * ``"lemma1"``   — exactly the paper's Lemma 1;
      * ``"makespan"`` — argmin of the event simulator over k (robust);
      * ``"auto"``     — Lemma 1 when the steady-state regime is feasible
                         (eta < 1 gives k >= 2), makespan otherwise.

    ``v_cap`` > 1 extends subproblem 1 to the joint (l, k, v) trade:
    interleaved virtual-stage counts v in [1, v_cap] are enumerated
    alongside the cut layer, each with its own Lemma-1/makespan k, and
    the (l, k, v) triple minimizing the simulated makespan wins (the
    AC2P2SL-style adaptive-schedule direction; v_cap=1 is the paper's
    plain 1F1B).
    """
    n = fleet.n
    kc = k_cap or 64
    vc = max(1, int(v_cap))
    # Initialize: batch proportional to UE compute, uniform slots.
    w = fleet.ue_flops / fleet.ue_flops.sum()
    b = np.floor(w * batch)
    b[np.argmax(w)] += batch - b.sum()
    tau = np.full(n, fleet.channel.frame_s / n)

    def pick_k(cand_l, bb, tt, vv):
        k_lemma = lemma1_k(profile, fleet, cand_l, bb, tt, k_cap=kc,
                           virtual_stages=vv)
        if k_policy == "lemma1":
            return k_lemma
        if k_policy == "auto" and k_lemma > 1:
            return k_lemma
        k_ms, _ = makespan_k(profile, fleet, cand_l, bb, tt, k_cap=kc,
                             virtual_stages=vv)
        return k_ms

    l, k, v = 1, 1, 1
    history = []
    prev_br = np.inf
    for _ in range(max_iters):
        # --- subproblem 1: (l, k, v) — enumerate cuts x interleave ---
        best = (np.inf, np.inf, l, k, v)
        for cand_l in feasible_l(profile, fleet, b):
            for cand_v in range(1, vc + 1):
                cand_k = pick_k(cand_l, b, tau, cand_v)
                t = task_times(profile, fleet,
                               Plan(l=cand_l, k=cand_k, b=b, tau=tau))
                ms, _ = simulate_c2p2sl(t, cand_k, virtual_stages=cand_v)
                br = bubble_rate(t, cand_k, cand_v)
                if ms < best[0] - 1e-12:
                    best = (ms, br, cand_l, cand_k, cand_v)
        _, _, l, k, v = best
        # --- subproblem 2: b ---
        nb = solve_batch_p3(profile, fleet, l, k, tau, batch)
        if nb is not None:
            b = nb
        # --- subproblem 3: tau ---
        tau = solve_tau_p5(profile, fleet, l, k, b)
        # re-pick k after b/tau moved (v held from subproblem 1)
        k = pick_k(l, b, tau, v)

        t = task_times(profile, fleet, Plan(l=l, k=k, b=b, tau=tau))
        br = bubble_rate(t, k, v)
        history.append(br)
        if abs(prev_br - br) <= eps:
            break
        prev_br = br

    plan = Plan(l=l, k=k, b=b, tau=tau, v=v)
    t = task_times(profile, fleet, plan)
    return AOResult(plan=plan, bubble=bubble_rate(t, k, v),
                    history=history, times=t)
