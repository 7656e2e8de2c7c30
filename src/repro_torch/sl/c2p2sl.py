"""The C²P²SL trainer: split training with micro-batch pipelining.

Port of the JAX package's ``sl/c2p2sl.py``, the paper's faithful runtime
(SII-C): per micro-batch m and UE i,

    UE FP:  a_{i,m} = f_ue(theta_ue, x_{i,m})       (graph kept for UE BP)
    UT:     a_{i,m}, y_{i,m} -> BS
    BS FP+BP: loss over the aggregated micro-batch; grads wrt
            (theta_bs, a_{.,m})
    DT:     da_{i,m} -> UE i
    UE BP:  pull da_{i,m} back through UE i's graph -> dtheta_ue

Gradients accumulate over the k micro-batches, weighted by sample counts,
and the optimizer runs once per batch: the same update as full-batch
split learning.  The state is updated IN PLACE (``training/optim.py``).
Computation is real; *time* comes from the event-driven schedule
simulator (``core/schedule.py``) through ``batch_wall_time``, in seconds
of the paper's Table I system model, since a host clock on one card
cannot reproduce a radio network.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.schedule import Plan, simulate_c2p2sl, task_times
from repro_torch.sl.split import SplitSpec
from repro_torch.training.optim import Optimizer
from repro_torch.utils.trees import tree_leaves, tree_unflatten


@dataclasses.dataclass
class SLState:
    ue_params: Any
    bs_params: Any
    opt_state_ue: Any
    opt_state_bs: Any
    step: int


def init_sl_state(spec: SplitSpec, full_params, opt: Optimizer) -> SLState:
    ue, bs = spec.split_params(full_params)
    return SLState(ue_params=ue, bs_params=bs, opt_state_ue=opt.init(ue),
                   opt_state_bs=opt.init(bs), step=0)


def make_c2p2sl_step(spec: SplitSpec, opt: Optimizer, k: int,
                     epsl_aggregate: bool = False):
    """One C²P²SL batch step ``step(state_tree, xs, ys) -> (state_tree,
    metrics)`` with ``state_tree`` the fields of ``SLState`` as a dict.

    ``xs``/``ys`` are the ``shard_batch`` layout: ``[n_ue][k]`` tensors of
    ``b_{i,m}`` rows, possibly ragged, possibly empty.
    ``epsl_aggregate=True`` is the EPSL baseline: activation gradients are
    mean-aggregated over each UE's micro-batch before the downlink.
    """

    def _grads(out, leaves, grad_outputs=None):
        gs = torch.autograd.grad(out, leaves, grad_outputs=grad_outputs,
                                 allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)]

    def batch_grads(ue_params, bs_params, xs, ys):
        ue_leaves, bs_leaves = tree_leaves(ue_params), tree_leaves(bs_params)
        for p in ue_leaves + bs_leaves:
            p.requires_grad_(True)
        ue_acc = [torch.zeros_like(p, dtype=torch.float32) for p in ue_leaves]
        bs_acc = [torch.zeros_like(p, dtype=torch.float32) for p in bs_leaves]
        n_ue = len(xs)
        total = float(sum(int(xs[i][m].shape[0])
                          for i in range(n_ue) for m in range(k)))
        loss_acc, met_acc = None, None
        for m in range(k):                     # micro-batch pipeline order
            # zero-sized micro-batches carry no samples: skipped
            live = [i for i in range(n_ue) if xs[i][m].shape[0] > 0]
            if not live:
                continue
            # --- UE FP (all UEs), graphs kept for the UE BP ---
            acts = [spec.ue_fwd(ue_params, xs[i][m]) for i in live]
            # --- UT: aggregate at the BS ---
            agg = torch.cat([a.detach() for a in acts]).requires_grad_(True)
            labels = torch.cat([ys[i][m] for i in live])
            w_m = agg.shape[0] / total             # sample-weighted average
            # --- BS FP + BP ---
            loss, mets = spec.bs_loss(bs_params, agg, labels)
            *dbs, dagg = _grads(loss, bs_leaves + [agg])
            for acc, g in zip(bs_acc, dbs):
                acc.add_(g, alpha=w_m)
            loss = loss.detach() * w_m
            mets = {n: v.detach() * w_m for n, v in mets.items()}
            loss_acc = loss if loss_acc is None else loss_acc + loss
            met_acc = mets if met_acc is None else \
                {n: met_acc[n] + v for n, v in mets.items()}
            # --- DT + UE BP ---
            offs = 0
            for a in acts:
                da = dagg[offs:offs + a.shape[0]]
                offs += a.shape[0]
                if epsl_aggregate:
                    da = da.mean(dim=0, keepdim=True).expand_as(da)
                for acc, g in zip(ue_acc, _grads(a, ue_leaves, da)):
                    acc.add_(g, alpha=w_m)
        return (loss_acc, tree_unflatten(ue_params, ue_acc),
                tree_unflatten(bs_params, bs_acc), met_acc)

    def step(state_tree, xs, ys):
        loss, dg_ue, dg_bs, mets = batch_grads(
            state_tree["ue_params"], state_tree["bs_params"], xs, ys)
        new_ue, opt_ue = opt.update(dg_ue, state_tree["opt_state_ue"],
                                    state_tree["ue_params"],
                                    state_tree["step"])
        new_bs, opt_bs = opt.update(dg_bs, state_tree["opt_state_bs"],
                                    state_tree["bs_params"],
                                    state_tree["step"])
        mets = dict(mets, loss=loss)
        return {"ue_params": new_ue, "bs_params": new_bs,
                "opt_state_ue": opt_ue, "opt_state_bs": opt_bs,
                "step": state_tree["step"] + 1}, mets

    return step


def shard_batch(batch_x, batch_y, b: np.ndarray, k: int):
    """Split a host batch into per-UE sequences of k micro-batches.

    Every sample is used exactly once and the lists have one entry per UE
    in ``b``'s order (zero-batch UEs get k empty micro-batches).  Per-UE
    sizes need not be multiples of k: the remainder ``b_i % k`` is spread
    one sample each over the first micro-batches.  If ``sum(b) !=
    len(batch_x)``, the difference is absorbed by the largest
    allocations, never driving any b_i below zero.

    Returns ``(xs, ys)`` with ``xs[i]`` a list of k arrays shaped
    ``[b_{i,m}, ...]`` where ``sum_m b_{i,m} == b_i``.
    """
    if k < 1:
        raise ValueError(f"micro-batch count k={k} must be >= 1")
    b = np.asarray(b, dtype=int).copy()
    if (b < 0).any():
        raise ValueError(f"negative UE allocation in {b}")
    n = batch_x.shape[0]
    diff = n - int(b.sum())
    while diff != 0:
        i = int(np.argmax(b))
        step = diff if diff > 0 else max(-int(b[i]), diff)
        b[i] += step
        diff -= step
    xs, ys, off = [], [], 0
    for bi in b:
        base, rem = divmod(int(bi), k)
        sizes = [base + 1] * rem + [base] * (k - rem)
        xi, yi = [], []
        for s in sizes:
            xi.append(batch_x[off:off + s])
            yi.append(batch_y[off:off + s])
            off += s
        xs.append(xi)
        ys.append(yi)
    return xs, ys


def batch_wall_time(profile, fleet, plan: Plan) -> float:
    """Simulated wall time of one C²P²SL batch under the plan.

    Honors ``plan.v`` (interleaved virtual stages, AO-selected when
    ``algorithm1(..., v_cap>1)``): compute is v-independent — gradient
    accumulation over k micro-batches is identical math at any chunking
    — so only the simulated schedule time changes.
    """
    t = task_times(profile, fleet, plan)
    ms, _ = simulate_c2p2sl(t, plan.k, virtual_stages=plan.v)
    return ms
