"""Baseline training schemes: SL [4], PSL [7], EPSL [8].

Port of the JAX package's ``sl/baselines.py``.  Computation semantics:
  * SL   — strictly sequential: UE i trains (with the BS) on its own batch,
           parameters update after EVERY UE's turn (n updates per round);
           each turn sees the parameters the previous turn's in-place
           update left (``training/optim.py``).
  * PSL  — all UEs in parallel on the shared BS model; one update per batch
           (identical update to C²P²SL with k=1 — C²P²SL's equivalence
           baseline).
  * EPSL — PSL with last-layer gradient aggregation: the downlink activation
           gradient is replaced by its per-UE batch mean (volume /b_i),
           which is the paper's accuracy-for-time tradeoff.

Timing comes from the schedule simulators of ``core/schedule.py``.
"""
from __future__ import annotations

import torch

from repro_torch.sl.c2p2sl import make_c2p2sl_step
from repro_torch.sl.split import SplitSpec
from repro_torch.training.optim import Optimizer
from repro_torch.utils.trees import tree_leaves, tree_unflatten


def make_psl_step(spec: SplitSpec, opt: Optimizer):
    """PSL == C²P²SL with k=1 (no pipelining)."""
    return make_c2p2sl_step(spec, opt, k=1)


def make_epsl_step(spec: SplitSpec, opt: Optimizer, k: int = 1):
    return make_c2p2sl_step(spec, opt, k=k, epsl_aggregate=True)


def make_sl_step(spec: SplitSpec, opt: Optimizer):
    """Sequential SL: per-UE update, one UE after another.  The metrics
    are the last trained UE's."""

    def step(state_tree, xs, ys):
        ue_params = state_tree["ue_params"]
        bs_params = state_tree["bs_params"]
        stp = state_tree["step"]
        ue_leaves, bs_leaves = tree_leaves(ue_params), tree_leaves(bs_params)
        for p in ue_leaves + bs_leaves:
            p.requires_grad_(True)
        loss_last = torch.zeros(())
        mets_last = {}
        for i in range(len(xs)):
            # shard_batch yields k (possibly ragged/empty) micro-batches
            # per UE; sequential SL trains on the UE's whole allocation
            x, y = torch.cat(list(xs[i])), torch.cat(list(ys[i]))
            if x.shape[0] == 0:
                continue                 # zero-batch UE: no local update
            loss, mets = spec.bs_loss(bs_params, spec.ue_fwd(ue_params, x), y)
            gs = torch.autograd.grad(loss, ue_leaves + bs_leaves,
                                     allow_unused=True)
            gs = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(ue_leaves + bs_leaves, gs)]
            n_ue = len(ue_leaves)
            opt.update(tree_unflatten(ue_params, gs[:n_ue]),
                       state_tree["opt_state_ue"], ue_params, stp)
            opt.update(tree_unflatten(bs_params, gs[n_ue:]),
                       state_tree["opt_state_bs"], bs_params, stp)
            loss_last = loss.detach()
            mets_last = {n: v.detach() for n, v in mets.items()}
        return dict(state_tree, step=stp + 1), dict(mets_last, loss=loss_last)

    return step
