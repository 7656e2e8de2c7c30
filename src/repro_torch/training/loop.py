"""Generic train loop: state, step builder, checkpointing hooks.

Port of the JAX package's ``training/loop.py``.  The step runs eagerly and
updates the state in place (``training/optim.py``); ``step`` is a Python
int.  ``fit`` keeps the reference's hooks and history rows: a row every
``log_every`` steps (each metric as a float, ``step``, ``wall_s``), a
checkpoint every ``ckpt_every`` steps followed by ``prune``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.microbatch import microbatched_value_and_grad
from repro_torch.training.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int

    def tree(self) -> dict:
        return {"params": self.params, "opt_state": self.opt_state,
                "step": self.step}

    @classmethod
    def from_tree(cls, t) -> "TrainState":
        return cls(params=t["params"], opt_state=t["opt_state"],
                   step=int(t["step"]))


def init_state(params, opt: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def make_train_step(loss_fn: Callable, opt: Optimizer,
                    microbatches: int = 1):
    """Build ``step(state_tree, batch) -> (state_tree, metrics)``.

    ``microbatches`` > 1 turns on the paper's gradient accumulation (the
    same update as the full batch)."""
    vg = microbatched_value_and_grad(loss_fn, microbatches)

    def step(state_tree, batch):
        params = state_tree["params"]
        (loss, mets), grads = vg(params, batch)
        new_params, new_opt = opt.update(grads, state_tree["opt_state"],
                                         params, state_tree["step"])
        new_state = {"params": new_params, "opt_state": new_opt,
                     "step": state_tree["step"] + 1}
        mets = dict(mets)
        mets["loss"] = loss
        return new_state, mets

    return step


def fit(state: TrainState, step_fn, data_iter, *, steps: int,
        ckpt_dir: str | None = None, ckpt_every: int = 0,
        log_every: int = 50, metrics_cb=None):
    """Run ``steps`` steps from ``state``; checkpoint periodically.
    Returns ``(state, history)``."""
    tree = state.tree()
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = next(data_iter)
        tree, mets = step_fn(tree, batch)
        if log_every and (i + 1) % log_every == 0:
            row = {k: float(v) for k, v in mets.items()}
            row["step"] = i + 1
            row["wall_s"] = time.perf_counter() - t0
            history.append(row)
            if metrics_cb:
                metrics_cb(row)
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, i + 1, tree)
            ckpt_lib.prune(ckpt_dir)
    return TrainState.from_tree(tree), history


def resume_or_init(state: TrainState, ckpt_dir: str | None,
                   device=None) -> TrainState:
    """Restart from the newest checkpoint in ``ckpt_dir``, or ``state``
    when there is none."""
    if not ckpt_dir:
        return state
    step = ckpt_lib.latest_step(ckpt_dir)
    if step is None:
        return state
    tree = ckpt_lib.restore(ckpt_dir, step, state.tree(), device=device)
    return TrainState.from_tree(tree)
