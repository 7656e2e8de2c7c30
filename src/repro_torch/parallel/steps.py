"""The training step: loss, gradients (micro-batched or pipelined), AdamW.

Port of the training half of the JAX package's ``parallel/steps.py``.
There is no jit: the step runs eagerly, and updates the state IN PLACE
(parameters and optimizer state, see ``training/optim.py``).
"""
from __future__ import annotations

from repro_torch.training.microbatch import microbatched_value_and_grad
from repro_torch.training.optim import Optimizer


def make_lm_loss(model):
    def loss_fn(params, batch):
        return model.forward(params, batch)
    return loss_fn


def make_lm_train_step(model, opt: Optimizer, *, microbatches: int = 1,
                       pipeline=None):
    """Build ``train_step(state, batch) -> (state, metrics)`` with
    ``state = {"params", "opt_state", "step"}``.

    ``microbatches`` is the paper's k (gradient accumulation, the same
    update as the full batch).  ``pipeline`` is a ``PipelineSpec`` that
    runs the block stack as the C²P²SL pipeline with a coded hop between
    stages instead; its wire bytes accumulate in ``train_step.meter``.
    """
    meter = None
    if pipeline is not None:
        if microbatches != 1:
            raise ValueError(
                "microbatches (gradient accumulation) and pipeline are "
                "mutually exclusive: the pipeline micro-batches with its "
                "own k")
        from repro_torch.parallel.pipeline import make_pipelined_loss
        loss_fn = make_pipelined_loss(model, pipeline)
        meter = loss_fn.meter
        vg = microbatched_value_and_grad(loss_fn, 1)
    else:
        vg = microbatched_value_and_grad(make_lm_loss(model), microbatches)

    def train_step(state, batch):
        params = state["params"]
        (loss, mets), grads = vg(params, batch)
        params, opt_state = opt.update(grads, state["opt_state"], params,
                                       state["step"])
        mets = dict(mets, loss=loss)
        return {"params": params, "opt_state": opt_state,
                "step": state["step"] + 1}, mets

    train_step.meter = meter
    return train_step
