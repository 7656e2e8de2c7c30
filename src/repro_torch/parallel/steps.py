"""The training step: loss, gradients (micro-batched or pipelined), AdamW.

Port of the training half of the JAX package's ``parallel/steps.py``.
There is no jit: the step runs eagerly, and updates the state IN PLACE
(parameters and optimizer state, see ``training/optim.py``).
"""
from __future__ import annotations

from repro_torch.training.compress import compress_grads_
from repro_torch.training.microbatch import microbatched_value_and_grad
from repro_torch.training.optim import Optimizer


def make_lm_loss(model):
    def loss_fn(params, batch):
        return model.forward(params, batch)
    return loss_fn


def make_lm_train_step(model, opt: Optimizer, *, microbatches: int = 1,
                       pipeline=None, compress: bool = False):
    """Build ``train_step(state, batch) -> (state, metrics)`` with
    ``state = {"params", "opt_state", "step"}``.

    ``microbatches`` is the paper's k (gradient accumulation, the same
    update as the full batch).  ``pipeline`` is a ``PipelineSpec`` that
    runs the block stack as the C²P²SL pipeline with a coded hop between
    stages instead; its wire bytes accumulate in ``train_step.meter``.
    Under a top-k codec at S > 1 the state carries the hop's
    error-feedback buffer ``state["wire_ef"]`` (``wire_ef_zeros``).
    ``compress`` passes the gradients through ``compress_grads`` and
    ``decompress_grads`` (int8 blocks with error feedback; in place,
    ``compress_grads_``) before the update; the state then carries
    ``state["error_fb"]`` (``init_error_fb``).  Both buffers are updated
    in place, as the parameters are.
    """
    meter, needs_wire_ef = None, False
    if pipeline is not None:
        if microbatches != 1:
            raise ValueError(
                "microbatches (gradient accumulation) and pipeline are "
                "mutually exclusive: the pipeline micro-batches with its "
                "own k")
        from repro_torch.parallel.pipeline import make_pipelined_loss
        loss_fn = make_pipelined_loss(model, pipeline)
        meter, needs_wire_ef = loss_fn.meter, loss_fn.needs_wire_ef
        microbatches = 1
    else:
        loss_fn = make_lm_loss(model)

    def train_step(state, batch):
        params = state["params"]
        fn = loss_fn
        if needs_wire_ef:
            # the hops' backward writes the new residuals into the buffer
            fn = lambda p, b: loss_fn(p, b, state["wire_ef"])  # noqa: E731
        (loss, mets), grads = microbatched_value_and_grad(
            fn, microbatches)(params, batch)
        new_state = {}
        if needs_wire_ef:
            new_state["wire_ef"] = state["wire_ef"]
        if compress:
            compress_grads_(grads, state["error_fb"])
            new_state["error_fb"] = state["error_fb"]
        params, opt_state = opt.update(grads, state["opt_state"], params,
                                       state["step"])
        mets = dict(mets, loss=loss)
        new_state.update(params=params, opt_state=opt_state,
                         step=state["step"] + 1)
        return new_state, mets

    train_step.meter = meter
    return train_step
