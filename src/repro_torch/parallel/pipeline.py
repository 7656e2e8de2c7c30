"""C²P²SL's micro-batch pipeline of the block stack, on one card.

Port of the JAX package's ``parallel/pipeline.py``.  The first L/S layers
are stage 0 (the UE-side model), the next L/S stage 1, and so on; each
batch is split into k micro-batches that stream through the stages, with
the cut activation crossing each stage boundary through the coded hop
(``parallel/wire.py::CodedHop``: ``PipelineSpec.wire_dtype`` none, int8
or fp8, the gradient coded the same way on the way back).  Gradients
accumulate over the k micro-batches.

On one card the stages run one after the other, so the reference's tick
timetable (the 1F1B schedule over the pod axis, ``_tick_loop``) is not
needed for the result: the loss and the gradients are the schedule's,
which the reference's own tests hold equal to the unpipelined step.  What
the timetable buys is overlap between stages on different devices; that
is the schedule simulator's business (``core/schedule.py``).
``PipelineSpec.auto_k`` picks k by the paper's Lemma 1.  Interleaved
virtual stages (v > 1) and top-k codecs are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.ao import pipeline_k_auto
from repro_torch.models.common import apply_norm
from repro_torch.models.lm import run_blocks, unstack
from repro_torch.parallel import wire


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    num_stages: int = 2          # S: UE-side / BS-side (extensible)
    microbatches: int = 4        # k
    virtual_stages: int = 1      # v: interleaved model chunks per stage
    wire_dtype: str = "none"     # hop codec: none | int8 | fp8

    def __post_init__(self):
        object.__setattr__(self, "wire_dtype",
                           wire.validate_wire_dtype(self.wire_dtype))
        if self.num_stages < 1 or self.microbatches < 1:
            raise ValueError(f"num_stages={self.num_stages} and "
                             f"microbatches={self.microbatches} must be >= 1")
        if self.virtual_stages != 1:
            raise NotImplementedError(
                f"virtual_stages={self.virtual_stages}: interleaved "
                "scheduling is not ported yet (v = 1 only)")
        if wire.parse_wire_dtype(self.wire_dtype)[1] is not None:
            raise NotImplementedError(
                f"wire_dtype {self.wire_dtype!r}: top-k codecs are not "
                "ported yet (none | int8 | fp8)")

    @classmethod
    def auto_k(cls, stage_compute_s: float, link_s: float, *,
               num_stages: int = 2, virtual_stages: int = 1,
               k_cap: int = 16):
        """Spec with k chosen by the paper's Lemma 1 closed form
        (``core/ao.py::pipeline_k_auto``) from per-stage compute time and
        inter-stage link time; interleaving (v > 1) divides the k needed
        to reach the steady state (and raises here, as v > 1 does)."""
        k = pipeline_k_auto(stage_compute_s, link_s, k_cap=k_cap,
                            virtual_stages=virtual_stages)
        return cls(num_stages=num_stages, microbatches=k,
                   virtual_stages=virtual_stages)


def _split_stages(layers: list, num_stages: int, virtual_stages: int = 1):
    """L per-layer block trees -> ``out[s][j]``, the list of L/(S*v)
    consecutive layers of model chunk ``c = j*S + s`` (layers
    ``[c*Lc, (c+1)*Lc)``): the reference's round-robin placement, which
    it keeps as stacked ``[S, v, L/(S*v), ...]`` leaves."""
    chunks = num_stages * virtual_stages
    n = len(layers)
    if n % chunks:
        raise ValueError(
            f"num_layers {n} not divisible by num_stages x virtual_stages "
            f"= {num_stages} x {virtual_stages} = {chunks} model chunks — "
            "pick S*v dividing the layer count")
    lc = n // chunks
    return [[layers[(j * num_stages + s) * lc:(j * num_stages + s + 1) * lc]
             for j in range(virtual_stages)] for s in range(num_stages)]


def make_pipelined_loss(model, spec: PipelineSpec):
    """``loss_fn(params, batch) -> (loss, metrics)`` with the block stack
    run as the S-stage, k-micro-batch pipeline.

    A batch whose size is not a multiple of k is padded with zero rows to
    ``k * ceil(b / k)``, as the reference does; the pad rows are dropped
    before the loss, so the cross entropy is the unpadded batch's.  The
    hop's wire bytes accumulate in ``loss_fn.meter``.
    """
    cfg = model.cfg
    if not cfg.homogeneous:
        raise ValueError(f"pipeline mode needs a homogeneous layer stack; "
                         f"{cfg.name} has a mixed pattern")
    k, n_stages = spec.microbatches, spec.num_stages
    meter = wire.HopMeter()

    def loss_fn(params, batch):
        x = model._embed(params, batch["tokens"], model.dtype)
        b, seq, d = x.shape
        pad_rows = (-b) % k
        if pad_rows:
            x = torch.cat([x, x.new_zeros((pad_rows, seq, d))])
        xs = x.reshape(k, (b + pad_rows) // k, seq, d)
        stages = [chunks[0] for chunks in _split_stages(
            unstack(params["blocks"], x.dtype), n_stages)]
        outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for m in range(k):
            h = xs[m]
            for s, stage in enumerate(stages):
                if s > 0:
                    h = wire.coded_hop(h, spec.wire_dtype, meter)
                h, a = run_blocks(cfg, stage, h)
                aux = aux + a
            outs.append(h)
        h = torch.cat(outs)[:b]
        h = apply_norm(h, params["final_norm"], cfg.norm)
        loss = model.xent(params, h, batch["labels"])
        aux = aux / k
        return loss + 0.01 * aux, {"xent": loss, "aux": aux}

    loss_fn.meter = meter
    return loss_fn
