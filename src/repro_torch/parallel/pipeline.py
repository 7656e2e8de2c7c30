"""C²P²SL's micro-batch pipeline of the block stack, on one card.

Port of the JAX package's ``parallel/pipeline.py``.  The layer stack
splits into S·v model chunks of L/(S·v) consecutive layers; chunk c lives
on stage c mod S (round-robin, ``_split_stages``), so with v = 1 the first
L/S layers are stage 0 (the UE-side model), the next L/S stage 1, and so
on.  Each batch is split into k micro-batches; each micro-batch runs the
chunks c = 0 … S·v−1 in order, and at S > 1 the cut activation crosses
each of the S·v − 1 chunk boundaries through the coded hop (``parallel/wire.py``:
``PipelineSpec.wire_dtype`` none, int8 or fp8, the gradient coded the same
way on the way back, or ``<base>+topk<frac>``, whose gradient hop is top-k
with error feedback).  Gradients accumulate over the k micro-batches.

On one card the chunks run one after the other, so the reference's tick
timetable (the interleaved 1F1B schedule over the pod axis,
``_tick_loop``) is not needed for the result: the loss and the gradients
are the schedule's, which the reference's own tests hold equal to the
unpipelined step.  What the timetable buys is overlap between stages on
different devices; that is the schedule simulator's business
(``core/schedule.py``).  The timetable still names the error-feedback
slots: chunk c of micro-batch m runs at tick ``_sigma(m) + c`` on stage
c mod S, and the hop after it keeps its residual in slot
``[(c + 1) mod S, _sigma(m) + c]`` of the ``[S, ticks, mb, seq, d]``
buffer (``wire_ef_zeros``), the receiving stage's slot at that tick, as
the reference's backward rule runs on the receiving device.  The other
slots see no gradient and stay zero.  ``PipelineSpec.auto_k`` picks k by
the paper's Lemma 1.

An encoder-decoder (the audio family) runs its encoder once over the whole
batch, pads the memory with the zero rows that pad ``x`` and hands
micro-batch m's memory to every chunk's "xattn" layers, as the reference
hands it to every stage outside the hop: the hop, its codec and its
bytes carry the cut activation ``h`` alone.
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
    wire_dtype: str = "none"     # hop codec: none | int8 | fp8 | +topk

    def __post_init__(self):
        object.__setattr__(self, "wire_dtype",
                           wire.validate_wire_dtype(self.wire_dtype))
        if min(self.num_stages, self.microbatches, self.virtual_stages) < 1:
            raise ValueError(
                f"num_stages={self.num_stages}, microbatches="
                f"{self.microbatches} and virtual_stages="
                f"{self.virtual_stages} must be >= 1")

    @classmethod
    def from_plan(cls, plan) -> "PipelineSpec":
        """The ``Plan -> PipelineSpec`` constructor.

        ``plan`` is the planner's cell (``analysis/autotune.Plan``); a
        plan fixed at launch and one the re-planner switches to
        (``training/replan.py``) construct alike."""
        from repro_torch.analysis.autotune import Plan
        if not isinstance(plan, Plan):
            raise TypeError(
                f"from_plan expects an autotune.Plan, got "
                f"{type(plan).__name__} — build one with Plan(stages=..., "
                "k=..., v=..., wire_dtype=...) or Plan.from_json")
        return cls(num_stages=plan.stages, microbatches=plan.k,
                   virtual_stages=plan.v, wire_dtype=plan.wire_dtype)

    @property
    def plan(self):
        """This spec as the planner's cell (inverse of ``from_plan``)."""
        from repro_torch.analysis.autotune import Plan
        return Plan(stages=self.num_stages, k=self.microbatches,
                    v=self.virtual_stages, wire_dtype=self.wire_dtype)

    @classmethod
    def auto_k(cls, stage_compute_s: float, link_s: float, *,
               num_stages: int = 2, virtual_stages: int = 1,
               k_cap: int = 16):
        """Spec with k chosen by the paper's Lemma 1 closed form
        (``core/ao.py::pipeline_k_auto``) from per-stage compute time and
        inter-stage link time; interleaving (v > 1) divides the k needed
        to reach the steady state."""
        k = pipeline_k_auto(stage_compute_s, link_s, k_cap=k_cap,
                            virtual_stages=virtual_stages)
        return cls(num_stages=num_stages, microbatches=k,
                   virtual_stages=virtual_stages)

    @classmethod
    def auto_plan(cls, inputs, *, k_fixed: int | None = None,
                  v_fixed: int | None = None, wire_dtype: str | None = None):
        """Spec with (k, v[, codec]) chosen by the training planner over
        ``inputs`` (``analysis/autotune.PlanInputs``; the reference's
        dry-run records are not ported).  ``k_fixed`` / ``v_fixed`` pin
        one coordinate; ``wire_dtype`` pins the codec, or ``'auto'``
        enumerates ``WIRE_AUTO`` jointly with (k, v).  Returns ``(spec,
        AutoPlan)``."""
        from repro_torch.analysis import autotune
        wire_candidates = None
        if wire_dtype == "auto":
            wire_candidates = list(autotune.WIRE_AUTO)
        elif wire_dtype is not None:
            inputs = inputs.with_wire(wire_dtype)
        plan = autotune.choose_plan(inputs, k_fixed=k_fixed, v_fixed=v_fixed,
                                    wire_candidates=wire_candidates)
        return cls.from_plan(plan.plan), plan


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


def _sigma(m: int, num_stages: int, virtual_stages: int) -> int:
    """Pipeline-entry tick of micro-batch m (interleaved spacing): groups
    of S micro-batches enter back to back, groups S·v ticks apart; v = 1
    gives ``sigma(m) = m``."""
    return (m // num_stages) * num_stages * virtual_stages \
        + (m % num_stages)


def wire_ef_ticks(spec: PipelineSpec) -> int:
    """Tick count of one batch's schedule — the EF buffer's slot axis."""
    return _sigma(spec.microbatches - 1, spec.num_stages,
                  spec.virtual_stages) + spec.num_stages * spec.virtual_stages


def wire_ef_zeros(cfg, spec: PipelineSpec, batch: int, seq: int,
                  device=None):
    """Zero error-feedback buffer of a top-k wire codec: f32 [S, ticks,
    mb, seq, d_model], one residual slot per (stage, tick) of the static
    schedule, with ``mb = ceil(batch / k)`` as ``make_pipelined_loss``
    pads a ragged batch, and ``seq`` the token count plus a vlm's patch
    prefix, which the hop carries.  None when the codec carries no
    top-k, or at S = 1, where there is no hop."""
    if spec.num_stages <= 1 or not wire.has_topk(spec.wire_dtype):
        return None
    k = spec.microbatches
    mb = (batch + (-batch) % k) // k
    seq_total = seq + (cfg.num_patches if cfg.family == "vlm" else 0)
    return torch.zeros((spec.num_stages, wire_ef_ticks(spec), mb, seq_total,
                        cfg.d_model), dtype=torch.float32, device=device)


def make_pipelined_loss(model, spec: PipelineSpec):
    """``loss_fn(params, batch) -> (loss, metrics)`` with the block stack
    run as the S-stage, v-chunk, k-micro-batch pipeline; under a top-k
    codec at S > 1, ``loss_fn(params, batch, wire_ef)``, whose backward
    updates the EF buffer ``wire_ef`` in place (``loss_fn.needs_wire_ef``).

    A batch whose size is not a multiple of k is padded with zero rows to
    ``k * ceil(b / k)``, as the reference does; the pad rows are dropped
    before the loss, so the cross entropy is the unpadded batch's.  A
    vlm's patch prefix is put before the tokens first (``LM._with_prefix``),
    so every hop carries its rows too.  The hop's wire bytes accumulate in
    ``loss_fn.meter``.
    """
    cfg = model.cfg
    if not cfg.homogeneous:
        raise ValueError(f"pipeline mode needs a homogeneous layer stack; "
                         f"{cfg.name} has a mixed pattern")
    k, n_stages, v = spec.microbatches, spec.num_stages, spec.virtual_stages
    needs_ef = n_stages > 1 and wire.has_topk(spec.wire_dtype)
    meter = wire.HopMeter()

    def _loss(params, batch, wire_ef):
        x = model._embed(params, batch["tokens"], model.dtype)
        x, labels, prefix_len = model._with_prefix(batch, x, batch["labels"])
        enc = model._encoder_memory(params, batch)
        b, seq, d = x.shape
        pad_rows = (-b) % k
        if pad_rows:
            x = torch.cat([x, x.new_zeros((pad_rows, seq, d))])
            if enc is not None:
                enc = torch.cat([enc, enc.new_zeros((pad_rows,)
                                                    + enc.shape[1:])])
        xs = x.reshape(k, (b + pad_rows) // k, seq, d)
        encs = None if enc is None else enc.reshape(
            (k, xs.shape[1]) + enc.shape[1:])
        if needs_ef:
            want = (n_stages, wire_ef_ticks(spec)) + tuple(xs.shape[1:])
            if wire_ef is None or tuple(wire_ef.shape) != want:
                raise ValueError(
                    f"wire_ef {None if wire_ef is None else tuple(wire_ef.shape)}"
                    f" != expected {want} ([S, ticks, mb, seq, d] — build "
                    "it with pipeline.wire_ef_zeros for this spec and "
                    "batch shape)")
        staged = _split_stages(unstack(params["blocks"], x.dtype), n_stages, v)
        chunks = [staged[c % n_stages][c // n_stages]
                  for c in range(n_stages * v)]
        outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for m in range(k):
            h, t0 = xs[m], _sigma(m, n_stages, v)
            for c, chunk in enumerate(chunks):
                if c > 0 and n_stages > 1:   # S = 1: the chain stays local
                    ef = wire_ef[c % n_stages, t0 + c - 1] if needs_ef \
                        else None
                    h = wire.coded_hop(h, spec.wire_dtype, meter, ef)
                h, a = run_blocks(cfg, chunk, h, enc_out=None
                                  if encs is None else encs[m],
                                  prefix_len=prefix_len)
                aux = aux + a
            outs.append(h)
        h = torch.cat(outs)[:b]
        h = apply_norm(h, params["final_norm"], cfg.norm)
        loss = model.xent(params, h, labels)
        aux = aux / k
        return loss + 0.01 * aux, {"xent": loss, "aux": aux}

    if needs_ef:
        def loss_fn(params, batch, wire_ef):
            return _loss(params, batch, wire_ef)
    else:
        def loss_fn(params, batch):
            return _loss(params, batch, None)
    loss_fn.meter = meter
    loss_fn.needs_wire_ef = needs_ef
    return loss_fn
