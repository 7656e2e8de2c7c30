"""The port's interleaved pipeline, its top-k hop with error feedback and
gradient compression, on the CPU without JAX.

The reference holds these paths in ``test_torch_topk.py``; here the
pipeline with a raw hop is held to the port's own unpipelined step (1e-5
on the loss and the updated parameters, the bound the port holds its f32
model to), the EF buffer's slot pattern to the schedule's formula, the
hop bytes to the bills exactly, and the training CLI runs the whole path.
The smoke configs have 2 layers; S 2 × v 2 needs 4, so the tests widen
the smoke qwen's depth to 4 (``CFG4``).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchSpec
from repro_torch.data.synthetic import TokenTaskConfig, token_batches
from repro_torch.launch import train
from repro_torch.models.lm import LM
from repro_torch.parallel import pipeline
from repro_torch.parallel.steps import make_lm_train_step
from repro_torch.runtime import protocol
from repro_torch.training import compress, optim
from repro_torch.utils.trees import tree_leaves, tree_map

QWEN = get_arch("qwen1.5-4b")
CFG4 = dataclasses.replace(QWEN.smoke, num_layers=4)
SEQ = 12


def _batch(rows: int, seed: int = 3):
    b = next(token_batches(TokenTaskConfig(vocab=CFG4.vocab), rows, SEQ,
                           seed=seed))
    return {n: torch.as_tensor(a) for n, a in b.items()}


def _params():
    return LM(CFG4, "cpu").init(torch.Generator().manual_seed(0),
                                master=True)


def _step(params, batch, **kw):
    opt = optim.sgd(0.1)
    p = tree_map(lambda t: t.detach().clone(), params)
    state = {"params": p, "opt_state": opt.init(p), "step": 0}
    step = make_lm_train_step(LM(CFG4, "cpu"), opt, **kw)
    state, mets = step(state, batch)
    return float(mets["loss"]), state["params"], step.meter


def _live_slots(spec):
    """The slots the hops write: [(c + 1) mod S, sigma(m) + c]."""
    s, v = spec.num_stages, spec.virtual_stages
    live = torch.zeros((s, pipeline.wire_ef_ticks(spec)), dtype=torch.bool)
    for m in range(spec.microbatches):
        for c in range(s * v - 1):
            live[(c + 1) % s, pipeline._sigma(m, s, v) + c] = True
    return live


@pytest.mark.parametrize("rows", [8, 6])
def test_interleaved_none_step_equals_unpipelined_step(rows):
    """S 2, v 2, k 4 with the raw hop is the plain step; 6 rows pad the
    last micro-batch to 2 rows, as the reference pads; S 1 with v 2 runs
    no hop."""
    params, batch = _params(), _batch(rows)
    want_loss, want, _ = _step(params, batch)
    for s_, v_ in ((2, 2), (1, 2)):
        spec = pipeline.PipelineSpec(s_, 4, virtual_stages=v_)
        loss, got, meter = _step(params, batch, pipeline=spec)
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-5,
                                       atol=1e-5)
        hops = 4 * (s_ * v_ - 1) if s_ > 1 else 0
        raw = hops * (8 // 4) * SEQ * CFG4.d_model * 4
        assert (meter.hops_up, meter.hops_down, meter.up, meter.down) == (
            hops, hops, raw, raw)


def test_spec_takes_interleaving_and_topk_and_checks_the_buffer():
    spec = pipeline.PipelineSpec(2, 4, virtual_stages=2,
                                 wire_dtype="INT8+topk0.25")
    assert (spec.virtual_stages, spec.wire_dtype) == (2, "int8+topk0.25")
    assert pipeline.PipelineSpec.auto_k(1.0, 2.0, virtual_stages=2) \
        .virtual_stages == 2
    with pytest.raises(ValueError):
        pipeline.PipelineSpec(2, 4, virtual_stages=0)
    loss_fn = pipeline.make_pipelined_loss(LM(CFG4, "cpu"), spec)
    assert loss_fn.needs_wire_ef
    assert not pipeline.make_pipelined_loss(
        LM(CFG4, "cpu"), pipeline.PipelineSpec(2, 4, wire_dtype="int8")) \
        .needs_wire_ef
    wrong = pipeline.wire_ef_zeros(CFG4, spec, 4, SEQ)    # mb 1, not 2
    with pytest.raises(ValueError, match="wire_ef"):
        loss_fn(_params(), _batch(8), wrong)


def test_compress_round_trip_keeps_the_error_feedback_invariant():
    """deq(Q(g + e)) + new e == g + e, the flat tensor padded to 256."""
    g = torch.randn((3, 100), generator=torch.Generator().manual_seed(1))
    e = torch.randn((3, 100), generator=torch.Generator().manual_seed(2))
    q, s, shape = compress.quantize(g + e)
    assert q.shape == (2, 256) and s.shape == (2, 1) and shape == (3, 100)
    (qt,), (new_e,) = compress.compress_grads([g], [e])
    deq = compress.decompress_grads([qt])[0]
    torch.testing.assert_close(deq + new_e, g + e, rtol=0, atol=1e-6)
    assert float(new_e.abs().max()) <= float(s.max()) / 2 + 1e-6


def test_train_cli_interleaved_topk_compressed(monkeypatch):
    """``--virtual-stages 2 --wire-dtype int8+topk0.25 --compress-grads``
    on the CPU at the widened smoke depth: hop bytes up and down equal
    their bills every step, the EF buffer is live in exactly the
    schedule's slots, and the residual trees are finite and nonzero."""
    monkeypatch.setattr(train, "get_arch", lambda name: ArchSpec(
        name=name, full=QWEN.full, smoke=CFG4))
    res = train.main(["--arch", "qwen1.5-4b", "--device", "cpu", "--steps",
                      "2", "--batch", "8", "--seq", str(SEQ),
                      "--pipeline-stages", "2", "--virtual-stages", "2",
                      "--pipeline-k", "4", "--wire-dtype", "int8+topk0.25",
                      "--compress-grads", "--log-every", "1"])
    d, n = CFG4.d_model, 8 * SEQ * CFG4.d_model
    up = 3 * protocol.billed_hop_bytes(n, d, "int8+topk0.25", 4)
    down = 3 * protocol.billed_hop_bytes(n, d, "int8+topk0.25", 4,
                                         backward=True)
    for row in res["rows"]:
        assert (row["hop_bytes_up"], row["hop_bytes_down"]) == (up, down)
    state, spec = res["state"], res["pipeline"]
    assert (spec.virtual_stages, spec.wire_dtype) == (2, "int8+topk0.25")
    ef = state["wire_ef"]
    assert ef.shape == (2, 9, 2, SEQ, d) and bool(ef.isfinite().all())
    torch.testing.assert_close(ef.flatten(2).abs().amax(-1) > 0,
                               _live_slots(spec))
    fb = tree_leaves(state["error_fb"])
    assert all(bool(t.isfinite().all()) for t in fb)
    assert any(bool(t.any()) for t in fb)
    with pytest.raises(SystemExit):
        train.main(["--arch", "qwen1.5-4b", "--device", "cpu",
                    "--virtual-stages", "2"])
