"""The port's streaming multi-UE runtime against the JAX package's.

* Frames: ACT and GRAD frames byte-identical to the reference's for every
  codec grammar (and its net-loss raw fallback), the top-k residual chain
  of three rounds equal to the reference's ``encode_grad_payload`` chain.
* Data: ``lm_batch_for`` / ``client_batches`` equal to the reference's.
* One tiny f32 ``run_streaming`` (2 UEs x 2 rounds, 'none' and 'int8')
  against the reference's ``run_streaming`` from the same weights
  (``bridge.py``): losses and both halves within 1e-5.
* Torch only: arrival-order independence under a slow ``LinkShaper``,
  bounded-inbox backpressure, wire honesty of every codec, 4 UEs equal to
  the port's own joint full-batch step, the CLI with ``--device cpu``
  and the re-planner seeing an injected 4x rate drop through measured
  hops alone.
"""
import asyncio
import json
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.runtime import protocol as ref_protocol
from repro_torch.bridge import (params_from_jax, streaming_state_from_jax,
                                streaming_state_to_jax)
from repro_torch.data.synthetic import lm_batch_for
from repro_torch.models.config import LMConfig
from repro_torch.models.lm import LM
from repro_torch.runtime import protocol
from repro_torch.runtime.bs import BSDispatcher
from repro_torch.runtime.driver import client_batches, main, run_streaming
from repro_torch.runtime.ue import UEClient, UESync
from repro_torch.sl.split import lm_split
from repro_torch.training.optim import adamw
from repro_torch.utils.trees import tree_leaves, tree_map
from repro_torch.wireless.channel import LinkShaper

CODECS = ["none", "int8", "fp8", "int8+topk0.25"]


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """The runs here are many small eager ops on one event loop, whose
    stalls enter every measured hop: one intra-op thread each keeps the
    suite's parallel workers from starving each other's loops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_cfg(d_model=32, vocab=64, num_layers=4, cls=LMConfig):
    return cls(name="t", num_layers=num_layers, d_model=d_model, n_heads=4,
               n_kv=2, d_ff=64, vocab=vocab, dtype="float32")


def _pair(x: np.ndarray, dt: str):
    """The same values as the reference's numpy array and a port tensor."""
    if dt == "bfloat16":
        return x.astype(ml_dtypes.bfloat16), \
            torch.from_numpy(x).to(torch.bfloat16)
    return x, torch.from_numpy(x)


def _frames(ref_arrays, ref_meta, port_arrays, port_meta, ftype):
    """The reference's and the port's frame bytes of the same content."""
    ref = ref_protocol.pack_frame(ftype, 1, 3, meta=ref_meta,
                                  arrays=ref_arrays)
    port = protocol.pack_frame(ftype, 1, 3, meta=port_meta,
                               arrays=port_arrays)
    return ref, port


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", CODECS)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_act_frame_byte_identical_to_reference(wire, dt):
    rng = np.random.default_rng(0)
    x_ref, x = _pair(rng.standard_normal((4, 16, 64)).astype(np.float32), dt)
    labels = rng.integers(0, 64, (4, 16)).astype(np.int32)
    ra, rm = ref_protocol.encode_act_payload(x_ref, wire)
    ra["labels"] = labels
    pa, pm = protocol.encode_act_payload(x, wire)
    pa["labels"] = torch.from_numpy(labels)
    meta = {"dl_nbytes": 123, "dl_s": 0.5, "t_send": 7.25}
    ref, port = _frames(ra, dict(rm, **meta), pa, dict(pm, **meta),
                              protocol.ACT)
    assert protocol.ACT == ref_protocol.ACT
    assert port == ref
    frame = protocol.unpack_frame(ref[4:])
    got = protocol.decode_act_payload(frame, "cpu")
    want = ref_protocol.decode_act_payload(ref_protocol.unpack_frame(ref[4:]))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))
    assert frame.aux_nbytes == labels.nbytes


@pytest.mark.parametrize("wire", CODECS + ["fp8+topk0.5"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_grad_frame_byte_identical_to_reference(wire, dt):
    rng = np.random.default_rng(1)
    g_ref, g = _pair(rng.standard_normal((2, 8, 64)).astype(np.float32), dt)
    ef = rng.standard_normal((2, 8, 64)).astype(np.float32) * 0.1
    ra, rm, ref_ef = ref_protocol.encode_grad_payload(g_ref, wire, ef)
    pa, pm, port_ef = protocol.encode_grad_payload(
        g, wire, torch.from_numpy(ef))
    meta = {"loss": 4.5, "t_send": 1.0}
    ref, port = _frames(ra, dict(rm, **meta), pa, dict(pm, **meta),
                              protocol.GRAD)
    assert protocol.GRAD == ref_protocol.GRAD
    assert port == ref
    if "+topk" in wire:
        np.testing.assert_array_equal(port_ef.numpy(), ref_ef)
    else:                       # dense codecs carry no EF: passed through
        assert port_ef is not None and ref_ef is ef
    got = protocol.decode_grad_payload(protocol.unpack_frame(ref[4:]), "cpu")
    want = ref_protocol.decode_grad_payload(
        ref_protocol.unpack_frame(ref[4:]))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))


def test_net_loss_raw_fallback_matches_reference():
    """d = 263 (prime, block 1): both hops ship raw and the top-k
    residual passes through unchanged, as in the reference."""
    d = 263
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, d)).astype(np.float32)
    ra, rm = ref_protocol.encode_act_payload(x, "int8")
    with pytest.warns(UserWarning, match="net loss"):
        pa, pm = protocol.encode_act_payload(torch.from_numpy(x), "int8")
    assert pm["kind"] == "raw"
    ref, port = _frames(ra, rm, pa, pm, protocol.ACT)
    assert port == ref
    ef = torch.ones(2, d)
    ga, gm, ef_out = protocol.encode_grad_payload(
        torch.from_numpy(x), "int8+topk0.25", ef)
    rga, rgm, _ = ref_protocol.encode_grad_payload(x, "int8+topk0.25",
                                                   np.ones((2, d), np.float32))
    assert gm["kind"] == "raw" and ef_out is ef
    ref, port = _frames(rga, rgm, ga, gm, protocol.GRAD)
    assert port == ref


def test_topk_residual_chain_matches_reference_over_three_rounds():
    """Three rounds of one client's gradient hop: every frame and every
    residual equal to the reference's chain, and the shipped sum
    telescopes (d1 + d2 + d3 == g1 + g2 + g3 - ef3)."""
    rng = np.random.default_rng(2)
    gs = [rng.standard_normal((4, 32)).astype(np.float32) for _ in range(3)]
    ef_r = ef_p = None
    shipped = torch.zeros(4, 32)
    for step, g in enumerate(gs):
        ra, rm, ef_r = ref_protocol.encode_grad_payload(
            g, "int8+topk0.25", ef_r)
        pa, pm, ef_p = protocol.encode_grad_payload(
            torch.from_numpy(g), "int8+topk0.25", ef_p)
        ref = ref_protocol.pack_frame(ref_protocol.GRAD, 0, step, rm, ra)
        port = protocol.pack_frame(protocol.GRAD, 0, step, pm, pa)
        assert port == ref
        np.testing.assert_array_equal(ef_p.numpy(), ef_r)
        shipped += protocol.decode_grad_payload(
            protocol.unpack_frame(port[4:]), "cpu")
    np.testing.assert_allclose(shipped.numpy(), sum(gs) - ef_r, atol=1e-5)


def test_billed_hop_bytes_match_reference():
    n, d = 4 * 16 * 64, 64
    for wire in CODECS:
        for bwd in (False, True):
            for act in (2.0, 4.0):
                assert protocol.billed_hop_bytes(
                    n, d, wire, act, backward=bwd) == pytest.approx(
                    ref_protocol.billed_hop_bytes(n, d, wire, act,
                                                  backward=bwd), rel=1e-12)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_lm_batch_for_and_client_batches_match_reference():
    from repro.data import lm_batch_for as ref_batch
    from repro.runtime.driver import client_batches as ref_clients
    cfg, ref_cfg = _tiny_cfg(), _tiny_cfg(cls=_ref_lmconfig())
    b = lm_batch_for(cfg, 6, 16, seed=7)
    rb = ref_batch(ref_cfg, 6, 16, seed=7)
    for k in ("tokens", "labels"):
        assert b[k].dtype == torch.int32
        np.testing.assert_array_equal(b[k].numpy(), rb[k])
    n, bpc, seq, seed = 3, 2, 16, 7
    ours = [client_batches(cfg, c, n, bpc, seq, seed) for c in range(n)]
    theirs = [ref_clients(ref_cfg, c, n, bpc, seq, seed) for c in range(n)]
    for _step in range(2):
        for a, r in zip(ours, theirs):
            (t, lab), (rt, rl) = next(a), next(r)
            np.testing.assert_array_equal(t.numpy(), rt)
            np.testing.assert_array_equal(lab.numpy(), rl)


def _ref_lmconfig():
    from repro.models import LMConfig as RefLMConfig
    return RefLMConfig


# ---------------------------------------------------------------------------
# The streamed run against the reference's
# ---------------------------------------------------------------------------


def _close_trees(port_tree, ref_tree, atol):
    def check(a, b):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=atol, rtol=0)
    tree_map(check, port_tree, ref_tree)


@pytest.fixture
def ref_dispatcher_closes_connections(monkeypatch):
    """The reference's ``BSDispatcher`` never closes its side of a client
    connection, and ``Server.wait_closed()`` waits for every connection
    on Python >= 3.12.1, so its ``run_streaming`` never returns there
    (ROADMAP Queue 3, fault 12).  Close them before the server's close;
    nothing the run computes changes."""
    from repro.runtime.bs import BSDispatcher as RefDispatcher
    close = RefDispatcher.close

    async def closing(self):
        for _inbox, writer in self._clients.values():
            writer.close()
        await close(self)
    monkeypatch.setattr(RefDispatcher, "close", closing)


@pytest.mark.parametrize("wire", ["none", "int8"])
def test_tiny_run_streaming_matches_reference(
        wire, ref_dispatcher_closes_connections):
    import jax

    from repro.models import LM as RefLM
    from repro.runtime.driver import run_streaming as ref_run
    ref_cfg = _tiny_cfg(cls=_ref_lmconfig())
    kw = dict(cut=2, n_clients=2, steps=2, batch_per_client=2, seq=16,
              seed=0, wire_dtype=wire)
    ref = asyncio.run(ref_run(ref_cfg, **kw))
    init = jax.tree.map(np.asarray, RefLM(ref_cfg).init(jax.random.key(0)))
    res = asyncio.run(run_streaming(_tiny_cfg(), **kw, device="cpu",
                                    params=params_from_jax(init)))
    np.testing.assert_allclose(res["losses"], ref["losses"], atol=1e-5,
                               rtol=0)
    ref_state = streaming_state_from_jax(
        {"params": jax.tree.map(np.asarray, ref["params"])})
    _close_trees(res["params"], streaming_state_to_jax(ref_state)["params"],
                 1e-5)
    for cid, losses in res["client_losses"].items():
        np.testing.assert_allclose(losses, ref["client_losses"][cid],
                                   atol=1e-5, rtol=0)
    assert res["wire_honesty"] == ref["wire_honesty"]


def test_bridge_carries_the_streaming_state_both_ways():
    """The reference's ``{"params": {"ue", "bs"}, "ef": {client:
    residual}}`` (its f32 top-k residuals from ``encode_grad_payload``)
    into the port and back, leaf for leaf."""
    import jax

    from repro.models import LM as RefLM
    from repro.sl import lm_split as ref_split
    ref_cfg = _tiny_cfg(cls=_ref_lmconfig())
    model = RefLM(ref_cfg)
    ue, bs = ref_split(model, 2).split_params(model.init(jax.random.key(1)))
    rng = np.random.default_rng(5)
    ef = {c: ref_protocol.encode_grad_payload(
        rng.standard_normal((2, 16, 32)).astype(np.float32),
        "int8+topk0.25")[2] for c in (0, 1)}
    state = {"params": jax.tree.map(np.asarray, {"ue": ue, "bs": bs}),
             "ef": ef}
    port = streaming_state_from_jax(state)
    assert set(port["ef"]) == {0, 1}
    assert all(e.dtype == torch.float32 for e in port["ef"].values())
    back = streaming_state_to_jax(port)
    for c in (0, 1):
        np.testing.assert_array_equal(back["ef"][c], ef[c])
    _close_trees(port["params"], state["params"], 0.0)
    jax.tree.map(np.testing.assert_array_equal, back["params"],
                 state["params"])


# ---------------------------------------------------------------------------
# Torch only
# ---------------------------------------------------------------------------


def _fake_split():
    def bs_loss(params, acts, labels):
        return torch.sum(acts * params["w"]), {}
    return types.SimpleNamespace(bs_loss=bs_loss)


def test_bounded_inbox_backpressure():
    """A client pushing frames faster than the trainer drains them fills
    its bounded inbox: the QoS monitor counts the backpressure and the
    inbox never holds more than ``queue_depth``."""
    async def scenario():
        disp = BSDispatcher(_fake_split(), {"w": torch.ones(())},
                            adamw(1e-3), n_clients=1, device="cpu",
                            queue_depth=1)
        await disp.start()
        reader, writer = await asyncio.open_connection(disp.host, disp.port)
        writer.write(protocol.pack_frame(protocol.HELLO, 0, 0))
        acts = torch.zeros((1, 4, 8))
        for step in range(3):
            arrays, meta = protocol.encode_act_payload(acts, "none")
            arrays["labels"] = torch.zeros((1, 4), dtype=torch.int32)
            writer.write(protocol.pack_frame(protocol.ACT, 0, step,
                                             meta, arrays))
        await writer.drain()
        await asyncio.sleep(0.3)        # the reader meets the full inbox
        inbox, _w = disp._clients[0]
        assert inbox.qsize() == 1
        assert disp.qos.clients[0].backpressure_events >= 1
        assert disp.qos.clients[0].queue_high_water == 1
        await inbox.get()               # one slot frees: the next frame in
        await asyncio.sleep(0.2)
        assert inbox.qsize() == 1
        writer.close()
        await disp.close()

    asyncio.run(asyncio.wait_for(scenario(), 30))


async def _stream(cfg, *, shapers, steps, wire_dtype="none", lr=1e-3,
                  seed=0, bpc=2, seq=16, cut=2):
    """run_streaming with one shaper a client (ragged arrivals)."""
    n = len(shapers)
    model = LM(cfg, "cpu")
    spec = lm_split(model, cut)
    ue, bs = spec.split_params(
        model.init(torch.Generator().manual_seed(seed)))
    disp = BSDispatcher(spec, bs, adamw(lr), n_clients=n, device="cpu",
                        wire_dtype=wire_dtype)
    sync = UESync(ue, adamw(lr), n)
    clients = [UEClient(cid, spec, client_batches(cfg, cid, n, bpc, seq,
                                                  seed),
                        sync, device="cpu", wire_dtype=wire_dtype,
                        shaper=shapers[cid]) for cid in range(n)]
    host, port = await disp.start()
    try:
        await asyncio.gather(disp.train(steps),
                             *(c.run(host, port, steps) for c in clients))
    finally:
        await disp.close()
    return disp, sync


def test_ragged_arrival_order_independence():
    """Slowing down a DIFFERENT client does not change the result: every
    micro-step uses the round's parameters and the round's mean is taken
    in sorted-client order."""
    cfg = _tiny_cfg()
    slow = LinkShaper(2e5)
    d1, s1 = asyncio.run(_stream(cfg, shapers=[slow, None, None], steps=3))
    d2, s2 = asyncio.run(_stream(cfg, shapers=[None, None, slow], steps=3))
    np.testing.assert_allclose(d1.losses, d2.losses, rtol=0, atol=1e-7)
    for a, b in zip(tree_leaves(d1.bs_params) + tree_leaves(s1.params),
                    tree_leaves(d2.bs_params) + tree_leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("wire", CODECS)
def test_wire_honesty_on_socket(wire):
    """Measured payload bytes of every hop equal the bill (the top-k
    downlink billed with ``backward=True``); the QoS snapshot is plain
    JSON and counts every frame and round."""
    res = asyncio.run(run_streaming(
        _tiny_cfg(d_model=64), cut=2, n_clients=2, steps=2,
        batch_per_client=2, seq=16, wire_dtype=wire, device="cpu"))
    assert all(np.isfinite(res["losses"]))
    honesty = res["wire_honesty"]
    assert honesty["uplink"] and honesty["downlink"]
    for rows in honesty.values():
        for row in rows:
            assert row["ok"] and row["measured_bytes"] == row["billed_bytes"]
    qos = res["qos"]
    json.dumps(qos)
    assert qos["rounds"] == 2 and qos["totals"]["frames_in"] == 4
    assert sum(c["straggler_rounds"]
               for c in qos["clients"].values()) == qos["rounds"]
    if "+topk" in wire:
        assert set(res["ef"]) == {0, 1}
        for e in res["ef"].values():
            assert e.dtype == torch.float32 and bool(torch.isfinite(e).all())
            assert float(e.abs().max()) > 0


def test_four_clients_match_the_joint_full_batch_step():
    """4 UEs x 5 rounds, codec 'none': the streamed losses and parameters
    equal joint full-batch training of the unsplit objective (the same
    AdamW) within 1e-5."""
    cfg = _tiny_cfg()
    steps, n, bpc, seq, lr, cut = 5, 4, 2, 16, 1e-3, 2
    res = asyncio.run(run_streaming(
        cfg, cut=cut, n_clients=n, steps=steps, batch_per_client=bpc,
        seq=seq, lr=lr, device="cpu"))
    assert all(len(v) == steps for v in res["client_losses"].values())
    model = LM(cfg, "cpu")
    spec = lm_split(model, cut)
    ue, bs = spec.split_params(model.init(torch.Generator().manual_seed(0)))
    opt = adamw(lr)
    opt_ue, opt_bs = opt.init(ue), opt.init(bs)
    losses = []
    for step in range(steps):
        b = lm_batch_for(cfg, n * bpc, seq, seed=step)
        pu = tree_map(lambda t: t.detach().requires_grad_(True), ue)
        pb = tree_map(lambda t: t.detach().requires_grad_(True), bs)
        loss, _ = spec.bs_loss(pb, spec.ue_fwd(pu, b["tokens"]), b["labels"])
        grads = torch.autograd.grad(loss, tree_leaves(pu) + tree_leaves(pb))
        k = len(tree_leaves(pu))
        gu = tree_map(lambda _t, g=iter(grads[:k]): next(g), ue)
        gb = tree_map(lambda _t, g=iter(grads[k:]): next(g), bs)
        opt.update(gu, opt_ue, ue, step)
        opt.update(gb, opt_bs, bs, step)
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(res["losses"], losses, atol=1e-5, rtol=0)
    for got, want in ((res["params"]["ue"], ue), (res["params"]["bs"], bs)):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.detach().numpy(),
                                       atol=1e-5, rtol=0)


def test_cli_runs_on_cpu_when_asked(capsys, tmp_path):
    out = tmp_path / "qos.json"
    res = main(["--device", "cpu", "--clients", "2", "--steps", "2",
                "--layers", "2", "--cut", "1", "--seq", "8",
                "--wire-dtype", "int8+topk0.25", "--bw-Bps", "5e6",
                "--qos-out", str(out)])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["link_hints"]["link_bw_Bps"] > 0
    assert json.loads(out.read_text())["rounds"] == 2
    text = capsys.readouterr().out
    assert "wire honesty uplink: 1/1" in text
    assert "wire honesty downlink: 1/1" in text


def test_cli_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--steps", "1"])


def test_split_serving_hooks_shape_the_link_and_count_frames():
    """The serving CLI's split path through a ``LinkShaper`` and the BS's
    ``QoSMonitor``: gen + 1 uplink frames counted, their payload bytes
    equal to the audit's, the unshaped run's tokens."""
    from repro_torch.launch import serve
    argv = ["--arch", "qwen1.5-4b", "--size", "smoke", "--device", "cpu",
            "--split-cut", "1", "--wire-dtype", "int8", "--batch", "2",
            "--prompt-len", "8", "--gen", "4"]
    plain = serve.main(argv)
    shaped = serve.main(argv + ["--bw-Bps", "1e6"])
    assert torch.equal(plain["tokens"], shaped["tokens"])
    for res in (plain, shaped):
        client = res["qos"]["clients"]["0"]
        assert client["frames_in"] == 4 + 1 == res["frames"]
        assert client["payload_bytes_in"] == res["measured_payload_bytes"]


def test_replanner_tracks_injected_delay_change():
    """A ``LinkShaper`` at bw0 drops to bw0/4 after round 5; the
    re-planner's ``LinkEstimator``, fed only through ``observe_hop`` from
    frame timestamps (``observe_bandwidth`` is spied on), shows the drop,
    and ``refreshed_inputs().link_s`` grows with it.

    A hop's measured seconds include every stall of the one event loop
    (a client's micro-step or pull-back blocks it), and the estimator's
    affine fit rests on the spread between the two directions' frame
    sizes.  The reference's test ('none' at d 32: frames 174 bytes
    apart of ~4,400) relies on jitted micro-steps; the port's eager ones,
    and PyTorch's intra-op threads contending with the suite's other
    workers, bury that spread.  Here the codec is ``int8+topk0.1`` at d
    128 (frames of ~4,400 bytes up and ~1,600 down) and the run keeps one
    intra-op thread (``one_intra_op_thread``), so the shaper's delays
    dominate the samples."""
    from repro_torch.analysis.autotune import (WIRE_AUTO, PlanInputs,
                                               choose_plan)
    from repro_torch.training.replan import (LinkEstimator, ReplanConfig,
                                             Replanner)
    bw0 = 5e4
    shaper = LinkShaper(bw0)
    inp = PlanInputs(num_stages=2, stage_fwd_s=0.1, stage_bwd_s=0.2,
                     link_s=0.01, hop_overhead_s=0.002, k_cap=16, v_cap=4,
                     num_layers=8, act_bytes=2.0, act_hop_bytes=4.0e8,
                     d_model=1024)
    rp = Replanner(inp, choose_plan(inp, wire_candidates=WIRE_AUTO).plan,
                   ReplanConfig(every=5, hysteresis=0.1))
    rp.link = LinkEstimator(ewma=0.7, window=8)
    scripted = []
    orig_bw = rp.link.observe_bandwidth
    rp.link.observe_bandwidth = (
        lambda *a, **k: scripted.append(a) or orig_bw(*a, **k))
    snaps = {}
    tasks = []

    def on_started(disp, clients):
        async def watch():
            while len(disp.losses) < 5:
                await asyncio.sleep(0.01)
            snaps["link_s"] = rp.refreshed_inputs().link_s
            snaps["bw"] = rp.link.hints()["link_bw_Bps"]
            shaper.set_rate(bw0 / 4)
        tasks.append(asyncio.ensure_future(watch()))

    asyncio.run(run_streaming(
        _tiny_cfg(d_model=128), cut=2, n_clients=2, steps=10,
        batch_per_client=2, seq=16, wire_dtype="int8+topk0.1",
        shaper=shaper, replanner=rp, on_started=on_started, device="cpu"))
    assert tasks[0].done() and tasks[0].exception() is None
    assert not scripted
    assert rp.link.samples
    bw_after = rp.link.hints()["link_bw_Bps"]
    link_s_after = rp.refreshed_inputs().link_s
    assert bw_after < 0.5 * snaps["bw"], (bw_after, snaps["bw"])
    assert link_s_after > 2.0 * snaps["link_s"]
    assert link_s_after == pytest.approx(inp.act_hop_bytes / bw_after)
