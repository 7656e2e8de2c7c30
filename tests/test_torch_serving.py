"""Split-inference serving of the port against the JAX package's.

The split halves compose to the port's monolithic model bit for bit and
match the reference's halves at 1e-5; INFER frames are byte-identical to
the reference's for the same activation; the loopback run is honest
about its wire bytes and its 'none' tokens equal the reference's; a port
UE completes a run against a reference BS; and the CLI runs on the CPU
only when asked to: static (greedy and sampled), split and continuous.
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import LM as RefLM
from repro.models import LMConfig as RefLMConfig
from repro.runtime import protocol as ref_protocol
from repro.serving import infer as ref_infer
from repro_torch import bridge
from repro_torch.launch import serve
from repro_torch.models import LM, LMConfig
from repro_torch.runtime import protocol
from repro_torch.serving import infer

CFG = RefLMConfig(name="torch-serve-test", num_layers=2, d_model=64,
                  n_heads=4, n_kv=2, d_ff=96, vocab=128, qkv_bias=True,
                  rope_theta=1_000_000.0, dtype="float32")
TOL = dict(atol=1e-5, rtol=1e-5)
PROMPT, GEN, CACHE = 5, 3, 10


@pytest.fixture(scope="module")
def models():
    ref = RefLM(CFG)
    ref_params = ref.init(jax.random.key(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, ref_params))
    port = LM(LMConfig(**dataclasses.asdict(CFG)), "cpu")
    prompts = np.random.default_rng(3).integers(
        0, CFG.vocab, (2, PROMPT)).astype(np.int32)
    return ref, ref_params, port, params, prompts


@pytest.fixture(scope="module")
def ref_none_tokens(models):
    ref, ref_params, _port, _params, prompts = models
    res = ref_infer.run_split_infer(ref, ref_params, cut=1, prompts=prompts,
                                    gen=GEN, cache_len=CACHE,
                                    wire_dtype="none")
    return res["tokens"]


def test_split_composition_bitexact(models):
    _ref, _rp, port, params, prompts = models
    split = infer.SplitDecode(port, 1)
    ue, bs = split.split_params(params)
    toks = torch.from_numpy(prompts).long()
    acts, ue_c = split.ue_prefill(ue, toks, cache_len=CACHE)
    logits, bs_c = split.bs_prefill(bs, acts, cache_len=CACHE)
    ml, state = port.prefill_with_cache(params, {"tokens": toks}, CACHE,
                                        torch.float32)
    assert torch.equal(logits, ml)
    cache = state["cache"]
    tok = torch.argmax(logits, -1, keepdim=True)
    for pos in range(PROMPT, PROMPT + 3):
        a, ue_c = split.ue_decode(ue, tok, ue_c, pos)
        lg, bs_c = split.bs_decode(bs, a, bs_c, pos)
        mlg, cache = port.decode_step(params, tok, cache, pos)
        assert torch.equal(lg, mlg)
        tok = torch.argmax(lg, -1, keepdim=True)
    assert torch.equal(torch.cat([ue_c["k"], bs_c["k"]]), cache["k"])


def test_split_halves_match_reference(models):
    ref, ref_params, port, params, prompts = models
    rsplit, psplit = ref_infer.SplitDecode(ref, 1), infer.SplitDecode(port, 1)
    rue, rbs = rsplit.split_params(ref_params)
    pue, pbs = psplit.split_params(params)
    racts, rue_c = rsplit.ue_prefill(rue, jnp.asarray(prompts),
                                     cache_len=CACHE)
    pacts, pue_c = psplit.ue_prefill(pue, torch.from_numpy(prompts).long(),
                                     cache_len=CACHE)
    np.testing.assert_allclose(pacts.numpy(), np.asarray(racts), **TOL)
    rl, rbs_c = rsplit.bs_prefill(rbs, racts, cache_len=CACHE)
    pl_, pbs_c = psplit.bs_prefill(pbs, pacts, cache_len=CACHE)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(rl), **TOL)
    tok = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]
    for pos in range(PROMPT, PROMPT + 2):
        ra, rue_c = rsplit.ue_decode(rue, jnp.asarray(tok), rue_c,
                                     jnp.asarray(pos, jnp.int32))
        pa, pue_c = psplit.ue_decode(pue, torch.from_numpy(tok).long(),
                                     pue_c, pos)
        np.testing.assert_allclose(pa.numpy(), np.asarray(ra), **TOL)
        rl, rbs_c = rsplit.bs_decode(rbs, ra, rbs_c,
                                     jnp.asarray(pos, jnp.int32))
        pl_, pbs_c = psplit.bs_decode(pbs, pa, pbs_c, pos)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(rl), **TOL)
        tok = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]


def test_split_validation(models):
    _ref, _rp, port, _params, _prompts = models
    for cut in (0, CFG.num_layers):
        with pytest.raises(ValueError):
            infer.SplitDecode(port, cut)
    with pytest.raises(ValueError):
        infer._require_dense("int8+topk0.25")
    assert infer._require_dense("fp8") == "fp8"


@pytest.mark.parametrize("wire", ["none", "int8", "fp8"])
def test_loopback_wire_honesty(models, ref_none_tokens, wire):
    _ref, _rp, port, params, prompts = models
    res = infer.run_split_infer(port, params, cut=1, prompts=prompts,
                                gen=GEN, cache_len=CACHE, wire_dtype=wire)
    assert tuple(res["tokens"].shape) == (2, GEN)
    assert res["frames"] == GEN + 1
    rel = abs(res["measured_payload_bytes"] - res["billed_payload_bytes"]) \
        / res["billed_payload_bytes"]
    assert rel <= 0.01, res
    assert res["client_payload_bytes"] == res["measured_payload_bytes"]
    if wire == "none":
        np.testing.assert_array_equal(res["tokens"].numpy(), ref_none_tokens)


@pytest.mark.parametrize("wire", ["none", "int8", "fp8"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_infer_frame_byte_identical_to_reference(wire, dt):
    x = np.random.default_rng(7).standard_normal((2, 3, 64)).astype(
        np.float32) * 2
    if dt == "bfloat16":
        x_ref = x.astype(ml_dtypes.bfloat16)
        x_port = torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(x_ref.view(np.uint16),
                              x_port.view(torch.int16).numpy().view(np.uint16))
    else:
        x_ref, x_port = x, torch.from_numpy(x)
    ra, rmeta = ref_protocol.encode_act_payload(x_ref, wire)
    pa, pmeta = protocol.encode_act_payload(x_port, wire)
    ref_frame = ref_protocol.pack_frame(ref_protocol.INFER, 0, 4,
                                        meta=dict(rmeta, phase="decode"),
                                        arrays=ra)
    port_frame = protocol.pack_frame(protocol.INFER, 0, 4,
                                     meta=dict(pmeta, phase="decode"),
                                     arrays=pa)
    assert port_frame == ref_frame
    # and the port reads the reference's frame back to the same numbers
    frame = protocol.unpack_frame(ref_frame[4:])
    got = protocol.decode_act_payload(frame, "cpu")
    want = ref_protocol.decode_act_payload(ref_protocol.unpack_frame(
        ref_frame[4:]))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))
    assert frame.payload_nbytes == ref_protocol.unpack_frame(
        ref_frame[4:]).payload_nbytes


def test_frame_round_trip_and_errors():
    arrays = {"q": torch.arange(6, dtype=torch.int8).reshape(2, 3),
              "scale": torch.ones(3, 1), "tok": torch.tensor([[5]],
                                                             dtype=torch.int32)}
    body = protocol.pack_frame(protocol.INFER, 3, 9, {"phase": "x"}, arrays)
    f = protocol.unpack_frame(body[4:])
    assert (f.ftype, f.client, f.step, f.meta) == (protocol.INFER, 3, 9,
                                                   {"phase": "x"})
    for k, t in arrays.items():
        assert torch.equal(f.arrays[k], t)
    assert f.payload_nbytes == 6 + 12 and f.aux_nbytes == 4
    assert f.wire_nbytes == len(body)
    with pytest.raises(ValueError):
        protocol.unpack_frame(b"XXXX" + body[8:])
    with pytest.raises(ValueError):
        protocol.unpack_frame(body[4:-1])


def test_port_ue_against_reference_bs(models, ref_none_tokens):
    ref, ref_params, port, params, prompts = models
    rsplit, psplit = ref_infer.SplitDecode(ref, 1), infer.SplitDecode(port, 1)
    _rue, rbs = rsplit.split_params(ref_params)
    pue, _pbs = psplit.split_params(params)

    async def run():
        server = ref_infer.BSInferServer(rsplit, rbs, cache_len=CACHE,
                                         wire_dtype="int8")
        host, port_ = await server.start()
        client = infer.UEInferClient(0, psplit, pue, cache_len=CACHE,
                                     wire_dtype="int8")
        try:
            toks = await client.run(host, port_, prompts, GEN)
        finally:
            await server.close()
        return toks, server.audit, client.sent_payload_bytes

    toks, audit, sent = asyncio.run(run())
    assert tuple(toks.shape) == (2, GEN) and len(audit) == GEN + 1
    assert sent == sum(m for m, _ in audit) == sum(b for _, b in audit)


def test_cli_runs_on_cpu_when_asked():
    res = serve.main(["--arch", "qwen1.5-4b", "--size", "smoke",
                      "--device", "cpu", "--batch", "2", "--prompt-len", "6",
                      "--gen", "3", "--split-cut", "1", "--wire-dtype",
                      "int8"])
    assert res["frames"] == 4 and tuple(res["tokens"].shape) == (2, 3)
    assert res["measured_payload_bytes"] == res["billed_payload_bytes"]
    static = serve.main(["--arch", "qwen1.5-4b", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    none = serve.main(["--arch", "qwen1.5-4b", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3",
                       "--split-cut", "1"])
    assert torch.equal(static["tokens"], none["tokens"])


def test_cli_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen1.5-4b", "--batch", "2",
                    "--prompt-len", "4", "--gen", "2"])


def test_cli_static_sampling_repeats_with_the_engines_keys():
    """--temperature 0.7 on the static path samples with the engine's
    keys, the batch row as the request id: a rerun gives the same
    tokens, and so does the chain of ``sample_tokens`` on the same
    weights."""
    argv = ["--arch", "qwen1.5-4b", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--gen", "3", "--seed", "5",
            "--temperature", "0.7"]
    first, again = serve.main(argv), serve.main(argv)
    assert torch.equal(first["tokens"], again["tokens"])
    from repro_torch.configs import get_arch
    from repro_torch.serving.engine import sample_tokens
    cfg = get_arch("qwen1.5-4b").smoke
    port = LM(cfg, "cpu")
    params = port.init(torch.Generator().manual_seed(5))
    prompts = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 6)))
    with torch.inference_mode():
        logits, state = port.prefill_with_cache(params, {"tokens": prompts},
                                                9, torch.float32)
        tok, out = torch.argmax(logits, -1, keepdim=True), []
        for i in range(3):
            logits, _ = port.decode_step(params, tok, state["cache"], 6 + i)
            tok = sample_tokens(logits, 0.7, 5, torch.arange(2), i)[:, None]
            out.append(tok[:, 0])
    assert torch.equal(first["tokens"], torch.stack(out, 1).to(torch.int32))


def test_cli_continuous_runs_on_cpu(capsys):
    """--continuous on qwen SMOKE: every request is served, each equal to
    its solo decode on the same weights, and the stats are printed."""
    from repro_torch.configs import get_arch
    from repro_torch.serving.engine import solo_decode
    res = serve.main(["--arch", "qwen1.5-4b", "--device", "cpu",
                      "--continuous", "--requests", "5", "--prompt-len", "6",
                      "--gen-mix", "2,5", "--slots", "2", "--policy",
                      "longest_first"])
    out = capsys.readouterr().out
    assert "continuous: 5/5 requests" in out and "decode step eager" in out
    assert "engine units" in out and "p50 ttft" in out
    stats = res["stats"]
    assert res["slots"] == 2 and not stats["graph"]
    assert stats["qos"]["completed"] == 5 and stats["decode_steps"] > 0
    port = LM(get_arch("qwen1.5-4b").smoke, "cpu")
    params = port.init(torch.Generator().manual_seed(0))
    for r in serve._request_mix(port.cfg, serve.parse_args(
            ["--arch", "qwen1.5-4b", "--requests", "5", "--prompt-len", "6",
             "--gen-mix", "2,5"])):
        np.testing.assert_array_equal(
            res["tokens"][r.rid],
            solo_decode(port, params, r.prompt, r.max_new_tokens,
                        cache_len=11))


def test_cli_continuous_refusals():
    """--slots auto needs an offered load (it exits, as the reference's
    CLI does), and --split-cut serves only the static batch greedily."""
    with pytest.raises(SystemExit, match="--arrival-hz"):
        serve.main(["--arch", "qwen1.5-4b", "--device", "cpu",
                    "--continuous", "--slots", "auto"])
    for extra in (["--continuous"], ["--temperature", "0.7"]):
        with pytest.raises(ValueError, match="--split-cut"):
            serve.main(["--arch", "qwen1.5-4b", "--device", "cpu",
                        "--split-cut", "1"] + extra)
