"""Kernels of the PyTorch port against the JAX package's Pallas kernels.

On the CPU the port's plain versions are held to the Pallas kernels run
in interpret mode and to the jnp oracles: the wire codec bit for bit for
int8 (fp8 within one e4m3 ULP, the bound the reference accepted for its
host twin), flash attention within 2e-4 in f32.  Bit for bit means the
reference's host codec, the bytes its INFER frames carry; its jitted
Pallas codec differs from that by one f32 ULP in some scales.  The CUDA
kernels are held to the plain versions on the card in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_fa
from repro.kernels import ref as ref_oracles
from repro.kernels import wire_codec as ref_wc
from repro.parallel import wire as ref_wire
from repro.training import compress as ref_compress
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import wire_codec as wc
from repro_torch.parallel import wire
from repro_torch.training import compress

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _x(shape, seed=0, scale=3.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x *= scale
    x.reshape(-1, shape[-1])[0, :ref_wc.wire_block(shape[-1])] = 0.0
    return x


def _pair(x, dt):
    """The same numbers as a jnp array and a torch tensor at dtype ``dt``."""
    return jnp.asarray(x, JNP_DT[dt]), torch.from_numpy(x).to(TORCH_DT[dt])


def _u8(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _e4m3_order(bits: np.ndarray) -> np.ndarray:
    """Sign-magnitude e4m3 bytes -> integers ordered like their values
    (+0 and -0 both map to 0), so adjacent codes differ by one."""
    mag = (bits & 0x7F).astype(np.int32)
    return np.where(bits & 0x80, -mag, mag)


def _assert_payload(port_q, ref_q, wire_dtype):
    a, b = _u8(port_q), _u8(ref_q)
    assert a.shape == b.shape
    if wire_dtype == "int8":
        np.testing.assert_array_equal(a, b)
    else:
        gap = np.abs(_e4m3_order(a) - _e4m3_order(b))
        assert gap.max() <= 1, f"fp8 payload off by {gap.max()} e4m3 ULPs"


# --------------------------------------------------------------- wire codec


@pytest.mark.parametrize("wire_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("d,lead", [(32, (3, 5)), (96, (7,)), (200, (2, 3)),
                                    (2560, (3,))])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_codec_plain_matches_reference(wire_dtype, d, lead, dt):
    """Bit-identical to the reference's host codec (the bytes of its
    INFER frames) and to its eager ``quantize_blocks``; against the
    Pallas kernel, whose jitted ``amax / qmax`` XLA rewrites into
    ``amax * (1 / qmax)``, the scales are within one f32 ULP (ROADMAP,
    Queue 3)."""
    x = _x(lead + (d,), seed=d)
    xj, xt = _pair(x, dt)
    q, s = wc.encode_plain(xt, wire_dtype)
    b = ref_wc.wire_block(d)
    assert tuple(q.shape) == lead + (d // b, b)
    assert q.dtype == compress.payload_dtype(wire_dtype)
    hq, hs = ref_wire.host_encode(np.asarray(xj), wire_dtype)
    jq, js = ref_compress.quantize_blocks(
        xj.astype(jnp.float32).reshape(lead + (d // b, b)), wire_dtype)
    for ref_q, ref_s in ((hq, hs), (jq, js)):
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
        _assert_payload(q, ref_q, wire_dtype)
    rq, rs = ref_wc.encode_fused(xj, wire_dtype, interpret=True)
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(rs), maxulp=1)
    if wire_dtype == "int8":
        gap = np.abs(_u8(q).view(np.int8).astype(np.int32)
                     - _u8(rq).view(np.int8).astype(np.int32))
        assert gap.max() <= 1
    else:
        _assert_payload(q, rq, wire_dtype)
    # decode the Pallas kernel's own payload on both sides: bit-identical
    rq_t = torch.from_numpy(_u8(rq).copy()).view(q.dtype)
    out = wc.decode_plain(rq_t, torch.from_numpy(np.array(rs)), TORCH_DT[dt])
    ref_out = ref_wc.decode_fused(rq, rs, JNP_DT[dt], interpret=True)
    np.testing.assert_array_equal(
        out.to(torch.float32).numpy(),
        np.asarray(ref_out.astype(jnp.float32)))


def test_quantize_blocks_all_zero_block_and_qmax():
    blocks = torch.zeros((2, 8))
    blocks[1] = torch.linspace(-2, 2, 8)
    q, s = compress.quantize_blocks(blocks, "int8")
    assert float(s[0, 0]) == np.float32(1e-12)
    assert int(q[1].abs().max()) == 127
    assert compress.dequantize_blocks(q, s)[0].abs().max() == 0
    assert compress.qmax_for("fp8") == ref_compress.qmax_for("fp8") == 448.0
    with pytest.raises(ValueError):
        compress.qmax_for("int4")


@pytest.mark.parametrize("spelling", [
    "none", "INT8", " fp8 ", "int8+topk0.25", "fp8+topk1.0", None,
    "int8+topk0", "none+topk0.5", "int4", "int8+foo", "int8+topkx"])
def test_wire_grammar_matches_reference(spelling):
    try:
        want = ref_wire.parse_wire_dtype(spelling)
    except ValueError:
        with pytest.raises(ValueError):
            wire.parse_wire_dtype(spelling)
        return
    assert wire.parse_wire_dtype(spelling) == want
    assert wire.validate_wire_dtype(spelling) \
        == ref_wire.validate_wire_dtype(spelling)


@pytest.mark.parametrize("d,itemsize", [(7, 2), (7, 4), (64, 2), (251, 4),
                                        (2560, 2)])
def test_net_loss_rule_matches_reference(d, itemsize):
    assert wire.codec_net_loss(d, itemsize) \
        == ref_wire.codec_net_loss(d, itemsize)


def test_encode_raw_passthrough_at_degenerate_block():
    x = torch.randn(3, 257)         # prime d > 256: block 1, 5 B/element
    wire._NET_LOSS_WARNED.clear()
    with pytest.warns(UserWarning, match="net loss"):
        q, s = wire.encode(x, "int8")
    assert s is None and q is x
    assert torch.equal(wire.decode(q, s, torch.float32), x)


@pytest.mark.parametrize("wire_dtype", ["int8", "fp8"])
def test_roundtrip_matches_reference_jnp_path(wire_dtype):
    x = _x((4, 6, 64), seed=5)
    xj, xt = _pair(x, "float32")
    got = wire.roundtrip(xt, wire_dtype).numpy()
    want = np.asarray(ref_wire.roundtrip(xj, wire_dtype, impl="jnp"))
    if wire_dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:                       # one e4m3 ULP is at most 1/8 of the value
        np.testing.assert_allclose(got, want, rtol=0.125, atol=1e-6)


# ------------------------------------------------------------ flash attention


FLASH_CASES = [  # (b, hq, hkv, s, dh, causal, window)
    (1, 4, 4, 32, 16, True, 0),
    (2, 4, 2, 32, 16, True, 0),     # GQA rep 2
    (1, 2, 1, 48, 16, True, 8),     # sliding window
    (1, 2, 2, 32, 16, False, 0),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_plain_matches_pallas_interpret(case):
    b, hq, hkv, s, dh, causal, window = case
    rng = np.random.default_rng(s + hq)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, hq, s, dh), (b, hkv, s, dh),
                             (b, hkv, s, dh)))
    got = fa.attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window).numpy()
    pallas = ref_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, bq=16, bk=16,
                                    interpret=True)
    oracle = ref_oracles.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=2e-4, rtol=2e-4)


# ------------------------------------------------------------ dispatcher


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    ops.reset_launches()
    x = torch.randn(2, 3, 64)
    q, s = ops.wire_encode(x, "int8")
    qp, sp = wc.encode_plain(x, "int8")
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert torch.equal(ops.wire_decode(q, s, torch.float32),
                       wc.decode_plain(q, s, torch.float32))
    qa = torch.randn(1, 2, 8, 16)
    assert torch.equal(ops.flash_attention(qa, qa, qa, causal=True),
                       fa.attention_plain(qa, qa, qa, causal=True))
    assert sum(ops.LAUNCHES.values()) == 0


def test_no_fallback_for_devices_without_a_kernel():
    meta = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError):
        ops.wire_encode(meta, "int8")
    with pytest.raises(ValueError):        # the launcher takes CUDA only
        wc.encode_cuda(torch.randn(2, 64), "int8")
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(*(torch.randn(1, 2, 8, 16),) * 3)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def test_build_cache_key_tracks_source():
    p = build.library_path("wire_codec")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    assert p.name.startswith("wire_codec-")
    assert p != build.library_path("flash_attention")


def test_build_cache_key_tracks_shared_headers(monkeypatch, tmp_path):
    """A source that includes a header of csrc rebuilds when the header
    changes."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("k")
    assert build.library_path("k") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build.library_path("k") != before
