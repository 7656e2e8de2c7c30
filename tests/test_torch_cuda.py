"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one (the marker
``cuda``).  The file imports no JAX, so it also runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import wire_codec as wc
from repro_torch.models.lm import LM
from repro_torch.serving.infer import run_split_infer
from repro_torch.utils.trees import tree_map

pytestmark = pytest.mark.cuda

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_CASES = [  # (b, hq, hkv, s, dh, causal, window)
    (1, 4, 4, 32, 16, True, 0),
    (2, 4, 2, 37, 64, True, 0),      # GQA rep 2, ragged S
    (1, 2, 1, 150, 128, True, 8),    # sliding window
    (1, 2, 2, 70, 32, False, 0),
    (4, 20, 20, 512, 128, True, 0),  # the main path's shape
]


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("wire_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("shape,dt", [((2048, 2560), "bfloat16"),
                                      ((4, 2560), "bfloat16"),
                                      ((37, 96), "float32"),
                                      ((5, 200), "bfloat16"),
                                      ((3, 7, 251), "float32")])
def test_codec_kernel_bit_exact(wire_dtype, shape, dt):
    dev = cuda_device()
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[0, :wc.wire_block(shape[-1])] = 0.0
    x = torch.from_numpy(3 * x).to(dev, TORCH_DT[dt])
    q, s = wc.encode_cuda(x, wire_dtype)
    qp, sp = wc.encode_plain(x, wire_dtype)
    assert torch.equal(q.view(torch.uint8), qp.view(torch.uint8))
    assert torch.equal(s, sp)
    assert torch.equal(wc.decode_cuda(q, s, TORCH_DT[dt]),
                       wc.decode_plain(q, s, TORCH_DT[dt]))


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dt,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_flash_kernel_matches_plain(case, dt, tol):
    dev = cuda_device()
    b, hq, hkv, s, dh, causal, window = case
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(TORCH_DT[dt])
               for shape in ((b, hq, s, dh), (b, hkv, s, dh),
                             (b, hkv, s, dh)))
    o = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    op = fa.attention_plain(q, k, v, causal=causal, window=window)
    assert float((o.float() - op.float()).abs().max()) <= tol


def test_flash_kernel_reads_the_model_layout():
    """[B, S, H, dh] activations pass as transposed views; the output
    keeps that layout, so the model reshapes it without a copy."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((2, 40, 4, 64), generator=g, device=dev)
               .transpose(1, 2) for _ in range(3))
    o = fa.flash_attention_cuda(q, k, v, causal=True)
    assert o.transpose(1, 2).is_contiguous()
    op = fa.attention_plain(q, k, v, causal=True)
    assert float((o - op).abs().max()) <= 2e-4


def test_unsupported_shapes_raise():
    dev = cuda_device()
    t = torch.randn(1, 2, 8, 48, device=dev)     # head dim 48 not built
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(t, t, t)
    with pytest.raises(TypeError):
        wc.encode_cuda(torch.zeros(2, 64, device=dev, dtype=torch.float16),
                       "int8")


def test_dispatcher_counts_launches():
    dev = cuda_device()
    ops.reset_launches()
    x = torch.randn(4, 2560, device=dev, dtype=torch.bfloat16)
    q, s = ops.wire_encode(x, "int8")
    ops.wire_decode(q, s, torch.bfloat16)
    t = torch.randn(1, 2, 64, 64, device=dev)
    ops.flash_attention(t, t, t)
    assert dict(ops.LAUNCHES) == {"wire_encode": 1, "wire_decode": 1,
                                  "flash_attention": 1}


def test_small_model_on_card_matches_cpu_and_split_serves():
    dev = cuda_device()
    cfg = get_arch("qwen1.5-4b").smoke
    cpu, card = LM(cfg, "cpu"), LM(cfg, dev)
    params = cpu.init(torch.Generator().manual_seed(0))
    pcard = tree_map(lambda t: t.to(dev), params)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    lc, _ = cpu.prefill_with_cache(params, {"tokens": toks}, 48,
                                   torch.float32)
    ops.reset_launches()
    lg, _ = card.prefill_with_cache(pcard, {"tokens": toks.to(dev)}, 48,
                                    torch.float32)
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)
    res = run_split_infer(card, pcard, cut=1, prompts=toks[:, :8], gen=4,
                          cache_len=16, wire_dtype="int8")
    assert res["frames"] == 5
    assert res["measured_payload_bytes"] == res["billed_payload_bytes"]
    assert ops.LAUNCHES["wire_encode"] == ops.LAUNCHES["wire_decode"] == 5
