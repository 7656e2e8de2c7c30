"""Which kernel route the grouped matmul, flash and wire decode wrappers
pick.

``moe_gmm.route``, ``moe_gmm.bwd_route``, ``flash_attention.route`` and
``wire_codec.decode_route`` are pure functions of a dtype, shapes,
strides and base addresses: they launch nothing, so they run here on the
CPU.  The tensor-core routes need what TMA and cp.async need (16-byte
aligned bases, strides that are multiples of 16 bytes); everything else
goes to the SIMT kernels, which take any layout.  The decode kernel's
vector route needs b = 256 and aligned payload and output.  Imports torch
only.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import wire_codec as wc

BF16, F32 = torch.bfloat16, torch.float32


def _gmm_route(h, w):
    return mg.route(h.dtype, h.shape[1], h.shape[2],
                    (h.stride(0), h.stride(1), w.stride(0), w.stride(1)),
                    (h.data_ptr(), w.data_ptr()))


@pytest.mark.parametrize("shape,dtype,want", [
    ((40, 512, 1536, 512), BF16, "wgmma"),        # granite prefill: w1, w3
    ((40, 512, 512, 1536), BF16, "wgmma"),        # ... w2
    ((40, 8, 1536, 512), BF16, "wgmma_small_c"),  # a decode step
    ((2, 1, 200, 72), BF16, "wgmma_small_c"),
    ((2, 16, 200, 72), BF16, "wgmma_small_c"),    # the largest small C
    ((2, 17, 200, 72), BF16, "wgmma"),
    ((5, 37, 200, 72), BF16, "wgmma"),
    ((1, 1, 1, 1), BF16, "simt"),                 # 2-byte strides
    ((5, 37, 200, 71), BF16, "simt"),             # w's rows 142 B apart
    ((5, 37, 203, 72), BF16, "simt"),             # h's rows 406 B apart
    ((40, 512, 1536, 512), F32, "simt"),          # f32 holds 2e-4: no TF32
    ((40, 8, 1536, 512), F32, "simt"),
])
def test_gmm_route_of_contiguous_inputs(shape, dtype, want):
    e, c, d, f = shape
    h = torch.empty((e, c, d), dtype=dtype)
    w = torch.empty((e, d, f), dtype=dtype)
    assert _gmm_route(h, w) == want


def test_gmm_route_reads_strides_not_shapes():
    """A w sliced along F keeps its parent's row stride: 40 elements (80 B)
    is TMA's, 44 (88 B) is not; a transposed-view h of legal strides is."""
    w = torch.empty((3, 48, 44), dtype=BF16)
    h = torch.empty((20, 3, 48), dtype=BF16).transpose(0, 1)  # [E, C, D]
    assert _gmm_route(h, w[:, :, :33]) == "simt"
    assert _gmm_route(h, w[:, :, :40].contiguous()[:, :, :33]) == "wgmma"


@pytest.mark.parametrize("ptrs,want", [((0, 0), "wgmma"),
                                       ((256, 4096), "wgmma"),
                                       ((2, 0), "simt"),
                                       ((0, 8), "simt")])
def test_gmm_route_needs_16_byte_aligned_bases(ptrs, want):
    strides = (512 * 1536, 1536, 1536 * 512, 512)
    assert mg.route(BF16, 512, 1536, strides, ptrs) == want


def test_gmm_route_without_a_reduction_axis_is_simt():
    assert mg.route(BF16, 8, 0, (0, 0, 0, 512), (0, 0)) == "simt"


def test_gmm_route_ids_cover_every_route():
    names = {mg.route(BF16, c, 64, (8, 8, 8, 8), (0, 0)) for c in (8, 64)}
    names.add(mg.route(F32, 8, 64, (8, 8, 8, 8), (0, 0)))
    assert names == set(mg._ROUTE_IDS)


def _gmm_bwd_route(h, w, dout):
    e, c, d = h.shape
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    return mg.bwd_route(h.dtype, (e, c, d, w.shape[2]),
                        (h.stride(0), h.stride(1), w.stride(0), w.stride(1),
                         dout.stride(0), dout.stride(1)),
                        [t.data_ptr() for t in (h, w, dout, dh, dw)])


@pytest.mark.parametrize("shape,dtype,want", [
    ((40, 256, 1536, 512), BF16, "wgmma"),   # granite training: w1, w3
    ((40, 256, 512, 1536), BF16, "wgmma"),   # ... w2
    ((3, 8, 200, 72), BF16, "wgmma"),        # small C: no swapped variant
    ((2, 130, 96, 40), BF16, "wgmma"),
    ((2, 130, 96, 33), BF16, "simt"),        # dout's and w's rows 66 B apart
    ((5, 37, 203, 72), BF16, "simt"),        # h's rows 406 B apart
    ((40, 256, 1536, 512), F32, "simt"),     # f32 holds 2e-4: no TF32
    ((3, 8, 200, 72), F32, "simt"),
])
def test_gmm_bwd_route_of_contiguous_inputs(shape, dtype, want):
    e, c, d, f = shape
    h = torch.empty((e, c, d), dtype=dtype)
    w = torch.empty((e, d, f), dtype=dtype)
    assert _gmm_bwd_route(h, w, torch.empty((e, c, f), dtype=dtype)) == want


@pytest.mark.parametrize("which", ["h", "w", "dout"])
def test_gmm_bwd_route_takes_simt_when_one_input_is_misaligned(which):
    """chip_smoke.py's misaligned views, one at a time: a base 2 bytes off
    16, or a row stride that is not a multiple of 8 elements, sends the
    backward to SIMT; the aligned inputs take the tensor cores."""
    e, c, d, f = 3, 20, 48, 40
    ts = {"h": torch.empty((e, c, d), dtype=BF16),
          "w": torch.empty((e, d, f), dtype=BF16),
          "dout": torch.empty((e, c, f), dtype=BF16)}
    assert _gmm_bwd_route(ts["h"], ts["w"], ts["dout"]) == "wgmma"
    t = ts[which]
    buf = torch.empty(t.numel() + 1, dtype=BF16)
    off = dict(ts, **{which: buf[1:].view(t.shape)})
    assert _gmm_bwd_route(off["h"], off["w"], off["dout"]) == "simt"
    wide = torch.empty(t.shape[:-1] + (t.shape[-1] + 4,), dtype=BF16)
    strided = dict(ts, **{which: wide[..., :t.shape[-1]]})
    assert _gmm_bwd_route(strided["h"], strided["w"],
                          strided["dout"]) == "simt"


def test_gmm_bwd_route_without_a_dimension_is_simt():
    strides = (8, 8, 8, 8, 8, 8)
    assert mg.bwd_route(BF16, (4, 8, 64, 64), strides, [0] * 5) == "wgmma"
    for dims in ((0, 8, 64, 64), (4, 0, 64, 64), (4, 8, 0, 64),
                 (4, 8, 64, 0)):
        assert mg.bwd_route(BF16, dims, strides, [0] * 5) == "simt"


def _flash_route(*tensors):
    return fa.route(tensors[0].dtype,
                    [s for t in tensors for s in t.stride()[:3]],
                    [t.data_ptr() for t in tensors])


@pytest.mark.parametrize("b,hq,hkv,s,dh", [(4, 20, 20, 512, 128),
                                           (4, 24, 8, 512, 64),
                                           (4, 10, 1, 512, 256),
                                           (2, 3, 3, 33, 16)])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_route_bf16_takes_the_tensor_cores(b, hq, hkv, s, dh, layout):
    def mk(h, dtype):
        if layout == "bshd":       # the model's [B, S, H, dh] as a view
            return torch.empty((b, s, h, dh), dtype=dtype).transpose(1, 2)
        return torch.empty((b, h, s, dh), dtype=dtype)
    q, k, v = mk(hq, BF16), mk(hkv, BF16), mk(hkv, BF16)
    assert _flash_route(q, k, v, torch.empty_like(q)) == "mma"
    q, k, v = mk(hq, F32), mk(hkv, F32), mk(hkv, F32)
    assert _flash_route(q, k, v, torch.empty_like(q)) == "simt"


def test_flash_route_misaligned_bf16_is_simt():
    buf = torch.empty(2 * 4 * 40 * 64 + 1, dtype=BF16)
    q = buf[1:].view(2, 4, 40, 64)                 # base 2 bytes off
    k = torch.empty((2, 4, 40, 64), dtype=BF16)
    assert _flash_route(q, k, k, k) == "simt"
    wide = torch.empty((2, 4, 40, 68), dtype=BF16)[..., :64]   # 136 B rows
    assert _flash_route(wide, k, k, k) == "simt"
    assert _flash_route(k, k, k, k) == "mma"


@pytest.mark.parametrize("d,q_ptr,out_ptr,want", [
    (2560, 0, 0, "warp256"),          # every main path: d_model 2560
    (2560, 4096 + 8, 512 + 16, "warp256"),
    (2560, 1, 0, "strided"),          # a payload view 1 byte off
    (2560, 4, 0, "strided"),
    (2560, 0, 8, "strided"),          # output off 16 bytes
    (1536, 0, 0, "warp256"),          # granite's d_model: b = 256 too
    (96, 0, 0, "strided"),            # b = 96
    (200, 0, 0, "strided"),
    (251, 0, 0, "strided"),           # a prime: b = d
])
def test_decode_route(d, q_ptr, out_ptr, want):
    assert wc.decode_route(wc.wire_block(d), q_ptr, out_ptr) == want


def test_decode_route_of_tensors():
    q = torch.empty((4, 10, 256), dtype=torch.int8)
    out = torch.empty((4, 2560), dtype=torch.bfloat16)
    assert wc.decode_route(q.shape[-1], q.data_ptr(), out.data_ptr()) == \
        "warp256"
    buf = torch.empty(q.numel() + 1, dtype=torch.int8)
    qm = buf[1:].view(q.shape)
    assert wc.decode_route(qm.shape[-1], qm.data_ptr(), out.data_ptr()) == \
        "strided"
