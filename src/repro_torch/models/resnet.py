"""ResNet-18 adapted to 32x32 CIFAR-10 (paper SIV-A, Table II).

Port of the JAX package's ``models/resnet.py``: 3x3 stem, no max-pool,
GroupNorm (8 groups of contiguous channels, population variance, eps
1e-5; the model is f32, so are its statistics) so that micro-batched gradient accumulation is
exactly full-batch training, as the paper asserts for C²P²SL.

Layout: images enter unit 0 as the reference's NHWC ``[B, 32, 32, 3]``
(what ``data/synthetic.py::image_batches`` yields) and are permuted once
to NCHW; every activation between units, the cut activation included,
is NCHW ``[B, C, H, W]``.  Convolution weights are PyTorch's OIHW
``[C_out, C_in, kh, kw]`` (the reference keeps HWIO; ``bridge.py``
transposes), and the classifier is ``x @ fc_w`` with ``fc_w`` ``[512,
classes]``, as in the reference.

The reference's ``"SAME"`` padding is kept exactly: a 3x3 stride-2
convolution on an even map pads 0 before and 1 after (``F.pad`` then
``padding=0``), not PyTorch's symmetric ``padding=1``; a 1x1 stride-2
projection pads nothing.  The package turns TF32 off for cuDNN and
cuBLAS when it is imported (``repro_torch/__init__.py``), which covers
the convolutions' backward too, run by autograd outside any forward
scope; ``forward_cut`` raises if a caller has turned either back on, so
f32 stays f32 on the card.

Cut units follow Table II: 0 conv1 | 1..4 block1..block4 | 5 avgpool+fc,
so ``forward_cut(params, x, 0, l)`` / ``forward_cut(params, a, l, 6)``
are the UE-side / BS-side submodels of cut l in {1..5}.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CUT_NAMES = ("conv1", "block1", "block2", "block3", "block4", "avgpool_fc")
_STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


def _conv_init(gen, kh, kw, cin, cout):
    w = torch.randn((cout, cin, kh, kw), generator=gen, device=gen.device)
    return w * math.sqrt(2.0 / (kh * kw * cin))


def _same_pad(size, k, stride):
    """(before, after) of XLA's ``"SAME"``: the odd pixel goes after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """``lax.conv_general_dilated(..., "SAME")`` on NCHW / OIHW."""
    (t, b), (lft, r) = (_same_pad(x.shape[2], w.shape[2], stride),
                        _same_pad(x.shape[3], w.shape[3], stride))
    if t == b and lft == r:
        return F.conv2d(x, w, stride=stride, padding=(t, lft))
    return F.conv2d(F.pad(x, (lft, r, t, b)), w, stride=stride)


def _gn(x, w, b, groups=8, eps=1e-5):
    return F.group_norm(x, groups, w, b, eps)


def _init_basic(gen, cin, cout, stride):
    dev = gen.device
    p = {"c1": _conv_init(gen, 3, 3, cin, cout),
         "g1w": torch.ones(cout, device=dev),
         "g1b": torch.zeros(cout, device=dev),
         "c2": _conv_init(gen, 3, 3, cout, cout),
         "g2w": torch.ones(cout, device=dev),
         "g2b": torch.zeros(cout, device=dev)}
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout)
        p["gpw"] = torch.ones(cout, device=dev)
        p["gpb"] = torch.zeros(cout, device=dev)
    return p


def _apply_basic(p, x, stride):
    h = F.relu(_gn(_conv(x, p["c1"], stride), p["g1w"], p["g1b"]))
    h = _gn(_conv(h, p["c2"]), p["g2w"], p["g2b"])
    if "proj" in p:
        x = _gn(_conv(x, p["proj"], stride), p["gpw"], p["gpb"])
    return F.relu(x + h)


def init_resnet18(generator: torch.Generator, num_classes: int = 10):
    """f32 parameters on ``generator.device``, drawn from ``generator``
    (the reference's initialisers: He-normal convolutions, unit / zero
    GroupNorm, ``N(0, 0.02)`` classifier)."""
    dev = generator.device
    params = {"conv1": _conv_init(generator, 3, 3, 3, 64),
              "g1w": torch.ones(64, device=dev),
              "g1b": torch.zeros(64, device=dev)}
    cin = 64
    for si, (cout, stride) in enumerate(_STAGES):
        blocks = []
        for bi in range(2):
            blocks.append(_init_basic(generator, cin, cout,
                                      stride if bi == 0 else 1))
            cin = cout
        params[f"stage{si}"] = tuple(blocks)
    params["fc_w"] = torch.randn((512, num_classes), generator=generator,
                                 device=dev) * 0.02
    params["fc_b"] = torch.zeros(num_classes, device=dev)
    return params


def forward_cut(params, x, start: int, stop: int):
    """Run cut units [start, stop).  Unit indices per CUT_NAMES; ``x`` is
    NHWC images when ``start == 0``, else an NCHW activation."""
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is on (torch.backends.cuda.matmul / cudnn .allow_tf32): "
            "the f32 ResNet would round its products' inputs to 10 bits")
    if start <= 0 < stop:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(_gn(_conv(x, params["conv1"]), params["g1w"],
                       params["g1b"]))
    for si, (_, stride) in enumerate(_STAGES):
        if start <= si + 1 < stop:
            for bi, bp in enumerate(params[f"stage{si}"]):
                x = _apply_basic(bp, x, stride if bi == 0 else 1)
    if start <= 5 < stop:
        x = x.mean(dim=(2, 3))
        x = x @ params["fc_w"] + params["fc_b"]
    return x


def forward(params, x):
    return forward_cut(params, x, 0, 6)


def xent(logits, labels):
    """Mean cross entropy (f32 log-softmax) and accuracy."""
    ll = F.log_softmax(logits.float(), dim=-1)
    loss = -ll.gather(1, labels.long()[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"acc": acc}


def loss_fn(params, batch):
    return xent(forward(params, batch["images"]), batch["labels"])
