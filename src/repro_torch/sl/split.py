"""Cut-layer model splitting: UE-side / BS-side submodels.

Port of the JAX package's ``sl/split.py``.  ResNet-18 cuts at the Table
II unit boundaries (``resnet_split``); an LM cuts at a block index: the
embedding and blocks[:l] live UE-side, the rest of the blocks, the final
norm and the head BS-side — the same cut the pipeline
(``parallel/pipeline.py``) makes.  ``split_params`` copies in both: the
two halves are trained on their own (the optimizers update in place) and
share no storage with the full tree.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import resnet
from repro_torch.models.common import apply_norm
from repro_torch.models.lm import run_blocks, unstack
from repro_torch.utils.trees import tree_map


@dataclasses.dataclass(frozen=True)
class SplitSpec:
    """ue_fwd(ue_params, batch_inputs) -> activations
    bs_loss(bs_params, activations, labels) -> (loss, metrics)"""
    ue_fwd: Callable
    bs_loss: Callable
    split_params: Callable      # full params -> (ue_params, bs_params)
    merge_params: Callable      # (ue, bs) -> full


def resnet_split(l: int) -> SplitSpec:
    """Cut ResNet-18 after Table II unit ``l`` (1..5).  The cut activation
    is NCHW (``models/resnet.py``)."""
    if not 1 <= l <= 5:
        raise ValueError(f"cut {l} must be in [1, 5]")

    def ue_fwd(ue_params, images):
        return resnet.forward_cut(ue_params, images, 0, l)

    def bs_loss(bs_params, acts, labels):
        return resnet.xent(resnet.forward_cut(bs_params, acts, l, 6), labels)

    keys_ue, keys_bs = _resnet_key_split(l)

    def split_params(params):
        copy = lambda t: t.detach().clone()
        return ({k: tree_map(copy, params[k]) for k in keys_ue},
                {k: tree_map(copy, params[k]) for k in keys_bs})

    def merge_params(ue, bs):
        return tree_map(torch.Tensor.detach, {**ue, **bs})

    return SplitSpec(ue_fwd, bs_loss, split_params, merge_params)


def _resnet_key_split(l: int):
    all_keys = (["conv1", "g1w", "g1b"], ["stage0"], ["stage1"], ["stage2"],
                ["stage3"], ["fc_w", "fc_b"])
    ue, bs = [], []
    for u, ks in enumerate(all_keys):
        (ue if u < l else bs).extend(ks)
    return ue, bs


def lm_split(model, l: int) -> SplitSpec:
    """Cut an LM after block ``l``: UE = embed + blocks[:l]; BS = the rest
    + final norm + head.  Needs a homogeneous stack and an untied head."""
    cfg = model.cfg
    if not cfg.homogeneous:
        raise ValueError("lm_split requires a homogeneous layer stack")
    if cfg.tie_embeddings:
        raise ValueError("tied embeddings cannot be split at the head")
    if not 1 <= l < cfg.num_layers:
        raise ValueError(f"cut {l} must be in [1, {cfg.num_layers})")

    def split_params(params):
        copy = lambda t: t.detach().clone()
        take = lambda sl: tree_map(lambda a: copy(a[sl]), params["blocks"])
        ue = {"embed": copy(params["embed"]), "blocks": take(slice(0, l))}
        bs = {"blocks": take(slice(l, cfg.num_layers)),
              "final_norm": tree_map(copy, params["final_norm"]),
              "head": copy(params["head"])}
        return ue, bs

    def merge_params(ue, bs):
        blocks = tree_map(lambda a, b: torch.cat([a, b]).detach(),
                          ue["blocks"], bs["blocks"])
        return {"embed": ue["embed"].detach(), "blocks": blocks,
                "final_norm": tree_map(torch.Tensor.detach, bs["final_norm"]),
                "head": bs["head"].detach()}

    def ue_fwd(ue_params, tokens):
        x = model._embed(ue_params, tokens, model.dtype)
        return run_blocks(cfg, unstack(ue_params["blocks"], x.dtype), x)[0]

    def bs_loss(bs_params, acts, labels):
        x, _ = run_blocks(cfg, unstack(bs_params["blocks"], acts.dtype),
                          acts)
        x = apply_norm(x, bs_params["final_norm"], cfg.norm)
        loss = model.xent(bs_params, x, labels)
        return loss, {"xent": loss}

    return SplitSpec(ue_fwd, bs_loss, split_params, merge_params)
