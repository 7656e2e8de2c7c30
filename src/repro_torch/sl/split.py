"""Cut-layer model splitting: UE-side / BS-side submodels.

Port of the LM half of the JAX package's ``sl/split.py``.  An LM cuts at a
block index: the embedding and blocks[:l] live UE-side, the rest of the
blocks, the final norm and the head BS-side — the same cut the pipeline
(``parallel/pipeline.py``) makes.  ``resnet_split`` waits for
``models/resnet.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

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


def lm_split(model, l: int) -> SplitSpec:
    """Cut an LM after block ``l``: UE = embed + blocks[:l]; BS = the rest
    + final norm + head.  Needs a homogeneous stack and an untied head.

    ``split_params`` copies: the two halves are trained on their own and
    share no storage with the full tree."""
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
