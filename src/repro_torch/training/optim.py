"""Optimizers on parameter trees: AdamW, SGD with momentum, a cosine
schedule.

Port of the JAX package's ``training/optim.py``.  Parameters are f32
master weights; the model casts to the compute dtype at each use.  The
reference is functional (``update`` returns new trees); the port updates
the parameters and the optimizer state IN PLACE and returns the same
objects, which saves a second copy of both (at rwkv6-3b's width the f32
parameters, AdamW's m and v and the gradients fill 52 GB of the card).
Parameters are f32 master weights, or the compute dtype where a run keeps
no master copy (the streaming runtime, as the reference's does); m and v
are f32 either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.utils.trees import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (params, state)


def _lr_fn(lr):
    return lr if callable(lr) else (lambda step: lr)


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: float = 0.0) -> Optimizer:
    """AdamW with global-norm clipping (``grad_clip > 0``), bias
    correction at ``t = step + 1`` and decoupled weight decay."""
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        # each gradient leaf is widened to f32 where it is used, so a
        # bf16 tree never has a second, f32 copy of itself alive at once
        gs = tree_leaves(grads)
        scale = None
        if grad_clip > 0:
            gsq = sum(torch.sum(torch.square(g.to(torch.float32)))
                      for g in gs)
            scale = torch.clamp_max(grad_clip * torch.rsqrt(gsq + 1e-12), 1.0)
        t = int(step) + 1
        lr_t = float(lr_fn(int(step)))
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for p, g, m, v in zip(tree_leaves(params), gs,
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g = g.to(torch.float32)
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (m / c1).div_((v / c2).sqrt_().add_(eps))
            if weight_decay:
                upd.add_(p, alpha=weight_decay)
            p.sub_(upd.mul_(lr_t))
        return params, state

    return Optimizer(init=init, update=update)


def sgd(lr: float | Callable = 0.1, momentum: float = 0.9,
        weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mom": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = float(lr_fn(int(step)))
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["mom"])):
            m.mul_(momentum).add_(g.to(torch.float32))
            if weight_decay:
                m.add_(p, alpha=weight_decay)
            p.sub_(m * lr_t)
        return params, state

    return Optimizer(init=init, update=update)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.0):
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor`` at ``total``.  ``step -> lr`` (Python floats)."""
    def lr(step):
        s = float(step)
        if s < warmup:
            return peak_lr * (s + 1) / max(warmup, 1)
        prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return floor + 0.5 * (peak_lr - floor) * (1 + math.cos(math.pi * prog))
    return lr
