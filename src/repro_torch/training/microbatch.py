"""Micro-batched gradient accumulation — the paper's equivalence primitive.

Port of the JAX package's ``training/microbatch.py``.  C²P²SL splits each
batch into k micro-batches and accumulates gradients; the accumulated
update equals the full-batch one when the loss is a per-sample mean.  In
PyTorch the accumulation is autograd's own: each micro-batch runs
``(loss / k).backward()`` into the parameters' ``.grad``.
"""
from __future__ import annotations

import torch

from repro_torch.utils.trees import tree_leaves, tree_map


def split_batch(batch, k: int):
    """Reshape every leaf [B, ...] -> [k, B//k, ...]."""
    def r(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by k={k}")
        return x.reshape((k, b // k) + tuple(x.shape[1:]))
    return tree_map(r, batch)


def microbatched_value_and_grad(loss_fn, k: int):
    """value_and_grad with gradient accumulation over k micro-batches.

    ``loss_fn(params, micro_batch) -> (loss, metrics)``.  Returns
    ``(params, batch) -> ((loss, metrics), grads)`` with loss, metrics and
    grads averaged over the micro-batches; ``grads`` mirrors ``params``
    (f32 master weights give f32 gradients).  The parameters are made
    leaves that require grad, and their ``.grad`` is cleared again.
    """
    k = max(int(k), 1)

    def run(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        if k == 1:
            micro = [batch]
        else:
            split = split_batch(batch, k)
            micro = [tree_map(lambda x, i=i: x[i], split) for i in range(k)]
        loss_acc, mets_acc = None, None
        for mb in micro:
            loss, mets = loss_fn(params, mb)
            (loss / k).backward()
            mets = tree_map(lambda t: t.detach(), mets)
            loss_acc = loss.detach() if loss_acc is None \
                else loss_acc + loss.detach()
            mets_acc = mets if mets_acc is None \
                else tree_map(torch.add, mets_acc, mets)
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        for p in leaves:
            p.grad = None
        return (loss_acc / k, tree_map(lambda t: t / k, mets_acc)), grads

    return run
