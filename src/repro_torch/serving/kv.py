"""Slot-based KV / recurrent-state cache arena for continuous batching.

Port of the JAX package's ``serving/kv.py``.  The decode state of every
served family (K/V buffers, local-window rings, RG-LRU recurrent
states, RWKV's WKV state and token shifts) is a tree whose leaves all
carry ONE batch axis, but not the same one: a homogeneous stacked cache
puts layers first (``[L, B, cache_len, ...]``), a heterogeneous tuple of
per-layer dicts puts batch first.  The arena treats that axis as the
SLOT axis: a fixed-shape ``[.., slots, ..]`` arena that requests are
written into when admitted and freed from when they complete, so the
decode step keeps one shape (one CUDA graph on the card) while requests
join and leave.

``slot_axes`` finds the per-leaf slot axis the reference's way, with two
probes at batch sizes 5 and 7 that ``LM.init_cache`` builds on
``device="meta"`` (nothing is allocated).

PyTorch idiom: the arena is mutated IN PLACE.  ``put_slot`` copies a row
into ``arena.select(ax, slot)``; the reference rebinds the whole tree
instead, which in the port would move the tensors under a captured
graph.  ``take_slot`` returns views.  ``FreeList`` is the host-side
slot allocator.
"""
from __future__ import annotations

import torch

from repro_torch.utils.trees import tree_leaves, tree_map

# Probe batch sizes for slot-axis discovery: the ONLY leaf axis that
# differs between the two probes is the batch axis.
_PROBE_A, _PROBE_B = 5, 7


def slot_axes(model, cache_len: int, cache_dtype=torch.float32):
    """Per-leaf slot (batch) axis of ``model.init_cache``'s tree: a tree
    of ints of the cache's structure.  Two probes on the meta device at
    batch 5 and 7; the unique axis whose extent changed is the batch
    axis."""
    meta = type(model)(model.cfg, "meta")
    a = meta.init_cache(_PROBE_A, cache_len, cache_dtype)
    b = meta.init_cache(_PROBE_B, cache_len, cache_dtype)

    def one(x, y):
        diff = [i for i, (p, q) in enumerate(zip(x.shape, y.shape))
                if p != q]
        if len(diff) != 1:
            raise ValueError(
                f"cache leaf {tuple(x.shape)} -> {tuple(y.shape)} has no "
                f"unique batch axis (changed axes: {diff}); the slot arena "
                "needs exactly one per leaf")
        return diff[0]

    return tree_map(one, a, b)


def take_slot(tree, axes, index: int):
    """One slot of an arena (or one row of a prefill batch) as views:
    every leaf loses its slot axis."""
    return tree_map(lambda a, ax: a.select(ax, index), tree, axes)


def put_slot(tree, axes, row, index: int):
    """Copy a slot-axis-free ``row`` (``take_slot``) into slot ``index``
    of the arena, in place, cast to the arena's dtype.  Returns the
    arena."""
    for a, r, ax in zip(tree_leaves(tree), tree_leaves(row),
                        tree_leaves(axes), strict=True):
        a.select(ax, index).copy_(r)
    return tree


def expand_slot(row, axes):
    """Re-insert a size-1 slot axis, so that a ``take_slot`` row can feed
    the model's batch-shaped decode step (batch = 1 lane)."""
    return tree_map(lambda a, ax: a.unsqueeze(ax), row, axes)


def squeeze_slot(tree, axes):
    """Inverse of ``expand_slot``."""
    return tree_map(lambda a, ax: a.squeeze(ax), tree, axes)


def where_slots(mask, new, old, axes):
    """Per-slot merge: a leaf's rows along its slot axis keep ``new``
    where ``mask`` [slots] is True, ``old`` elsewhere (a new tree).  The
    engine's step masks only the rows it writes, to the same effect
    (``models/blocks.py``)."""
    def one(n, o, ax):
        shape = [1] * n.dim()
        shape[ax] = mask.shape[0]
        return torch.where(mask.reshape(shape), n, o)
    return tree_map(one, new, old, axes)


class FreeList:
    """Host-side slot allocator: LIFO free list over ``n`` slots.

    LIFO on purpose: a freed slot is re-used as soon as possible, which
    is the reuse pattern the continuous-batching equivalence tests pin
    (a stale cache row must never leak into the next tenant).
    """

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"FreeList needs >= 1 slot, got {n}")
        self.n = int(n)
        self._free = list(range(self.n - 1, -1, -1))   # pop() -> slot 0 first

    def __len__(self):
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise IndexError("no free slots")
        return self._free.pop()

    def free(self, slot: int) -> None:
        slot = int(slot)
        if not 0 <= slot < self.n:
            raise ValueError(f"slot {slot} out of range [0, {self.n})")
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self._free.append(slot)
