"""Mixture-of-experts MLP: top-k routing with capacity-bounded dispatch.

Port of the JAX package's ``models/moe.py`` on one device (its
``ctx.mesh is None`` branch; the sharded ``shard_map`` dispatches are
listed in ROADMAP.md).  Each token picks its top-k experts from an f32
router; each expert takes at most ``capacity`` tokens, in token-major,
k-minor order, and drops the rest; the kept tokens are gathered into an
``[E, capacity, D]`` buffer, and the three expert products go through
``kernels.ops.moe_gmm`` (the CUDA kernel on the card, its plain version
on the CPU; the reference computes them with einsums).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import activation, dense_init


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, *, device, weight_dtype=torch.float32):
    """The reference's draws: router ``dense_init`` (kept f32, it routes in
    f32: ``lm._KEEP_F32``), w1 and w3 normal / sqrt(d_model), w2 normal /
    sqrt(d_ff); expert weights stored at ``weight_dtype``."""
    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32).mul_(scale)
        return w.to(weight_dtype)

    return {
        "router": dense_init(generator, d_model, n_experts, device=device),
        "w1": normal((n_experts, d_model, d_ff), 1.0 / math.sqrt(d_model)),
        "w3": normal((n_experts, d_model, d_ff), 1.0 / math.sqrt(d_model)),
        "w2": normal((n_experts, d_ff, d_model), 1.0 / math.sqrt(d_ff)),
    }


def _capacity(n_tokens: int, topk: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(n_tokens * topk * factor / n_experts))
    return max(8, ((c + 7) // 8) * 8)


def router_aux(me, ce):
    """Switch-style load-balance aux ``E * sum_e f_e * p_e`` from the mean
    router probability ``me`` and the fraction of top-k assignments ``ce``
    per expert (both [E])."""
    return me.shape[-1] * torch.sum(me * ce)


def _route(x, router, topk: int):
    """x [T, D] -> (probs [T, E], gates [T, K] renormalised, expert ids
    [T, K] sorted by descending probability), all from f32 logits."""
    probs = torch.softmax(x.to(torch.float32) @ router.to(torch.float32), -1)
    gate, idx = torch.topk(probs, topk, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, idx


def _slots(idx, n_experts: int, capacity: int):
    """Each assignment's buffer slot: ``expert * capacity + rank``, its rank
    within its expert counted in token-major, k-minor order; assignments
    ranked at or past ``capacity`` go to the dump slot ``E * capacity``.
    -> (slot [T*K], keep [T*K] bool).

    The reference's cumulative sum of a one-hot, laid out ``[E, T*K]`` so
    that the scan runs along the inner axis: along the outer axis of a
    ``[T*K, E]`` one-hot, PyTorch's CUDA scan gives each of the E columns
    one thread (3.1 ms a call on an H100 at granite-moe-3b-a800m's
    prefill, 16,384 x 40)."""
    eid = idx.reshape(-1)
    experts = torch.arange(n_experts, device=eid.device)
    onehot = (eid[None, :] == experts[:, None]).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, 1), 0, eid[None, :])[0] - 1
    keep = pos < capacity
    slot = torch.where(keep, eid * capacity + pos,
                       torch.full_like(eid, n_experts * capacity))
    return slot, keep


def _moe_local(x, router, w1, w3, w2, *, topk: int, capacity: int, act: str):
    """Dispatch and combine.  x: [T, D] -> ([T, D], aux loss)."""
    t, d = x.shape
    e = router.shape[1]
    dt = x.dtype
    probs, gate, idx = _route(x, router, topk)
    me = probs.mean(0)
    ce = F.one_hot(idx, e).to(torch.float32).sum(1).mean(0) / topk
    aux = router_aux(me, ce)

    slot, keep = _slots(idx, e, capacity)
    buf = torch.zeros((e * capacity + 1, d), dtype=dt, device=x.device)
    buf[slot] = x[:, None].expand(t, topk, d).reshape(t * topk, d)
    h = buf[:-1].reshape(e, capacity, d)

    a = activation(ops.moe_gmm(h, w1.to(dt)), act) * ops.moe_gmm(h, w3.to(dt))
    y = ops.moe_gmm(a, w2.to(dt))

    flat = torch.cat([y.reshape(e * capacity, d),
                      torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    picked = flat[slot] * (gate.reshape(-1, 1).to(y.dtype)
                           * keep[:, None].to(y.dtype))
    return picked.reshape(t, topk, d).sum(1), aux


def apply_moe(params, x, *, topk: int, cap_factor: float, act: str,
              dropless: bool = False):
    """x: [B, S, D] -> ([B, S, D], aux).  Capacity from all B * S tokens,
    as the reference computes it without a mesh.

    ``dropless`` raises the capacity to at least B * S: a token picks
    each expert at most once, so no expert then drops one.  The serving
    engine's batched step routes so, which is what the reference's
    vmapped lanes compute (each lane routes its one token alone, at
    capacity ``_capacity(1, ...) = 8``, and never drops it)."""
    b, s, d = x.shape
    cap = _capacity(b * s, topk, params["router"].shape[1], cap_factor)
    if dropless:
        cap = max(cap, _capacity(b * s, 1, 1, 1.0))
    out, aux = _moe_local(x.reshape(-1, d), params["router"], params["w1"],
                          params["w3"], params["w2"], topk=topk,
                          capacity=cap, act=act)
    return out.reshape(b, s, d), aux
