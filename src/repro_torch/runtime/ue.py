"""UE-side client of the streaming runtime.

Port of the JAX package's ``runtime/ue.py``.  Each client task owns one
UE's data shard and runs the SUB-CUT layers (``sl.split.lm_split``:
embedding + blocks[:l]) each round:

    forward below the cut (no autograd graph kept while the frame is in
    flight) -> code the activation on the device -> ACT frame over the
    socket (shaped by the LinkShaper) -> await the GRAD frame (the BS's
    coded cut-activation gradient) -> decode it on the device -> pull
    back by re-running the sub-cut forward under autograd -> round sync

The client TIMES the downlink hop (GRAD frame ``t_send`` -> local
receive) and reports it in its next frame, so the BS-side
``LinkEstimator`` sees measured samples of both directions.

``UESync`` is the round barrier and the client-side model update (C2P2SL
keeps every UE's sub-model in step each round, the FedAvg-style update of
parallel split learning).  It runs in-process because all UE tasks share
the driver's process; what crosses the socket are the SL hops.
"""
from __future__ import annotations

import asyncio
import time

import torch

from repro_torch.runtime import protocol
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten


def mean_tree_(trees: list):
    """The leafwise mean ``(t0 + t1 + ... ) / n`` of same-structured
    trees, summed left to right in list order in the leaves' dtype, as the
    reference's ``sum(gs[1:], gs[0]) / len(gs)``: written into the first
    tree, which it returns."""
    acc = trees[0]
    for leaf, *rest in zip(*(tree_leaves(t) for t in trees)):
        for other in rest:
            leaf.add_(other)
        leaf.div_(len(trees))
    return acc


class UESync:
    """Round barrier + mean of the clients' UE-side gradients + one
    optimizer update.

    All clients hold the SAME ``params``; ``apply`` blocks until every
    client of the round has contributed, applies the mean update once (in
    place) and releases them all.  The mean is taken in sorted-client
    order once every tree is in, so the result does not depend on arrival
    order.
    """

    def __init__(self, params, opt, n_clients: int):
        self.params = params
        self.opt = opt
        self.opt_state = opt.init(params)
        self.n_clients = int(n_clients)
        self.round = 0
        self._grads: dict = {}
        self._cond = asyncio.Condition()

    async def apply(self, client: int, grads):
        """Hand in one client's gradient tree (the barrier keeps the only
        reference, so the trees are freed once their mean is taken) and
        wait for the round's update."""
        async with self._cond:
            self._grads[client] = grads
            del grads
            if len(self._grads) == self.n_clients:
                ordered = [self._grads[c] for c in sorted(self._grads)]
                self._grads = {}
                mean = mean_tree_(ordered)
                del ordered
                self.opt.update(mean, self.opt_state, self.params,
                                self.round)
                del mean
                self.round += 1
                self._cond.notify_all()
            else:
                target = self.round + 1
                await self._cond.wait_for(lambda: self.round >= target)
            return self.params


def ue_pullback(split, params, tokens, g):
    """The UE-side gradients: the sub-cut forward re-run under autograd
    and pulled back with the decoded cut-activation gradient ``g`` (the
    reference's ``jax.vjp`` of ``ue_fwd``)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        acts = split.ue_fwd(p, tokens)
        grads = torch.autograd.grad(acts, tree_leaves(p), grad_outputs=g)
    return tree_unflatten(p, grads)


class UEClient:
    """One UE: connects, then streams ``steps`` rounds of SL hops."""

    def __init__(self, client_id: int, split, data_iter, sync: UESync, *,
                 device, wire_dtype: str = "none", shaper=None):
        self.client_id = int(client_id)
        self.split = split
        self.data_iter = data_iter
        self.sync = sync
        self.device = torch.device(device)
        self.wire_dtype = str(wire_dtype)
        self.shaper = shaper
        self.steps_done = 0
        self.losses: list = []

    async def _send(self, writer, payload: bytes):
        if self.shaper is not None:
            await asyncio.sleep(self.shaper.delay_s(len(payload)))
        writer.write(payload)
        await writer.drain()

    def _act_frame(self, acts, labels, step: int, dl_report: dict) -> bytes:
        """The ACT frame of one round: the activation coded on its device,
        the labels, the last downlink measurement and the send time
        (stamped before the shaper's sleep on purpose: the emulated
        serialization delay IS hop time)."""
        arrays, meta = protocol.encode_act_payload(acts, self.wire_dtype)
        arrays["labels"] = labels.to(torch.int32)
        meta.update(dl_report)
        meta["t_send"] = time.monotonic()
        return protocol.pack_frame(protocol.ACT, self.client_id, step,
                                   meta=meta, arrays=arrays)

    async def run(self, host: str, port: int, steps: int):
        reader, writer = await asyncio.open_connection(host, port)
        cid = self.client_id
        try:
            await self._send(writer, protocol.pack_frame(
                protocol.HELLO, cid, 0,
                meta={"wire_dtype": self.wire_dtype}))
            dl_report = {}
            for step in range(steps):
                tokens, labels = next(self.data_iter)
                tokens = tokens.to(self.device)
                with torch.no_grad():
                    acts = self.split.ue_fwd(self.sync.params, tokens)
                act_dtype = acts.dtype
                frame = self._act_frame(acts, labels, step, dl_report)
                del acts
                await self._send(writer, frame)

                grad_frame = await protocol.read_frame(reader)
                t_recv = time.monotonic()
                if grad_frame.ftype != protocol.GRAD \
                        or grad_frame.step != step:
                    raise ValueError(
                        f"client {cid}: expected the GRAD frame of step "
                        f"{step}, got ftype={grad_frame.ftype} step="
                        f"{grad_frame.step}")
                dl_report = {
                    "dl_nbytes": grad_frame.wire_nbytes,
                    "dl_s": t_recv - grad_frame.meta["t_send"],
                }
                g = protocol.decode_grad_payload(
                    grad_frame, self.device).to(act_dtype)
                self.losses.append(float(grad_frame.meta["loss"]))
                await self.sync.apply(cid, ue_pullback(
                    self.split, self.sync.params, tokens, g))
                del g
                self.steps_done += 1
            await self._send(writer, protocol.pack_frame(
                protocol.BYE, cid, steps, meta=dl_report))
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
