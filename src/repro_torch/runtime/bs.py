"""BS-side dispatcher: socket server, bounded inboxes, one micro-step per
arrival, and the measured-hop feed into the online re-planner.

Port of the JAX package's ``runtime/bs.py``.  A training round, the
C2P2SL server pipeline:

* every UE's ACT frame lands in that client's BOUNDED inbox
  (``asyncio.Queue(maxsize=queue_depth)``).  A full inbox blocks the
  connection's reader coroutine, which stops draining the socket: TCP
  backpressure then throttles the UE's ``drain()``.
* the aggregator takes ONE frame a client a round, in ARRIVAL order:
  each arrival at once runs the BS micro-step (forward and backward of
  blocks[l:], the head and the loss on that client's shard, with the
  gradient with respect to the decoded activation) and ships the coded
  gradient straight back, so server compute overlaps the stragglers'
  uplinks: the paper's pipeline, event-driven.  The GRAD frame is coded
  on the device; a ``+topk`` codec keeps each client's f32
  error-feedback residual on the device.
* the optimizer applies once a round, to the sorted-client mean of the
  per-client gradient trees, every tree held until the round ends: the
  result does not depend on arrival order.

The micro-step blocks the event loop while UE coroutines wait, as in the
reference: measured hop seconds include the loop's stalls.  Every hop is
measured: uplink frames carry ``t_send`` (one host, one monotonic
clock), the UE measures each downlink and reports it in its next frame;
both feed ``replanner.observe_hop``.
"""
from __future__ import annotations

import asyncio
import collections
import time

import torch

from repro_torch.runtime import protocol
from repro_torch.runtime.qos import QoSMonitor
from repro_torch.runtime.ue import mean_tree_
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten


class BSDispatcher:
    def __init__(self, split, bs_params, opt, *, n_clients: int, device,
                 wire_dtype: str = "none", queue_depth: int = 2,
                 replanner=None, shaper=None, qos: QoSMonitor | None = None,
                 stall_after_s: float = 0.25,
                 host: str = "127.0.0.1", port: int = 0):
        self.split = split
        self.bs_params = bs_params
        self.opt = opt
        self.opt_state = opt.init(bs_params)
        self.n_clients = int(n_clients)
        self.device = torch.device(device)
        self.wire_dtype = str(wire_dtype)
        self.queue_depth = int(queue_depth)
        self.replanner = replanner
        self.shaper = shaper
        self.qos = qos or QoSMonitor(stall_after_s=stall_after_s)
        self.stall_after_s = float(stall_after_s)
        self.host, self.port = host, int(port)
        self._server = None
        self._clients: dict = {}          # cid -> (inbox, writer)
        self._all_joined = asyncio.Event()
        self.ef: dict = {}                # cid -> f32 EF residual (device)
        self.losses: list = []
        # wire-honesty audit: (payload_bytes, n_elements, d, act_itemsize)
        self.hop_audit = {"uplink": set(), "downlink": set()}
        # measured hop seconds per direction and client
        self.hop_seconds = {"uplink": collections.defaultdict(list),
                            "downlink": collections.defaultdict(list)}

    # -- transport -----------------------------------------------------------

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def close(self):
        """Close every client connection and the server (a reader blocked
        on a full inbox never reaches its connection's end itself)."""
        if self._server is not None:
            for _inbox, writer in self._clients.values():
                writer.close()
            self._server.close()
            await self._server.wait_closed()

    def _observe_hop(self, direction, cid, nbytes, seconds):
        if nbytes and seconds and seconds > 0:
            self.hop_seconds[direction][cid].append(float(seconds))
            if self.replanner is not None:
                self.replanner.observe_hop(float(nbytes), float(seconds))

    def _observe_frame(self, frame: protocol.Frame, t_recv: float) -> None:
        t_send = frame.meta.get("t_send")
        if t_send is not None:
            self._observe_hop("uplink", frame.client, frame.wire_nbytes,
                              t_recv - float(t_send))
        # the UE piggybacks its measurement of our PREVIOUS downlink
        self._observe_hop("downlink", frame.client,
                          frame.meta.get("dl_nbytes"),
                          frame.meta.get("dl_s"))

    async def _handle_client(self, reader, writer):
        hello = await protocol.read_frame(reader)
        if hello.ftype != protocol.HELLO:
            writer.close()
            raise ValueError(
                f"client handshake must be HELLO, got ftype={hello.ftype}")
        cid = hello.client
        inbox = asyncio.Queue(maxsize=self.queue_depth)
        self._clients[cid] = (inbox, writer)
        if len(self._clients) >= self.n_clients:
            self._all_joined.set()
        while True:
            try:
                frame = await protocol.read_frame(reader)
            except (asyncio.IncompleteReadError, ConnectionError):
                break
            t_recv = time.monotonic()
            self._observe_frame(frame, t_recv)
            if frame.ftype == protocol.BYE:
                break
            if frame.ftype != protocol.ACT:
                continue                   # STATS etc.: telemetry only
            shape = frame.meta["shape"]
            n_el = 1
            for s in shape:
                n_el *= int(s)
            self.hop_audit["uplink"].add(
                (frame.payload_nbytes, n_el, int(shape[-1]),
                 protocol.DTYPES[frame.meta["dtype"]].itemsize))
            self.qos.record_arrival(cid, frame.wire_nbytes,
                                    frame.payload_nbytes, frame.aux_nbytes)
            if inbox.full():
                self.qos.record_backpressure(cid)
            await inbox.put(frame)
            self.qos.record_queue_depth(cid, inbox.qsize())

    def _grad_frame(self, cid: int, step: int, act_grad, loss: float):
        """The GRAD frame of one client's micro-step, coded on the device
        (the client's EF residual updated); returns (frame, payload
        bytes)."""
        arrays, meta, self.ef[cid] = protocol.encode_grad_payload(
            act_grad, self.wire_dtype, self.ef.get(cid))
        meta["loss"] = float(loss)
        meta["t_send"] = time.monotonic()
        frame = protocol.pack_frame(protocol.GRAD, cid, step, meta=meta,
                                    arrays=arrays)
        payload_nbytes = sum(t.numel() * t.element_size()
                             for n, t in arrays.items()
                             if n in protocol.PAYLOAD_SECTIONS)
        self.hop_audit["downlink"].add(
            (payload_nbytes, act_grad.numel(), int(act_grad.shape[-1]),
             act_grad.element_size()))
        return frame, payload_nbytes

    async def _send_grad(self, cid: int, step: int, act_grad, loss) -> None:
        _inbox, writer = self._clients[cid]
        frame, payload_nbytes = self._grad_frame(cid, step, act_grad, loss)
        if self.shaper is not None:
            await asyncio.sleep(self.shaper.delay_s(len(frame)))
        writer.write(frame)
        await writer.drain()
        self.qos.record_send(cid, len(frame), payload_nbytes)

    # -- training ------------------------------------------------------------

    def _micro(self, acts, labels):
        """Forward and backward of the BS side on one client's shard:
        (loss, BS gradient tree, gradient of the decoded activation)."""
        p = tree_map(lambda t: t.detach().requires_grad_(True),
                     self.bs_params)
        a = acts.detach().requires_grad_(True)
        leaves = tree_leaves(p)
        with torch.enable_grad():
            loss, _mets = self.split.bs_loss(p, a, labels)
            *grads, act_g = torch.autograd.grad(loss, leaves + [a])
        return float(loss.detach()), tree_unflatten(p, grads), act_g

    async def train(self, steps: int):
        """Run ``steps`` aggregation rounds; returns the per-round losses
        (the mean of the clients', in sorted-client order)."""
        await self._all_joined.wait()
        for step in range(steps):
            per_client: dict = {}
            pending = {
                asyncio.ensure_future(inbox.get()): cid
                for cid, (inbox, _w) in self._clients.items()}
            straggler = None
            while pending:
                done, _ = await asyncio.wait(
                    pending, timeout=self.stall_after_s,
                    return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    for cid in pending.values():
                        self.qos.record_stall(cid)
                    continue
                for task in done:
                    cid = pending.pop(task)
                    frame = task.result()
                    inbox, _w = self._clients[cid]
                    self.qos.record_queue_depth(cid, inbox.qsize())
                    acts = protocol.decode_act_payload(frame, self.device)
                    labels = frame.arrays["labels"].to(self.device)
                    loss, bs_g, act_g = self._micro(acts, labels)
                    del acts
                    per_client[cid] = (loss, bs_g)
                    del bs_g
                    straggler = cid
                    # the gradient leaves NOW, while other clients'
                    # uplinks are still in flight
                    await self._send_grad(cid, step, act_g, loss)
                    del act_g
            ordered = sorted(per_client)
            losses = [per_client[c][0] for c in ordered]
            trees = [per_client.pop(c)[1] for c in ordered]
            mean = mean_tree_(trees)
            del trees
            self.opt.update(mean, self.opt_state, self.bs_params, step)
            del mean
            self.losses.append(sum(losses) / len(losses))
            self.qos.record_round(straggler)
        return self.losses

    # -- audits --------------------------------------------------------------

    def wire_honesty(self, rtol: float = 0.01) -> dict:
        """Measured socket payload bytes per hop against the planner's
        bill (``protocol.billed_hop_bytes``; ``backward=True`` for the
        downlink): per direction, rows of (measured, billed, ok)."""
        out = {}
        for direction, rows in self.hop_audit.items():
            ent = []
            for payload_nbytes, n_el, d, itemsize in sorted(rows):
                billed = protocol.billed_hop_bytes(
                    n_el, d, self.wire_dtype, float(itemsize),
                    backward=(direction == "downlink"))
                ent.append({
                    "measured_bytes": int(payload_nbytes),
                    "billed_bytes": billed,
                    "ok": bool(abs(payload_nbytes - billed)
                               <= rtol * max(billed, 1.0)),
                })
            out[direction] = ent
        return out
