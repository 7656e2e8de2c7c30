"""Split-inference serving: the UE runs the sub-cut layers, the BS the rest.

Port of the JAX package's ``serving/infer.py``:

* ``SplitDecode`` cuts a homogeneous decoder-only LM after block ``l``
  into a UE half (embed + blocks[:l], with its own slice of the decode
  cache) and a BS half (blocks[l:] + final norm + head, with the other
  slice).  Composing the halves is the monolithic ``prefill_with_cache``
  / ``decode_step`` exactly: the same per-layer calls in the same order.
* ``run_split_infer`` drives a real asyncio loopback socket: the UE
  prefills its half and ships the coded cut activation of the whole
  prompt as one INFER frame, then per decode step ships one coded
  ``[B, 1, d]`` activation and receives the greedy token back.  The UE
  encodes on its device before the payload leaves it (the encode kernel
  on the card), the BS decodes on its device (the decode kernel), and the
  BS audits every uplink's measured payload bytes against
  ``protocol.billed_hop_bytes``.  A ``shaper`` (``wireless.LinkShaper``
  or anything with ``delay_s(nbytes)``) delays every frame both sides
  send; a ``qos`` (``runtime.qos.QoSMonitor``) counts the uplink frames
  the BS receives.
"""
from __future__ import annotations

import asyncio
import time

import torch

from repro_torch.models.lm import decode_blocks, prefill_blocks
from repro_torch.parallel.wire import parse_wire_dtype
from repro_torch.runtime import protocol
from repro_torch.utils.trees import tree_map


def _require_dense(wire_dtype: str) -> str:
    """INFER hops carry forward activations only: dense codecs."""
    base, frac = parse_wire_dtype(wire_dtype)
    if frac is not None:
        raise ValueError(
            f"wire_dtype {wire_dtype!r}: the INFER hop is forward-only "
            "(no gradient, no error feedback) — top-k sparsification "
            "would silently corrupt activations; use 'none', 'int8' or "
            "'fp8'")
    return base


class SplitDecode:
    """Cut a homogeneous decoder-only LM after block ``l`` for serving.

    UE = embed + blocks[:l]; BS = blocks[l:] + final_norm + head.  Both
    halves hold their own layers' slice of the decode cache, updated in
    place by the decode calls.
    """

    def __init__(self, model, l: int):
        cfg = model.cfg
        if not cfg.homogeneous:
            raise ValueError("SplitDecode requires a homogeneous stack")
        if cfg.tie_embeddings:
            raise ValueError("tied embeddings cannot be split at the head")
        if cfg.enc_layers or cfg.family in ("audio", "vlm"):
            raise ValueError(
                f"SplitDecode serves decoder-only token LMs, not "
                f"{cfg.family}")
        if not 1 <= l < cfg.num_layers:
            raise ValueError(
                f"cut l={l} must be in [1, {cfg.num_layers})")
        self.model = model
        self.cfg = cfg
        self.l = int(l)

    def split_params(self, params):
        """(ue_params, bs_params): views of ``params``, no copy."""
        l, n = self.l, self.cfg.num_layers
        take = lambda sl: tree_map(lambda a: a[sl], params["blocks"])
        ue = {"embed": params["embed"], "blocks": take(slice(0, l))}
        bs = {"blocks": take(slice(l, n)),
              "final_norm": params["final_norm"], "head": params["head"]}
        return ue, bs

    # -- UE half -------------------------------------------------------------

    def ue_prefill(self, ue_params, tokens, *, cache_len,
                   cache_dtype=torch.float32):
        """tokens [B, S] -> (cut activations [B, S, d], ue cache)."""
        model = self.model
        x = model._embed(ue_params, tokens, model.dtype)
        cache = model.init_cache(x.shape[0], cache_len, cache_dtype,
                                 layers=self.l)
        return prefill_blocks(self.cfg, ue_params["blocks"], x, cache), cache

    def ue_decode(self, ue_params, tok, cache, position: int):
        """tok [B, 1] -> (cut activation [B, 1, d], ue cache)."""
        model = self.model
        x = model._embed(ue_params, tok, model.dtype)
        x = decode_blocks(self.cfg, ue_params["blocks"], x, cache, position)
        return x, cache

    # -- BS half -------------------------------------------------------------

    def bs_prefill(self, bs_params, acts, *, cache_len,
                   cache_dtype=torch.float32):
        """Cut activations [B, S, d] -> (last-position logits [B, V] f32,
        bs cache)."""
        model = self.model
        x = acts.to(model.dtype)
        cache = model.init_cache(x.shape[0], cache_len, cache_dtype,
                                 layers=self.cfg.num_layers - self.l)
        x = prefill_blocks(self.cfg, bs_params["blocks"], x, cache)
        return model.logits(bs_params, x), cache

    def bs_decode(self, bs_params, act, cache, position: int):
        """Cut activation [B, 1, d] -> (logits [B, V] f32, bs cache)."""
        model = self.model
        x = act.to(model.dtype)
        x = decode_blocks(self.cfg, bs_params["blocks"], x, cache, position)
        return model.logits(bs_params, x), cache


def _greedy(logits) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


# ---------------------------------------------------------------------------
# Loopback split-inference serving (INFER frames on a real socket).
# ---------------------------------------------------------------------------


class BSInferServer:
    """BS side: receives coded cut activations, decodes them on its
    device, runs blocks[l:], replies the greedy token; audits wire
    honesty per uplink frame."""

    def __init__(self, split: SplitDecode, bs_params, *, cache_len: int,
                 wire_dtype: str = "none", shaper=None, qos=None,
                 host: str = "127.0.0.1", port: int = 0):
        _require_dense(wire_dtype)
        self.split = split
        self.bs_params = bs_params
        self.device = split.model.device
        self.cache_len = int(cache_len)
        self.wire_dtype = str(wire_dtype)
        self.shaper = shaper
        self.qos = qos
        self.host, self.port = host, int(port)
        self._server = None
        # (measured payload bytes, billed bytes) per uplink frame
        self.audit: list[tuple] = []

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def close(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _reply_tok(self, writer, cid, step, tok):
        frame = protocol.pack_frame(
            protocol.INFER, cid, step, meta={"phase": "tok"},
            arrays={"tok": tok})
        if self.shaper is not None:
            await asyncio.sleep(self.shaper.delay_s(len(frame)))
        writer.write(frame)
        await writer.drain()

    def _audit_uplink(self, frame) -> None:
        shape = frame.meta["shape"]
        n_elements = 1
        for s in shape:
            n_elements *= int(s)
        act_bytes = protocol.DTYPES[frame.meta["dtype"]].itemsize
        billed = protocol.billed_hop_bytes(
            n_elements, shape[-1], frame.meta["codec"], act_bytes)
        self.audit.append((frame.payload_nbytes, billed))
        if self.qos is not None:
            self.qos.record_arrival(frame.client, frame.wire_nbytes,
                                    frame.payload_nbytes, frame.aux_nbytes)

    async def _handle(self, reader, writer):
        hello = await protocol.read_frame(reader)
        if hello.ftype != protocol.HELLO:
            writer.close()
            raise ValueError(
                f"handshake must be HELLO, got ftype={hello.ftype}")
        if hello.meta.get("wire_dtype", self.wire_dtype) != self.wire_dtype:
            writer.close()
            raise ValueError(
                f"client codec {hello.meta.get('wire_dtype')!r} != server "
                f"{self.wire_dtype!r}")
        cid = hello.client
        split = self.split
        cache = None
        position = None
        try:
            while True:
                frame = await protocol.read_frame(reader)
                if frame.ftype == protocol.BYE:
                    break
                if frame.ftype != protocol.INFER:
                    raise ValueError(
                        f"expected INFER frame, got ftype={frame.ftype}")
                self._audit_uplink(frame)
                acts = protocol.decode_act_payload(frame, self.device)
                if frame.meta["phase"] == "prefill":
                    logits, cache = split.bs_prefill(
                        self.bs_params, acts, cache_len=self.cache_len)
                    position = acts.shape[1]
                else:
                    logits, cache = split.bs_decode(
                        self.bs_params, acts, cache, position)
                    position += 1
                await self._reply_tok(writer, cid, frame.step,
                                      _greedy(logits))
        finally:
            writer.close()


class UEInferClient:
    """UE side: prefills blocks[:l], then streams one coded cut
    activation per decode step and feeds the returned token back."""

    def __init__(self, client_id: int, split: SplitDecode, ue_params, *,
                 cache_len: int, wire_dtype: str = "none", shaper=None):
        _require_dense(wire_dtype)
        self.client_id = int(client_id)
        self.split = split
        self.ue_params = ue_params
        self.device = split.model.device
        self.cache_len = int(cache_len)
        self.wire_dtype = str(wire_dtype)
        self.shaper = shaper
        self.sent_payload_bytes = 0
        # host clock at the start of run(), the first token reply (the
        # prefill's round trip) and the last reply
        self.t_start = self.t_first = self.t_done = None

    async def _send(self, writer, payload: bytes):
        if self.shaper is not None:
            await asyncio.sleep(self.shaper.delay_s(len(payload)))
        writer.write(payload)
        await writer.drain()

    def _act_frame(self, act, step: int, phase: str) -> bytes:
        arrays, meta = protocol.encode_act_payload(act, self.wire_dtype)
        self.sent_payload_bytes += sum(
            t.numel() * t.element_size() for k, t in arrays.items()
            if k in protocol.PAYLOAD_SECTIONS)
        return protocol.pack_frame(protocol.INFER, self.client_id, step,
                                   meta=dict(meta, phase=phase),
                                   arrays=arrays)

    async def run(self, host: str, port: int, prompts, gen: int):
        """prompts [B, L] int -> emitted tokens [B, gen] int32 (CPU)
        (the BS's greedy chain; the prefill seed token is fed, not
        emitted)."""
        split = self.split
        prompts = torch.as_tensor(prompts).to(self.device, torch.int64)
        reader, writer = await asyncio.open_connection(host, port)
        cid = self.client_id
        self.t_start = time.perf_counter()
        try:
            await self._send(writer, protocol.pack_frame(
                protocol.HELLO, cid, 0,
                meta={"wire_dtype": self.wire_dtype, "mode": "infer"}))
            acts, cache = split.ue_prefill(self.ue_params, prompts,
                                           cache_len=self.cache_len)
            position = prompts.shape[1]
            await self._send(writer, self._act_frame(acts, 0, "prefill"))
            out = []
            for step in range(1, gen + 1):
                reply = await protocol.read_frame(reader)
                if reply.ftype != protocol.INFER \
                        or reply.meta.get("phase") != "tok":
                    raise ValueError(f"expected tok reply, got {reply}")
                tok = reply.arrays["tok"].to(torch.int32)
                if step == 1:
                    self.t_first = time.perf_counter()
                else:
                    out.append(tok[:, 0])
                act, cache = split.ue_decode(
                    self.ue_params, tok.to(self.device, torch.int64), cache,
                    position)
                position += 1
                await self._send(writer, self._act_frame(act, step, "decode"))
            # one reply is still in flight: the token of the last decode
            reply = await protocol.read_frame(reader)
            out.append(reply.arrays["tok"][:, 0].to(torch.int32))
            self.t_done = time.perf_counter()
            await self._send(writer, protocol.pack_frame(
                protocol.BYE, cid, gen))
            return torch.stack(out, dim=1)
        finally:
            writer.close()


async def _run_split_infer(model, params, *, cut, prompts, gen,
                           cache_len, wire_dtype="none", shaper=None,
                           qos=None):
    split = SplitDecode(model, cut)
    ue_params, bs_params = split.split_params(params)
    server = BSInferServer(split, bs_params, cache_len=cache_len,
                           wire_dtype=wire_dtype, shaper=shaper, qos=qos)
    host, port = await server.start()
    client = UEInferClient(0, split, ue_params, cache_len=cache_len,
                           wire_dtype=wire_dtype, shaper=shaper)
    try:
        tokens = await client.run(host, port, prompts, gen)
    finally:
        await server.close()
        # the closed server stays in reference cycles with the event
        # loop's objects until a garbage collection: drop its weights now
        server.bs_params = client.ue_params = None
    measured = sum(m for m, _ in server.audit)
    billed = sum(b for _, b in server.audit)
    decode_s = max(client.t_done - client.t_first, 1e-9)
    return {"tokens": tokens,
            "prefill_ms": (client.t_first - client.t_start) * 1e3,
            "decode_tok_s": tokens.numel() / decode_s,
            "measured_payload_bytes": int(measured),
            "billed_payload_bytes": float(billed),
            "frames": len(server.audit),
            "client_payload_bytes": int(client.sent_payload_bytes)}


def run_split_infer(model, params, *, cut: int, prompts, gen: int,
                    cache_len: int, wire_dtype: str = "none", shaper=None,
                    qos=None) -> dict:
    """Serve ``prompts`` for ``gen`` greedy tokens through the split
    UE->BS loopback (``shaper`` delaying every frame, ``qos`` counting the
    uplink); returns tokens + the wire-honesty audit sums."""
    return asyncio.run(_run_split_infer(
        model, params, cut=cut, prompts=prompts, gen=gen,
        cache_len=cache_len, wire_dtype=wire_dtype, shaper=shaper,
        qos=qos))
