"""Length-prefixed frame protocol of the UE -> BS runtime, on tensors.

Port of the JAX package's ``runtime/protocol.py``.  One frame on the wire::

    u32 total_len | header (20 B) | meta (JSON) | payload sections

    header = !4s B B H I I I
             magic 'C2P2' | version | ftype | client_id
             | step | meta_len | payload_len

``payload`` is the concatenation of named binary sections; the meta JSON
carries a ``sections`` table ``[[name, dtype, shape], ...]``.  For the
same input a frame is byte-identical to the reference's: same section
names, dtype names and meta JSON.  Section bytes move as ``uint8`` views
of the tensors, and dtype names resolve through ``DTYPES`` (the
reference needs ``ml_dtypes`` for ``bfloat16`` and ``float8_e4m3fn``;
the port needs nothing beyond torch).

Sections named in ``PAYLOAD_SECTIONS`` are codec payload (what the
planner bills as hop bytes); everything else (``labels``, the token
reply) is aux traffic.

The payload codecs code on the tensor's device (the codec kernels on the
card, their plain versions on the CPU), where the reference codes on the
host with numpy: the same bytes, since the port's plain quantizer equals
the reference's host codec bit for bit.  The activation hop ships the
dense base codec; the gradient hop of a ``+topk<frac>`` codec ships the
top-k of the gradient plus the sender's per-client f32 error-feedback
residual (``encode_grad_payload``); 'none' and the degenerate-block
net-loss fallback ship raw.
"""
from __future__ import annotations

import dataclasses
import json
import struct

import torch

from repro_torch.analysis import autotune
from repro_torch.parallel import wire

MAGIC = b"C2P2"
VERSION = 1

HELLO = 1     # client -> server: join (meta: wire_dtype, shapes)
ACT = 2       # client -> server: coded cut activations + labels
GRAD = 3      # server -> client: coded cut-activation gradient
STATS = 4     # either direction: QoS/telemetry snapshot
BYE = 5       # client -> server: clean shutdown
INFER = 6     # serving: UE->BS coded cut activation (phase=prefill/decode),
              # BS->UE sampled token reply (phase=tok, aux section, un-billed)

_HEADER = struct.Struct("!4sBBHIII")
_LEN = struct.Struct("!I")

PAYLOAD_SECTIONS = ("q", "scale", "idx", "raw")

MAX_FRAME_BYTES = 1 << 30

# section dtype name (numpy's spelling, as the reference writes it) <-> torch
DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def dtype_name(dt: torch.dtype) -> str:
    if dt not in _NAMES:
        raise TypeError(f"no wire name for dtype {dt}")
    return _NAMES[dt]


def _dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown section dtype {name!r}")
    return DTYPES[name]


@dataclasses.dataclass
class Frame:
    """A decoded frame: typed header + meta dict + named CPU tensors."""

    ftype: int
    client: int
    step: int
    meta: dict
    arrays: dict
    wire_nbytes: int        # total bytes on the socket (prefix included)

    @property
    def payload_nbytes(self) -> int:
        """Codec-payload bytes only (the billed hop traffic)."""
        return sum(t.numel() * t.element_size()
                   for name, t in self.arrays.items()
                   if name in PAYLOAD_SECTIONS)

    @property
    def aux_nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for name, t in self.arrays.items()
                   if name not in PAYLOAD_SECTIONS)


def _section_bytes(t: torch.Tensor) -> bytes:
    flat = t.detach().contiguous().reshape(-1).cpu()
    return flat.view(torch.uint8).numpy().tobytes()


def pack_frame(ftype: int, client: int, step: int, meta: dict | None = None,
               arrays: dict | None = None) -> bytes:
    """Frame bytes; ``arrays`` are tensors on any device (copied to the
    host here)."""
    meta = dict(meta or {})
    arrays = arrays or {}
    sections = []
    chunks = []
    for name, t in arrays.items():
        sections.append([name, dtype_name(t.dtype), list(t.shape)])
        chunks.append(_section_bytes(t))
    meta["sections"] = sections
    meta_b = json.dumps(meta, separators=(",", ":")).encode()
    payload = b"".join(chunks)
    header = _HEADER.pack(MAGIC, VERSION, int(ftype), int(client),
                          int(step), len(meta_b), len(payload))
    body = header + meta_b + payload
    return _LEN.pack(len(body)) + body


def unpack_frame(body: bytes, *, wire_nbytes: int | None = None) -> Frame:
    """Decode a frame body (everything after the length prefix)."""
    magic, version, ftype, client, step, meta_len, payload_len = \
        _HEADER.unpack_from(body)
    if magic != MAGIC:
        raise ValueError(f"bad frame magic {magic!r} (expected {MAGIC!r})")
    if version != VERSION:
        raise ValueError(f"frame version {version} != {VERSION}")
    if _HEADER.size + meta_len + payload_len != len(body):
        raise ValueError(
            f"frame length mismatch: header says "
            f"{_HEADER.size + meta_len + payload_len}, body is {len(body)}")
    meta = json.loads(body[_HEADER.size:_HEADER.size + meta_len])
    start = _HEADER.size + meta_len
    buf = torch.frombuffer(bytearray(body[start:]), dtype=torch.uint8) \
        if payload_len else torch.empty(0, dtype=torch.uint8)
    arrays = {}
    off = 0
    for name, dtype, shape in meta.pop("sections", []):
        dt = _dtype(dtype)
        n = 1
        for s in shape:
            n *= int(s)
        nb = n * dt.itemsize
        if off + nb > payload_len:
            raise ValueError(f"section {name!r} overruns the payload")
        seg = buf[off:off + nb]
        if off % dt.itemsize:
            seg = seg.clone()           # realign for the dtype view
        arrays[name] = seg.view(dt).reshape(shape)
        off += nb
    if off != payload_len:
        raise ValueError(
            f"payload sections cover {off} bytes, header says {payload_len}")
    return Frame(ftype=ftype, client=client, step=step, meta=meta,
                 arrays=arrays,
                 wire_nbytes=(wire_nbytes if wire_nbytes is not None
                              else _LEN.size + len(body)))


async def read_frame(reader) -> Frame:
    """Read one length-prefixed frame from an asyncio StreamReader."""
    prefix = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(prefix)
    if n > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {n} bytes exceeds MAX_FRAME_BYTES")
    body = await reader.readexactly(n)
    return unpack_frame(body, wire_nbytes=_LEN.size + n)


# ---------------------------------------------------------------------------
# Activation / gradient payload codecs.
# ---------------------------------------------------------------------------


def encode_act_payload(x: torch.Tensor, wire_dtype: str):
    """Cut activation [..., d] -> (arrays, meta fields) for an ACT or
    INFER frame, coded on x's device.  Dense base codec (the forward hop
    never sparsifies); 'none' and the net-loss condition ship raw."""
    base, _frac = wire.parse_wire_dtype(wire_dtype)
    meta = {"codec": str(wire_dtype), "shape": list(x.shape),
            "dtype": dtype_name(x.dtype)}
    if base == "none":
        return {"raw": x}, dict(meta, kind="raw")
    q, scale = wire.encode(x, base)
    if scale is None:
        return {"raw": q}, dict(meta, kind="raw")
    return {"q": q, "scale": scale}, dict(meta, kind="dense")


def decode_act_payload(frame: Frame, device) -> torch.Tensor:
    """The activation of an ACT or INFER frame, decoded on ``device``."""
    out_dtype = _dtype(frame.meta["dtype"])
    if frame.meta["kind"] == "raw":
        return frame.arrays["raw"].to(device).to(out_dtype)
    return wire.decode(frame.arrays["q"].to(device),
                       frame.arrays["scale"].to(device), out_dtype)


def encode_grad_payload(g: torch.Tensor, wire_dtype: str, ef=None):
    """Cut-activation gradient [..., d] -> (arrays, meta, new_ef), coded
    on g's device.

    A ``+topk<frac>`` codec sparsifies this reverse hop with per-client
    error feedback: ``corrected = g + ef`` (f32; the sender keeps one
    residual per client) ships its top-k, and the new residual is
    ``corrected - decoded``, the mass not shipped.  At a degenerate block
    (``wire.codec_net_loss``) it ships raw and the residual passes through
    unchanged.  Dense codecs are direction-symmetric and carry no EF."""
    _base, frac = wire.parse_wire_dtype(wire_dtype)
    d = g.shape[-1]
    meta = {"codec": str(wire_dtype), "shape": list(g.shape),
            "dtype": dtype_name(g.dtype)}
    if frac is None:
        arrays, m = encode_act_payload(g, wire_dtype)
        return arrays, dict(meta, kind=m["kind"]), ef
    if wire.codec_net_loss(d, g.element_size()):
        return {"raw": g}, dict(meta, kind="raw"), ef
    corrected = g.to(torch.float32)
    if ef is not None:
        corrected = corrected + ef
    q, idx, scale = wire.topk_encode(corrected, wire_dtype)
    dec = wire.topk_decode(q, idx, scale, d, torch.float32)
    return ({"q": q, "idx": idx, "scale": scale}, dict(meta, kind="topk"),
            corrected - dec)


def decode_grad_payload(frame: Frame, device) -> torch.Tensor:
    """The gradient of a GRAD frame, decoded on ``device``."""
    kind = frame.meta["kind"]
    if kind != "topk":
        return decode_act_payload(frame, device)
    out_dtype = _dtype(frame.meta["dtype"])
    a = {k: frame.arrays[k].to(device) for k in ("q", "idx", "scale")}
    return wire.topk_decode(a["q"], a["idx"], a["scale"],
                            frame.meta["shape"][-1], out_dtype)


def billed_hop_bytes(n_elements: int, d_model: int, wire_dtype: str,
                     act_bytes: float, *, backward: bool = False) -> float:
    """What the planner bills this hop: ``autotune.wire_bytes_per_element``
    (or ``_bwd``) x elements at the effective block for this width — the
    number the measured bytes must match (the discrete ``round(frac*d)``
    top-k count is the only divergence from the continuous ``frac``)."""
    block = autotune.wire_block_for(int(d_model))
    if backward:
        per = autotune.wire_bytes_per_element_bwd(
            wire_dtype, act_bytes, block, d_model=int(d_model))
    else:
        per = autotune.wire_bytes_per_element(wire_dtype, act_bytes, block)
    return float(per) * int(n_elements)
