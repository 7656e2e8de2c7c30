"""Wire byte model of the hop, from the JAX package's planner.

Only the pieces the serving audit bills with (``wire_block_for``,
``wire_bytes_per_element``); the planner itself is listed in ROADMAP.md.
The codec grammar and block rule are the port's own
(``parallel/wire.py``), so the billing cannot drift from the codec.
"""
from __future__ import annotations

from repro_torch.parallel.wire import parse_wire_dtype, wire_block

WIRE_BLOCK = 256


def wire_block_for(d_model, block: int = WIRE_BLOCK) -> int:
    """Effective codec block for a model width: the largest divisor of
    ``d_model`` that is <= ``block``.  Unknown ``d_model`` assumes the
    nominal block."""
    if d_model is None or int(d_model) <= 0:
        return block
    return wire_block(int(d_model), block)


def wire_bytes_per_element(wire_dtype: str, act_bytes: float,
                           block: int = WIRE_BLOCK) -> float:
    """Wire bytes one activation element costs on the FORWARD hop:
    ``act_bytes`` raw for 'none', else one payload byte plus the
    per-block fp32 scale at the EFFECTIVE block."""
    base, _frac = parse_wire_dtype(wire_dtype)
    if base == "none":
        return float(act_bytes)
    return 1.0 + 4.0 / max(1, int(block))
