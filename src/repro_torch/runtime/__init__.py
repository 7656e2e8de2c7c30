"""Async multi-client streaming runtime: UE clients -> BS dispatcher over
a real (loopback) socket, with measured per-hop link feeds.

``protocol`` and ``qos`` import eagerly; the training pieces
(``UEClient``/``UESync``/``BSDispatcher``/``run_streaming``) load on
first use, as the reference's do, so the frame format imports without
the model stack.
"""
from repro_torch.runtime import protocol, qos
from repro_torch.runtime.protocol import (Frame, pack_frame, read_frame,
                                          unpack_frame)
from repro_torch.runtime.qos import ClientStats, QoSMonitor

__all__ = [
    "BSDispatcher", "ClientStats", "Frame", "QoSMonitor", "UEClient",
    "UESync", "client_batches", "pack_frame", "protocol", "qos",
    "read_frame", "run_streaming", "unpack_frame",
]

_LAZY = {
    "BSDispatcher": "repro_torch.runtime.bs",
    "UEClient": "repro_torch.runtime.ue",
    "UESync": "repro_torch.runtime.ue",
    "client_batches": "repro_torch.runtime.driver",
    "run_streaming": "repro_torch.runtime.driver",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
