"""Serving: the continuous-batching engine, its slot arena and scheduler,
and split inference over a loopback socket (the JAX package's
``repro.serving`` exports, as far as the port has them)."""
from repro_torch.serving.engine import (ServingEngine, convoy_units,
                                        make_sample_step, solo_decode)
from repro_torch.serving.infer import (BSInferServer, SplitDecode,
                                       UEInferClient, run_split_infer)
from repro_torch.serving.kv import FreeList, slot_axes
from repro_torch.serving.scheduler import POLICIES, Request, Scheduler

__all__ = [
    "BSInferServer", "FreeList", "POLICIES", "Request", "Scheduler",
    "ServingEngine", "SplitDecode", "UEInferClient", "convoy_units",
    "make_sample_step", "run_split_infer", "slot_axes", "solo_decode",
]
