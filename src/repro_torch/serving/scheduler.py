"""Request queue + admission policy for the continuous-batching engine.

Copy of the JAX package's ``serving/scheduler.py`` (numpy only; the
port imports nothing of it).

The scheduler owns everything host-side about WHICH work runs next; the
engine owns HOW it runs (the fixed-shape decode step).  Per engine
iteration the scheduler hands back at most one **prefill chunk**: a length-bucketed
group of queued requests (identical prompt length -> one fixed-shape
``prefill_with_cache`` call, no padding, bit-identical to each
request's solo prefill) bounded by

* the number of free slots, and
* ``prefill_chunk_tokens`` — the token budget one chunk may spend, so a
  burst of long prompts cannot stall in-flight decodes for many steps
  (decode steps interleave between chunks).

Admission control is part of the same surface: a request whose
``prompt + max_new_tokens`` cannot fit the arena's ``cache_len`` is
REJECTED (counted by the QoS monitor), and an optional ``max_queue``
bounds the backlog the engine will accept.

Policies: ``fifo`` (arrival order) and ``longest_first`` (longest
declared generation first — LPT scheduling; drains ragged gen mixes
with a shorter idle tail; the reference's ``benchmarks/serve_bench.py``
runs it).
"""
from __future__ import annotations

import dataclasses

import numpy as np

POLICIES = ("fifo", "longest_first")


@dataclasses.dataclass
class Request:
    """One serving request: a prompt and a declared generation budget."""

    rid: int
    prompt: np.ndarray            # [L] int32 token ids
    max_new_tokens: int

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens="
                f"{self.max_new_tokens} must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)


class Scheduler:
    def __init__(self, *, cache_len: int, prefill_chunk_tokens: int = 256,
                 policy: str = "fifo", max_queue: int | None = None):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1")
        self.cache_len = int(cache_len)
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.policy = policy
        self.max_queue = None if max_queue is None else int(max_queue)
        self._queue: list[Request] = []
        self.submitted = 0
        self.rejected = 0

    def __len__(self):
        return len(self._queue)

    @property
    def pending(self) -> tuple:
        return tuple(self._queue)

    def submit(self, req: Request) -> bool:
        """Queue a request; False = rejected (does not fit the arena's
        cache, or the backlog is at ``max_queue``)."""
        self.submitted += 1
        if req.prompt_len + req.max_new_tokens > self.cache_len:
            self.rejected += 1
            return False
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self.rejected += 1
            return False
        self._queue.append(req)
        return True

    def _order(self) -> list[Request]:
        if self.policy == "longest_first":
            # stable: ties keep arrival order
            return sorted(self._queue, key=lambda r: -r.max_new_tokens)
        return list(self._queue)

    def next_chunk(self, free_slots: int) -> list[Request]:
        """Pop the next length-bucketed prefill chunk.

        The bucket length is the head-of-line request's prompt length
        (under the active policy); further queued requests join the
        chunk only if they share that exact length, while slots and the
        token budget last.  The head request is always admitted even
        when its prompt alone exceeds the budget — a long prompt must
        not starve.
        """
        if free_slots < 1 or not self._queue:
            return []
        ordered = self._order()
        bucket_len = ordered[0].prompt_len
        chunk: list[Request] = []
        spent = 0
        for req in ordered:
            if len(chunk) >= free_slots:
                break
            if req.prompt_len != bucket_len:
                continue
            if chunk and spent + req.prompt_len > self.prefill_chunk_tokens:
                break
            chunk.append(req)
            spent += req.prompt_len
        for req in chunk:
            self._queue.remove(req)
        return chunk
