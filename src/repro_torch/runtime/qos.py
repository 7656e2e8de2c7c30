"""QoS monitor for the streaming runtime (stdlib only).

Copy of the JAX package's ``runtime/qos.py``: the port imports nothing
of it.  ``QoSMonitor`` is fed by the streaming runtime's dispatcher
(``runtime/bs.py``) and the split-serving server (``serving/infer.py``);
``ServingQoS`` is the continuous-batching engine's.

Per-UE counters the in-process simulator cannot express — measured
arrival rates, queue occupancy, backpressure and straggler behaviour of
a real transport:

* **arrival rate** — EWMA of 1/inter-arrival time per client;
* **queue depth** — the BS-side bounded inbox occupancy (current and
  high-water) per client;
* **backpressure events** — arrivals that found the inbox full (the
  reader then blocks on ``put``, which stops draining the socket and
  pushes TCP backpressure down to the UE's ``drain()``);
* **stalls / stragglers** — rounds where the aggregator waited longer
  than ``stall_after_s`` on a client (stall), and which client closed
  each aggregation round (straggler).

``snapshot()`` returns a plain-JSON dict (the ``--qos-out`` payload and
the ``streaming_smoke`` bench's non-deterministic sidecar).
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class ClientStats:
    frames_in: int = 0
    frames_out: int = 0
    wire_bytes_in: int = 0          # full frames incl. prefix/header/meta
    wire_bytes_out: int = 0
    payload_bytes_in: int = 0       # codec payload only (billed hop bytes)
    payload_bytes_out: int = 0
    aux_bytes_in: int = 0           # labels/control sections
    last_arrival_t: float | None = None
    arrival_rate_hz: float | None = None
    queue_depth: int = 0
    queue_high_water: int = 0
    backpressure_events: int = 0
    stalls: int = 0
    straggler_rounds: int = 0


class QoSMonitor:
    def __init__(self, ewma: float = 0.7, stall_after_s: float = 0.25,
                 clock=time.monotonic):
        self.ewma = float(ewma)
        self.stall_after_s = float(stall_after_s)
        self.clock = clock
        self.clients: dict = {}
        self.rounds = 0

    def _c(self, client: int) -> ClientStats:
        if client not in self.clients:
            self.clients[client] = ClientStats()
        return self.clients[client]

    # -- feeds ---------------------------------------------------------------

    def record_arrival(self, client: int, wire_nbytes: int,
                       payload_nbytes: int, aux_nbytes: int = 0) -> None:
        c = self._c(client)
        now = self.clock()
        c.frames_in += 1
        c.wire_bytes_in += int(wire_nbytes)
        c.payload_bytes_in += int(payload_nbytes)
        c.aux_bytes_in += int(aux_nbytes)
        if c.last_arrival_t is not None:
            dt = max(now - c.last_arrival_t, 1e-9)
            rate = 1.0 / dt
            c.arrival_rate_hz = (rate if c.arrival_rate_hz is None
                                 else self.ewma * c.arrival_rate_hz
                                 + (1.0 - self.ewma) * rate)
        c.last_arrival_t = now

    def record_send(self, client: int, wire_nbytes: int,
                    payload_nbytes: int) -> None:
        c = self._c(client)
        c.frames_out += 1
        c.wire_bytes_out += int(wire_nbytes)
        c.payload_bytes_out += int(payload_nbytes)

    def record_queue_depth(self, client: int, depth: int) -> None:
        c = self._c(client)
        c.queue_depth = int(depth)
        c.queue_high_water = max(c.queue_high_water, int(depth))

    def record_backpressure(self, client: int) -> None:
        self._c(client).backpressure_events += 1

    def record_stall(self, client: int) -> None:
        self._c(client).stalls += 1

    def record_round(self, straggler: int | None) -> None:
        self.rounds += 1
        if straggler is not None:
            self._c(straggler).straggler_rounds += 1

    # -- export --------------------------------------------------------------

    def totals(self) -> dict:
        out = {"frames_in": 0, "frames_out": 0, "wire_bytes_in": 0,
               "wire_bytes_out": 0, "payload_bytes_in": 0,
               "payload_bytes_out": 0, "aux_bytes_in": 0,
               "backpressure_events": 0, "stalls": 0}
        for c in self.clients.values():
            for k in out:
                out[k] += getattr(c, k)
        return out

    def snapshot(self) -> dict:
        return {
            "rounds": self.rounds,
            "totals": self.totals(),
            "clients": {str(cid): dataclasses.asdict(c)
                        for cid, c in sorted(self.clients.items())},
        }


# ---------------------------------------------------------------------------
# Serving-side QoS: per-request latency percentiles + admission counters.
# ---------------------------------------------------------------------------


def percentile(samples, q: float) -> float | None:
    """Nearest-rank percentile (q in [0, 100]) of a sample list.

    Deterministic and schema-stable (no interpolation): the value
    returned is always one of the samples.  None on an empty list.
    """
    if not samples:
        return None
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} must be in [0, 100]")
    xs = sorted(float(x) for x in samples)
    rank = max(1, int(-(-q * len(xs) // 100)))     # ceil(q/100 * n), >= 1
    return xs[min(rank, len(xs)) - 1]


@dataclasses.dataclass
class RequestTimeline:
    """Latency stamps of one serving request (wall clock + engine step)."""

    submit_t: float
    admit_t: float | None = None
    first_token_t: float | None = None
    done_t: float | None = None
    admit_step: int | None = None
    first_token_step: int | None = None
    done_step: int | None = None
    tokens: int = 0

    @property
    def ttft_s(self) -> float | None:
        """Submit -> first emitted token (queue wait + prefill + the
        first decode)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def per_token_s(self) -> float | None:
        """Mean decode seconds per emitted token after the first."""
        if self.done_t is None or self.first_token_t is None \
                or self.tokens < 2:
            return None
        return (self.done_t - self.first_token_t) / (self.tokens - 1)


class ServingQoS:
    """Per-request latency percentiles + admission/reject counters for
    the continuous-batching serving engine (``repro_torch.serving.engine``).

    The engine stamps submit/admit/first-token/done per request; the
    snapshot derives p50/p99 TTFT and per-token latency (nearest-rank,
    over COMPLETED requests) next to the admission counters.  ``clock``
    is injectable so tests can drive a scripted clock and pin exact
    percentile values.
    """

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.requests: dict = {}
        self.admitted = 0
        self.rejected = 0
        self.completed = 0

    def _r(self, rid: int) -> RequestTimeline:
        if rid not in self.requests:
            raise KeyError(f"request {rid} was never submitted")
        return self.requests[rid]

    def record_submit(self, rid: int) -> None:
        if rid in self.requests:
            raise ValueError(f"request {rid} submitted twice")
        self.requests[rid] = RequestTimeline(submit_t=self.clock())

    def record_reject(self, rid: int) -> None:
        self.rejected += 1
        self.requests.pop(rid, None)

    def record_admit(self, rid: int, step: int) -> None:
        self.admitted += 1
        r = self._r(rid)
        r.admit_t = self.clock()
        r.admit_step = int(step)

    def record_token(self, rid: int, step: int) -> None:
        r = self._r(rid)
        r.tokens += 1
        if r.first_token_t is None:
            r.first_token_t = self.clock()
            r.first_token_step = int(step)

    def record_done(self, rid: int, step: int) -> None:
        self.completed += 1
        r = self._r(rid)
        r.done_t = self.clock()
        r.done_step = int(step)

    def latency_percentiles(self) -> dict:
        done = [r for r in self.requests.values() if r.done_t is not None]
        ttft = [r.ttft_s for r in done if r.ttft_s is not None]
        per_tok = [r.per_token_s for r in done if r.per_token_s is not None]
        return {
            "p50_ttft_s": percentile(ttft, 50),
            "p99_ttft_s": percentile(ttft, 99),
            "p50_tok_s": percentile(per_tok, 50),
            "p99_tok_s": percentile(per_tok, 99),
        }

    def snapshot(self) -> dict:
        return {
            "admitted": self.admitted,
            "rejected": self.rejected,
            "completed": self.completed,
            "in_flight": sum(1 for r in self.requests.values()
                             if r.admit_t is not None and r.done_t is None),
            "queued": sum(1 for r in self.requests.values()
                          if r.admit_t is None),
            "latency": self.latency_percentiles(),
            "tokens_emitted": sum(r.tokens for r in self.requests.values()),
        }
