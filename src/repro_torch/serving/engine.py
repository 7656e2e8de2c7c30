"""Continuous-batching serving engine: one fixed-shape decode step.

Port of the JAX package's ``serving/engine.py``.  The engine owns a
``kv`` slot arena of ``slots`` lanes and runs ONE fixed-shape
decode-plus-sample step per iteration, whichever requests occupy which
slots:

* each lane decodes its own slot at its own position: one batched
  ``LM.decode_step`` over all slots with an int64 tensor of per-lane
  positions, which computes what the reference's ``vmap`` of a batch-1
  step over the arena computes (``models/blocks.py``: per-lane K/V
  writes and masks, per-lane recurrent and RWKV states, dropless MoE
  routing);
* temperature sampling runs inside the step with per-request keys, so
  sampled tokens are reproducible and independent of slot assignment
  and batch composition (``sample_tokens``);
* inactive lanes are inert: the rows the step would write keep their
  bytes, their tokens are held, and a freed slot is overwritten whole at
  the next admit.

On the card the step is captured once, at construction, as one CUDA
graph (the counterpart of the reference's ``jax.jit`` of its step; the
arena's addresses never change, which makes it possible).  Its inputs
are persistent device registers (tokens, positions, active, request
seeds and token indices, ``[slots]`` each), into which the host
registers are copied before each replay; one ``[slots]`` int32 copy
returns to the host after it.  A capture that fails raises: the engine
never carries on eagerly by itself.  ``graph=False`` is the explicit
eager run; on the CPU the step always runs eagerly.

Prefill is chunked through the scheduler: one length-bucketed chunk
(``LM.prefill_with_cache`` at the bucket's exact length: the flash
kernel on the card) is interleaved with decode steps under the chunk
token budget; the prefill's argmax seeds each lane's first decode and is
never emitted.

Modeled cost accounting, as in the reference: a decode step bills
``slots`` lane-tokens, a prefill chunk its exact token count;
``convoy_units`` prices the run-to-completion baseline for the same
request set.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _mg
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as _rw
from repro_torch.kernels import wire_codec as _wc
from repro_torch.runtime.qos import ServingQoS
from repro_torch.serving import kv
from repro_torch.serving.scheduler import Request, Scheduler

# every launch and route count a kernel wrapper keeps: a graph replay
# adds what the capture recorded
_COUNTERS = (ops.LAUNCHES, _fa.ROUTES, _fa.BWD_ROUTES, _mg.ROUTES,
             _rw.ROUTES, _wc.ROUTES)
_WARMUP_STEPS = 2       # eager steps on a side stream before the capture


def _check_servable(cfg):
    if getattr(cfg, "enc_layers", 0) or cfg.family in ("audio", "vlm"):
        raise ValueError(
            f"continuous batching serves decoder-only token LMs; "
            f"{cfg.name} (family={cfg.family}) carries encoder state "
            "the slot arena does not manage")


# ---------------------------------------------------------------------------
# Sampling: a counter-based Gumbel-max with the port's own keys.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant
    ``c`` < 2**32, in int64 operations that never overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A bijective 32-bit integer hash (C. Wellons' "lowbias32") of
    int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seed: int, rid, tok_idx, vocab: int, device):
    """Standard Gumbel noise [B, vocab] f32, a pure function of
    ``(seed, rid[b], tok_idx[b], v)``: ``u`` from an integer hash of the
    four (int64 tensor operations on ``device``: no generator state, so
    nothing for a CUDA graph to capture), ``g = -log(-log u)``."""
    rid = torch.as_tensor(rid, dtype=torch.int64, device=device).reshape(-1)
    tok_idx = torch.as_tensor(tok_idx, dtype=torch.int64,
                              device=device).reshape(-1)
    lane = _mix32(torch.full_like(rid, int(seed) & _M32))
    lane = _mix32(_mix32(lane ^ (rid & _M32)) ^ (tok_idx & _M32))   # [B]
    vid = _mix32(torch.arange(1, vocab + 1, dtype=torch.int64,
                              device=device))                       # [V]
    bits = _mix32(lane[:, None] ^ vid[None, :])
    # 23 bits + 1/2: exact in f32, strictly inside (0, 1)
    u = ((bits >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, temperature: float, seed: int, rid, tok_idx):
    """Next tokens [B] int64 from logits [B, V] f32.

    Greedy (``temperature == 0``) is ``argmax``, ties to the first index
    as in ``jnp.argmax``.  Otherwise Gumbel-max:
    ``argmax(logits / T + g)`` with ``g = gumbel_noise(seed, rid,
    tok_idx)``, one key per request (``rid``) and emitted-token index
    (``tok_idx``, from 0).  This keeps the reference's guarantees (the
    same request samples the same tokens in any slot and beside any
    other requests, and again on a rerun) but not its tokens: the
    reference folds ``rid`` and the index into ``jax.random`` threefry
    keys and samples ``categorical``, which PyTorch cannot reproduce at a
    reasonable cost."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    g = gumbel_noise(seed, rid, tok_idx, logits.shape[-1], logits.device)
    return torch.argmax(logits / float(temperature) + g, dim=-1)


def make_sample_step(model, temperature: float, seed: int = 0):
    """Decode + sample as one step (the reference fuses them into one
    jitted program; the engine captures this one as a CUDA graph).

    ``step(params, tokens [B, 1], cache, position, rid, tok_idx,
    active=None) -> (next tokens [B] int64, logits [B, V] f32, cache)``.
    ``position`` is an ``int`` (the static path) or an int64 tensor [B]
    of per-lane positions with ``active`` lanes (``LM.decode_step``);
    ``rid`` and ``tok_idx`` key the sampling (``sample_tokens``)."""
    temperature = float(temperature)

    def step(params, tokens, cache, position, rid, tok_idx, active=None):
        logits, cache = model.decode_step(params, tokens, cache, position,
                                          active)
        return (sample_tokens(logits, temperature, seed, rid, tok_idx),
                logits, cache)

    return step


class ServingEngine:
    """Slot-based continuous batching over one decoder-only LM.

    ``graph``: None captures the decode step as a CUDA graph on the card
    and runs it eagerly on the CPU; False runs it eagerly everywhere;
    True requires the card.  ``keep_logits``: request ids whose logits
    at every emitted token are kept on the host in ``kept_logits[rid]``
    ([n, V] f32 once done), for checks against a solo decode."""

    def __init__(self, model, params, *, slots: int, cache_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 prefill_chunk_tokens: int = 256, policy: str = "fifo",
                 max_queue: int | None = None,
                 cache_dtype=torch.float32, qos: ServingQoS | None = None,
                 graph: bool | None = None, keep_logits=()):
        _check_servable(model.cfg)
        if slots < 1:
            raise ValueError(f"slots={slots} must be >= 1")
        self.device = resolve_device(model.device)
        if graph is None:
            graph = self.device.type == "cuda"
        if graph and self.device.type != "cuda":
            raise ValueError("graph=True captures a CUDA graph: it needs "
                             "the model on the card")
        self.model = model
        self.params = params
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.cache_dtype = cache_dtype
        self.qos = qos or ServingQoS()
        self.axes = kv.slot_axes(model, self.cache_len, cache_dtype)
        self.scheduler = Scheduler(
            cache_len=self.cache_len,
            prefill_chunk_tokens=prefill_chunk_tokens,
            policy=policy, max_queue=max_queue)
        self.freelist = kv.FreeList(self.slots)

        # host-side lane registers
        self.positions = np.zeros(self.slots, np.int64)
        self.active = np.zeros(self.slots, bool)
        self.tokens = np.zeros(self.slots, np.int64)
        self.req_seed = np.zeros(self.slots, np.int64)
        self.tok_idx = np.zeros(self.slots, np.int64)
        self._tenant: dict[int, Request] = {}     # slot -> request
        self.outputs: dict[int, list] = {}        # rid -> emitted tokens
        self.done: dict[int, np.ndarray] = {}
        self._keep = set(keep_logits)
        self.kept_logits: dict[int, list] = {}

        # accounting
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.engine_units = 0                     # modeled lane-tokens
        self.occupancy_trace: list[int] = []

        self._sample_step = make_sample_step(model, self.temperature,
                                             self.seed)
        with torch.inference_mode():
            # the device arena and the step's input registers: tokens,
            # positions, active, request seeds, token indices
            self.cache = model.init_cache(self.slots, self.cache_len,
                                          cache_dtype)
            self._regs = torch.zeros((5, self.slots), dtype=torch.int64,
                                     device=self.device)
        self._graph = None
        self.capture_ms = None
        if graph:
            self._capture()

    # -- the fixed-shape step ------------------------------------------------

    def _device_step(self):
        """Decode + sample over every slot from the device registers.
        -> (next tokens [slots] int32, logits [slots, V] f32)."""
        tokens, positions, active, rid, tok_idx = self._regs.unbind(0)
        active = active != 0
        nxt, logits, _ = self._sample_step(
            self.params, tokens[:, None], self.cache, positions, rid,
            tok_idx, active)
        return torch.where(active, nxt, tokens).to(torch.int32), logits

    def _capture(self) -> None:
        """Capture ``_device_step`` as one CUDA graph: eager warm-up steps
        on the capture's side stream with every lane inactive (so they
        leave the arena as it was), then the capture.  The warm-up takes
        ``torch.cuda.graph``'s one stream for the process, not a stream of
        its own: cuBLAS keeps a workspace for every stream it has run on,
        for the life of the process.  The launches the capture records
        are taken back out of the counts and added at each replay.
        Raises when the capture fails."""
        dev = self.device
        with torch.inference_mode():
            self._regs.zero_()
            graph = torch.cuda.CUDAGraph()
            capture = torch.cuda.graph(graph)
            side = capture.capture_stream
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(_WARMUP_STEPS):
                    self._device_step()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            before = [collections.Counter(c) for c in _COUNTERS]
            t0 = time.perf_counter()
            try:
                with capture:
                    out = self._device_step()
            except RuntimeError as e:
                raise RuntimeError(
                    f"{self.model.cfg.name}: capturing the decode step as a "
                    f"CUDA graph failed ({e}); the engine does not fall back "
                    "to eager steps (pass graph=False to run them)") from e
            torch.cuda.synchronize(dev)
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        self._replay_counts = []
        for counter, was in zip(_COUNTERS, before):
            added = counter - was
            counter.clear()               # the capture launched nothing
            counter.update(was)
            self._replay_counts.append((counter, added))
        self._graph, self._out = graph, out

    def _run_step(self) -> np.ndarray:
        """One step from the host registers -> next tokens [slots]."""
        host = np.stack([self.tokens, self.positions, self.active,
                         self.req_seed, self.tok_idx]).astype(np.int64)
        with torch.inference_mode():
            self._regs.copy_(torch.from_numpy(host))
            if self._graph is not None:
                self._graph.replay()
                for counter, added in self._replay_counts:
                    counter.update(added)
                nxt, logits = self._out
            else:
                nxt, logits = self._device_step()
            keep = [s for s, r in self._tenant.items()
                    if self.active[s] and r.rid in self._keep]
            if keep:
                rows = logits[keep].cpu()
                for i, s in enumerate(keep):
                    self.kept_logits.setdefault(
                        self._tenant[s].rid, []).append(rows[i])
            return nxt.cpu().numpy()

    # -- request intake ------------------------------------------------------

    def submit(self, req: Request) -> bool:
        self.qos.record_submit(req.rid)
        ok = self.scheduler.submit(req)
        if not ok:
            self.qos.record_reject(req.rid)
        return ok

    # -- engine iterations ---------------------------------------------------

    def _admit_chunk(self, chunk: list) -> None:
        with torch.inference_mode():
            prompts = torch.as_tensor(np.stack([r.prompt for r in chunk]),
                                      dtype=torch.int64, device=self.device)
            logits, state = self.model.prefill_with_cache(
                self.params, {"tokens": prompts}, cache_len=self.cache_len,
                cache_dtype=self.cache_dtype)
            tok0 = torch.argmax(logits, dim=-1).cpu().numpy()
            bucket = state["cache"]
            self.prefill_chunks += 1
            self.engine_units += int(prompts.numel())
            for i, req in enumerate(chunk):
                slot = self.freelist.alloc()
                kv.put_slot(self.cache, self.axes,
                            kv.take_slot(bucket, self.axes, i), slot)
                self.positions[slot] = req.prompt_len
                self.active[slot] = True
                self.tokens[slot] = tok0[i]
                self.req_seed[slot] = req.rid
                self.tok_idx[slot] = 0
                self._tenant[slot] = req
                self.outputs[req.rid] = []
                self.qos.record_admit(req.rid, self.decode_steps)

    def _decode_once(self) -> None:
        nxt = self._run_step()
        self.decode_steps += 1
        self.engine_units += self.slots
        self.occupancy_trace.append(int(self.active.sum()))
        finished = []
        for slot, req in self._tenant.items():
            if not self.active[slot]:
                continue
            self.outputs[req.rid].append(int(nxt[slot]))
            self.qos.record_token(req.rid, self.decode_steps)
            self.positions[slot] += 1
            self.tok_idx[slot] += 1
            self.tokens[slot] = nxt[slot]
            if len(self.outputs[req.rid]) >= req.max_new_tokens:
                finished.append(slot)
        for slot in finished:
            req = self._tenant.pop(slot)
            self.active[slot] = False
            self.freelist.free(slot)
            self.done[req.rid] = np.asarray(self.outputs[req.rid], np.int32)
            if req.rid in self.kept_logits:
                self.kept_logits[req.rid] = torch.stack(
                    self.kept_logits[req.rid])
            self.qos.record_done(req.rid, self.decode_steps)

    def step_once(self) -> bool:
        """One engine iteration: at most one prefill chunk, then one
        decode step.  Returns False when fully idle."""
        chunk = self.scheduler.next_chunk(len(self.freelist))
        if chunk:
            self._admit_chunk(chunk)
        if self.active.any():
            self._decode_once()
            return True
        return bool(chunk)

    def run(self, requests=None, max_steps: int | None = None) -> dict:
        """Drain: submit ``requests`` (optional), iterate until idle.
        Returns ``{rid: np.ndarray of emitted tokens}``."""
        for req in (requests or []):
            self.submit(req)
        guard = max_steps if max_steps is not None else 10_000_000
        while (len(self.scheduler) or self.active.any()) and guard > 0:
            if not self.step_once():
                break
            guard -= 1
        if guard <= 0:
            raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return dict(self.done)

    def stats(self) -> dict:
        occ = self.occupancy_trace
        return {
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "engine_units": self.engine_units,
            "occupancy_mean": (float(np.mean(occ)) if occ else 0.0),
            "occupancy_trace_sum": int(np.sum(occ)) if occ else 0,
            "graph": self._graph is not None,
            "capture_ms": self.capture_ms,
            "qos": self.qos.snapshot(),
        }


# ---------------------------------------------------------------------------
# References: the solo decode the equivalence checks compare against, and
# the convoy cost model.
# ---------------------------------------------------------------------------


def solo_decode(model, params, prompt, max_new_tokens: int, *,
                cache_len: int, temperature: float = 0.0, seed: int = 0,
                rid: int = 0, cache_dtype=torch.float32, forced=None,
                keep_logits: bool = False):
    """Batch-1 run-to-completion decode with the ENGINE's sampling
    contract (greedy seed from the prefill logits; per-request keys at
    temperature > 0), on the static path (an ``int`` position): the
    ground truth every continuously-batched request must match.

    ``forced``: tokens to feed instead of the decode's own picks (teacher
    forcing on another run's tokens).  Returns the emitted tokens [n]
    int32, and with ``keep_logits`` also the logits [n, V] f32 on the
    host."""
    dev = resolve_device(model.device)
    step = make_sample_step(model, temperature, seed)
    out, kept = [], []
    with torch.inference_mode():
        prompt = torch.as_tensor(np.asarray(prompt, np.int64).reshape(1, -1),
                                 device=dev)
        logits, state = model.prefill_with_cache(
            params, {"tokens": prompt}, cache_len=cache_len,
            cache_dtype=cache_dtype)
        tok = torch.argmax(logits, dim=-1, keepdim=True)
        cache, position = state["cache"], state["position"]
        if forced is not None:
            forced = torch.as_tensor(np.asarray(forced, np.int64),
                                     device=dev)
        for i in range(max_new_tokens):
            nxt, logits, cache = step(params, tok, cache, position, rid, i)
            position += 1
            out.append(nxt)
            if keep_logits:
                kept.append(logits[0])
            tok = (nxt if forced is None else forced[i:i + 1])[:, None]
        toks = torch.cat(out).to(torch.int32).cpu().numpy()
        if keep_logits:
            return toks, torch.stack(kept).cpu()
    return toks


def convoy_units(requests, batch: int) -> int:
    """Modeled lane-token cost of the static run-to-completion baseline:
    groups of ``batch`` in submission order; each group prefills its
    exact prompt tokens, then decodes ``batch * max(gen in group)``
    lane-tokens (everyone waits for the longest generation: the convoy
    tax continuous batching removes)."""
    reqs = list(requests)
    total = 0
    for i in range(0, len(reqs), batch):
        group = reqs[i:i + batch]
        total += sum(r.prompt_len for r in group)
        total += batch * max(r.max_new_tokens for r in group)
    return total
