"""Serving CLI: static convoy, continuous batching, or split inference.

Port of the JAX package's ``launch/serve.py``.  Runs on the card unless
``--device cpu`` is given; without CUDA and without that flag it raises.

* static (default): prefill a prompt batch with ``LM.prefill_with_cache``
  (or, with ``--token-loop-prefill``, the reference's token-by-token feed
  through the decode step, ``prefill_into_cache``), then ``--gen`` decode
  + sample steps (``serving.engine.make_sample_step``: greedy, or
  ``--temperature > 0`` with the port's sampling keys, the batch row as
  the request id).
* ``--continuous``: the continuous-batching engine
  (``serving.engine.ServingEngine``): a slot arena of ``--slots`` lanes
  (or ``--slots auto``: ``analysis/autotune.choose_serving_plan`` on
  measured step costs, which needs ``--arrival-hz``), chunked prefill
  interleaved with one fixed-shape decode step (one CUDA graph on the
  card), per-request QoS latency percentiles.  Not with ``--split-cut``.
* ``--split-cut L``: the UE half (embed + blocks[:L]) ships coded cut
  activations as INFER frames over a real loopback socket
  (``--wire-dtype`` none/int8/fp8) to the BS half, which replies with the
  greedy token; prints the measured-vs-billed wire audit and the BS's
  QoS counts.  ``--bw-Bps`` shapes both directions with a
  ``wireless.LinkShaper``.  Homogeneous
  stacks with an untied head only (qwen1.5-4b, qwen3-moe-30b-a3b,
  rwkv6-3b): a hybrid (recurrentgemma-2b) or tied embeddings
  (granite-moe-3b-a800m) raise ``ValueError``, as the reference's
  ``SplitDecode`` does.

Every registered decoder-only LM serves static and continuous:
qwen1.5-4b, recurrentgemma-2b, granite-moe-3b-a800m, qwen3-moe-30b-a3b (at
full width its bf16 weights take 61.1 GB of the card) and rwkv6-3b (its
decode state the WKV6 state and the two token shifts).  The
encoder-decoder whisper-small serves static only: ``--batch`` segments of
stub frame embeddings [enc_seq, d_model] f32 (drawn after the prompts from
the same seed, cast to the compute dtype) go through the encoder; the
one-pass prefill caches each decoder layer's cross K/V, and
``--token-loop-prefill`` encodes, fills them (``LM.fill_cross_kv``) and
then feeds the prompt.  ``--continuous`` and ``--split-cut`` raise
``ValueError`` on it, as the reference's engine and ``SplitDecode`` do.
The prefix-LM paligemma-3b serves static only and always by the token
loop, as the reference's CLI does: like it, the CLI feeds no patch
embeddings (``LM.prefill_with_cache`` takes them from a caller);
``--continuous`` and ``--split-cut`` raise ``ValueError``.

PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
    --size full --batch 4 --prompt-len 512 --gen 32
PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
    --size full --split-cut 20 --wire-dtype int8
PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
    --size full --continuous --requests 12 --prompt-len 512 \
    --gen-mix 8,32,128 --slots 8 --policy longest_first \
    --prefill-chunk-tokens 2048
PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
    --size full --batch 4 --prompt-len 512 --gen 32
PYTHONPATH=src python -m repro_torch.launch.serve \
    --arch granite-moe-3b-a800m --size full --batch 4 --prompt-len 512 --gen 32
PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
    --size full --batch 4 --prompt-len 512 --gen 32
PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
    --size full --batch 4 --prompt-len 512 --gen 32 --split-cut 24 \
    --wire-dtype int8
PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
    --size full --batch 4 --prompt-len 512 --gen 32 --split-cut 16 \
    --wire-dtype int8
PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
    --size full --continuous --requests 12 --prompt-len 512 \
    --gen-mix 8,32,128 --slots 8 --policy longest_first \
    --prefill-chunk-tokens 2048
PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
    --size smoke --batch 2 --prompt-len 10 --gen 4 --token-loop-prefill
PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
    --size full --batch 8 --prompt-len 224 --gen 224
PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
    --size full --batch 8 --prompt-len 224 --gen 224 --token-loop-prefill
PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
    --size full --batch 4 --prompt-len 128 --gen 32
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.launch.plan_args import add_plan_args
from repro_torch.models.lm import LM
from repro_torch.parallel.wire import validate_wire_dtype
from repro_torch.runtime.qos import QoSMonitor
from repro_torch.serving.engine import (ServingEngine, convoy_units,
                                        make_sample_step)
from repro_torch.serving.infer import SplitDecode, run_split_infer
from repro_torch.serving.scheduler import POLICIES, Request
from repro_torch.wireless.channel import LinkShaper


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_into_cache(model, params, tokens, cache):
    """Token-by-token prompt feed (the reference's path, any family):
    ``LM.decode_step`` once a prompt token, at positions 0..S-1, into
    ``cache`` (``LM.init_cache``, updated in place).  Returns (the last
    token's logits [B, V] f32, the serve state), as
    ``LM.prefill_with_cache`` does in one full-sequence forward."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache,
                                          t)
    return logits, {"cache": cache, "position": int(tokens.shape[1])}


def _static_serve(model, params, prompts, args, cache_len,
                  frames=None) -> dict:
    """Batched convoy serving: one prefill, ``--gen`` decode + sample
    steps.  Emitted tokens [batch, gen]: the prefill's argmax seeds the
    first decode, and each decode's sampled token is emitted after it
    runs.  ``frames`` (an encoder-decoder's stub frame embeddings) are
    encoded in the prefill; the decode steps read the cached cross K/V.
    The vlm family takes the token loop whatever the flags, as the
    reference's CLI does."""
    dev = model.device
    _sync(dev)
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    if args.token_loop_prefill or model.cfg.family == "vlm":
        cache = model.init_cache(prompts.shape[0], cache_len, torch.float32)
        if frames is not None:
            model.fill_cross_kv(params, model._encode(params, frames), cache)
        logits, state = prefill_into_cache(model, params, prompts, cache)
    else:
        batch = {"tokens": prompts}
        if frames is not None:
            batch["frames"] = frames
        logits, state = model.prefill_with_cache(
            params, batch, cache_len=cache_len, cache_dtype=torch.float32)
    tok = torch.argmax(logits, dim=-1, keepdim=True)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_launches = {k: n - before.get(k, 0)
                        for k, n in ops.LAUNCHES.items()
                        if n > before.get(k, 0)}
    cache, position = state["cache"], state["position"]
    step = make_sample_step(model, args.temperature, args.seed)
    rows = torch.arange(prompts.shape[0], device=dev)
    out = []
    t0 = time.perf_counter()
    for i in range(args.gen):
        nxt, logits, cache = step(params, tok, cache, position, rows, i)
        position += 1
        tok = nxt[:, None]
        out.append(nxt)
    toks = torch.stack(out, dim=1).to(torch.int32).cpu()
    t_decode = time.perf_counter() - t0
    print(f"prefill: {args.prompt_len} toks x {args.batch} seqs in "
          f"{t_prefill * 1e3:.2f} ms on {dev}")
    print(f"decode:  {args.gen} toks x {args.batch} seqs in "
          f"{t_decode * 1e3:.2f} ms "
          f"({args.gen * args.batch / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample:", toks[0, :16].tolist())
    return {"mode": "static", "tokens": toks,
            "prefill_launches": prefill_launches,
            "prefill_ms": t_prefill * 1e3,
            "decode_tok_s": args.gen * args.batch / max(t_decode, 1e-9)}


def _request_mix(cfg, args) -> list:
    """Deterministic request set: ``--requests`` prompts of
    ``--prompt-len`` tokens, generation budgets cycled from ``--gen-mix``
    through a seeded shuffle (ragged on purpose: the convoy tax)."""
    rng = np.random.default_rng(args.seed)
    mix = [int(g) for g in str(args.gen_mix).split(",") if g]
    gens = np.asarray([mix[i % len(mix)] for i in range(args.requests)])
    rng.shuffle(gens)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len),
                    max_new_tokens=int(gens[i]))
            for i in range(args.requests)]


def _measure_serving_inputs(model, params, args, cache_len):
    """Two-point measurement of the engine's step cost for ``--slots
    auto``: decode steps at two arena sizes give the per-lane slope and
    the fixed overhead; one prefill gives the per-token cost."""
    from repro_torch.analysis.autotune import ServingInputs
    dev = model.device

    def step_s(slots):
        eng = ServingEngine(model, params, slots=slots,
                            cache_len=cache_len, seed=args.seed)
        for r in range(slots):
            eng.submit(Request(rid=r, prompt=np.zeros(1, np.int32),
                               max_new_tokens=cache_len - 1))
        eng.step_once()                      # admit + first step
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(4):
            eng._decode_once()
        return (time.perf_counter() - t0) / 4

    t1, t4 = step_s(1), step_s(4)
    lane_s = max((t4 - t1) / 3, 1e-9)
    prompts = torch.zeros((1, args.prompt_len), dtype=torch.int64,
                          device=dev)
    times = []
    for _ in range(2):                       # the first call warms up
        _sync(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            model.prefill_with_cache(params, {"tokens": prompts}, cache_len,
                                     torch.float32)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return ServingInputs(
        decode_lane_s=lane_s, step_overhead_s=max(t1 - lane_s, 0.0),
        prefill_s_per_token=times[-1] / args.prompt_len,
        arrival_hz=args.arrival_hz, prompt_tokens=float(args.prompt_len),
        gen_tokens=float(np.mean([int(g) for g in
                                  str(args.gen_mix).split(",") if g])),
        wire_dtype=args.wire_dtype, act_bytes=4.0,
        d_model=model.cfg.d_model)


def _resolve_slots(model, params, args, cache_len):
    """``--slots`` -> (slot count, ServingPlan evidence | None)."""
    if str(args.slots) != "auto":
        n = int(args.slots) or args.batch
        return n, None
    if not args.arrival_hz > 0:
        raise SystemExit("--slots auto needs --arrival-hz (the offered "
                         "load the serving planner optimizes for)")
    from repro_torch.analysis.autotune import choose_serving_plan
    inp = _measure_serving_inputs(model, params, args, cache_len)
    plan = choose_serving_plan(inp)
    print(f"serving plan: slots={plan.slots} wire={plan.wire_dtype} "
          f"p99_ttft={plan.p99_ttft_s * 1e3:.2f} ms "
          f"({plan.tokens_per_s:.1f} tok/s, rho={plan.rho:.2f})")
    return plan.slots, plan


def _continuous_serve(model, params, args, cache_len) -> dict:
    """Continuous batching: the slot-arena engine over a ragged request
    mix.  Returns the emitted tokens by request id, the engine's stats,
    the plan (``--slots auto``) and the wall."""
    slots, plan = _resolve_slots(model, params, args, cache_len)
    requests = _request_mix(model.cfg, args)
    engine = ServingEngine(
        model, params, slots=slots, cache_len=cache_len,
        temperature=args.temperature, seed=args.seed,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        policy=args.policy)
    _sync(model.device)
    t0 = time.perf_counter()
    outputs = engine.run(requests)
    _sync(model.device)
    wall = time.perf_counter() - t0
    stats = engine.stats()
    emitted = sum(len(v) for v in outputs.values())
    convoy = convoy_units(requests, args.batch)
    print(f"continuous: {len(outputs)}/{len(requests)} requests, "
          f"{emitted} tokens in {wall:.2f}s "
          f"({emitted / max(wall, 1e-9):.1f} tok/s) on {model.device}, "
          f"decode step {'one CUDA graph' if stats['graph'] else 'eager'}")
    print(f"engine units {stats['engine_units']} vs convoy(batch="
          f"{args.batch}) {convoy} -> modeled speedup "
          f"{convoy / max(stats['engine_units'], 1):.2f}x; "
          f"occupancy {stats['occupancy_mean']:.2f}/{slots}; "
          f"{stats['decode_steps']} decode steps, "
          f"{stats['prefill_chunks']} prefill chunks")
    lat = stats["qos"]["latency"]
    if lat["p50_ttft_s"] is not None:
        print(f"latency: p50 ttft {lat['p50_ttft_s'] * 1e3:.1f} ms, "
              f"p99 ttft {lat['p99_ttft_s'] * 1e3:.1f} ms")
    if args.plan_out:
        doc = {"mode": "continuous", "slots": slots,
               "wire_dtype": args.wire_dtype,
               "plan": plan.to_dict() if plan is not None else None,
               "stats": stats}
        with open(args.plan_out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.plan_out}")
    return {"mode": "continuous", "tokens": outputs, "stats": stats,
            "plan": plan, "slots": slots, "convoy_units": convoy,
            "wall_s": wall, "tok_s": emitted / max(wall, 1e-9)}


def _split_serve(model, params, prompts, args, cache_len) -> dict:
    """Split inference over the loopback socket (shaped when
    ``--bw-Bps`` > 0); prints the wire audit and the QoS counts."""
    shaper = LinkShaper(args.bw_Bps) if args.bw_Bps > 0 else None
    qos = QoSMonitor()
    _sync(model.device)
    t0 = time.perf_counter()
    res = run_split_infer(model, params, cut=args.split_cut, prompts=prompts,
                          gen=args.gen, cache_len=cache_len,
                          wire_dtype=args.wire_dtype, shaper=shaper, qos=qos)
    wall = time.perf_counter() - t0
    res["qos"] = qos.snapshot()
    rel = abs(res["measured_payload_bytes"] - res["billed_payload_bytes"]) \
        / max(res["billed_payload_bytes"], 1e-9)
    print(f"split-infer: cut={args.split_cut} wire={args.wire_dtype} "
          f"{res['frames']} INFER frames, measured "
          f"{res['measured_payload_bytes']} B vs billed "
          f"{res['billed_payload_bytes']:.0f} B (rel {rel:.2e}) on "
          f"{model.device}")
    print(f"prefill (UE half + uplink + BS half + token reply): "
          f"{res['prefill_ms']:.2f} ms; decode {res['decode_tok_s']:.1f} "
          f"tok/s; wall {wall * 1e3:.2f} ms")
    print(f"qos: {json.dumps(res['qos']['totals'], sort_keys=True)}"
          + (f"; link shaped by {shaper}" if shaper else ""))
    print("sample:", res["tokens"][0, :16].tolist())
    return dict(res, mode="split", rel=rel, wall_ms=wall * 1e3)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--size", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--token-loop-prefill", action="store_true",
                    help="static mode: the reference's prefill path (the "
                         "prompt through the decode step, token by token) "
                         "instead of the one-pass prefill")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine instead of the "
                         "static convoy loop")
    ap.add_argument("--requests", type=int, default=24,
                    help="continuous mode: request count")
    ap.add_argument("--gen-mix", default="8,32,128",
                    help="continuous mode: generation budgets, cycled "
                         "through a seeded shuffle")
    ap.add_argument("--slots", default="0",
                    help="continuous mode: slot-arena size (0 = --batch; "
                         "'auto' runs the serving planner, which needs "
                         "--arrival-hz)")
    ap.add_argument("--arrival-hz", type=float, default=0.0,
                    help="offered request rate for --slots auto")
    ap.add_argument("--policy", default="fifo", choices=list(POLICIES),
                    help="continuous mode: admission order")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=256,
                    help="continuous mode: prefill-chunk token budget")
    ap.add_argument("--split-cut", type=int, default=0,
                    help="L>0: split inference — UE runs blocks[:L], "
                         "ships coded INFER frames over loopback")
    ap.add_argument("--bw-Bps", type=float, default=0.0,
                    help="split mode: emulated link rate both ways; 0 = "
                         "unshaped loopback")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    # --wire-dtype (the INFER uplink's codec) and --plan-out (continuous
    # mode: the slots, the plan and the engine's stats as JSON)
    add_plan_args(ap, flavor="serve")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    args.wire_dtype = validate_wire_dtype(args.wire_dtype)
    if args.split_cut and (args.continuous or args.temperature > 0):
        raise ValueError("--split-cut serves the static batch greedily, as "
                         "the reference's split path does: not with "
                         "--continuous or --temperature > 0")
    if args.token_loop_prefill and (args.continuous or args.split_cut):
        raise ValueError("--token-loop-prefill feeds the static path's "
                         "prompt: not with --continuous or --split-cut")
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.size == "smoke" else spec.full
    model = LM(cfg, device)
    if args.split_cut:              # refuse a cut it cannot make before
        SplitDecode(model, args.split_cut)  # any weight is drawn
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    cache_len = args.cache_len or (args.prompt_len + args.gen)
    if args.continuous:
        cache_len = args.cache_len or (
            args.prompt_len + max(int(g) for g in
                                  str(args.gen_mix).split(",") if g))
        return _continuous_serve(model, params, args, cache_len)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        device=device)
    frames = None
    if cfg.enc_layers:         # enc-dec: stub frames -> encoder memory
        frames = torch.as_tensor(rng.standard_normal(
            (args.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32),
            device=device).to(model.dtype)
    with torch.inference_mode():
        if args.split_cut:
            return _split_serve(model, params, prompts, args, cache_len)
        return _static_serve(model, params, prompts, args, cache_len,
                             frames)


if __name__ == "__main__":
    main()
