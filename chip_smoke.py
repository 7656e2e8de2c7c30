#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi) and torch's CUDA version;
  2. build every CUDA kernel from src/repro_torch/csrc (one nvcc per source,
     all at once) and print the build time and ptxas' register report;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes: the wire codec bit for bit (int8 and fp8, bf16 and
     f32 inputs, d = 2560 and 96 and 200), flash attention within 2e-4 (f32)
     and 5e-2 (bf16), causal, GQA and sliding-window;
  4. the main path at the full width of qwen1.5-4b (40 layers, random
     weights from seed 0, bf16, batch 4, prompt 512, 32 greedy tokens)
     through the serving CLI's entry point: the static path, then split
     inference at cut 20 over a loopback socket for none, int8 and fp8.
     Measured payload bytes must equal billed bytes, there must be gen + 1
     uplink frames, 'none' split tokens must equal the static tokens bit
     for bit, and every kernel's launch count must be above 0.  A small
     f32 model on the card is also held to the same model on the CPU;
  5. timings: a torch.profiler trace of one prefill and four decode steps
     (device busy time and idle share, top kernels); per kernel its device
     time, its plain version's, its bound and the library yardstick where
     one PyTorch call computes the same function.

The line before the last is one JSON object describing the kernels; the
last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate, bf16
# tensor-core rate, f32 rate outside the tensor cores.
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12

ARCH, CUT, BATCH, PROMPT, GEN, SEED = "qwen1.5-4b", 20, 4, 512, 32, 0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Wall time per call between CUDA events: device time plus whatever
    host overhead keeps the device waiting between launches."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_us(events):
    """Sum of the self device time (us) of the CUDA entries of a
    profiler's ``key_averages()``, and those entries."""
    rows = [e for e in events if str(getattr(e, "device_type", "")).endswith(
        "CUDA")]
    us = lambda e: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
    return sum(us(e) for e in rows), sorted(rows, key=us, reverse=True), us


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: the CUDA kernels' own time in a window of
    ``iters`` calls traced with torch.profiler (CUPTI), host overhead
    between launches left out.  CUDA events where the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, _, _ = _kernel_us(prof.key_averages())
    if total_us <= 0:
        print("profiler recorded no device time: timing with CUDA events")
        return cuda_ms(fn, iters, warmup)
    return total_us / iters / 1e3


def bound(nbytes: float, ops: float, ops_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / ops_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 3


def check_codec(torch, wc, dev):
    """Encode/decode kernels against their plain versions, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [((BATCH * PROMPT, 2560), torch.bfloat16),
             ((BATCH, 2560), torch.bfloat16),
             ((37, 96), torch.bfloat16),
             ((3, 11, 96), torch.float32),
             ((33, 200), torch.float32)]
    for shape, dt in cases:
        x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dt)
        x.view(-1, shape[-1])[0, :wc.wire_block(shape[-1])] = 0  # zero block
        for wire in ("int8", "fp8"):
            q, s = wc.encode_cuda(x, wire)
            qp, sp = wc.encode_plain(x, wire)
            torch.cuda.synchronize()
            if not (torch.equal(q.view(torch.uint8), qp.view(torch.uint8))
                    and torch.equal(s, sp)):
                bad = (q.view(torch.uint8) != qp.view(torch.uint8)).sum()
                fail(f"wire_encode {wire} {shape} {dt}: {int(bad)} payload "
                     f"bytes differ, max scale diff "
                     f"{float((s - sp).abs().max())}")
            y = wc.decode_cuda(q, s, dt)
            yp = wc.decode_plain(q, s, dt)
            torch.cuda.synchronize()
            if not torch.equal(y, yp):
                fail(f"wire_decode {wire} {shape} {dt}: max diff "
                     f"{float((y.float() - yp.float()).abs().max())}")
            print(f"codec {wire:4s} {str(tuple(shape)):14s} "
                  f"{str(dt):15s} bit-exact")


def check_flash(torch, fa, dev):
    """Flash kernel against the plain version; returns the max error at
    the main path's bf16 shape."""
    gen = torch.Generator(device=dev).manual_seed(2)
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    # (B, Hq, Hkv, S, dh, causal, window, dtype, model layout [B,S,H,dh])
    cases = [(BATCH, 20, 20, PROMPT, 128, True, 0, torch.bfloat16, True),
             (BATCH, 20, 20, PROMPT, 128, True, 0, torch.float32, True),
             (2, 8, 4, 200, 64, True, 0, torch.float32, False),
             (2, 8, 4, 200, 64, True, 0, torch.bfloat16, False),
             (2, 4, 4, 300, 128, True, 64, torch.float32, False),
             (1, 4, 2, 130, 32, False, 0, torch.float32, False)]
    main_err = None
    for b, hq, hkv, s, dh, causal, window, dt, bshd in cases:
        def mk(h):
            if bshd:
                t = torch.randn((b, s, h, dh), generator=gen, device=dev)
                return t.to(dt).transpose(1, 2)
            return torch.randn((b, h, s, dh), generator=gen,
                               device=dev).to(dt)
        q, k, v = mk(hq), mk(hkv), mk(hkv)
        o = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        op = fa.attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((o.float() - op.float()).abs().max())
        name = (f"flash B{b} H{hq}/{hkv} S{s} dh{dh} causal={causal} "
                f"window={window} {dt}{' [B,S,H,dh] view' if bshd else ''}")
        if not err <= tol[dt]:
            fail(f"{name}: max abs err {err} > {tol[dt]}")
        print(f"{name}: max abs err {err:.3e} (tol {tol[dt]})")
        if bshd and dt == torch.bfloat16:
            main_err = err
    return main_err


def check_small_model(torch, dev):
    """A small f32 model on the card against the same model on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.utils.trees import tree_map
    cfg = get_arch(ARCH).smoke
    cpu = LM(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(SEED))
    card = LM(cfg, dev)
    pcard = tree_map(lambda t: t.to(dev), params)
    toks = torch.randint(0, cfg.vocab, (2, 70),
                         generator=torch.Generator().manual_seed(3))
    lc, _ = cpu.prefill_with_cache(params, {"tokens": toks}, 80,
                                   torch.float32)
    lg, _ = card.prefill_with_cache(pcard, {"tokens": toks.to(dev)}, 80,
                                    torch.float32)
    err = float((lg.cpu() - lc).abs().max())
    if not (lg.shape == (2, cfg.vocab) and math.isfinite(err) and err <= 1e-3):
        fail(f"small model on the card vs CPU: max logit err {err}")
    print(f"small f32 model, card vs CPU prefill logits: max err {err:.3e}")


# ------------------------------------------------------------------ phase 4


def run_main_path(torch, ops, serve):
    base = ["--arch", ARCH, "--size", "full", "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN),
            "--seed", str(SEED)]
    ops.reset_launches()
    static = serve.main(base)
    split = {w: serve.main(base + ["--split-cut", str(CUT),
                                   "--wire-dtype", w])
             for w in ("none", "int8", "fp8")}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    toks = static["tokens"]
    if tuple(toks.shape) != (BATCH, GEN) or int(toks.min()) < 0:
        fail(f"static tokens {tuple(toks.shape)} out of range")
    for w, res in split.items():
        if res["frames"] != GEN + 1:
            fail(f"split {w}: {res['frames']} frames != gen + 1")
        if not res["rel"] <= 0.01:
            fail(f"split {w}: measured {res['measured_payload_bytes']} B vs "
                 f"billed {res['billed_payload_bytes']} B")
        if tuple(res["tokens"].shape) != (BATCH, GEN):
            fail(f"split {w}: tokens {tuple(res['tokens'].shape)}")
    if not torch.equal(split["none"]["tokens"], toks):
        fail("split 'none' tokens differ from the static path's")
    print(f"split none tokens == static tokens ({BATCH}x{GEN})")
    for name in ops.KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the main path")
    print(f"main-path launches: {json.dumps(launches, sort_keys=True)}")
    return static, split, launches


def profile_serving(torch, dev):
    """Where the time of the static path goes: one prefill and four
    decode steps traced with torch.profiler; wall time (host clock, ends
    in a synchronise), device busy time (sum of kernel time) and the
    device's idle share, with the kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    model = LM(get_arch(ARCH).full, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    prompts = torch.randint(0, model.cfg.vocab, (BATCH, PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(5))
    cache_len = PROMPT + GEN

    def prefill():
        return model.prefill_with_cache(params, {"tokens": prompts},
                                        cache_len, torch.float32)

    def decode(state, steps):
        cache, pos = state["cache"], state["position"]
        tok = prompts[:, -1:]
        for _ in range(steps):
            logits, cache = model.decode_step(params, tok, cache, pos)
            tok = torch.argmax(logits, dim=-1, keepdim=True)
            pos += 1
        return tok

    with torch.inference_mode():
        _, state = prefill()
        decode(state, 2)                                     # warm
        for name, fn, steps in (("prefill", prefill, 1),
                                ("decode", lambda: decode(state, 4), 4)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy_us, rows, us = _kernel_us(prof.key_averages())
            print(f"profile {name} ({steps} step{'s' * (steps > 1)}): wall "
                  f"{wall / steps:.3f} ms/step, device busy "
                  f"{busy_us / 1e3 / steps:.3f} ms/step, idle share "
                  f"{1 - busy_us / 1e3 / wall:.3f}")
            for e in rows[:6]:
                print(f"  {us(e) / 1e3 / steps:9.3f} ms/step  {e.count // steps:5d}"
                      f" calls/step  {e.key[:70]}")


# ------------------------------------------------------------------ phase 5


def time_kernels(torch, wc, fa, dev, launches, flash_err):
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(4)
    rows, d = BATCH * PROMPT, 2560
    out = []

    x = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    q, s = wc.encode_cuda(x, "int8")
    n, nblk = rows * d, rows * d // wc.wire_block(d)
    b_ms, b_by = bound(n * (2 + 1) + nblk * 4, 7 * n, F32_OPS_S)
    out.append({
        "name": "wire_encode", "route": "cuda",
        "source": "src/repro_torch/csrc/wire_codec.cu",
        "replaces": "src/repro/kernels/wire_codec.py:90",
        "launches": launches.get("wire_encode", 0), "max_abs_err": 0.0,
        "ms": device_ms(lambda: wc.encode_cuda(x, "int8")),
        "plain_ms": device_ms(lambda: wc.encode_plain(x, "int8")),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    b_ms, b_by = bound(n * (1 + 2) + nblk * 4, 2 * n, F32_OPS_S)
    out.append({
        "name": "wire_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/wire_codec.cu",
        "replaces": "src/repro/kernels/wire_codec.py:118",
        "launches": launches.get("wire_decode", 0), "max_abs_err": 0.0,
        "ms": device_ms(lambda: wc.decode_cuda(q, s, torch.bfloat16)),
        "plain_ms": device_ms(lambda: wc.decode_plain(q, s, torch.bfloat16)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    xs = torch.randn((BATCH, d), generator=gen, device=dev).to(torch.bfloat16)
    qs, ss = wc.encode_cuda(xs, "int8")
    enc = lambda: wc.encode_cuda(xs, "int8")
    dec = lambda: wc.decode_cuda(qs, ss, torch.bfloat16)
    print(f"codec at the decode shape {(BATCH, d)} bf16/int8: encode "
          f"{device_ms(enc):.4f} ms on the device, {cuda_ms(enc):.4f} ms "
          f"between events; decode {device_ms(dec):.4f} ms on the device, "
          f"{cuda_ms(dec):.4f} ms between events")
    print(f"codec at the prefill shape {(rows, d)}: encode "
          f"{cuda_ms(lambda: wc.encode_cuda(x, 'int8')):.4f} ms, decode "
          f"{cuda_ms(lambda: wc.decode_cuda(q, s, torch.bfloat16)):.4f} ms "
          f"between events")

    h, dh = 20, 128
    qkv = [torch.randn((BATCH, PROMPT, h, dh), generator=gen,
                       device=dev).to(torch.bfloat16).transpose(1, 2)
           for _ in range(3)]
    pairs = BATCH * h * PROMPT * (PROMPT + 1) // 2      # causal (q, k) pairs
    b_ms, b_by = bound(4 * BATCH * h * PROMPT * dh * 2, 4 * dh * pairs,
                       BF16_OPS_S)
    contig = [t.contiguous() for t in qkv]
    out.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "launches": launches.get("flash_attention", 0),
        "max_abs_err": flash_err,
        "ms": device_ms(lambda: fa.flash_attention_cuda(*qkv, causal=True)),
        "plain_ms": device_ms(lambda: fa.attention_plain(*qkv, causal=True),
                              iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            *contig, is_causal=True))})
    for k in out:
        print(f"kernel {k['name']}: {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), library {k['library_ms']}, "
              f"launches {k['launches']}")
    return out


def main():
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs the card")
    sys.path.insert(0, SRC)
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wire_codec as wc
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    check_codec(torch, wc, dev)
    flash_err = check_flash(torch, fa, dev)
    check_small_model(torch, dev)

    static, split, launches = run_main_path(torch, ops, serve)
    print(f"main path static: prefill {static['prefill_ms']:.2f} ms, "
          f"decode {static['decode_tok_s']:.1f} tok/s")
    for w, res in split.items():
        print(f"main path split {w}: prefill {res['prefill_ms']:.2f} ms, "
              f"decode {res['decode_tok_s']:.1f} tok/s, {res['frames']} "
              f"frames, {res['measured_payload_bytes']} B measured == billed")

    profile_serving(torch, dev)
    kernels = time_kernels(torch, wc, fa, dev, launches, flash_err)
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
