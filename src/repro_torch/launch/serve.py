"""Serving CLI: static greedy convoy, or split inference over loopback.

Port of the static and split paths of the JAX package's
``launch/serve.py``.  Runs on the card unless ``--device cpu`` is given;
without CUDA and without that flag it raises.

* static (default): prefill a prompt batch with ``LM.prefill_with_cache``,
  then ``--gen`` greedy decode steps.  Sampling (``--temperature > 0``)
  and the continuous-batching engine are not ported yet.
* ``--split-cut L``: the UE half (embed + blocks[:L]) ships coded cut
  activations as INFER frames over a real loopback socket
  (``--wire-dtype`` none/int8/fp8) to the BS half, which replies with the
  greedy token; prints the measured-vs-billed wire audit.  Homogeneous
  stacks with an untied head only: a hybrid (recurrentgemma-2b) or tied
  embeddings (granite-moe-3b-a800m) raise ``ValueError``, as the
  reference's ``SplitDecode`` does.

PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
    --size full --batch 4 --prompt-len 512 --gen 32
PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
    --size full --split-cut 20 --wire-dtype int8
PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
    --size full --batch 4 --prompt-len 512 --gen 32
PYTHONPATH=src python -m repro_torch.launch.serve \
    --arch granite-moe-3b-a800m --size full --batch 4 --prompt-len 512 --gen 32
PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
    --size smoke --split-cut 1 --wire-dtype int8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models.lm import LM
from repro_torch.parallel.wire import validate_wire_dtype
from repro_torch.serving.infer import SplitDecode, run_split_infer


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _static_serve(model, params, prompts, args, cache_len) -> dict:
    """Batched convoy serving: one prefill, ``--gen`` greedy decode steps.
    Emitted tokens [batch, gen]: the prefill's argmax seeds the first
    decode, and each decode's argmax is emitted after it runs."""
    dev = model.device
    _sync(dev)
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    logits, state = model.prefill_with_cache(
        params, {"tokens": prompts}, cache_len=cache_len,
        cache_dtype=torch.float32)
    tok = torch.argmax(logits, dim=-1, keepdim=True)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_launches = {k: n - before.get(k, 0)
                        for k, n in ops.LAUNCHES.items()
                        if n > before.get(k, 0)}
    cache, position = state["cache"], state["position"]
    out = []
    t0 = time.perf_counter()
    for _ in range(args.gen):
        logits, cache = model.decode_step(params, tok, cache, position)
        position += 1
        tok = torch.argmax(logits, dim=-1, keepdim=True)
        out.append(tok[:, 0])
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


def _split_serve(model, params, prompts, args, cache_len) -> dict:
    """Split inference over the loopback socket; prints the wire audit."""

    _sync(model.device)
    t0 = time.perf_counter()
    res = run_split_infer(model, params, cut=args.split_cut, prompts=prompts,
                          gen=args.gen, cache_len=cache_len,
                          wire_dtype=args.wire_dtype)
    wall = time.perf_counter() - t0
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
    ap.add_argument("--split-cut", type=int, default=0,
                    help="L>0: split inference — UE runs blocks[:L], "
                         "ships coded INFER frames over loopback")
    ap.add_argument("--wire-dtype", default="none",
                    help="codec of the INFER uplink: none | int8 | fp8")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.temperature > 0:
        raise NotImplementedError(
            "--temperature > 0 is not yet ported (sampling comes with the "
            "continuous-batching slice); greedy only")
    args.wire_dtype = validate_wire_dtype(args.wire_dtype)
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.size == "smoke" else spec.full
    model = LM(cfg, device)
    if args.split_cut:              # refuse a cut it cannot make before
        SplitDecode(model, args.split_cut)  # any weight is drawn
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    cache_len = args.cache_len or (args.prompt_len + args.gen)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        device=device)
    with torch.inference_mode():
        if args.split_cut:
            return _split_serve(model, params, prompts, args, cache_len)
        return _static_serve(model, params, prompts, args, cache_len)


if __name__ == "__main__":
    main()
