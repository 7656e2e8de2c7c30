"""Training CLI: C²P²SL split training of an LM on the card.

Port of the JAX package's ``launch/train.py`` for the flags that apply:
the synthetic affine-chain token task, AdamW (cosine schedule, warm-up 20,
global-norm clip 1.0) on f32 master weights with bf16 compute, and either
gradient accumulation over ``--microbatches`` or the S-stage pipeline
(``--pipeline-stages``, ``--pipeline-k``, ``--virtual-stages`` v
interleaved chunks a stage) with a coded hop between model chunks
(``--wire-dtype`` none | int8 | fp8, activations up and gradients down, or
``<base>+topk<frac>``: the gradient hop top-k with error feedback, whose
buffer the CLI builds), and ``--compress-grads`` (int8 gradients with
error feedback before the update).  k, v and the codec are plain values:
the reference's planner (``auto``) is not ported.  Runs on the card unless
``--device cpu`` is given; without CUDA and without that flag it raises.
Prints one JSON line per logged step: loss, step ms, tokens/s, peak device
GB, the hop's wire bytes up and down and, for an MoE model, the
load-balance aux.

Which arch trains by which path: the homogeneous stacks (``rwkv6-3b``,
``qwen1.5-4b``, ``granite-moe-3b-a800m``) by either; the hybrid
``recurrentgemma-2b`` (RG-LRU and local-attention layers) by
``--microbatches`` accumulation only, since the pipeline takes a
homogeneous stack, as the reference asserts.

PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
    --size full --pipeline-stages 2 --virtual-stages 2 --pipeline-k 4 \
    --wire-dtype int8+topk0.25 --batch 8 --seq 512 --steps 3 --log-every 1
PYTHONPATH=src python -m repro_torch.launch.train \
    --arch granite-moe-3b-a800m --size full --pipeline-stages 2 \
    --pipeline-k 4 --wire-dtype int8 --batch 8 --seq 512 --steps 3
PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \
    --size full --microbatches 2 --batch 4 --seq 4096 --steps 3
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import TokenTaskConfig, token_batches
from repro_torch.models.lm import LM
from repro_torch.parallel.pipeline import PipelineSpec, wire_ef_zeros
from repro_torch.parallel.steps import make_lm_train_step
from repro_torch.parallel.wire import validate_wire_dtype
from repro_torch.training.compress import init_error_fb
from repro_torch.training.optim import adamw, cosine_schedule


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--size", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="the paper's k (gradient accumulation)")
    ap.add_argument("--pipeline-stages", type=int, default=1,
                    help="S > 1: run the block stack as the C2P2SL "
                         "pipeline with a coded hop between stages")
    ap.add_argument("--pipeline-k", type=int, default=None,
                    help="micro-batches of the pipeline (default 4)")
    ap.add_argument("--virtual-stages", "--pipeline-v",
                    dest="virtual_stages", type=int, default=None,
                    help="v > 1: interleaved virtual stages, v round-robin "
                         "model chunks a stage (default 1)")
    ap.add_argument("--wire-dtype", default="none",
                    help="codec of the stage hop: none | int8 | fp8 | "
                         "<base>+topk<frac> (e.g. int8+topk0.25: the "
                         "gradient hop top-k with error feedback)")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 block-quantized gradients with error "
                         "feedback before the optimizer update")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    return ap.parse_args(argv)


def pipeline_spec(args):
    """``PipelineSpec`` from the flags, or None without a pipeline."""
    wire = validate_wire_dtype(args.wire_dtype)
    if args.pipeline_stages <= 1:
        if args.pipeline_k is not None or args.virtual_stages is not None \
                or wire != "none":
            raise SystemExit("--pipeline-k, --virtual-stages and "
                             "--wire-dtype need --pipeline-stages > 1")
        return None
    if args.microbatches != 1:
        raise SystemExit("--microbatches (gradient accumulation) and "
                         "--pipeline-stages are mutually exclusive: the "
                         "pipeline micro-batches with --pipeline-k")
    return PipelineSpec(num_stages=args.pipeline_stages,
                        microbatches=args.pipeline_k or 4,
                        virtual_stages=args.virtual_stages or 1,
                        wire_dtype=wire)


def main(argv=None) -> dict:
    """Train; returns the per-step rows, the final state and the model."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.size == "smoke" else spec.full
    pipeline = pipeline_spec(args)
    model = LM(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed),
                        master=True)
    opt = adamw(cosine_schedule(args.lr, warmup=20, total=args.steps),
                grad_clip=1.0)
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    if args.compress_grads:
        state["error_fb"] = init_error_fb(params)
    if pipeline is not None:
        ef = wire_ef_zeros(cfg, pipeline, args.batch, args.seq, device)
        if ef is not None:       # top-k wire codec: EF rides the state
            state["wire_ef"] = ef
    step_fn = make_lm_train_step(model, opt, microbatches=args.microbatches,
                                 pipeline=pipeline,
                                 compress=args.compress_grads)
    meter = step_fn.meter
    if pipeline is not None:
        print(f"pipeline: S={pipeline.num_stages} k={pipeline.microbatches} "
              f"v={pipeline.virtual_stages} wire={pipeline.wire_dtype} "
              f"on {device}", flush=True)
    batches = token_batches(TokenTaskConfig(vocab=cfg.vocab), args.batch,
                            args.seq, seed=args.seed)
    cuda = device.type == "cuda"
    rows = []
    for i in range(args.steps):
        batch = {n: torch.as_tensor(a, device=device)
                 for n, a in next(batches).items()}
        if meter is not None:
            meter.reset()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state, mets = step_fn(state, batch)
        loss = float(mets["loss"])            # waits for the step
        if cuda:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        row = {"step": i + 1, "loss": loss, "step_ms": dt * 1e3,
               "tokens_per_s": args.batch * args.seq / dt,
               "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if cuda else None),
               "hop_bytes_up": meter.up if meter else 0,
               "hop_bytes_down": meter.down if meter else 0,
               "device": torch.cuda.get_device_name(device) if cuda
               else "cpu"}
        if cfg.is_moe:
            row["aux"] = float(mets["aux"])
        rows.append(row)
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {i + 1}: loss {loss}")
        if args.log_every and (i + 1) % args.log_every == 0:
            print(json.dumps(row), flush=True)
    return {"rows": rows, "state": state, "model": model,
            "pipeline": pipeline}


if __name__ == "__main__":
    main()
