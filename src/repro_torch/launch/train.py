"""Training CLI: C²P²SL split training of an LM on the card.

Port of the JAX package's ``launch/train.py``: the synthetic affine-chain
token task, AdamW (cosine schedule, warm-up 20, global-norm clip 1.0) on
f32 master weights with bf16 compute, and either gradient accumulation
over ``--microbatches`` or the S-stage pipeline (the shared plan flags of
``launch/plan_args.py``: ``--pipeline-stages``, ``--pipeline-k``,
``--virtual-stages`` v interleaved chunks a stage, ``--wire-dtype`` none |
int8 | fp8 | ``<base>+topk<frac>``, the gradient hop top-k with error
feedback, whose buffer the CLI builds), and ``--compress-grads`` (int8
gradients with error feedback before the update).

The plan: k, v and the codec are an integer (a codec name) or ``auto``;
an unset k is planned too, never a silent default
(``resolve_pipeline_plan``: the config estimate of
``analysis/autotune.plan_inputs_from_cfg``, overlaid by ``--plan-hints``).
``--plan-out`` writes the plan and its evidence.  ``--replan
every:N,hysteresis:F`` re-plans online (``training/replan.py``) from the
measured step times and the bandwidth of ``--replan-trace`` and switches
the cell: the state carries over (``carry_state``) and each cell's step
is built once (``PlanCellCache``).

Checkpoints: ``--ckpt-dir`` with ``--ckpt-every N`` saves the state and
its live plan cell every N steps and keeps the newest three
(``training/checkpoint.py``); a run started on a directory that holds one
resumes from its newest step and skips the batches already trained on, so
a resumed run equals the run it continues.  Under ``--replan`` it resumes
on the checkpoint's cell, where the re-planner had moved; the re-planner's
measurements (its cadence, step-time anchor and link average) start afresh
at the resumed step, so such a run equals the uninterrupted one where the
re-planner decides alike after the resume, as on a link that holds steady.
Without ``--replan`` the flags' cell wins: a checkpoint of another cell is
moved onto it by ``carry_state``.  A checkpoint taken without
``--compress-grads`` or a top-k codec resumes with their error feedback at
zero; each such move is printed.

Runs on the card unless ``--device cpu`` is given; without CUDA and
without that flag it raises.  Prints one JSON line per logged step: loss,
step ms, tokens/s, peak device GB, the hop's wire bytes up and down, the
cell and, for an MoE model, the load-balance aux; ``--metrics-out`` writes
every step's row as a JSON list.

Which arch trains by which path: the homogeneous stacks (``rwkv6-3b``,
``qwen1.5-4b``, ``granite-moe-3b-a800m``, the
encoder-decoder ``whisper-small`` and the prefix-LM ``paligemma-3b``) by
either; the hybrid
``recurrentgemma-2b`` (RG-LRU and local-attention layers) by
``--microbatches`` accumulation only, since the pipeline takes a
homogeneous stack, as the reference asserts.  whisper-small's batches
carry stub frame embeddings [batch, enc_seq, d_model] f32 from a stream of
their own (``build_batch_iter``, seed + 2, as the reference draws them);
its encoder runs once a batch, outside the pipeline's hop.
paligemma-3b's carry stub patch embeddings [batch, num_patches, d_model]
f32 (seed + 1), put before the tokens with labels -1: the pipeline's hops
carry those rows too.

PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
    --size full --pipeline-stages 2 --virtual-stages 2 --pipeline-k 4 \
    --wire-dtype int8+topk0.25 --batch 8 --seq 512 --steps 3 --log-every 1
PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
    --size full --pipeline-stages 2 --pipeline-k 4 --wire-dtype int8 \
    --batch 8 --seq 512 --steps 3 --ckpt-dir ckpts/qwen --ckpt-every 2
PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \
    --size full --microbatches 2 --batch 4 --seq 4096 --steps 3
PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \
    --size full --pipeline-stages 2 --pipeline-k 4 --wire-dtype int8 \
    --batch 32 --seq 448 --steps 3 --log-every 1
PYTHONPATH=src python -m repro_torch.launch.train --arch paligemma-3b \
    --size full --pipeline-stages 2 --pipeline-k 4 --wire-dtype int8 \
    --batch 8 --seq 512 --steps 3 --log-every 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis.autotune import Plan
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import TokenTaskConfig, token_batches
from repro_torch.launch.plan_args import add_plan_args, replan_config
from repro_torch.models.lm import LM
from repro_torch.parallel.pipeline import PipelineSpec, wire_ef_zeros
from repro_torch.parallel.steps import make_lm_train_step
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.compress import init_error_fb
from repro_torch.training.optim import adamw, cosine_schedule
from repro_torch.training.replan import (PlanCellCache, Replanner,
                                         carry_state)
from repro_torch.utils.trees import tree_map

# state entries a checkpoint from before their flag may lack: they
# restart at zero, their natural initial state
_EF_KEYS = ("error_fb", "wire_ef")


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
    add_plan_args(ap, flavor="train")
    ap.add_argument("--replan-trace", default=None,
                    help="scripted link drift for --replan: JSON with "
                         "{'steps': [...], 'bw_Bps': [...]} (a "
                         "wireless.channel.BandwidthTrace) fed to the "
                         "re-planner as per-step bandwidth observations")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 block-quantized gradients with error "
                         "feedback before the optimizer update")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its newest "
                         "step, and save there every --ckpt-every steps")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None,
                    help="write every step's row as a JSON list")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    return ap.parse_args(argv)


def build_batch_iter(cfg, batch: int, seq: int, seed: int = 0):
    """The training batches (the reference's ``build_batch_iter``): the
    token task's, with one draw a batch of stub inputs from their own
    stream: for the vlm family patch embeddings [batch, num_patches,
    d_model] f32 from ``default_rng(seed + 1)``, for an encoder-decoder
    frames [batch, enc_seq, d_model] f32 from ``default_rng(seed + 2)``."""
    gen = token_batches(TokenTaskConfig(vocab=cfg.vocab), batch, seq,
                        seed=seed)
    if cfg.family == "vlm":
        key, offset, rows = "patch_embeds", 1, cfg.num_patches
    elif cfg.enc_layers:
        key, offset, rows = "frames", 2, cfg.enc_seq
    else:
        return gen
    rng = np.random.default_rng(seed + offset)

    def it():
        for b in gen:
            b[key] = rng.standard_normal(
                (batch, rows, cfg.d_model)).astype(np.float32)
            yield b
    return it()


def _parse_auto_int(value, flag: str):
    """'auto' | int-string | int | None -> 'auto' | int | None."""
    if value is None or isinstance(value, int):
        return value
    s = str(value).strip().lower()
    if s == "auto":
        return "auto"
    try:
        return int(s)
    except ValueError:
        raise SystemExit(
            f"{flag} must be an integer or 'auto', got {value!r}")


def _load_plan_hints(plan_hints):
    """Measured planner hints JSON (``{"planner_hints": {...}}`` or the
    bare object) -> dict, or None."""
    if not plan_hints:
        return None
    try:
        with open(plan_hints) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"--plan-hints {plan_hints}: {e}")
    hints = doc.get("planner_hints", doc) if isinstance(doc, dict) else doc
    if not isinstance(hints, dict):
        raise SystemExit(
            f"--plan-hints {plan_hints}: expected a JSON object with a "
            "planner_hints dict")
    return hints


def plan_inputs_for(*, cfg, batch: int, seq: int, pipeline_stages: int,
                    plan_hints: str | None = None):
    """Base ``PlanInputs`` of this run: the compile-free config estimate,
    with ``--plan-hints``' ``hop_overhead_s`` and ``link_bw_Bps`` in place
    of the priors.  Returns ``(inputs, source_label)``; also the anchor
    the online re-planner drifts from."""
    from repro_torch.analysis import autotune
    hints = _load_plan_hints(plan_hints) or {}
    inp = autotune.plan_inputs_from_cfg(
        cfg, batch=batch, seq=seq, num_stages=pipeline_stages,
        hop_overhead_s=hints.get("hop_overhead_s"),
        link_bw_Bps=hints.get("link_bw_Bps"))
    # a micro-batch needs at least one sample row
    return (dataclasses.replace(inp, k_cap=max(1, min(inp.k_cap, batch))),
            "config estimate (no --plan-roofline)")


def resolve_pipeline_plan(*, pipeline_stages: int, pipeline_k,
                          virtual_stages, cfg, batch: int, seq: int,
                          wire_dtype: str = "none",
                          plan_hints: str | None = None):
    """The (S, k, v, wire) decision from the flags and the planner.

    Returns ``(PipelineSpec | None, info)``.  ``info`` records where each
    value came from: ``flag`` (given), ``auto`` (the planner, asked for),
    ``auto:default`` (k unset: the planner picks it; there is no silent
    default k) or ``default`` (v unset stays 1, the codec 'none').  The
    cell rides ``info["plan_cell"]`` as ``autotune.Plan`` JSON; when the
    planner ran, ``info["plan"]`` holds its ``AutoPlan`` evidence.
    """
    from repro_torch.parallel import wire as wire_mod
    k_arg = _parse_auto_int(pipeline_k, "--pipeline-k")
    v_arg = _parse_auto_int(virtual_stages, "--virtual-stages")
    wire = "none" if wire_dtype is None else str(wire_dtype).strip().lower()
    if wire != "auto":
        try:
            wire = wire_mod.validate_wire_dtype(wire)
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(f"--wire-dtype: {e}")
    if pipeline_stages <= 1:
        if v_arg not in (None, 1):
            raise SystemExit(
                "--virtual-stages requires --pipeline-stages > 1 "
                "(interleaving subdivides pipeline stages)")
        if k_arg is not None:
            raise SystemExit(
                "--pipeline-k requires --pipeline-stages > 1 "
                "(use --microbatches for plain gradient accumulation)")
        if wire != "none":
            raise SystemExit(
                "--wire-dtype requires --pipeline-stages > 1 (the codec "
                "compresses the inter-stage pipeline hop)")
        return None, {"enabled": False}
    if isinstance(k_arg, int) and k_arg < 1:
        raise SystemExit(f"--pipeline-k {k_arg} must be >= 1")
    if isinstance(v_arg, int) and v_arg < 1:
        raise SystemExit(f"--virtual-stages {v_arg} must be >= 1")
    k_src = "flag" if isinstance(k_arg, int) \
        else ("auto" if k_arg == "auto" else "auto:default")
    v_src = "flag" if isinstance(v_arg, int) \
        else ("auto" if v_arg == "auto" else "default")
    wire_src = "auto" if wire == "auto" \
        else ("flag" if wire != "none" else "default")
    if isinstance(k_arg, int) and (isinstance(v_arg, int) or v_arg is None) \
            and wire != "auto":
        try:
            cell = Plan(stages=pipeline_stages, k=k_arg,
                        v=v_arg if v_arg else 1, wire_dtype=wire)
        except ValueError as e:
            raise SystemExit(str(e))
        spec = PipelineSpec.from_plan(cell)
        return spec, {"enabled": True, "k": spec.microbatches,
                      "v": spec.virtual_stages, "wire": spec.wire_dtype,
                      "k_source": k_src, "v_source": v_src,
                      "wire_source": wire_src,
                      "plan_cell": cell.to_json(), "plan": None}

    inp, inp_src = plan_inputs_for(
        cfg=cfg, batch=batch, seq=seq, pipeline_stages=pipeline_stages,
        plan_hints=plan_hints)
    try:
        spec, plan = PipelineSpec.auto_plan(
            inp,
            k_fixed=k_arg if isinstance(k_arg, int) else None,
            v_fixed=v_arg if isinstance(v_arg, int)
            else (1 if v_arg is None else None),
            wire_dtype=wire)
    except ValueError as e:               # e.g. S*v does not divide layers
        raise SystemExit(str(e))
    return spec, {"enabled": True, "k": spec.microbatches,
                  "v": spec.virtual_stages, "wire": spec.wire_dtype,
                  "k_source": k_src, "v_source": v_src,
                  "wire_source": wire_src, "roofline": inp_src,
                  "plan_cell": spec.plan.to_json(),
                  "plan": plan.to_dict()}


def _load_trace(path):
    from repro_torch.wireless.channel import BandwidthTrace
    try:
        with open(path) as f:
            doc = json.load(f)
        return BandwidthTrace(steps=tuple(doc["steps"]),
                              bw_Bps=tuple(doc["bw_Bps"]))
    except (OSError, KeyError, TypeError, ValueError) as e:
        raise SystemExit(f"--replan-trace {path}: {e}")


def observe_and_replan(replanner, trace, step: int, step_s):
    """Feed finished step ``step`` to the re-planner and run its cadence:
    the step time to its Watchdog (``step_s`` None for the first step of
    a cell's step function, which is not a sample), the trace's bandwidth
    at ``step``; returns the ``PlanSwitch`` or None."""
    if step_s is not None:
        replanner.observe_step(0, step_s)
    if trace is not None:
        replanner.observe_bandwidth(trace.at(step))
    return replanner.maybe_replan(step)


def _saved_plan(ckpt_dir: str, step: int):
    """The plan cell checkpoint ``step`` was taken on, or None (a
    checkpoint without a pipeline, or one written by the JAX package)."""
    cell = ckpt_lib.manifest(ckpt_dir, step).get("plan_cell")
    return None if cell is None else Plan.from_json(cell)


def _resume(ckpt_dir: str, step: int, state: dict, device, plan,
            **carry_kw) -> dict:
    """The state of checkpoint ``step``, on this run's plan cell ``plan``
    (None without a pipeline).

    The caller's state is the template (shapes and dtypes), freed before
    the checkpoint's arrays are loaded, so the card holds one state at a
    time.  A checkpoint of another cell is read in its own cell's layout
    and moved onto ``plan`` by ``carry_state`` (``carry_kw``: its
    ``cfg``, ``batch``, ``seq``).  An error-feedback entry the checkpoint
    lacks keeps its zeros; one this run has no place for is dropped."""
    held = {n.split("]", 1)[0] + "]"
            for n in ckpt_lib.manifest(ckpt_dir, step)["arrays"]}
    saved = _saved_plan(ckpt_dir, step) if plan is not None else None
    moved = saved is not None and saved != plan
    if moved:
        print(f"checkpoint cell {saved} -> this run's {plan}: state "
              "carried over (carry_state)", flush=True)
        carried = carry_state(state, saved, **carry_kw)
        state.clear()            # the caller's dict: cleared below, it
        state.update(carried)    # frees the caller's tensors
        del carried
    fresh = {key: state.pop(key) for key in _EF_KEYS
             if key in state and f"[{key!r}]" not in held}
    template = tree_map(lambda t: t.to("meta")
                        if isinstance(t, torch.Tensor) else t, state)
    state.clear()
    out = ckpt_lib.restore(ckpt_dir, step, template, device=device)
    out.update(fresh)
    if moved:
        out = carry_state(out, plan, **carry_kw)
    for key in _EF_KEYS:
        if key in out and f"[{key!r}]" not in held:
            print(f"checkpoint predates {key} — error feedback restarts "
                  "at zero", flush=True)
        elif key not in out and f"[{key!r}]" in held:
            print(f"checkpoint's {key} has no place in this run's state — "
                  "dropped", flush=True)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Train; returns the per-step rows, the final state, the model, the
    pipeline spec in force at the end, the plan's evidence and the
    checkpoint timings."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.size == "smoke" else spec.full
    if args.pipeline_stages > 1:
        if not cfg.homogeneous:
            raise ValueError(f"pipeline mode needs a homogeneous layer "
                             f"stack; {cfg.name} has a mixed pattern")
        if args.microbatches != 1:
            raise SystemExit("--microbatches (gradient accumulation) and "
                             "--pipeline-stages are mutually exclusive: "
                             "the pipeline micro-batches with --pipeline-k")
    pipeline, plan_info = resolve_pipeline_plan(
        pipeline_stages=args.pipeline_stages, pipeline_k=args.pipeline_k,
        virtual_stages=args.virtual_stages, cfg=cfg, batch=args.batch,
        seq=args.seq, wire_dtype=args.wire_dtype,
        plan_hints=args.plan_hints)
    replan_cfg = replan_config(args)
    if replan_cfg is not None and pipeline is None:
        raise SystemExit("--replan requires --pipeline-stages > 1 (the "
                         "re-planner moves the pipeline plan cell; there "
                         "is no cell without a pipeline)")
    trace = _load_trace(args.replan_trace) \
        if replan_cfg is not None and args.replan_trace else None
    last = ckpt_lib.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if last is not None and replan_cfg is not None:
        saved = _saved_plan(args.ckpt_dir, last)
        if saved is not None and saved != pipeline.plan:
            # the re-planner had moved the run: it continues there
            print(f"resuming on the checkpoint's cell {saved} (planned "
                  f"{pipeline.plan})", flush=True)
            pipeline = PipelineSpec.from_plan(saved)

    model = LM(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed),
                        master=True)
    opt = adamw(cosine_schedule(args.lr, warmup=20, total=args.steps),
                grad_clip=1.0)
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    if args.compress_grads:
        state["error_fb"] = init_error_fb(params)
    del params
    if pipeline is not None:
        ef = wire_ef_zeros(cfg, pipeline, args.batch, args.seq, device)
        if ef is not None:       # top-k wire codec: EF rides the state
            state["wire_ef"] = ef
        del ef

    ckpt_info = {"resumed_from": None, "restore_s": None, "save_s": {}}
    if last is not None:
        t0 = time.perf_counter()
        state = _resume(args.ckpt_dir, last, state, device,
                        pipeline.plan if pipeline is not None else None,
                        cfg=cfg, batch=args.batch, seq=args.seq)
        _sync(device)
        ckpt_info.update(resumed_from=last,
                         restore_s=time.perf_counter() - t0)
        print(f"resumed from step {last} "
              f"({ckpt_info['restore_s']:.1f} s)", flush=True)
    start = int(state["step"])

    def make_step(spec):
        return make_lm_train_step(model, opt, microbatches=args.microbatches,
                                  pipeline=spec, compress=args.compress_grads)

    replanner = cell_cache = None
    if pipeline is not None:
        line = (f"pipeline: S={pipeline.num_stages} "
                f"k={pipeline.microbatches} [{plan_info['k_source']}] "
                f"v={pipeline.virtual_stages} [{plan_info['v_source']}] "
                f"wire={pipeline.wire_dtype} [{plan_info['wire_source']}]")
        if plan_info.get("plan"):
            p = plan_info["plan"]
            line += (f"  modeled {p['wall_s'] * 1e3:.1f} ms/batch, "
                     f"{p['speedup']:.2f}x vs unpipelined, "
                     f"bubble {p['bubble']:.3f}")
        print(line + f" on {device}", flush=True)
    if args.plan_out:
        with open(args.plan_out, "w") as f:
            json.dump(plan_info, f, indent=1)
    if replan_cfg is not None:
        inp, _ = plan_inputs_for(
            cfg=cfg, batch=args.batch, seq=args.seq,
            pipeline_stages=args.pipeline_stages, plan_hints=args.plan_hints)
        replanner = Replanner(inp, pipeline.plan, replan_cfg)
        # the step of each plan cell is built once: re-entering a cell is
        # a cache hit
        cell_cache = PlanCellCache(
            lambda plan: make_step(PipelineSpec.from_plan(plan)))
        print(f"replan: {replan_cfg.describe()}"
              + (f" trace={args.replan_trace}" if trace else ""),
              flush=True)
        step_fn = cell_cache.get(pipeline.plan)
    else:
        step_fn = make_step(pipeline)

    batches = build_batch_iter(cfg, args.batch, args.seq, seed=args.seed)
    for _ in range(start):       # the batches the checkpoint trained on
        next(batches)
    cuda = device.type == "cuda"
    rows = []
    warm = False       # the first step after a switch is not a sample
    for i in range(start, args.steps):
        batch = {n: torch.as_tensor(a, device=device)
                 for n, a in next(batches).items()}
        meter = step_fn.meter
        if meter is not None:
            meter.reset()
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state, mets = step_fn(state, batch)
        loss = float(mets["loss"])            # waits for the step
        _sync(device)
        dt = time.perf_counter() - t0
        row = {"step": i + 1, "loss": loss, "step_ms": dt * 1e3,
               "tokens_per_s": args.batch * args.seq / dt,
               "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if cuda else None),
               "hop_bytes_up": meter.up if meter else 0,
               "hop_bytes_down": meter.down if meter else 0,
               "device": torch.cuda.get_device_name(device) if cuda
               else "cpu"}
        if pipeline is not None:
            row["cell"] = list(pipeline.plan.cell())
        if cfg.is_moe:
            row["aux"] = float(mets["aux"])
        rows.append(row)
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {i + 1}: loss {loss}")
        if args.log_every and (i + 1) % args.log_every == 0:
            print(json.dumps(row), flush=True)
        if replanner is not None:
            switch = observe_and_replan(replanner, trace, i + 1,
                                        dt if warm else None)
            warm = True
            if switch is not None:
                print(f"replan @ step {switch.step}: {switch.old} -> "
                      f"{switch.new}  modeled "
                      f"{switch.old_wall_s * 1e3:.1f} -> "
                      f"{switch.new_wall_s * 1e3:.1f} ms/batch "
                      f"({switch.gain:.0%} gain)", flush=True)
                state = carry_state(state, switch.new, cfg=cfg,
                                    batch=args.batch, seq=args.seq)
                pipeline = PipelineSpec.from_plan(switch.new)
                step_fn = cell_cache.get(switch.new)
                warm = False
        if args.ckpt_dir and args.ckpt_every \
                and (i + 1) % args.ckpt_every == 0:
            t0 = time.perf_counter()
            ckpt_lib.save(args.ckpt_dir, i + 1, state, extra=None
                          if pipeline is None
                          else {"plan_cell": pipeline.plan.to_json()})
            ckpt_lib.prune(args.ckpt_dir)
            ckpt_info["save_s"][i + 1] = time.perf_counter() - t0
            print(f"checkpoint step {i + 1}: "
                  f"{ckpt_info['save_s'][i + 1]:.1f} s", flush=True)
    if replanner is not None:
        print(f"replan: {replanner.evals} evals, "
              f"{len(replanner.switches)} switch(es), "
              f"{cell_cache.misses} cell compile(s); "
              f"final {replanner.current}", flush=True)
        plan_info["replan"] = replanner.to_json()
        if args.plan_out:     # re-written with the switch log appended
            with open(args.plan_out, "w") as f:
                json.dump(plan_info, f, indent=1)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(rows, f, indent=1)
    return {"rows": rows, "state": state, "model": model,
            "pipeline": pipeline, "plan_info": plan_info,
            "ckpt": ckpt_info}


if __name__ == "__main__":
    main()
