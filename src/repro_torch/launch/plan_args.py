"""Shared CLI surface for the pipeline plan.

Port of the JAX package's ``launch/plan_args.py``: one argparse group for
every launcher that builds a pipeline or a serving plan, so the plan
flags cannot drift apart.  Two flavors:

* ``add_plan_args(ap, flavor="train")``, the training launcher: values
  may be ``'auto'`` (the planner picks), the codec accepts ``auto``, and
  the planner-evidence flags (``--plan-hints``, ``--plan-out``) and the
  online re-planner's (``--replan``) are included;
* ``add_plan_args(ap, flavor="serve")``, the serving launcher: only
  ``--wire-dtype`` (the INFER uplink codec; the serving hop is
  forward-only, so dense codecs only) and ``--plan-out``.

The reference's ``"lower"`` flavor and ``--plan-roofline`` feed the
planner from XLA dry-run records; they wait for the port of those records
and are left out.  ``--virtual-stages`` is the interleave spelling;
``--pipeline-v`` keeps working as a deprecated alias (both bind to
``args.virtual_stages``).
"""
from __future__ import annotations

import argparse

_WIRE_HELP = ("wire codec for the pipeline's cut-activation hop "
              "(parallel/wire.py): int8/fp8 block-quantize the hop's "
              "payload both directions; '<base>+topk<frac>' (e.g. "
              "int8+topk0.25) additionally sparsifies the gradient hop "
              "with error feedback")


def add_plan_args(ap: argparse.ArgumentParser, *,
                  flavor: str = "train") -> argparse._ArgumentGroup:
    """Attach the shared pipeline-plan flag group; returns the group."""
    if flavor not in ("train", "serve"):
        raise ValueError(
            f"flavor must be 'train' or 'serve', got {flavor!r} (the "
            "'lower' flavor is not ported)")
    if flavor == "serve":
        g = ap.add_argument_group(
            "serving plan",
            "the serving cell — slots via --slots [auto] "
            "(analysis/autotune.choose_serving_plan), INFER-hop codec via "
            "the shared --wire-dtype spelling")
        g.add_argument("--wire-dtype", default="none",
                       help="codec for the split-serving INFER uplink "
                            "(parallel/wire.py grammar, dense only — the "
                            "serving hop is forward-only): none | int8 | "
                            "fp8")
        g.add_argument("--plan-out", default=None,
                       help="write the resolved serving plan + its "
                            "evidence (autotune.ServingPlan) as JSON")
        return g
    g = ap.add_argument_group(
        "pipeline plan",
        "the (stages, k, v, wire) plan cell — one Plan currency "
        "(analysis/autotune.Plan)")
    g.add_argument("--pipeline-stages", type=int, default=0,
                   help="S>1: run the block stack as a C2P2SL pipeline "
                        "of S stages with a coded hop between them")
    g.add_argument("--pipeline-k", default=None,
                   help="micro-batches per pipelined batch: an integer, "
                        "or 'auto' to let the planner pick (unset also "
                        "plans k)")
    g.add_argument("--virtual-stages", "--pipeline-v",
                   dest="virtual_stages", default=None,
                   help="v>1: interleaved virtual stages — each pipeline "
                        "stage holds v round-robin model chunks, "
                        "shrinking the bubble to (S-1)/v ticks per "
                        "direction at the same k; 'auto' lets the planner "
                        "trade the extra hops against the bubble shrink "
                        "(unset: 1). (--pipeline-v is a deprecated alias)")
    g.add_argument("--wire-dtype", default="none",
                   help=_WIRE_HELP + "; 'auto' lets the planner enumerate "
                        "the codec jointly with (k, v)")
    g.add_argument("--plan-hints", default=None,
                   help="measured planner hints JSON (a 'planner_hints' "
                        "object or a bare one: link_bw_Bps, "
                        "hop_overhead_s) overlaid on the config estimate "
                        "— calibrates the hop overhead and link bandwidth "
                        "from a measured hop instead of the priors")
    g.add_argument("--replan", default=None, metavar="SPEC",
                   help="online re-planning (training/replan.py): "
                        "'every:N,hysteresis:F' re-evaluates the plan "
                        "every N steps and switches when the modeled "
                        "wall-time gain beats F (also accepts "
                        "cooldown:N, ewma:F, bare 'on'); 'off' or unset "
                        "disables")
    g.add_argument("--plan-out", default=None,
                   help="write the resolved plan and its evidence "
                        "(and, with --replan, the switch log) as JSON")
    return g


def replan_config(args):
    """``args.replan`` -> ``ReplanConfig | None`` (None = disabled)."""
    from repro_torch.training.replan import ReplanConfig
    try:
        return ReplanConfig.parse(getattr(args, "replan", None))
    except ValueError as e:
        raise SystemExit(f"--replan: {e}")
