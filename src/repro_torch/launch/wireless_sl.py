"""The paper's scenario end to end: heterogeneous UEs and a BS over a TDMA
cellular channel, the joint (l, k, b, tau) optimisation of Algorithm 1,
then real C²P²SL split training of ResNet-18 against the PSL baseline.

Port of the JAX package's ``examples/wireless_sl.py``.  It samples the
Table I fleet, runs ``algorithm1`` at the paper's batch of 512 and prints
the plan and the simulated C²P²SL and PSL batch times (seconds of the
Table I system model, not of any device).  It then scales the plan's
batch split to ``--batch`` (``integer_allocation``), trains C²P²SL at the
plan's cut with k capped by the smallest live b_i, and PSL, from the
same weights with SGD 0.05 / momentum 0.9, and reports each scheme's
accuracy on a held-out batch.  One JSON line per step: scheme, loss, step
ms (host clock ending in a synchronise), peak device GB and the device.
Runs on the card unless ``--device cpu`` is given; without CUDA and
without that flag it raises.

PYTHONPATH=src python -m repro_torch.launch.wireless_sl --steps 60 --ues 8
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.resnet18_cifar10 import FULL
from repro_torch.core import algorithm1, resnet18_profile
from repro_torch.core.schedule import (Plan, simulate_epsl, simulate_psl,
                                       simulate_sl, task_times)
from repro_torch.data.synthetic import image_batches
from repro_torch.models import resnet
from repro_torch.sl.baselines import (make_epsl_step, make_psl_step,
                                      make_sl_step)
from repro_torch.sl.c2p2sl import (batch_wall_time, init_sl_state,
                                   make_c2p2sl_step, shard_batch)
from repro_torch.sl.split import resnet_split
from repro_torch.training.optim import sgd
from repro_torch.wireless import sample_fleet

EVAL_BATCH, EVAL_SEED = 256, 4242
STEPS = {"C2P2SL": lambda spec, opt, k: make_c2p2sl_step(spec, opt, k),
         "PSL": lambda spec, opt, k: make_psl_step(spec, opt),
         "EPSL": lambda spec, opt, k: make_epsl_step(spec, opt),
         "SL": lambda spec, opt, k: make_sl_step(spec, opt)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ues", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def integer_allocation(b: np.ndarray, batch: int) -> np.ndarray:
    """The plan's (real-valued) split scaled to ``batch`` integer samples
    summing to ``batch``, every UE at least one (as the reference's Fig 3
    benchmark rounds it)."""
    alloc = np.maximum(1, np.round(b / b.sum() * batch)).astype(int)
    alloc[np.argmax(alloc)] += batch - alloc.sum()
    return alloc


def train_k(plan_k: int, alloc: np.ndarray) -> int:
    """The plan's k capped by the smallest live allocation, so no UE's
    micro-batch is empty."""
    return int(min(plan_k, np.min(alloc[alloc > 0])))


def scheme_times(prof, fleet, plan: Plan, batch: int = FULL.batch) -> dict:
    """Simulated batch seconds (the Table I system model) of each scheme:
    C²P²SL under the plan; PSL, EPSL and SL at the plan's cut with a
    uniform batch split and uniform TDMA slots, as their papers run."""
    n = fleet.n
    uni = Plan(l=plan.l, k=1, b=np.full(n, batch / n),
               tau=np.full(n, fleet.channel.frame_s / n))
    t1 = task_times(prof, fleet, uni)
    return {"C2P2SL": batch_wall_time(prof, fleet, plan),
            "PSL": simulate_psl(t1),
            "SL": simulate_sl(prof, fleet, uni),
            "EPSL": simulate_epsl(t1, n)}


def train_scheme(scheme: str, params, l: int, alloc: np.ndarray, k: int,
                 batch: int, steps: int, seed: int, device):
    """Train ``scheme`` for ``steps`` steps from a copy of ``params`` on
    ``image_batches(batch, seed=seed)``, C²P²SL sharded into k
    micro-batches and the baselines into one.  Yields each step's row and
    the state tree it left (updated in place by the next step)."""
    spec = resnet_split(l)
    opt = sgd(0.05, momentum=0.9)
    st = init_sl_state(spec, params, opt)
    tree = {"ue_params": st.ue_params, "bs_params": st.bs_params,
            "opt_state_ue": st.opt_state_ue, "opt_state_bs": st.opt_state_bs,
            "step": st.step}
    kk = k if scheme == "C2P2SL" else 1
    step = STEPS[scheme](spec, opt, kk)
    cuda = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    gen = image_batches(batch, seed=seed)
    for i in range(steps):
        bt = next(gen)
        x = torch.as_tensor(bt["images"], device=device)
        y = torch.as_tensor(bt["labels"], device=device).long()
        xs, ys = shard_batch(x, y, alloc, kk)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        tree, mets = step(tree, xs, ys)
        loss = float(mets["loss"])            # waits for the step
        if cuda:
            torch.cuda.synchronize(device)
        row = {"scheme": scheme, "step": i + 1, "loss": loss,
               "step_ms": (time.perf_counter() - t0) * 1e3,
               "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if cuda else None),
               "device": name}
        if not math.isfinite(loss):
            raise FloatingPointError(f"{scheme} step {i + 1}: loss {loss}")
        yield row, tree


def accuracy(l: int, tree, device) -> float:
    """Accuracy on the held-out batch (the reference example's)."""
    test = next(image_batches(EVAL_BATCH, seed=EVAL_SEED))
    merged = resnet_split(l).merge_params(tree["ue_params"],
                                          tree["bs_params"])
    with torch.no_grad():
        logits = resnet.forward(merged,
                                torch.as_tensor(test["images"], device=device))
    return float((logits.argmax(-1).cpu().numpy() == test["labels"]).mean())


def main(argv=None) -> dict:
    """Plan, then train; returns the plan, the simulated times, the rows
    and the accuracies."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    prof = resnet18_profile()
    fleet = sample_fleet(args.ues, seed=args.seed)
    r_u, _ = fleet.rates()
    print(f"fleet: {args.ues} UEs, uplink {r_u.min() / 1e6:.0f}-"
          f"{r_u.max() / 1e6:.0f} Mb/s, clocks "
          f"{fleet.ue_flops.min() / 16e9:.2f}-"
          f"{fleet.ue_flops.max() / 16e9:.2f} Gcycle/s", flush=True)

    res = algorithm1(prof, fleet, batch=FULL.batch)
    plan = res.plan
    print("plan " + json.dumps({
        "l": plan.l, "cut": prof.layer_names[plan.l - 1], "k": plan.k,
        "v": plan.v, "b": plan.b.tolist(), "tau": plan.tau.tolist(),
        "bubble": res.bubble, "history": res.history}), flush=True)
    times = scheme_times(prof, fleet, plan)
    print(f"simulated batch time (Table I system model seconds): C2P2SL "
          f"{times['C2P2SL']:.3f} s vs PSL {times['PSL']:.3f} s "
          f"(-{100 * (1 - times['C2P2SL'] / times['PSL']):.1f}%)",
          flush=True)

    alloc = integer_allocation(plan.b, args.batch)
    k = train_k(plan.k, alloc)
    print(f"training batch {args.batch}: split {alloc.tolist()}, C2P2SL "
          f"k={k}, on {device}", flush=True)
    params = resnet.init_resnet18(
        torch.Generator(device=device).manual_seed(args.seed))
    rows, acc = {}, {}
    for scheme in ("C2P2SL", "PSL"):
        rows[scheme] = []
        for row, tree in train_scheme(scheme, params, plan.l, alloc, k,
                                      args.batch, args.steps, args.seed,
                                      device):
            print(json.dumps(row), flush=True)
            rows[scheme].append(row)
        acc[scheme] = accuracy(plan.l, tree, device)
        print(f"{scheme:7s}: acc {acc[scheme]:.3f} after {args.steps} "
              f"rounds ~ {args.steps * times[scheme]:.0f} s of simulated "
              f"(Table I model) wall time", flush=True)
    return {"plan": plan, "bubble": res.bubble, "history": res.history,
            "times": times, "alloc": alloc, "k": k, "rows": rows,
            "acc": acc}


if __name__ == "__main__":
    main()
