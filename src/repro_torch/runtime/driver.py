"""Orchestration and CLI of the streaming multi-UE runtime.

Port of the JAX package's ``runtime/driver.py``.  ``run_streaming``
wires the whole loop together in one process::

    N ``UEClient`` tasks  --loopback TCP-->  one ``BSDispatcher``

Each round every client runs its sub-cut shard, ships the coded cut
activation over a REAL socket (optionally shaped to a link rate by
``wireless.LinkShaper``) and gets the coded cut-activation gradient
back; the dispatcher micro-steps per arrival, and every hop's measured
(bytes, seconds) feeds the re-planner's ``LinkEstimator``.

With equal shards, no gradient clipping and codec 'none', the streamed
run computes the same parameter trajectory as joint full-batch training
of the unsplit model: the per-arrival micro-steps average to the
full-batch gradient (the mean of equal-shard means) and AdamW is
elementwise.

CLI (the reference's flags, plus ``--device``; on the card unless
``--device cpu``)::

    python -m repro_torch.runtime.driver --clients 4 --steps 20 \
        --wire-dtype int8+topk0.25 --bw-Bps 2e6 --qos-out qos.json
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys

import torch

from repro_torch import resolve_device
from repro_torch.data.synthetic import lm_batch_for
from repro_torch.models.config import LMConfig
from repro_torch.models.lm import LM
from repro_torch.parallel.wire import validate_wire_dtype
from repro_torch.runtime.bs import BSDispatcher
from repro_torch.runtime.ue import UEClient, UESync
from repro_torch.sl.split import lm_split
from repro_torch.training.optim import adamw
from repro_torch.training.replan import LinkEstimator
from repro_torch.wireless.channel import LinkShaper


def client_batches(cfg, client_id: int, n_clients: int,
                   batch_per_client: int, seq: int, seed: int = 0):
    """Client ``client_id``'s shard of the deterministic global stream:
    round ``step`` draws ``lm_batch_for(cfg, n_clients * batch_per_client,
    seq, seed + step)`` and yields rows ``[cid*b, (cid+1)*b)`` of its
    tokens and labels (CPU tensors), so one round's shards make the
    full-batch reference batch."""
    step = 0
    while True:
        batch = lm_batch_for(cfg, n_clients * batch_per_client, seq,
                             seed=seed + step)
        sl = slice(client_id * batch_per_client,
                   (client_id + 1) * batch_per_client)
        yield batch["tokens"][sl], batch["labels"][sl]
        step += 1


async def run_streaming(cfg, *, cut: int, n_clients: int, steps: int,
                        batch_per_client: int, seq: int, seed: int = 0,
                        wire_dtype: str = "none", lr: float = 1e-3,
                        shaper=None, replanner=None, queue_depth: int = 2,
                        stall_after_s: float = 0.25, qos=None,
                        on_started=None, params=None, device=None) -> dict:
    """Run the streaming loop on loopback; returns a summary dict.

    The model is drawn from ``torch.Generator`` seed ``seed`` in
    ``cfg.dtype`` (no f32 master copy), or taken from ``params`` (a full
    tree; ``split_params`` copies its halves).  ``shaper`` (anything with
    ``delay_s(nbytes)``) shapes both directions; ``replanner`` is a
    ``training.replan.Replanner`` or a bare ``LinkEstimator``: the
    dispatcher calls only ``observe_hop``.  ``on_started(dispatcher,
    clients)`` fires after the server binds, before the clients run.
    Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    model = LM(cfg, dev)
    spec = lm_split(model, cut)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    ue_params, bs_params = spec.split_params(params)
    del params                  # the halves are copies: free the full tree

    dispatcher = BSDispatcher(
        spec, bs_params, adamw(lr), n_clients=n_clients, device=dev,
        wire_dtype=wire_dtype, queue_depth=queue_depth,
        replanner=replanner, shaper=shaper, qos=qos,
        stall_after_s=stall_after_s)
    sync = UESync(ue_params, adamw(lr), n_clients)
    clients = [
        UEClient(cid, spec,
                 client_batches(cfg, cid, n_clients, batch_per_client,
                                seq, seed),
                 sync, device=dev, wire_dtype=wire_dtype, shaper=shaper)
        for cid in range(n_clients)]

    host, port = await dispatcher.start()
    if on_started is not None:
        on_started(dispatcher, clients)
    try:
        results = await asyncio.gather(
            dispatcher.train(steps),
            *(c.run(host, port, steps) for c in clients))
    finally:
        await dispatcher.close()
    losses = results[0]

    out = {
        "losses": losses,
        "final_loss": losses[-1] if losses else None,
        "steps": steps,
        "n_clients": n_clients,
        "wire_dtype": wire_dtype,
        "qos": dispatcher.qos.snapshot(),
        "wire_honesty": dispatcher.wire_honesty(),
        "params": {"ue": sync.params, "bs": dispatcher.bs_params},
        "ef": dict(dispatcher.ef),
        "hop_seconds": {d: dict(v)
                        for d, v in dispatcher.hop_seconds.items()},
        "spec": spec,
        "client_losses": {c.client_id: c.losses for c in clients},
    }
    if replanner is not None:
        link = getattr(replanner, "link", replanner)
        out["link_hints"] = link.hints()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="async multi-client streaming SL over loopback TCP")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-kv", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--cut", type=int, default=2,
                    help="UE-side depth l: embed + blocks[:l]")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-per-client", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--wire-dtype", default="none",
                    help="none | int8 | fp8 | <base>+topk<frac>")
    ap.add_argument("--bw-Bps", type=float, default=0.0,
                    help="emulated link rate; 0 = unshaped loopback")
    ap.add_argument("--latency-s", type=float, default=0.0)
    ap.add_argument("--queue-depth", type=int, default=2)
    ap.add_argument("--stall-after-s", type=float, default=0.25)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qos-out", default=None,
                    help="write the QoS snapshot JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    validate_wire_dtype(args.wire_dtype)

    cfg = LMConfig(name="stream", num_layers=args.layers,
                   d_model=args.d_model, n_heads=args.n_heads,
                   n_kv=args.n_kv, d_ff=args.d_ff, vocab=args.vocab,
                   dtype="float32")
    shaper = (LinkShaper(args.bw_Bps, latency_s=args.latency_s)
              if args.bw_Bps > 0 else None)
    result = asyncio.run(run_streaming(
        cfg, cut=args.cut, n_clients=args.clients, steps=args.steps,
        batch_per_client=args.batch_per_client, seq=args.seq,
        seed=args.seed, wire_dtype=args.wire_dtype, lr=args.lr,
        shaper=shaper, replanner=LinkEstimator(),
        queue_depth=args.queue_depth, stall_after_s=args.stall_after_s,
        device=device))

    print(f"streaming: {args.clients} UE x {args.steps} steps "
          f"wire={args.wire_dtype} on {device} "
          f"loss {result['losses'][0]:.4f} -> {result['losses'][-1]:.4f}")
    hints = result.get("link_hints") or {}
    if hints:
        bw = hints.get("link_bw_Bps")
        oh = hints.get("hop_overhead_s")
        print("  measured link: "
              + (f"bw {bw:.3g} B/s" if bw else "bw n/a")
              + (f", overhead {oh * 1e3:.3g} ms" if oh else ""))
    for direction, rows in result["wire_honesty"].items():
        bad = [r for r in rows if not r["ok"]]
        print(f"  wire honesty {direction}: "
              f"{len(rows) - len(bad)}/{len(rows)} hops within 1%")
    if args.qos_out:
        with open(args.qos_out, "w") as f:
            json.dump(result["qos"], f, indent=2, sort_keys=True)
        print(f"  qos snapshot -> {args.qos_out}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
