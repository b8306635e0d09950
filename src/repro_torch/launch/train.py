"""End-to-end GR training entry point (the port of ``repro.launch.train``).

Synthetic-KuaiRand data → Appendix-A preprocessing → load-balanced jagged
loader → HSTU or FuXi dense backbone + embedding table → fused
sampled-softmax recall loss → AdamW + Eq.-1 AdaGrad (τ=1 semi-async unless
``--no-semi-async``), all executed by the staged engine (§4.2.3 Algorithm
1 by default; ``--schedule flat`` runs the same stages serially with
identical numerics). One process drives one card.

On the card (the default; raises without one):
    PYTHONPATH=src python -m repro_torch.launch.train --arch hstu-large \\
        --steps 8 --synthetic-users 400 --num-items 200000 \\
        --max-seq-len 512 --users-per-device 2 --num-negatives 32

On the CPU, with the kernels' plain versions:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch hstu-tiny --steps 20 --synthetic-users 300 \\
        --num-items 3000 --max-seq-len 64 --log-every 5

``--arch fuxi-large`` (``fuxi-tiny`` on the CPU) trains FuXi-α, whose
attention runs the kernels' functional time mode. ``--neg-mode baseline``
and ``--neg-mode segmented`` run the §4.3 / Table-7 ablation's other
negative paths (K9); segmented needs the loader's capacity
(``--users-per-device`` × ``--max-seq-len``) to be a multiple of 128.

``--ckpt-dir`` runs the supervised loop (``GREngine.run_resilient``):
crash-consistent async checkpoints every ``--ckpt-every`` steps, per-stage
retry, the non-finite guard and recovery on failure; ``--resume`` restores
the newest intact checkpoint there and trains on to ``--steps``. Any of
``--trace-out``, ``--metrics-out`` and ``--metrics-every`` turns telemetry
on (a Perfetto trace, the metrics snapshot, per-step MFU lines); the MFU is
taken against the card's cited peak, or ``--peak-flops`` (needed on the
CPU, which has none).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.configs import get_arch
from repro_torch.core.device import resolve_device
from repro_torch.data import GRLoader, SyntheticKuaiRand, preprocess_log
from repro_torch.models.model_zoo import get_bundle
from repro_torch.obs import Obs
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.engine import GREngine
from repro_torch.training.resilience import FaultPolicy


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    """Parse ``argv`` (default: the command line), train, and return the
    per-step records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hstu-large",
                    help="a GR config: hstu-{tiny,small,medium,large,long}, "
                         "fuxi-{tiny,small,medium,large,long} or "
                         "sasrec-{tiny,small,medium,large}")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--synthetic-users", type=int, default=2000)
    ap.add_argument("--num-items", type=int, default=200_000)
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--users-per-device", type=int, default=2)
    ap.add_argument("--num-negatives", type=int, default=32)
    ap.add_argument("--strategy", default="token_realloc",
                    choices=["fixed", "token_scaling", "token_realloc"])
    ap.add_argument("--neg-mode", default="fused",
                    choices=["baseline", "segmented", "fused"],
                    help="the negative path: fused (K3/K4), or the §4.3 "
                         "ablation's materialised baseline and segmented "
                         "fetch (K9)")
    ap.add_argument("--schedule", default="algorithm1",
                    choices=["algorithm1", "flat"],
                    help="staged pipeline (Algorithm 1) vs serial stages")
    ap.add_argument("--expansion", type=int, default=1)
    ap.add_argument("--no-semi-async", action="store_true")
    ap.add_argument("--ckpt-dir", default="",
                    help="enables the supervised resilient loop: "
                         "crash-consistent async checkpoints, per-stage "
                         "retry, non-finite guard, recovery on failure")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep-last-n", type=int, default=0,
                    help="retain only the newest N checkpoints (0 = all)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest intact checkpoint in "
                         "--ckpt-dir and continue to --steps")
    ap.add_argument("--stage-retries", type=int, default=2,
                    help="retry budget for the host stages "
                         "(dataload/a2a/unique)")
    ap.add_argument("--max-skips", type=int, default=0,
                    help="non-finite-loss batches to skip before "
                         "escalating to recovery")
    ap.add_argument("--stage-timeout", type=float, default=0.0,
                    help="per-stage straggler watchdog in seconds "
                         "(0 = off; stragglers are recorded, not failed)")
    ap.add_argument("--lr", type=float, default=4e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "run (open in ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default="",
                    help="write the final MetricsRegistry snapshot: "
                         "*.prom gets Prometheus text exposition, "
                         "anything else the nested-JSON snapshot()")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="print measured MFU / token imbalance / step "
                         "wall time every N steps (0 = off; implies obs)")
    ap.add_argument("--peak-flops", type=float, default=0.0,
                    help="the peak FLOP/s the measured MFU is taken "
                         "against (0 = the card's cited peak)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, with the CUDA kernels) or cpu "
                         "(the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if not cfg.gr:
        raise SystemExit("train.py drives GR models; LM archs run through "
                         "models.model_zoo.LMBundle and "
                         "training.make_lm_train_step")
    cfg = cfg.replace(max_seq_len=args.max_seq_len,
                      num_negatives=args.num_negatives,
                      vocab_size=args.num_items)
    print(f"[data] synthesizing KuaiRand surrogate "
          f"({args.synthetic_users} users)...", flush=True)
    gen = SyntheticKuaiRand(num_users=args.synthetic_users,
                            num_items=args.num_items,
                            max_len=args.max_seq_len + 1, seed=args.seed)
    train_seqs, _, remap = preprocess_log(gen.log(args.synthetic_users))
    n_items = max(len(remap), 16)
    cfg = cfg.replace(vocab_size=n_items)
    print(f"[data] {len(train_seqs)} users, {n_items} items after 5-core "
          f"filter + leave-one-out", flush=True)
    loader = GRLoader(train_seqs, num_devices=1,
                      users_per_device=args.users_per_device,
                      max_seq_len=args.max_seq_len,
                      num_negatives=args.num_negatives,
                      num_items=n_items, strategy=args.strategy,
                      seed=args.seed)

    # observability: any telemetry flag turns the obs layer on
    obs = (Obs() if args.trace_out or args.metrics_out or args.metrics_every
           else None)
    t0 = time.perf_counter()
    tally = {"tokens": 0}

    def on_step(i, rec, state):
        tally["tokens"] += rec["tokens"]
        if (i + 1) % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(f"step {i+1:5d}  loss {rec['loss']:.4f}  "
                  f"{tally['tokens']/dt:,.0f} tok/s  "
                  f"{(i+1)/dt:.2f} steps/s", flush=True)
        if args.metrics_every and (i + 1) % args.metrics_every == 0:
            # per-step derived gauges ride the record when obs is live
            print(f"[obs] step {i+1:5d}  "
                  f"mfu {100*rec.get('mfu', 0):.2f}%  "
                  f"imbalance {100*rec.get('imbalance', 0):.2f}%  "
                  f"step_wall {rec.get('step_wall_s', 0)*1e3:.1f}ms",
                  flush=True)

    engine = GREngine(
        get_bundle(cfg), loader,
        loss_kwargs=dict(neg_mode=args.neg_mode, expansion=args.expansion),
        lr_dense=args.lr, lr_sparse=args.lr,
        semi_async=not args.no_semi_async, schedule=args.schedule,
        seed=args.seed, step_callback=on_step, device=device, obs=obs,
        peak_flops=args.peak_flops or None)
    n_dense = sum(p.numel() for p in engine.state.dense.parameters())
    print(f"[model] {cfg.name}: {n_dense/1e6:.2f}M dense params, table "
          f"{n_items}x{cfg.d_model} on {device}", flush=True)
    if args.ckpt_dir:
        # supervised loop: crash-consistent checkpoints + recovery; a
        # failed stage drains the pipeline, restores the newest intact
        # checkpoint and replays
        host_r = args.stage_retries
        policy = FaultPolicy(
            retries={"dataload": host_r, "a2a": host_r, "unique": host_r},
            stage_timeout_s=({s: args.stage_timeout for s in
                              ("dataload", "a2a", "unique", "dense_bwd")}
                             if args.stage_timeout else {}),
            max_skips=args.max_skips,
            nonfinite_action="skip" if args.max_skips else "recover")
        if args.resume and CKPT.latest_step(args.ckpt_dir) is not None:
            # the engine's fresh state is the template; the checkpoint's
            # values land in its tensors
            engine.state, used = CKPT.restore_with_step(args.ckpt_dir,
                                                        engine.state)
            print(f"[resume] restored intact checkpoint step {used}",
                  flush=True)
        results = engine.run_resilient(
            args.steps, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, policy=policy,
            keep_last_n=args.keep_last_n or None)
        for ev in engine.recoveries:
            print(f"[recovery] failed near step {ev.failed_step}, "
                  f"restored step {ev.restored_step} "
                  f"({ev.steps_lost} steps replayed)")
    else:
        results = engine.run(args.steps)
    r = engine.timeline_report()
    print(f"[timeline] computing {100*r.get('computing_ratio', 0):.1f}%  "
          f"comm-not-overlapped "
          f"{100*r.get('comm_not_overlapped_ratio', 0):.2f}%  "
          f"free {100*r.get('free_ratio', 0):.1f}%")
    if obs is not None:
        vals = obs.snapshot().get("train_pipeline_goodput", {}).get(
            "values", {})
        if vals:
            print(f"[obs] pipeline goodput "
                  f"{100*next(iter(vals.values())):.1f}%")
        if args.trace_out:
            obs.export_trace(args.trace_out)
            print(f"[obs] wrote Perfetto trace to {args.trace_out} "
                  f"({len(obs.tracer)} spans)")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                if args.metrics_out.endswith(".prom"):
                    f.write(obs.to_prometheus())
                else:
                    json.dump(obs.snapshot(), f, indent=1)
            print(f"[obs] wrote metrics snapshot to {args.metrics_out}")
    final = f"final loss {results[-1]['loss']:.4f}" if results else "no steps"
    print(f"[done] {args.steps} steps in "
          f"{time.perf_counter()-t0:.1f}s, {final}", flush=True)
    return results


if __name__ == "__main__":
    main()
