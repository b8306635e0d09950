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
attention runs the kernels' functional time mode.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.configs import get_arch
from repro_torch.core.device import resolve_device
from repro_torch.data import GRLoader, SyntheticKuaiRand, preprocess_log
from repro_torch.models.model_zoo import get_bundle
from repro_torch.training.engine import GREngine


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    """Parse ``argv`` (default: the command line), train, and return the
    per-step records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hstu-large",
                    help="a GR config: hstu-{tiny,small,medium,large,long} "
                         "or fuxi-{tiny,small,medium,large,long}")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--synthetic-users", type=int, default=2000)
    ap.add_argument("--num-items", type=int, default=200_000)
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--users-per-device", type=int, default=2)
    ap.add_argument("--num-negatives", type=int, default=32)
    ap.add_argument("--strategy", default="token_realloc",
                    choices=["fixed", "token_scaling", "token_realloc"])
    ap.add_argument("--neg-mode", default="fused", choices=["fused"],
                    help="the fused negative path (the other modes are "
                         "not ported yet)")
    ap.add_argument("--schedule", default="algorithm1",
                    choices=["algorithm1", "flat"],
                    help="staged pipeline (Algorithm 1) vs serial stages")
    ap.add_argument("--expansion", type=int, default=1)
    ap.add_argument("--no-semi-async", action="store_true")
    ap.add_argument("--lr", type=float, default=4e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, with the CUDA kernels) or cpu "
                         "(the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).replace(max_seq_len=args.max_seq_len,
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

    t0 = time.perf_counter()
    tally = {"tokens": 0}

    def on_step(i, rec, state):
        tally["tokens"] += rec["tokens"]
        if (i + 1) % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(f"step {i+1:5d}  loss {rec['loss']:.4f}  "
                  f"{tally['tokens']/dt:,.0f} tok/s  "
                  f"{(i+1)/dt:.2f} steps/s", flush=True)

    engine = GREngine(
        get_bundle(cfg), loader,
        loss_kwargs=dict(neg_mode=args.neg_mode, expansion=args.expansion),
        lr_dense=args.lr, lr_sparse=args.lr,
        semi_async=not args.no_semi_async, schedule=args.schedule,
        seed=args.seed, step_callback=on_step, device=device)
    n_dense = sum(p.numel() for p in engine.state.dense.parameters())
    print(f"[model] {cfg.name}: {n_dense/1e6:.2f}M dense params, table "
          f"{n_items}x{cfg.d_model} on {device}", flush=True)
    results = engine.run(args.steps)
    r = engine.timeline_report()
    print(f"[timeline] computing {100*r.get('computing_ratio', 0):.1f}%  "
          f"comm-not-overlapped "
          f"{100*r.get('comm_not_overlapped_ratio', 0):.2f}%  "
          f"free {100*r.get('free_ratio', 0):.1f}%")
    final = f"final loss {results[-1]['loss']:.4f}" if results else "no steps"
    print(f"[done] {args.steps} steps in "
          f"{time.perf_counter()-t0:.1f}s, {final}", flush=True)
    return results


if __name__ == "__main__":
    main()
