"""Re-derive the totals and roofline fields of existing dry-run records
from their saved per-op records (``ops/<tag>.ops.json.gz``), so the byte
and FLOP rules (``launch/op_analysis.py``) and the roofline constants can
change without rebuilding a cell (the port of ``repro.launch.reanalyze``,
which reads the cached HLO instead).

    PYTHONPATH=src python -m repro_torch.launch.reanalyze --dir results/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import SHAPES_BY_NAME
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import roofline as RL


def reanalyze_record(d, ops_dir, cfg=None, shape=None):
    """The record ``d`` with its totals, cost and roofline re-derived from
    its per-op records; None when it has none."""
    tag = f"{d['arch']}__{d['shape']}__{d['mesh']}"
    path = os.path.join(ops_dir, tag + ".ops.json.gz")
    if not os.path.exists(path):
        return None
    with gzip.open(path, "rt") as f:
        records = json.load(f)
    totals = OA.totals_of(records)
    cfg = cfg or get_arch(d["arch"])
    shape = shape or SHAPES_BY_NAME[d["shape"]]
    rl = RL.analyze(cfg, shape, d["mesh"], d["chips"], totals,
                    notes=d.get("plan", ""))
    return {**d, "totals": totals.to_dict(),
            "cost": {"flops": totals.flops, "bytes accessed": totals.bytes},
            "roofline": rl.to_dict()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    n = 0
    for jf in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        d = json.load(open(jf))
        if not d.get("ok"):
            continue
        new = reanalyze_record(d, os.path.join(args.dir, "ops"))
        if new is None:
            print(f"[skip] {d['arch']}__{d['shape']}__{d['mesh']}: no "
                  f"saved op records")
            continue
        with open(jf, "w") as f:
            json.dump(new, f, indent=1, default=str)
        n += 1
    print(f"re-analyzed {n} cells")


if __name__ == "__main__":
    main()
