#!/usr/bin/env python3
"""Where a dry-run cell's collectives come from: one
``launch.dryrun.run_cell`` with every collective that ``op_analysis``
counts tagged by the DTensor op whose redistribution started it and the
line of the port's model code that called that op (``backward`` where
autograd ran it with no model frame on the stack). Sums calls and operand
bytes per (kind, op, site, operand shape), prints the largest, and with
``--json`` writes them; ``--diff A.json B.json`` prints the keys whose
bytes differ between two such files (say, two torch versions).

    PYTHONPATH=src python3 scripts/collectives_by_site.py mamba2-2.7b \\
        train_4k --multi-pod --device cpu --json mamba2_train.json
    python3 scripts/collectives_by_site.py --diff a.json b.json

Runs on the host (``meta``, a fake world); no card needed."""
import argparse
import collections
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

MODEL_DIRS = (os.sep + os.path.join("repro_torch", "models") + os.sep,
              os.sep + os.path.join("repro_torch", "training") + os.sep)


def _site():
    """(DTensor op, model line) of the collective being counted."""
    f = sys._getframe(2)
    op, line = None, "backward"
    while f is not None:
        if op is None and "op_call" in f.f_locals and \
                "distributed" in f.f_code.co_filename:
            op = str(f.f_locals["op_call"])
        fn = f.f_code.co_filename
        if any(d in fn for d in MODEL_DIRS):
            line = f"{Path(fn).name}:{f.f_lineno} {f.f_code.co_name}"
            break
        f = f.f_back
    return op or "redistribute", line


def run(a) -> dict:
    import torch
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import op_analysis as OA
    sites = collections.defaultdict(lambda: [0, 0])
    count = OA.OpAnalysis._count

    def tagged(self, func, args, kwargs, ins, out):
        n = len(self.records)
        count(self, func, args, kwargs, ins, out)
        for rec in self.records[n:]:
            if rec[1] == "collective":
                op, line = _site()
                shape = tuple(ins[0].shape) if ins else ()
                e = sites[json.dumps([rec[5], op, line, shape])]
                e[0] += 1
                e[1] += rec[3]

    OA.OpAnalysis._count = tagged
    rec = DR.run_cell(a.arch, a.shape, a.multi_pod, mesh_device=a.device)
    total = collections.Counter()
    for k, (_, b) in sites.items():
        total[json.loads(k)[0]] += b
    return {"torch": torch.__version__, "arch": a.arch, "shape": a.shape,
            "mesh": rec["mesh"], "coll_bytes": rec["totals"]["coll_bytes"],
            "flops": rec["totals"]["flops"],
            "state_bytes_per_device": rec["state_bytes_per_device"],
            "t_build_s": rec["t_build_s"], "t_step_s": rec["t_step_s"],
            "by_site_total": dict(total),
            "sites": {k: {"calls": c, "bytes": b}
                      for k, (c, b) in sites.items()}}


def show(out: dict, top: int) -> None:
    print(f"# {out['arch']} {out['shape']} {out['mesh']} torch "
          f"{out['torch']}: {out['coll_bytes']}")
    rows = sorted(out["sites"].items(), key=lambda kv: -kv[1]["bytes"])
    for k, e in rows[:top]:
        kind, op, line, shape = json.loads(k)
        print(f"{kind:15s} {e['bytes']:12.4e} B {e['calls']:5d}x "
              f"{op:40s} {line:40s} {shape}")


def diff(pa: str, pb: str, top: int) -> None:
    A, B = (json.load(open(p)) for p in (pa, pb))
    print(f"# A torch {A['torch']}: {A['coll_bytes']}")
    print(f"# B torch {B['torch']}: {B['coll_bytes']}")
    keys = set(A["sites"]) | set(B["sites"])
    zero = {"calls": 0, "bytes": 0}
    rows = []
    for k in keys:
        a, b = A["sites"].get(k, zero), B["sites"].get(k, zero)
        if a != b:
            rows.append((abs(a["bytes"] - b["bytes"]), k, a, b))
    rows.sort(reverse=True)
    for _, k, a, b in rows[:top]:
        kind, op, line, shape = json.loads(k)
        print(f"{kind:15s} A {a['bytes']:.4e} B ({a['calls']}x) -> "
              f"B {b['bytes']:.4e} B ({b['calls']}x)  {op}  {line}  "
              f"{shape}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?")
    ap.add_argument("shape", nargs="?")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (cpu where no card)")
    ap.add_argument("--json", default="")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"))
    a = ap.parse_args(argv)
    if a.diff:
        diff(*a.diff, a.top)
        return 0
    out = run(a)
    show(out, a.top)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
