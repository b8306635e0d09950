"""The dry-run's tables from its records (the port of
``repro.launch.report``): per mesh, each cell's per-device FLOPs,
collective bytes and state bytes; the skipped cells; the roofline terms
on the single-pod mesh (H100 constants, ``launch/roofline.py``); and a
compact table of every cell's state bytes and dominant term on both
meshes.

    PYTHONPATH=src python -m repro_torch.launch.report --dir results/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(d):
    return [json.load(open(f))
            for f in sorted(glob.glob(os.path.join(d, "*.json")))]


def dryrun_table(recs, mesh):
    rows = ["| arch | shape | chips | step_s | GFLOP/dev | coll GB/dev | "
            "state GB/dev | dominant | status |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"])):
        if r["mesh"] != mesh:
            continue
        if not r.get("ok"):
            err = r.get("error", "").splitlines()[0] if r.get("error") \
                else ""
            rows.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - "
                        f"| - | FAIL: {err[:60]} |")
            continue
        rl = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['chips']} | "
            f"{r['t_step_s']} | {rl['hlo_flops'] / 1e9:,.0f} | "
            f"{rl['coll_bytes'] / 1e9:.2f} | "
            f"{r['state_bytes_per_device'] / 1e9:.2f} | {rl['dominant']} | "
            f"ok |")
    return "\n".join(rows)


def roofline_table(recs):
    rows = ["| arch | shape | compute_s | memory_s | collective_s | "
            "dominant | MODEL/counted flops | roofline frac | bottleneck "
            "note |",
            "|---|---|---|---|---|---|---|---|---|"]
    notes = {
        "compute": "more TP / larger per-device tiles",
        "memory": "fuse the elementwise passes (scores, casts), bf16 "
                  "intermediates",
        "collective": "overlap FSDP gathers with compute; shrink the grad "
                      "exchange (bf16 wire / sparse rows)",
    }
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"])):
        if r["mesh"] != "pod16x16" or not r.get("ok"):
            continue
        rl = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.3f} | "
            f"{rl['memory_s']:.3f} | {rl['collective_s']:.3f} | "
            f"{rl['dominant']} | {rl['useful_ratio']:.3f} | "
            f"{rl['roofline_frac']:.3f} | {notes[rl['dominant']][:46]} |")
    return "\n".join(rows)


TERM_LETTER = {"compute": "c", "memory": "m", "collective": "l"}


def _by_arch_table(recs, fmt):
    """One row per arch, one column per shape: ``fmt(record)`` of each
    cell on pod16x16 / pod2x16x16 (- for no record, FAIL for a failure
    record)."""
    by = {}
    for r in recs:
        by.setdefault(r["arch"], {}).setdefault(r["shape"], {})[r["mesh"]] = r
    shapes = sorted({r["shape"] for r in recs},
                    key=lambda s: (not s.startswith("gr_"), s))

    def cell(m):
        if m is None:
            return "-"
        return fmt(m) if m.get("ok") else "FAIL"
    rows = ["| arch | " + " | ".join(shapes) + " |",
            "|---|" + "---|" * len(shapes)]
    for arch in sorted(by):
        cols = []
        for sh in shapes:
            ms = by[arch].get(sh)
            cols.append("" if ms is None else
                        f"{cell(ms.get('pod16x16'))} / "
                        f"{cell(ms.get('pod2x16x16'))}")
        rows.append(f"| {arch} | " + " | ".join(cols) + " |")
    return "\n".join(rows)


def state_table(recs):
    """Each cell's per-device state GB on pod16x16 / pod2x16x16 and its
    dominant roofline term (c, m, l: compute, memory, collective)."""
    return _by_arch_table(recs, lambda m: (
        f"{m['state_bytes_per_device'] / 1e9:.2f} "
        f"{TERM_LETTER[m['roofline']['dominant']]}"))


def time_table(recs):
    """Each cell's build + step seconds on the host (``t_build_s`` +
    ``t_step_s``) on pod16x16 / pod2x16x16."""
    return _by_arch_table(recs, lambda m: (
        f"{m['t_build_s'] + m['t_step_s']:.1f}"))


def skips_table(d):
    path = os.path.join(d, "skips.txt")
    if not os.path.exists(path):
        return "(none)"
    rows = ["| arch | shape | reason |", "|---|---|---|"]
    for line in open(path):
        a, s, why = line.rstrip("\n").split("\t")
        rows.append(f"| {a} | {s} | {why} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline", "skips",
                             "states", "times"])
    args = ap.parse_args(argv)
    recs = load(args.dir)
    if args.section in ("all", "dryrun"):
        print("### Single-pod mesh (data=16, model=16) — 256 devices\n")
        print(dryrun_table(recs, "pod16x16"))
        print("\n### Multi-pod mesh (pod=2, data=16, model=16) — 512 "
              "devices\n")
        print(dryrun_table(recs, "pod2x16x16"))
    if args.section in ("all", "skips"):
        print("\n### Skipped cells\n")
        print(skips_table(args.dir))
    if args.section in ("all", "roofline"):
        print("\n### Roofline (single-pod, per device, H100 constants)\n")
        print(roofline_table(recs))
    if args.section in ("all", "states"):
        print("\n### State GB per device (pod16x16 / pod2x16x16) and the "
              "dominant term (c, m, l)\n")
        print(state_table(recs))
    if args.section in ("all", "times"):
        print("\n### Build + step seconds on the host (pod16x16 / "
              "pod2x16x16)\n")
        print(time_table(recs))


if __name__ == "__main__":
    main()
