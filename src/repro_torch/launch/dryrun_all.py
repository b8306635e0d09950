"""The dry-run sweep: every (arch × shape × mesh) cell, one subprocess
each (the port of ``repro.launch.dryrun_all``): a fresh fake world and
fresh DTensor caches per cell. Safe to re-run: completed cells are
skipped. A cell past ``--timeout`` gets a failure record.

    python -m repro_torch.launch.dryrun_all --out results/dryrun_torch \\
        --mesh both --device cpu [--jobs 4]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def list_cells():
    """(runnable (arch, shape) cells, skipped (arch, shape, reason))."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import cells_for
    cells, skips = [], []
    for name, cfg in ARCHS.items():
        for s, ok, why in cells_for(cfg):
            if ok:
                cells.append((name, s.name))
            else:
                skips.append((name, s.name, why))
    return cells, skips


def _stacks(log: str) -> str:
    """The last stack dump in a cell's log (``--stack-at``)."""
    text = open(log, errors="replace").read()
    i = text.rfind("Thread 0x")
    return text[i:][-4000:] if i >= 0 else text[-4000:]


def _run_one(arch, shape, mesh, out, device, timeout, tag):
    path = os.path.join(out, tag + ".json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", out]
    if device:
        cmd += ["--device", device]
    # the cell prints its stacks just before the timeout: the record's
    # traceback says where it was
    cmd += ["--stack-at", str(time.time() + 0.95 * timeout)]
    log = os.path.join(out, "logs", tag + ".log")
    t0 = time.perf_counter()
    error = None
    with open(log, "w") as f:
        try:
            rc = subprocess.run(cmd, timeout=timeout, check=False, stdout=f,
                                stderr=subprocess.STDOUT).returncode
            if not os.path.exists(path):
                error = f"the cell's process exited {rc} with no record"
        except subprocess.TimeoutExpired:
            error = f"dry-run timeout ({timeout} s)"
    if error is not None:
        with open(path, "w") as g:
            json.dump({"arch": arch, "shape": shape,
                       "mesh": tag.rsplit("__", 1)[1], "ok": False,
                       "error": error, "traceback": _stacks(log)}, g)
    return tag, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--device", default=None,
                    help="the fake mesh's device type (default the card's)")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run side by side (each a process)")
    args = ap.parse_args(argv)
    os.makedirs(os.path.join(args.out, "logs"), exist_ok=True)

    cells, skips = list_cells()
    with open(os.path.join(args.out, "skips.txt"), "w") as f:
        for a, s, why in skips:
            f.write(f"{a}\t{s}\t{why}\n")

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    todo = []
    for m in meshes:
        for a, s in cells:
            tag = f"{a}__{s}__" + ("pod2x16x16" if m == "multi"
                                   else "pod16x16")
            if not os.path.exists(os.path.join(args.out, tag + ".json")):
                todo.append((a, s, m, tag))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(1, args.jobs)) as ex:
        futs = [ex.submit(_run_one, a, s, m, args.out, args.device,
                          args.timeout, tag) for a, s, m, tag in todo]
        for i, fu in enumerate(futs):
            tag, secs = fu.result()
            print(f"[{i + 1}/{len(todo)}] {tag} {secs:.0f} s "
                  f"(t+{time.perf_counter() - t0:.0f} s)", flush=True)
    print(f"done in {time.perf_counter() - t0:.0f}s")


if __name__ == "__main__":
    main()
