"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Everything the cell needs is found by name: the cell in BENCHMARK.json,
its configuration's file, its traffic mix (``traffic/<mix>.json``, whose
``kind`` picks the driver), the limits of its compared numbers
(``limits/<cell>.json``) and, with ``--trace 1``, one reader per
per-layer metric (``metrics/<metric>.py``). The run needs the card: with
no CUDA device, or fewer than the cell asks for, it exits non-zero and
prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    common.set_cache_dirs()
    bench = common.benchmark()
    w = common.cell(a.workload, bench)
    common.require_cards(w["chips"])
    import torch
    from perfbench.traffic import gen
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = execute(w, common.config(w["config"], bench),
                     gen.load_mix(w["traffic"]), a.seed, a.seconds,
                     bool(a.trace), T_START, dev, bench=bench)
    if result is None:
        return 3
    common.emit(result)
    return 0


def execute(w, cfgj, mix, seed, seconds, trace, t_start, dev, *,
            bench=None, fault=None):
    """One run of cell ``w`` on ``dev`` → the result line as a dict (the
    checks last), or None when a forbidden module was loaded. ``fault``
    plants one of the driver's faults in the program (the tests do)."""
    bench = bench or common.benchmark()
    lim = common.limits(w["name"])
    if mix["kind"] == "train":
        from perfbench import train as driver
    elif mix["kind"] == "serve":
        from perfbench import serve as driver
    else:
        raise SystemExit(f"traffic kind {mix['kind']!r} has no driver")
    res = driver.run_cell(w, cfgj, mix, seed, seconds, trace, t_start, dev,
                          fault=fault)
    out = {}
    if trace:
        for m in common.metrics_of(w["name"], "per_layer", bench):
            v = common.metric_reader(m["name"]).read(res["ctx"])
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in common.metrics_of(w["name"], "end_to_end", bench):
            out[m["name"]] = {"value": float(res["metrics"][m["name"]]),
                              "unit": m["unit"]}
    tr = res["ctx"]["trace"] if trace and res["ctx"] else None
    breakdown = ({"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
                 if tr is not None else None)
    if dev.type == "cuda":
        dev_line = common.device_line(w["chips"])
    else:
        dev_line = {"platform": "cpu", "kind": "cpu", "count": 1}
    dev_line.update(res["device_extra"], memory_peak_bytes=res["peak"])
    res["ctx"] = tr = None
    gc.collect()
    numbers = {**res["window_checks"], **res["finish"]()}
    bad = common.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return None
    checks = common.judge(numbers, lim)
    result = {"correct": common.passed(checks),
              "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": out,
              "device": dev_line}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
