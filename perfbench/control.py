"""The readings a cell's limits are set from, at the cell's own size on
the card, all in one process:

* the program against the reference on each of ``--seeds`` (the lower
  readings);
* the control, the reference in float8 put in the program's place, on
  each of ``--control-seeds`` (an upper reading);
* each planted fault of the program (the driver's ``FAULTS``) on each of
  ``--fault-seeds``.

A training cell's readings are of its checked first steps; a serving
cell's of a ``--seconds`` open loop at the cell's rate, the control and
the reference judged on the program's checked sample.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,...
        [--control-seeds ...] [--fault-seeds ...] [--seconds s]
        [--out file.json]

Each reading is printed as a line ``[reading] <what> seed <n> {...}`` as
it comes, with ``correct``: its numbers judged against the cell's limits
(``limits/<cell>.json``) as a benchmark run judges its own, so a program
reading has to come out true and a control or fault reading false. All of
them are written to ``--out`` at the end. The benchmark's runs never run
this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import common  # noqa: E402


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    common.set_cache_dirs()
    w = common.cell(a.workload)
    common.require_cards(w["chips"])
    import torch
    from perfbench import train
    from perfbench.traffic import gen
    from repro_torch.kernels import _build
    cfgj, mix = common.config(w["config"]), gen.load_mix(w["traffic"])
    dev = torch.device("cuda", 0)
    lim = common.limits(a.workload)
    out = []

    def note(what, seed, numbers, t, judged=True):
        rec = {"what": what, "seed": seed, **numbers,
               "seconds": time.perf_counter() - t}
        if judged:
            rec["correct"] = judge(numbers, lim)
        out.append(rec)
        print(f"[reading] {what} seed {seed} {json.dumps(rec)}", flush=True)

    if mix["kind"] == "serve":
        serve_readings(a, cfgj, mix, dev, note)
    else:
        _build.build_all(train.LIBS)
        train_readings(a, cfgj, mix, dev, note)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1))
    return 0


def judge(numbers, lim) -> bool:
    """Whether ``numbers`` pass the limits ``lim``, as in a run. A limit
    these readings give no number for (the window's finite losses, the
    serving sample's count) reads as passed: only the compared gaps are
    judged."""
    rest = {k: 0.0 for k in lim if k not in numbers}
    return common.passed(common.judge({**rest, **numbers}, lim))


def _table(prog, ref):
    """The table's raw norms, program (or control) and reference."""
    return {f"table_{k}": [prog[k]["table"], ref[k]["table"]]
            for k in ("grad", "change")}


def train_readings(a, cfgj, mix, dev, note):
    import torch
    from perfbench import train

    def program(seed, fault=None):
        p = train.Program(cfgj, mix, seed, dev, fault=fault)
        p.checked_run(mix["checked_steps"])
        r = p.readings
        p.free()
        return r

    refs = {}
    for seed in sorted(set(a.seeds + a.control_seeds + a.fault_seeds)):
        t = time.perf_counter()
        refs[seed] = train.reference_readings(cfgj, mix, seed, dev)
        gc.collect()
        torch.cuda.empty_cache()
        note("reference", seed, {"loss": refs[seed]["loss"]}, t, False)
    for seed in a.seeds:
        t = time.perf_counter()
        r = program(seed)
        note("program", seed, {**train.compare(r, refs[seed]),
                               **_table(r, refs[seed]),
                               "losses": r["loss"],
                               "ref_losses": refs[seed]["loss"]}, t)
    for seed in a.control_seeds:
        t = time.perf_counter()
        ctl = train.reference_readings(cfgj, mix, seed, dev, "fp8")
        gc.collect()
        torch.cuda.empty_cache()
        note("control_fp8", seed, {**train.compare(ctl, refs[seed]),
                                   **_table(ctl, refs[seed])}, t)
    for fault in train.FAULTS:
        for seed in a.fault_seeds:
            t = time.perf_counter()
            r = program(seed, fault)
            note(f"fault_{fault}", seed, {**train.compare(r, refs[seed]),
                                          **_table(r, refs[seed])}, t)


def serve_readings(a, cfgj, mix, dev, note):
    import torch
    from perfbench import serve
    from repro_torch.kernels import _build
    _build.build_all(serve.LIBS)

    def program(seed, fault=None):
        client = serve.Client(mix, cfgj["vocab_size"])
        eng, model = serve.build(cfgj, mix, seed, dev, client)
        if fault is not None:
            serve.alter_answers(eng, cfgj["vocab_size"])
        rec = serve.open_loop(eng, client, mix, seed, mix["rate_per_s"],
                              a.seconds)
        del eng, model
        gc.collect()
        torch.cuda.empty_cache()
        return client, serve.check_sample(client, mix, seed), rec

    for seed in sorted(set(a.seeds + a.control_seeds + a.fault_seeds)):
        t = time.perf_counter()
        client, sample, rec = program(seed)
        gaps = serve.served_gaps(cfgj, client, sample, seed, dev)
        note("program", seed, {"served_gap": max(gaps), "gaps": gaps,
                               "p95_ms": rec["p95_ms"],
                               "failed": rec["failed"]}, t)
        if seed in a.control_seeds:
            t = time.perf_counter()
            ans = serve.control_answers(cfgj, client, sample, seed, dev)
            gaps = serve.served_gaps(cfgj, client, sample, seed, dev,
                                     answers=ans)
            note("control_fp8", seed, {"served_gap": max(gaps),
                                       "gaps": gaps}, t)
        gc.collect()
        torch.cuda.empty_cache()
    for fault in serve.FAULTS:
        for seed in a.fault_seeds:
            t = time.perf_counter()
            client, sample, _ = program(seed, fault)
            gaps = serve.served_gaps(cfgj, client, sample, seed, dev)
            note(f"fault_{fault}", seed, {"served_gap": max(gaps)}, t)


if __name__ == "__main__":
    sys.exit(main())
