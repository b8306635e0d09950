#!/usr/bin/env python3
"""Where an LM dry-run cell spends the host's time on a fake mesh: one
``launch.dryrun.run_cell`` of a ``reduced`` config under ``cProfile``,
on a mesh of the given shape (a one-process fake world, the CPU mesh
type). Prints the cell's wall (or where ``--limit`` cut it), the
functions with the most cumulative time, and, per aten op, the calls to
DTensor's sharding propagation, the strategy combinations it priced
(``expand_to_full_mesh_op_strategy``: the single-dim strategies to the
power of the mesh's dims, summed over calls) and the seconds spent there.

    PYTHONPATH=src python3 scripts/profile_dryrun_mesh.py mamba2-2.7b \\
        decode --mesh 2,2,2 --limit 100
    PYTHONPATH=src python3 scripts/profile_dryrun_mesh.py glm4-9b train \\
        --mesh 2,2

No card needed. Written against torch 2.13's DTensor internals: it wraps
``_ops.utils.expand_to_full_mesh_op_strategy`` in every module that
bound it and the propagator's ``propagate_op_sharding_non_cached``
(rebuilding the ``lru_cache`` of ``propagate_op_sharding`` over it), and
exits with a message where a torch lacks them; the per-op columns are
2.13's (torch 2.11 refuses the profiled views before any strategy)."""
import argparse
import collections
import cProfile
import io
import json
import pstats
import signal
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


class _Cut(Exception):
    pass


def _count_strategies(stats):
    """Wrap the propagator's per-op strategy search: per op, its calls,
    the combinations priced and the seconds."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._ops import utils as U
    prop = DTensor._op_dispatcher.sharding_propagator
    missing = [n for o, n in ((U, "expand_to_full_mesh_op_strategy"),
                              (prop, "propagate_op_sharding_non_cached"))
               if not hasattr(o, n)]
    if missing:
        import torch
        raise SystemExit(f"torch {torch.__version__} lacks {missing}: this "
                         f"profile is written against torch 2.13's DTensor")
    expand = U.expand_to_full_mesh_op_strategy
    current = []

    def counted_expand(mesh, op_schema, single, *a, **k):
        e = stats[str(current[-1]) if current else "?"]
        e["combos"] += len(single) ** mesh.ndim
        return expand(mesh, op_schema, single, *a, **k)

    # every module that imported the name binds its own reference
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("torch.distributed.tensor") \
                and getattr(mod, "expand_to_full_mesh_op_strategy",
                            None) is expand:
            mod.expand_to_full_mesh_op_strategy = counted_expand
    inner = prop.propagate_op_sharding_non_cached

    def timed(op_schema):
        current.append(op_schema.op)
        t0 = time.perf_counter()
        try:
            return inner(op_schema)
        finally:
            e = stats[str(op_schema.op)]
            e["calls"] += 1
            dt = time.perf_counter() - t0
            e["s"] += dt
            if dt > e.get("slowest_s", -1.0):   # its slowest call's inputs
                e["slowest_s"], e["slowest"] = dt, str(op_schema)[:500]
            current.pop()

    prop.propagate_op_sharding_non_cached = timed
    # the cache wraps the uncached function by reference: rebuild it
    if hasattr(prop, "propagate_op_sharding"):
        import functools
        prop.propagate_op_sharding = functools.lru_cache(None)(timed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("kind", choices=["train", "prefill", "decode"])
    ap.add_argument("--mesh", default="2,2,2")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--limit", type=float, default=100.0,
                    help="cut the cell after this many seconds")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--full", action="store_true",
                    help="the registry's config, not reduced()")
    ap.add_argument("--json", default="", help="write the per-op table here")
    a = ap.parse_args(argv)
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M
    shape_ = tuple(int(x) for x in a.mesh.split(","))
    n = 1
    for s in shape_:
        n *= s
    M.init_fake_world(n)
    mesh = M.device_mesh(shape_, AXES[len(shape_)], device="cpu")
    cfg = get_arch(a.arch)
    cfg = cfg if a.full else reduced(cfg)
    shape = ShapeConfig("t", a.seq, a.batch, a.kind)
    stats = collections.defaultdict(lambda: {"calls": 0, "combos": 0,
                                             "s": 0.0})
    import torch.distributed.tensor  # noqa: F401  (loads the op rules)
    _count_strategies(stats)

    def cut(signum, frame):
        raise _Cut()
    signal.signal(signal.SIGALRM, cut)
    signal.setitimer(signal.ITIMER_REAL, a.limit)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    rec, status = None, "ok"
    prof.enable()
    try:
        rec = DR.run_cell(a.arch, shape.name, mesh=mesh, cfg=cfg,
                          shape=shape, mesh_name="x".join(map(str, shape_)))
    except Exception as e:              # noqa: BLE001 — DTensor wraps it
        while e is not None and not isinstance(e, _Cut):
            e = e.__cause__ or e.__context__
        if e is None:
            raise
        status = f"cut at {a.limit} s"
    finally:
        prof.disable()
        signal.setitimer(signal.ITIMER_REAL, 0)
    wall = time.perf_counter() - t0
    print(f"# {a.arch} reduced={not a.full} {a.kind} mesh {shape_} torch "
          f"{torch.__version__}: {status}, wall {wall:.1f} s")
    if rec is not None:
        print(f"# build {rec['t_build_s']} s, step {rec['t_step_s']} s, "
              f"flops {rec['totals']['flops']}, state "
              f"{rec['state_bytes_per_device']}")
    s = io.StringIO()
    pstats.Stats(prof, stream=s).sort_stats("cumulative").print_stats(a.top)
    print(s.getvalue())
    rows = sorted(stats.items(), key=lambda kv: -kv[1]["s"])
    print(f"{'op':48s} {'calls':>6s} {'combos':>10s} {'s':>8s}")
    for op, e in rows[:a.top]:
        print(f"{op:48s} {e['calls']:6d} {e['combos']:10d} {e['s']:8.2f}")
        if e["s"] > 1.0:
            print(f"    slowest call {e['slowest_s']:.2f} s: {e['slowest']}")
    tot = sum(e["s"] for e in stats.values())
    print(f"# propagation {tot:.1f} s of {wall:.1f} s; combos "
          f"{sum(e['combos'] for e in stats.values())}")
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"status": status, "wall": wall, "ops": dict(stats)},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
