"""What every cell shares: finding the cell's files by name, the device
line, the forbidden-module check, the comparison of readings against their
limits, and the result line."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

#: Top-level module names that no run may load: JAX and the JAX package the
#: program was ported from. Compared whole: the program's own top-level
#: name begins with one of them.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# --------------------------------------------------------------------------
# finding things by name
# --------------------------------------------------------------------------

def benchmark() -> Dict[str, Any]:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, bench: Optional[Dict] = None) -> Dict[str, Any]:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench: Optional[Dict] = None) -> Dict[str, Any]:
    """The configuration ``name``'s file, as BENCHMARK.json names it."""
    bench = bench or benchmark()
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def limits(workload: str) -> Dict[str, float]:
    """The limits of the cell's compared numbers, ``limits/<cell>.json``."""
    path = HERE / "limits" / f"{workload}.json"
    return {k: float(v["limit"]) for k, v in
            json.loads(path.read_text()).items()}


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``metrics/<name>.py``: a module with ``read(ctx)``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    return load_module(path)


def metrics_of(workload: str, section: str,
               bench: Optional[Dict] = None) -> List[Dict]:
    """The ``section`` ("end_to_end" or "per_layer") metrics the cell
    reports: those that list it. An end-to-end metric with no list is
    reported by every cell; a per-layer metric always lists its cells."""
    bench = bench or benchmark()
    out = []
    for m in bench[section]:
        if section == "per_layer" and "workloads" not in m:
            raise KeyError(f"per-layer metric {m['name']!r} lists no "
                           "workloads")
        if workload in m.get("workloads", (workload,)):
            out.append(m)
    return out


# --------------------------------------------------------------------------
# the run's environment
# --------------------------------------------------------------------------

def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    libraries the program uses are kept from loading JAX."""
    cache = ROOT / "build" / "cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"{torch.cuda.device_count()} CUDA devices, the "
                         f"cell asks for {n}")


def device_line(count: int = 1) -> Dict[str, Any]:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)),
            "power_limit": power_limit()}


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------

def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip: Iterable[str] = ()) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    skip = set(skip)
    med = sorted(ref.values())[len(ref) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref
            if k not in skip}


def worst_leaf_gap(gaps: Dict[str, float]) -> float:
    """The largest of :func:`leaf_gaps`."""
    return max(gaps.values(), default=0.0)


def median_leaf_gap(gaps: Dict[str, float]) -> float:
    """The median leaf's of :func:`leaf_gaps`."""
    v = sorted(gaps.values())
    return v[len(v) // 2] if v else 0.0


def quiet_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: they move by round-off alone and are left out of the change."""
    med = sorted(ref_grad.values())[len(ref_grad) // 2]
    return sorted(k for k, g in ref_grad.items() if g < 1e-3 * med)


def judge(numbers: Dict[str, float], lim: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each number the limits name beside its limit (a number passes when
    it is finite and at most its limit); one it names and the run did not
    give reads infinite."""
    return {k: {"value": float(numbers.get(k, math.inf)), "limit": v}
            for k, v in lim.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def emit(result: Dict[str, Any]) -> None:
    """The checks on standard error as the last lines there, then the
    result as the last line of standard output, the checks' key last."""
    checks = result.pop("checks")
    for k, c in checks.items():
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
