"""Build the port's CUDA sources with nvcc at first use, load with ctypes.

Each source under ``csrc/`` is one shared library with a plain C interface
(pointers, sizes, the stream), compiled for Hopper (``sm_90a``) into
``build/kernels/`` at the root of the checkout, named by a hash of the
source, the headers under ``csrc/`` and the flags so an edited source or
header rebuilds. :func:`build_all`
starts one nvcc per source, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"jagged_attn_fwd": "jagged_attn_fwd.cu",
           "jagged_attn_bwd": "jagged_attn_bwd.cu",
           "neg_fused": "neg_fused.cu",
           "runsum": "runsum.cu",
           "wscatter": "wscatter.cu",
           "neg_logits": "neg_logits.cu",
           "gather": "gather.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name → {"seconds": build time, "log": nvcc/ptxas output} for this process
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _info(name: str) -> Dict[str, object]:
    """This process's build of ``name``, or the log kept beside a library
    an earlier process built."""
    if name in BUILD_INFO:
        return BUILD_INFO[name]
    log = library_path(name).with_suffix(".log")
    return {"seconds": 0.0,
            "log": log.read_text() if log.exists() else "cached"}


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Dict]:
    """Compile every named source that is not built yet, one nvcc each,
    started together; raises with nvcc's output if any fails. Each
    library's nvcc/ptxas output is kept beside it (``.log``)."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {n: _info(n) for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        final = library_path(n)
        tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        BUILD_INFO[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if p.returncode != 0:
            failed.append(f"{n} (nvcc exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            library_path(n).with_suffix(".log").write_text(log)
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return {n: _info(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
