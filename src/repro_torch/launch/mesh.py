"""Process-group meshes (the port of ``repro.launch.mesh``): a (data, model)
grid of ``torch.distributed`` ranks, its subgroups, the collectives the
sparse parallelism runs over them, and the launcher that starts a world of
rank processes.

Rank ``r`` of a mesh of shape ``(D, M)`` sits at ``(r // M, r % M)``: the
``model`` group of a rank is the M ranks of its row (the HSP group that
shards the table), its ``data`` group the D ranks of its column (the
replicas of its shard), and the group over both axes is the whole world.
A member's index in a group is its position among the group's ranks in
ascending order, which is the row-major index of its coordinates on the
group's axes (as the reference's ``_shard_lo`` numbers them).

The store is a ``FileStore`` in a directory the caller gives, or
``init_method="tcp://localhost:<port>"`` (:func:`free_port` picks one);
there is no fixed port, so worlds started side by side (the test suite's
workers) never meet. ``timeout_s`` bounds every collective: a lost peer
ends a collective with an error, not a hang. ``device="cuda"`` puts rank r
on card ``r % device_count`` (every rank on ``cuda:0`` on a one-card
machine, time-sharing it); ``device="cpu"`` runs the plain versions; there
is no fallback from one to the other. The backend is gloo (every rank may
share one card); ``backend="nccl"`` is for a card per rank and has not
been run: the one-card machine refuses two NCCL ranks on one device.

Collectives take and return tensors on the mesh's device. Under gloo they
are staged through pinned host buffers explicitly (one path for the CPU
and the card); under NCCL they run on the device tensors. Each collective
that carries a payload counts, under a ``kind`` its caller names, the
bytes this rank sends to other ranks (a rank's part to itself is not
counted), the peers it sends to, and its time (:attr:`Mesh.stats`):
``wait_s``, the wait for the card's queued work before it starts, and
``seconds``, from there until its result is on the device.
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import json
import os
import socket
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device

AXES = ("data", "model")
BACKENDS = ("gloo", "nccl")


class Group(NamedTuple):
    """This rank's group over some mesh axes: the process group (None for
    a group of one), its ranks ascending and this rank's index in it."""
    pg: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def group_index(rank: int, shape: Sequence[int],
                group_axes: Sequence[str], axes: Sequence[str] = AXES
                ) -> Tuple[int, int]:
    """(``rank``'s index in its group over ``group_axes``, the group's
    size) on a ``shape`` mesh: the row-major index of its coordinates on
    those axes, as :class:`Mesh` numbers a group's members."""
    coords = np.unravel_index(int(rank), tuple(shape))
    idx, size = 0, 1
    for a, n, c in zip(axes, shape, coords):
        if a in group_axes:
            idx, size = idx * int(n) + int(c), size * int(n)
    return idx, size


def _row_bytes(x: torch.Tensor) -> int:
    return int(np.prod(x.shape[1:], dtype=np.int64)) * x.element_size()


class Mesh:
    """A (data, model) grid over the ranks of the default process group;
    build it with :func:`make_mesh`."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...],
                 rank: int, device: torch.device, backend: str,
                 timeout: datetime.timedelta):
        self._timeout = timeout
        self.shape = tuple(int(n) for n in shape)
        self.axes = tuple(axes)
        self.rank = int(rank)
        self.world = int(np.prod(self.shape))
        self.device = device
        self.backend = backend
        self.coords = dict(zip(self.axes, np.unravel_index(self.rank,
                                                           self.shape)))
        self.coords = {a: int(i) for a, i in self.coords.items()}
        self._groups: Dict[Tuple[str, ...], Group] = {}
        #: per kind: bytes sent to other ranks, peers sent to, calls, and
        #: seconds (wait for the card's queue, then the exchange itself)
        self.stats: Dict[str, Dict[str, int]] = {}
        self._make_groups()

    # -- groups ------------------------------------------------------------
    def _members(self, axes: Tuple[str, ...], fixed: Dict[str, int]
                 ) -> Tuple[int, ...]:
        ranges = [range(n) if a in axes else [fixed[a]]
                  for a, n in zip(self.axes, self.shape)]
        return tuple(sorted(int(np.ravel_multi_index(c, self.shape))
                            for c in itertools.product(*ranges)))

    def _make_groups(self) -> None:
        """One process group per subset of the axes and per position on the
        others, created in one order on every rank (``new_group`` must be
        called by all ranks for every group)."""
        full = tuple(self.axes)
        for k in range(1, len(self.axes) + 1):
            for sub in itertools.combinations(self.axes, k):
                others = [a for a in self.axes if a not in sub]
                for pos in itertools.product(
                        *[range(self.shape[self.axes.index(a)])
                          for a in others]):
                    ranks = self._members(sub, dict(zip(others, pos)))
                    pg = None
                    if len(ranks) > 1:
                        pg = (dist.group.WORLD if sub == full else
                              dist.new_group(list(ranks),
                                             timeout=self._timeout,
                                             backend=self.backend))
                    if self.rank in ranks:
                        self._groups[sub] = Group(pg, ranks,
                                                  ranks.index(self.rank))

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        axes = tuple(axes)
        unknown = [a for a in axes if a not in self.axes]
        if unknown:
            raise ValueError(f"axes {unknown} not in the mesh's {self.axes}")
        return tuple(a for a in self.axes if a in axes)

    def group(self, axes: Sequence[str]) -> Group:
        """This rank's group over ``axes`` (``()``: the rank alone)."""
        key = self._key(axes)
        if not key:
            return Group(None, (self.rank,), 0)
        return self._groups[key]

    def size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[self.axes.index(a)]
                            for a in self._key(axes)], dtype=np.int64))

    # -- staging -----------------------------------------------------------
    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the backend reads it: itself under NCCL (or on the
        CPU), a pinned host copy under gloo."""
        x = x.contiguous()
        if self.backend == "nccl" or x.device.type == "cpu":
            return x
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return buf

    def _empty(self, shape, dtype) -> torch.Tensor:
        if self.backend == "nccl" or self.device.type == "cpu":
            return torch.empty(shape, dtype=dtype, device=self.device)
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device)

    def _count(self, kind: Optional[str], nbytes: int, peers: int) -> None:
        if kind is None:
            return
        s = self._entry(kind)
        s["bytes"] += int(nbytes)
        s["peers"] = max(s["peers"], int(peers))
        s["calls"] += 1

    def _entry(self, kind: str) -> Dict[str, Any]:
        return self.stats.setdefault(kind, {"bytes": 0, "peers": 0,
                                            "calls": 0, "seconds": 0.0,
                                            "wait_s": 0.0})

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @contextlib.contextmanager
    def _timed(self, kind: Optional[str]):
        """Time a collective under ``kind``: ``wait_s`` the wait for the
        work queued on the current stream (the staging copy would wait for
        it anyway), ``seconds`` from there until the result is on the
        device (staging, the transfer and the peers' lateness)."""
        if kind is None:
            yield
            return
        t0 = time.perf_counter()
        self._sync()
        t1 = time.perf_counter()
        yield
        self._sync()
        s = self._entry(kind)
        s["wait_s"] += t1 - t0
        s["seconds"] += time.perf_counter() - t1

    # -- collectives -------------------------------------------------------
    def all_to_all_v(self, x: torch.Tensor, counts: Sequence[int],
                     axes: Sequence[str], kind: Optional[str] = None
                     ) -> Tuple[torch.Tensor, List[int]]:
        """Send rows ``x[sum(counts[:j]) : sum(counts[:j+1])]`` to member j
        of the group over ``axes`` (the split sizes are sent first);
        returns the received rows, in member order, and their counts."""
        g = self.group(axes)
        counts = [int(c) for c in counts]
        if len(counts) != g.size or sum(counts) != x.shape[0]:
            raise ValueError(f"counts {counts} for {x.shape[0]} rows and "
                             f"{g.size} members")
        row = _row_bytes(x)
        self._count(kind, row * (sum(counts) - counts[g.index]),
                    sum(1 for j, c in enumerate(counts)
                        if c and j != g.index))
        if g.size == 1:
            return x, counts
        with self._timed(kind):
            send = self._wire(torch.tensor(counts, dtype=torch.int64))
            recv = self._empty((g.size,), torch.int64)
            dist.all_to_all_single(recv, send, group=g.pg)
            rcounts = [int(c) for c in recv.tolist()]
            out = self._empty((sum(rcounts),) + tuple(x.shape[1:]),
                              x.dtype)
            dist.all_to_all_single(out, self._wire(x), rcounts, counts,
                                   group=g.pg)
            out = self._back(out)
        return out, rcounts

    def all_gather_v(self, x: torch.Tensor, axes: Sequence[str],
                     kind: Optional[str] = None) -> List[torch.Tensor]:
        """Every member's ``x`` (leading dimensions may differ), in member
        order."""
        g = self.group(axes)
        row = _row_bytes(x)
        self._count(kind, row * x.shape[0] * (g.size - 1),
                    g.size - 1 if x.shape[0] else 0)
        if g.size == 1:
            return [x]
        with self._timed(kind):
            n = self._wire(torch.tensor([x.shape[0]], dtype=torch.int64))
            ns = [self._empty((1,), torch.int64) for _ in range(g.size)]
            dist.all_gather(ns, n, group=g.pg)
            sizes = [int(t.item()) for t in ns]
            top = max(sizes)
            rest = tuple(x.shape[1:])
            if top == 0:
                return [x.new_empty((0,) + rest) for _ in sizes]
            pad = x
            if x.shape[0] < top:
                pad = torch.cat([x, x.new_zeros((top - x.shape[0],) + rest)])
            parts = [self._empty((top,) + rest, x.dtype) for _ in sizes]
            dist.all_gather(parts, self._wire(pad), group=g.pg)
            out = [self._back(p[:s]) for p, s in zip(parts, sizes)]
        return out

    def sum_in_order(self, x: torch.Tensor, axes: Sequence[str],
                     kind: Optional[str] = None) -> torch.Tensor:
        """The sum of every member's ``x`` (one shape), added in member
        order, so every member gets the same bits; ``x`` itself in a group
        of one."""
        parts = self.all_gather_v(x.reshape(1, -1) if x.dim() == 0 else x,
                                  axes, kind)
        if len(parts) == 1:
            return x
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out.reshape(x.shape)

    def all_gather_object(self, obj: Any, axes: Sequence[str] = AXES
                          ) -> List[Any]:
        """Every member's picklable ``obj``, in member order."""
        g = self.group(axes)
        if g.size == 1:
            return [obj]
        out: List[Any] = [None] * g.size
        dist.all_gather_object(out, obj, group=g.pg)
        return out

    def barrier(self, axes: Sequence[str] = AXES) -> None:
        g = self.group(axes)
        if g.size > 1:
            dist.barrier(group=g.pg)

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axes, self.shape))}, rank {self.rank}"
                f" {self.coords}, {self.device}, {self.backend})")


def make_mesh(shape: Sequence[int], axes: Sequence[str] = AXES, *,
              rank: Optional[int] = None, store_dir: Optional[str] = None,
              init_method: Optional[str] = None, timeout_s: float = 60.0,
              device: Any = "cuda", backend: str = "gloo") -> Mesh:
    """Join (or make) the default process group of ``prod(shape)`` ranks
    as ``rank`` (default: the ``RANK`` environment variable) and build the
    mesh over it: ``store_dir`` holds a ``FileStore``, or ``init_method``
    names a TCP store (``tcp://localhost:<port>``); ``timeout_s`` bounds
    every collective; ``device`` is "cuda" (rank r on card r % count) or
    "cpu"; ``backend`` "gloo" or "nccl"."""
    shape = tuple(int(n) for n in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} for axes {axes}")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    world = int(np.prod(shape))
    if rank is None:
        rank = int(os.environ["RANK"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the NCCL backend needs device='cuda'")
    timeout = datetime.timedelta(seconds=timeout_s)
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise ValueError(
                f"the process group has rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {rank} of {world}")
    elif store_dir is not None:
        os.makedirs(store_dir, exist_ok=True)
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
    elif init_method is not None:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, timeout=timeout)
    else:
        raise ValueError("give store_dir (a FileStore) or init_method "
                         "(tcp://localhost:<port>)")
    return Mesh(shape, axes, rank, dev, backend, timeout)


# -- the production meshes (DeviceMesh) ---------------------------------------

#: The reference's production meshes: one pod (data 16, model 16) of 256
#: devices, and two such pods (pod 2, data 16, model 16) of 512.
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def production_mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def init_fake_world(world_size: int) -> None:
    """A default process group of ``world_size`` ranks in this one process,
    on the ``fake`` backend (every collective returns at once, without
    data): the dry-run's stand-in for the devices it plans for, as the
    reference forces 512 host devices. This process is rank 0. An existing
    group of that size is kept; one of another size raises."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks exists; "
                f"the fake world wants {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def device_mesh(shape: Sequence[int], axes: Sequence[str] = AXES, *,
                device: Any = None):
    """A ``DeviceMesh`` of ``shape`` over the first ``prod(shape)`` ranks of
    the default process group, ranks laid out row-major (rank r at the
    coordinates :class:`Mesh` gives it); ``device`` None means the card's
    mesh type."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape))
    dev = resolve_device(device)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, the default process group has "
            f"{have}: the dry-run's entry point makes a one-process world "
            f"of {n} ranks on the fake backend first "
            f"(launch.mesh.init_fake_world({n})); a real world starts "
            f"{n} ranks (spawn_ranks)")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: Any = None):
    """The reference's production mesh as a ``DeviceMesh``: (data 16, model
    16), or (pod 2, data 16, model 16) with ``multi_pod``, the same shapes
    and axis names, so every plan compares one to one with the
    reference's. It needs a default process group of at least 256 (512)
    ranks: :func:`init_fake_world` makes one in this process. ``device``
    None means the card's mesh type ("cuda"; without a card it raises),
    tests pass "cpu"."""
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    return device_mesh(shape, axes, device=device)


# -- a world of rank processes ------------------------------------------------

def _package_root() -> str:
    import repro_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))


def spawn_ranks(entry: str, kwargs: Dict[str, Any], *, shape: Sequence[int],
                run_dir: str, axes: Sequence[str] = AXES,
                device: str = "cuda", timeout_s: float = 60.0,
                backend: str = "gloo", store: str = "file",
                sys_path: Sequence[str] = ()) -> List[subprocess.Popen]:
    """Start one process per rank of a ``shape`` mesh, each running
    ``python -m repro_torch.launch.mesh``: it builds the mesh (a
    ``FileStore`` under ``run_dir``, or with ``store="tcp"`` a TCP store
    on a free port), calls ``entry`` ("module:function") as
    ``fn(mesh, **kwargs)`` and writes its JSON result to
    ``run_dir/rank<r>.json``; its output goes to ``run_dir/rank<r>.log``.
    ``sys_path``: directories the ranks import from besides the package's
    own. Each rank runs PyTorch on one intra-op thread (ranks share the
    host's cores)."""
    os.makedirs(run_dir, exist_ok=True)
    world = int(np.prod(shape))
    mesh_kw: Dict[str, Any] = dict(shape=list(shape), axes=list(axes),
                                   device=device, timeout_s=timeout_s,
                                   backend=backend)
    if store == "tcp":
        mesh_kw["init_method"] = f"tcp://localhost:{free_port()}"
    else:
        mesh_kw["store_dir"] = os.path.join(run_dir, "store")
    spec = dict(entry=entry, kwargs=kwargs, mesh=mesh_kw,
                sys_path=[_package_root(), *map(str, sys_path)],
                run_dir=run_dir)
    path = os.path.join(run_dir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join(
        [*spec["sys_path"], *filter(None, [e.get("PYTHONPATH")])])
    procs = []
    for r in range(world):
        log = open(os.path.join(run_dir, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.mesh", path, str(r)],
            stdout=log, stderr=subprocess.STDOUT, env=e))
        log.close()
    return procs


def wait_ranks(procs: Sequence[subprocess.Popen], deadline_s: float
               ) -> List[int]:
    """Wait for every rank (at most ``deadline_s`` in all), then kill any
    still running; their exit codes (a killed rank's is negative)."""
    end = time.monotonic() + deadline_s
    for p in procs:
        try:
            p.wait(timeout=max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return [p.returncode for p in procs]


def rank_results(run_dir: str, world: int) -> List[Any]:
    """Each rank's JSON result (None where it wrote none)."""
    out = []
    for r in range(world):
        path = os.path.join(run_dir, f"rank{r}.json")
        out.append(json.load(open(path)) if os.path.exists(path) else None)
    return out


def rank_logs(run_dir: str, world: int) -> List[str]:
    return [open(os.path.join(run_dir, f"rank{r}.log")).read()
            if os.path.exists(os.path.join(run_dir, f"rank{r}.log")) else ""
            for r in range(world)]


def _rank_main(spec_path: str, rank: int) -> int:
    import importlib
    with open(spec_path) as f:
        spec = json.load(f)
    for p in reversed(spec["sys_path"]):
        if p not in sys.path:
            sys.path.insert(0, p)
    torch.set_num_threads(1)
    mesh = None
    try:
        mesh = make_mesh(rank=rank, **spec["mesh"])
        mod, fn = spec["entry"].split(":")
        out = getattr(importlib.import_module(mod), fn)(mesh,
                                                         **spec["kwargs"])
        if out is not None:
            path = os.path.join(spec["run_dir"], f"rank{rank}.json")
            with open(path + ".tmp", "w") as f:
                json.dump(out, f)
            os.replace(path + ".tmp", path)
    except BaseException:                            # noqa: BLE001 — report
        traceback.print_exc()
        sys.stdout.flush()
        return 1
    finally:
        sys.stdout.flush()
    mesh.close()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
