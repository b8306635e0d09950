"""Crash-consistent checkpointing (the port of ``repro.training.checkpoint``,
with its layout on disk, so that checkpoints cross between the two packages
in both directions).

Layout:  <dir>/step_<n>/
             manifest.msgpack   — leaf paths, per-leaf shape/dtype/CRC32,
                                  step, meta
             arr_<i>.npy        — one file per leaf
         <dir>/LATEST           — atomic pointer (write-to-tmp + rename)

Leaves are written in the order jax flattens the reference's
``GRTrainState``: NamedTuple fields in order, dict keys sorted, the dense
params and the AdamW moments in the reference's ``init_gr`` layout (block
leaves stacked along a leading layer axis), ``count`` and ``step`` as 0-d
int32 leaves, and the shadow as a 0-row placeholder (``shadow ==
master.half()`` is rebuilt on restore). bfloat16 leaves are upcast to
float32 on save (exact) with ``"bfloat16"`` kept in the manifest, and cast
back on restore. The τ=1 carry is written compact (the unique pending ids,
ascending, and their rows), a form the reference restores and steps on;
restore reads either form (the reference's −1 slots are dropped).

Properties (as the reference's):
  * atomic + durable — every leaf file, the manifest and the step
    directory are fsync'd before the directory rename, and the parent
    directory after it, so a crash mid-save never corrupts the restore
    point and a completed save survives power loss;
  * verified — the manifest records a CRC32 per leaf; ``restore`` checks
    every leaf against it, and ``latest_step``/``restore`` fall back to the
    newest *intact* ``step_*`` directory when LATEST is torn, dangling, or
    points at a corrupt save;
  * async — :class:`AsyncCheckpointer` copies the state to host memory on
    the caller's thread (a training state is updated in place by the steps
    that follow, so the copy must be complete before the caller goes on),
    then writes the files on a background thread;
  * bounded — ``keep_last_n`` removes old step directories after each
    successful save (never the one just written).

``manifest.msgpack`` is written and read by :func:`packb`/:func:`unpackb`,
a MessagePack encoder and decoder of the subset a manifest uses (map, str,
int, float, list, bool, nil; bin is read too): the ``msgpack`` package is
not needed, and its ``unpackb`` reads what :func:`packb` writes.

A restore into a :class:`GRTrainState` writes the values into the
template's tensors in place (a second full-vocab table does not fit beside
the first on an 80 GB card); every leaf is read and verified on the host
before the first tensor is touched, so a corrupt step leaves the template
as it was.
"""
from __future__ import annotations

import os
import re
import shutil
import struct
import tempfile
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.embedding.tables import ShadowedTable
from repro_torch.training.optim import AdamWState
from repro_torch.training.trainer import GRTrainState

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointCorrupt(RuntimeError):
    """A step directory failed integrity verification (missing file,
    truncated leaf, CRC mismatch, unreadable manifest)."""


def _record_duration(registry: Any, name: str, seconds: float) -> None:
    """Publish one save/restore duration into an obs MetricsRegistry
    (duck-typed: this module never imports ``obs``)."""
    if registry is None:
        return
    registry.histogram(name + "_s",
                       "checkpoint duration").observe(seconds)
    registry.gauge(name + "_last_s").set(seconds)
    registry.counter(name + "s_total").inc()


# -- MessagePack, the subset a manifest uses ---------------------------------

def packb(obj: Any) -> bytes:
    """MessagePack bytes of ``obj`` (dict, list/tuple, str, bytes, int,
    float, bool, None), in the smallest form as ``msgpack.packb`` writes
    it (str as str, floats as float 64)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, out: bytearray, fix: Optional[int], fix_max: int,
              codes: Tuple[int, int, int]) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] and n <= 0xff:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xffff:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xffffffff:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True:
        out.append(0xc3)
    elif obj is False:
        out.append(0xc2)
    elif isinstance(obj, (int, np.integer)):
        n = int(obj)
        if 0 <= n <= 0x7f:
            out.append(n)
        elif -32 <= n < 0:
            out.append(n & 0xff)
        elif n > 0:
            for code, fmt, hi in ((0xcc, ">BB", 0xff), (0xcd, ">BH", 0xffff),
                                  (0xce, ">BI", 0xffffffff),
                                  (0xcf, ">BQ", 0xffffffffffffffff)):
                if n <= hi:
                    out += struct.pack(fmt, code, n)
                    break
            else:
                raise ValueError(f"int {n} too large for msgpack")
        else:
            for code, fmt, lo in ((0xd0, ">Bb", -0x80), (0xd1, ">Bh", -0x8000),
                                  (0xd2, ">Bi", -0x80000000),
                                  (0xd3, ">Bq", -0x8000000000000000)):
                if n >= lo:
                    out += struct.pack(fmt, code, n)
                    break
            else:
                raise ValueError(f"int {n} too small for msgpack")
    elif isinstance(obj, (float, np.floating)):
        out += struct.pack(">Bd", 0xcb, float(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xa0, 31, (0xd9, 0xda, 0xdb))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), out, None, 0, (0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 15, (0, 0xdc, 0xdd))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 15, (0, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H",
        0xc6: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}


def unpackb(data: bytes) -> Any:
    """Decode one MessagePack object that fills ``data`` (str as str, bin
    as bytes); raises ValueError on a truncated, trailing or unsupported
    encoding."""
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after msgpack")
    return obj


def _take(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    if pos + n > len(buf):
        raise ValueError("truncated msgpack")
    return buf[pos:pos + n], pos + n


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    raw, pos = _take(buf, pos, 1)
    c = raw[0]
    if c <= 0x7f:
        return c, pos
    if c >= 0xe0:
        return c - 0x100, pos
    if 0xa0 <= c <= 0xbf:
        b, pos = _take(buf, pos, c & 0x1f)
        return bytes(b).decode("utf-8"), pos
    if 0x90 <= c <= 0x9f:
        return _unpack_seq(buf, pos, c & 0x0f)
    if 0x80 <= c <= 0x8f:
        return _unpack_map(buf, pos, c & 0x0f)
    if c in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[c], pos
    if c in _FIXED:
        fmt = _FIXED[c]
        b, pos = _take(buf, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, b)[0], pos
    if c in _LEN:
        fmt = _LEN[c]
        b, pos = _take(buf, pos, struct.calcsize(fmt))
        n = struct.unpack(fmt, b)[0]
        if c in (0xdc, 0xdd):
            return _unpack_seq(buf, pos, n)
        if c in (0xde, 0xdf):
            return _unpack_map(buf, pos, n)
        b, pos = _take(buf, pos, n)
        return (bytes(b).decode("utf-8") if c in (0xd9, 0xda, 0xdb)
                else bytes(b)), pos
    raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")


def _unpack_seq(buf: memoryview, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        x, pos = _unpack(buf, pos)
        out.append(x)
    return out, pos


def _unpack_map(buf: memoryview, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


# -- leaves in the reference's order -----------------------------------------

class _Leaf(NamedTuple):
    """One leaf of a checkpoint: its path, its parts (one tensor, array or
    scalar; or the per-layer tensors a stacked leaf is made of), its shape
    and its true dtype name."""
    path: str
    parts: Tuple[Any, ...]
    shape: Tuple[int, ...]
    dtype: str


def _dtype_name(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def _stacked_leaves(prefix: str, named: Dict[str, torch.Tensor]
                    ) -> List[_Leaf]:
    """Tensors by GRModel parameter name → leaves in the ``init_gr`` layout
    (block leaves stacked along a leading layer axis), in jax's order."""
    # imported here: repro_torch.convert imports this package's optimizer
    from repro_torch.convert import _tree_key
    groups: Dict[Tuple[str, ...], Dict[Optional[int], torch.Tensor]] = {}
    for name, t in named.items():
        path, layer = _tree_key(name)
        groups.setdefault(path, {})[layer] = t
    out = []
    for path in sorted(groups):
        by_layer = groups[path]
        if None in by_layer:
            t = by_layer[None]
            out.append(_Leaf(".".join((prefix,) + path), (t.detach(),),
                             tuple(t.shape), _dtype_name(t)))
        else:
            parts = tuple(by_layer[i].detach() for i in sorted(by_layer))
            out.append(_Leaf(".".join((prefix,) + path), parts,
                             (len(parts),) + tuple(parts[0].shape),
                             _dtype_name(parts[0])))
    return out


def _scalar_leaf(path: str, value: int) -> _Leaf:
    return _Leaf(path, (np.int32(value),), (), "int32")


def _state_leaves(st: GRTrainState) -> List[_Leaf]:
    out = _stacked_leaves("dense", dict(st.dense.named_parameters()))
    out += _stacked_leaves("dense_opt.mu", st.dense_opt.mu)
    out += _stacked_leaves("dense_opt.nu", st.dense_opt.nu)
    out.append(_scalar_leaf("dense_opt.count", st.dense_opt.count))
    tbl = st.table
    for name, t in (("master", tbl.master), ("shadow", tbl.shadow),
                    ("accum", tbl.accum)):
        if t is None:
            continue
        if name == "shadow":       # the 0-row placeholder; dtype kept
            t = t.new_zeros((0, t.shape[-1]))
        out.append(_Leaf(f"table.{name}", (t.detach(),), tuple(t.shape),
                         _dtype_name(t)))
    for name in ("pending_ids", "pending_rows"):
        t = getattr(st, name).detach()
        out.append(_Leaf(name, (t,), tuple(t.shape), _dtype_name(t)))
    out.append(_scalar_leaf("step", st.step))
    return out


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _generic_leaves(tree: Any, path: str = "") -> List[_Leaf]:
    """Leaves of a nested dict / list / tuple / NamedTuple of tensors,
    arrays and scalars in jax's order (dict keys sorted, None no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _generic_leaves(tree[k], f"{path}.{k}".lstrip("."))]
    if isinstance(tree, (list, tuple)):
        keys = tree._fields if _is_namedtuple(tree) else range(len(tree))
        return [x for k, v in zip(keys, tree)
                for x in _generic_leaves(v, f"{path}.{k}".lstrip("."))]
    if isinstance(tree, torch.Tensor):
        return [_Leaf(path, (tree.detach(),), tuple(tree.shape),
                      _dtype_name(tree))]
    a = np.asarray(tree)
    return [_Leaf(path, (tree,), tuple(a.shape), a.dtype.name)]


def _leaves(tree: Any) -> List[_Leaf]:
    if isinstance(tree, GRTrainState):
        return _state_leaves(tree)
    return _generic_leaves(tree)


# -- host snapshots ----------------------------------------------------------

_SAVED = {"bfloat16": torch.float32}     # numpy has no bf16: upcast (exact)


class HostSnapshot(NamedTuple):
    """A state's leaves on the host, in the form they are saved: ``arrays``
    (C-contiguous numpy, bfloat16 upcast to float32), ``dtypes`` (the true
    dtype names), ``shapes``, ``paths``, the device-to-host copy's wall
    ``seconds`` and the saved ``nbytes``."""
    arrays: List[np.ndarray]
    dtypes: List[str]
    shapes: List[Tuple[int, ...]]
    paths: List[str]
    seconds: float
    nbytes: int


def _saved_torch_dtype(leaf: _Leaf, t: torch.Tensor) -> torch.dtype:
    return _SAVED.get(leaf.dtype, t.dtype)


@torch.no_grad()
def snapshot(tree: Any, *, buffers: Optional[Dict[int, torch.Tensor]] = None
             ) -> HostSnapshot:
    """Copy every leaf of ``tree`` to host memory, complete when this
    returns (later in-place steps cannot reach the copy). ``buffers``: a
    dict this function fills with pinned host tensors on the first call and
    reuses on later calls with the same leaf shapes (the caller must not
    hold an earlier snapshot made with them); None copies to pageable
    memory."""
    if isinstance(tree, HostSnapshot):
        return tree
    t0 = time.perf_counter()
    leaves = _leaves(tree)
    arrays: List[Optional[np.ndarray]] = []
    pinned_used = False
    for i, leaf in enumerate(leaves):
        first = leaf.parts[0]
        if not isinstance(first, torch.Tensor):
            a = np.asarray(first)
            if leaf.dtype == "bfloat16":
                a = a.astype(np.float32)
            arrays.append(a)
            continue
        dt = _saved_torch_dtype(leaf, first)
        stacked = len(leaf.parts) > 1 or leaf.shape != tuple(first.shape)
        if buffers is not None and first.is_cuda:
            buf = buffers.get(i)
            if (buf is None or tuple(buf.shape) != leaf.shape
                    or buf.dtype != dt):
                buf = torch.empty(leaf.shape, dtype=dt, pin_memory=True)
                buffers[i] = buf
            pinned_used = True
        else:
            buf = torch.empty(leaf.shape, dtype=dt)
        if stacked:
            for j, p in enumerate(leaf.parts):
                buf[j].copy_(p, non_blocking=pinned_used)
        elif buf.numel():
            buf.copy_(first, non_blocking=pinned_used)
        arrays.append(buf)
    if pinned_used:
        torch.cuda.synchronize()
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.numpy()
        out.append(np.ascontiguousarray(a))
    return HostSnapshot(out, [lf.dtype for lf in leaves],
                        [lf.shape for lf in leaves],
                        [lf.path for lf in leaves],
                        time.perf_counter() - t0,
                        sum(a.nbytes for a in out))


def host_nbytes(tree: Any) -> int:
    """Bytes of ``tree``'s host copy (a :func:`snapshot`'s ``nbytes``),
    from its leaves' shapes and saved dtypes; copies nothing."""
    total = 0
    for leaf in _leaves(tree):
        first = leaf.parts[0]
        if isinstance(first, torch.Tensor):
            item = torch.empty(0, dtype=_saved_torch_dtype(leaf, first)
                               ).element_size()
        else:
            item = 4 if leaf.dtype == "bfloat16" else \
                np.asarray(first).itemsize
        total += int(np.prod(leaf.shape, dtype=np.int64)) * item
    return total


def host_available_bytes() -> Optional[int]:
    """Host memory the kernel reports as available to new allocations
    (``MemAvailable``), or None where it does not say."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


# -- durability helpers ------------------------------------------------------

def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (a directory needs an O_RDONLY fd:
    the write-then-rename protocol is durable only if the data, the
    directory entry and the parent's entry all reach the disk)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


#: Leaf files checksummed and written, or read and checked, at a time
#: (``zlib.crc32``, ``np.save``, ``np.load`` and fsync release the GIL).
_IO_THREADS = 4


def _crc32(a: np.ndarray) -> int:
    """zlib's CRC32 of an array's C-order bytes."""
    return zlib.crc32(np.ascontiguousarray(a))


def _write_leaf(d: str, i: int, a: np.ndarray, fsync: bool) -> int:
    crc = _crc32(a)
    path = os.path.join(d, f"arr_{i}.npy")
    np.save(path, a)
    if fsync:
        _fsync_path(path)
    return crc


def _write_leaves(d: str, snap: HostSnapshot, upto: Optional[int] = None,
                  fsync: bool = True) -> List[int]:
    """Write (and fsync) ``arr_<i>.npy`` for the first ``upto`` leaves, all
    of them durable when this returns; their CRC32s in leaf order."""
    with ThreadPoolExecutor(_IO_THREADS) as ex:
        return list(ex.map(lambda ia: _write_leaf(d, *ia, fsync),
                           enumerate(snap.arrays[:upto])))


# -- save --------------------------------------------------------------------

def save(ckpt_dir: str, step: int, tree: Any,
         meta: Optional[Dict] = None,
         keep_last_n: Optional[int] = None,
         registry: Any = None) -> str:
    """Synchronous atomic + durable save of ``tree`` (a GRTrainState, a
    :class:`HostSnapshot` of one, or a nested dict/list of tensors, arrays
    and scalars). Returns the step directory.

    Every ``arr_*.npy`` and the manifest are fsync'd, then the tmp
    directory itself, before the ``os.rename`` that publishes the step; the
    parent directory is fsync'd after the rename and again after the
    LATEST flip. ``keep_last_n`` (≥1) removes older ``step_*`` directories
    after the new step is published. ``registry`` (a duck-typed obs
    ``MetricsRegistry``) records the save's seconds as ``ckpt_save_s``."""
    _t0 = time.perf_counter()
    os.makedirs(ckpt_dir, exist_ok=True)
    snap = snapshot(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")
    try:
        crcs = _write_leaves(tmp, snap)
        manifest = {
            "step": int(step),
            "treedef": "repro_torch:" + ",".join(snap.paths),
            "num_leaves": len(snap.arrays),
            "shapes": [[int(n) for n in s] for s in snap.shapes],
            "dtypes": list(snap.dtypes),
            "crc32s": crcs,
            "meta": meta or {},
        }
        mpath = os.path.join(tmp, "manifest.msgpack")
        with open(mpath, "wb") as f:
            f.write(packb(manifest))
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)                      # directory entries durable
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_path(ckpt_dir)                 # the rename itself durable
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step}")
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    _fsync_path(ckpt_dir)
    if keep_last_n is not None:
        gc_steps(ckpt_dir, keep_last_n)
    _record_duration(registry, "ckpt_save", time.perf_counter() - _t0)
    return final


def gc_steps(ckpt_dir: str, keep_last_n: int) -> List[int]:
    """Retention policy: delete all but the newest ``keep_last_n`` step
    directories (by step number). Returns the deleted steps. Stale
    ``.tmp_step_*`` leftovers from crashed saves are always removed."""
    assert keep_last_n >= 1, keep_last_n
    for name in os.listdir(ckpt_dir):
        if name.startswith(".tmp_step_"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    steps = sorted(_step_dirs(ckpt_dir))
    victims = steps[:-keep_last_n] if len(steps) > keep_last_n else []
    for s in victims:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
    return victims


class AsyncCheckpointer:
    """Snapshot-then-write-in-background saver; one save in flight.

    ``save_async`` waits for the save in flight, copies the state to host
    memory on the caller's thread (complete when it returns), then writes
    the files on a background thread. A card state is copied through
    pinned host buffers kept from save to save (safe: a save starts only
    after the last one finished writing from them). ``snapshots`` records
    each copy's (step, seconds, bytes)."""

    def __init__(self, ckpt_dir: str, keep_last_n: Optional[int] = None,
                 registry: Any = None):
        self.ckpt_dir = ckpt_dir
        self.keep_last_n = keep_last_n
        self.registry = registry
        self._buffers: Dict[int, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self.snapshots: List[Tuple[int, float, int]] = []

    def save_async(self, step: int, tree: Any,
                   meta: Optional[Dict] = None) -> None:
        self.wait()
        snap = snapshot(tree, buffers=self._buffers)
        self.snapshots.append((step, snap.seconds, snap.nbytes))

        def work():
            try:
                save(self.ckpt_dir, step, snap, meta,
                     keep_last_n=self.keep_last_n, registry=self.registry)
            except BaseException as e:      # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


# -- integrity / discovery ---------------------------------------------------

def _step_dirs(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            out.append(int(m.group(1)))
    return out


def read_manifest(step_dir: str) -> Dict:
    """Load and structurally validate a step directory's manifest; raises
    :class:`CheckpointCorrupt` on any problem (missing, truncated,
    undecodable, or missing required keys)."""
    path = os.path.join(step_dir, "manifest.msgpack")
    try:
        with open(path, "rb") as f:
            manifest = unpackb(f.read())
    except Exception as e:
        raise CheckpointCorrupt(f"unreadable manifest in {step_dir}: {e}")
    if not isinstance(manifest, dict) or "num_leaves" not in manifest:
        raise CheckpointCorrupt(f"malformed manifest in {step_dir}")
    return manifest


def intact_steps(ckpt_dir: str) -> List[int]:
    """Step numbers whose directory has a readable manifest, newest first
    (``restore`` additionally CRC-verifies every leaf)."""
    out = []
    for s in sorted(_step_dirs(ckpt_dir), reverse=True):
        try:
            read_manifest(os.path.join(ckpt_dir, f"step_{s}"))
            out.append(s)
        except CheckpointCorrupt:
            continue
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest restorable step. The LATEST pointer is a hint, not the
    truth: when it is missing, torn or dangling, fall back to the newest
    ``step_*`` directory with an intact manifest — a torn pointer must
    never silently restart training from step 0."""
    ptr = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(ptr):
        try:
            with open(ptr) as f:
                name = f.read().strip()
        except OSError:
            name = ""
        m = _STEP_RE.match(name)
        if m:
            d = os.path.join(ckpt_dir, name)
            if os.path.isdir(d):
                try:
                    read_manifest(d)
                    return int(m.group(1))
                except CheckpointCorrupt:
                    pass
    good = intact_steps(ckpt_dir)
    return good[0] if good else None


def _load_step_arrays(ckpt_dir: str, step: int, num_leaves: int,
                      verify: bool = True) -> Tuple[List[np.ndarray], Dict]:
    """Load + CRC-verify one step directory; CheckpointCorrupt on any
    missing/truncated/mismatching leaf."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    manifest = read_manifest(d)
    if manifest["num_leaves"] != num_leaves:
        raise CheckpointCorrupt(
            f"leaf count mismatch: ckpt {manifest['num_leaves']} vs "
            f"{num_leaves}")
    crcs = manifest.get("crc32s")
    shapes = manifest.get("shapes")

    def load(i: int) -> np.ndarray:
        path = os.path.join(d, f"arr_{i}.npy")
        try:
            a = np.load(path)
        except Exception as e:
            raise CheckpointCorrupt(f"unreadable leaf {path}: {e}")
        if verify and crcs is not None:
            got = _crc32(a)
            if got != crcs[i]:
                raise CheckpointCorrupt(
                    f"CRC mismatch on {path}: {got} != {crcs[i]}")
        if shapes is not None:
            # 0-d leaves are saved as (1,) arrays; the manifest holds the
            # true shape
            try:
                a = a.reshape(shapes[i])
            except ValueError as e:
                raise CheckpointCorrupt(
                    f"shape mismatch on {path}: {a.shape} vs {shapes[i]}: "
                    f"{e}")
        return a

    with ThreadPoolExecutor(_IO_THREADS) as ex:
        return list(ex.map(load, range(num_leaves))), manifest


# -- restore -----------------------------------------------------------------

def _copy_in(dst: torch.Tensor, a: np.ndarray) -> None:
    """Host array → ``dst`` in place, cast to its dtype (no device-sized
    temporary: the copy reads the host array directly)."""
    dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))


def _check_shape(path: str, a: np.ndarray, shape: Tuple[int, ...]) -> None:
    if tuple(a.shape) != tuple(shape):
        raise CheckpointCorrupt(f"{path}: checkpoint shape {a.shape} vs "
                                f"{tuple(shape)}")


def _scalar(a: np.ndarray) -> int:
    """A 0-d leaf's value (a snapshot keeps it as a (1,) array)."""
    return int(np.asarray(a).reshape(-1)[0])


@torch.no_grad()
def _load_state(st: GRTrainState, arrays: List[np.ndarray]) -> GRTrainState:
    """Write checkpoint leaves into ``st``'s tensors in place (every shape
    is checked first); returns the state with the restored carry, count
    and step."""
    leaves = _state_leaves(st)
    if len(arrays) != len(leaves):
        raise CheckpointCorrupt(f"leaf count mismatch: {len(arrays)} vs "
                                f"{len(leaves)}")
    pairs = list(zip(leaves, arrays))
    by_path = {lf.path: a for lf, a in pairs}
    in_place = [(lf, a) for lf, a in pairs
                if lf.path.startswith(("dense.", "dense_opt.mu.",
                                       "dense_opt.nu.", "table.master",
                                       "table.accum"))]
    for lf, a in in_place:
        _check_shape(lf.path, a, lf.shape)
    for lf, a in in_place:
        if len(lf.parts) == 1 and lf.shape == tuple(lf.parts[0].shape):
            _copy_in(lf.parts[0], a)
        else:
            for j, p in enumerate(lf.parts):
                _copy_in(p, a[j])
    tbl = st.table
    shadow = tbl.shadow
    if shadow is not None:
        if shadow.shape == tbl.master.shape:
            shadow.copy_(tbl.master.to(shadow.dtype))
        else:
            shadow = tbl.master.to(shadow.dtype)
    ids = np.asarray(by_path["pending_ids"]).reshape(-1).astype(np.int64)
    rows = np.asarray(by_path["pending_rows"], np.float32)
    keep = ids >= 0
    order = np.argsort(ids[keep], kind="stable")
    dev = tbl.master.device
    p_ids = torch.from_numpy(ids[keep][order].astype(np.int32)).to(dev)
    p_rows = torch.from_numpy(np.ascontiguousarray(
        rows[keep][order])).to(dev)
    return GRTrainState(
        dense=st.dense,
        dense_opt=AdamWState(st.dense_opt.mu, st.dense_opt.nu,
                             _scalar(by_path["dense_opt.count"])),
        table=ShadowedTable(tbl.master, shadow, tbl.accum),
        pending_ids=p_ids, pending_rows=p_rows,
        step=_scalar(by_path["step"]))


def _rebuild_generic(template: Any, arrays: List[np.ndarray]) -> Any:
    it = iter(arrays)

    def build(t: Any) -> Any:
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            vals = [build(v) for v in t]
            if _is_namedtuple(t):
                return type(t)(*vals)
            return type(t)(vals)
        a = next(it)
        if isinstance(t, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=t.device, dtype=t.dtype)
        return np.asarray(a).astype(np.asarray(t).dtype)

    return build(template)


def load_snapshot(template: Any, snap: HostSnapshot) -> Any:
    """Restore from a host snapshot (no files): what ``restore`` does after
    reading a step's leaves."""
    return _load_arrays(template, snap.arrays)


def _load_arrays(template: Any, arrays: List[np.ndarray]) -> Any:
    if isinstance(template, GRTrainState):
        return _load_state(template, arrays)
    return _rebuild_generic(template, arrays)


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            verify: bool = True, fallback: bool = True,
            registry: Any = None) -> Any:
    """Verified restore into ``template``'s structure (see
    :func:`restore_with_step`)."""
    tree, _ = restore_with_step(ckpt_dir, template, step=step,
                                verify=verify, fallback=fallback,
                                registry=registry)
    return tree


def restore_with_step(ckpt_dir: str, template: Any,
                      step: Optional[int] = None, verify: bool = True,
                      fallback: bool = True,
                      registry: Any = None) -> Tuple[Any, int]:
    """Verified restore into ``template``'s structure, and the step number
    actually restored.

    Every leaf is CRC-checked against the manifest; when ``step`` is None
    and the newest checkpoint is corrupt, restore falls back to the
    next-newest intact ``step_*`` directory (``fallback=False`` raises
    instead); an explicit ``step`` is restored exactly or raises. A
    :class:`GRTrainState` template receives the values in place (see the
    module docstring); the shadow is rebuilt from the restored master.
    ``registry`` records the restore's seconds as ``ckpt_restore_s``."""
    _t0 = time.perf_counter()
    num_leaves = len(_leaves(template))
    if step is not None:
        candidates = [step]
    else:
        candidates = intact_steps(ckpt_dir)
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        if not fallback:
            candidates = candidates[:1]
    arrs = None
    used = None
    last_err: Optional[Exception] = None
    for s in candidates:
        try:
            arrs, _ = _load_step_arrays(ckpt_dir, s, num_leaves,
                                        verify=verify)
            used = s
            break
        except CheckpointCorrupt as e:
            last_err = e
            continue
    if arrs is None:
        if step is not None:
            raise last_err or FileNotFoundError(
                f"no checkpoint step {step} under {ckpt_dir}")
        raise CheckpointCorrupt(
            f"no intact checkpoint under {ckpt_dir}: {last_err}")
    tree = _load_arrays(template, arrs)
    _record_duration(registry, "ckpt_restore", time.perf_counter() - _t0)
    return tree, used
