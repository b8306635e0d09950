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

Host memory. A leaf is written and read a piece (:data:`PIECE_BYTES`) at
a time, its CRC32 a running ``zlib.crc32`` over the pieces, so neither a
save nor a restore makes a host copy of its own beyond the snapshot it
writes. A restore reads every leaf of a step twice: first it checks each
leaf's CRC (the bytes pass through a piece buffer and the page cache),
then, once every leaf has passed, it hands the consumer
:class:`LeafFile` s that read the leaves on demand: into a
:class:`GRTrainState` template's tensors in place, a piece at a time (a
second full-vocab table does not fit beside the first on an 80 GB card),
or into a cached engine's host store. So a corrupt step leaves the
template as it was. A snapshot leaf may also be *streamed* (an object with
``pieces()``, ``shape``, ``dtype``, ``nbytes`` and ``close()``: a cached
engine's table read from its host store), written without ever being whole
in memory; a save closes it once written.
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

from repro_torch.core.hsp import carry_span
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


def _is_streamed(x: Any) -> bool:
    """A leaf read a piece at a time (a :class:`LeafFile`, or a cached
    engine's table leaf streamed from its host store), never whole."""
    return hasattr(x, "pieces") and not isinstance(x, np.ndarray)


def _dtype_name(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    if _is_streamed(x):
        return np.dtype(x.dtype).name
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
            t = (t.new_zeros((0, t.shape[-1])) if isinstance(t, torch.Tensor)
                 else np.zeros((0, t.shape[-1]), t.dtype))
        out.append(_Leaf(f"table.{name}", (_part(t),), tuple(t.shape),
                         _dtype_name(t)))
    for name in ("pending_ids", "pending_rows"):
        t = getattr(st, name)
        out.append(_Leaf(name, (_part(t),), tuple(t.shape), _dtype_name(t)))
    out.append(_scalar_leaf("step", st.step))
    return out


def _part(t: Any) -> Any:
    """A table or carry leaf's part: a tensor detached, a streamed leaf, or
    a numpy array (a host copy the caller hands over: saved without
    another copy)."""
    if isinstance(t, torch.Tensor):
        return t.detach()
    return t if _is_streamed(t) else np.asarray(t)


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
    (C-contiguous numpy, bfloat16 upcast to float32; or streamed leaves,
    see the module docstring), ``dtypes`` (the true dtype names),
    ``shapes``, ``paths``, the device-to-host copy's wall ``seconds`` and
    the saved ``nbytes``."""
    arrays: List[np.ndarray]
    dtypes: List[str]
    shapes: List[Tuple[int, ...]]
    paths: List[str]
    seconds: float
    nbytes: int


def _saved_torch_dtype(leaf: _Leaf, t: torch.Tensor) -> torch.dtype:
    return _SAVED.get(leaf.dtype, t.dtype)


@torch.no_grad()
def _pinned(buffers: Dict[int, torch.Tensor], i: int,
            shape: Tuple[int, ...], dt: torch.dtype) -> torch.Tensor:
    """Leaf ``i``'s pinned host buffer, allocated on first use and kept: a
    leaf whose leading dimension varies from save to save (the τ=1 carry)
    takes the first rows of a buffer as tall or taller."""
    buf = buffers.get(i)
    if (buf is None or buf.dtype != dt or buf.dim() != len(shape)
            or tuple(buf.shape[1:]) != shape[1:]
            or (shape and buf.shape[0] < shape[0])
            or (not shape and buf.shape != shape)):
        buffers.pop(i, None)
        buf = torch.empty(shape, dtype=dt, pin_memory=True)
        buffers[i] = buf
    return buf[:shape[0]] if shape else buf


@torch.no_grad()
def snapshot(tree: Any, *, buffers: Optional[Dict[int, torch.Tensor]] = None
             ) -> HostSnapshot:
    """Copy every leaf of ``tree`` to host memory, complete when this
    returns (later in-place steps cannot reach the copy). ``buffers``: a
    dict this function fills with pinned host tensors on the first call and
    reuses on later calls (the caller must not hold an earlier snapshot
    made with them); None copies to pageable memory. Numpy leaves (a host
    copy already) and streamed leaves are taken as they are, without a
    second copy."""
    if isinstance(tree, HostSnapshot):
        return tree
    t0 = time.perf_counter()
    leaves = _leaves(tree)
    arrays: List[Any] = []
    pinned_used = False
    for i, leaf in enumerate(leaves):
        first = leaf.parts[0]
        if not isinstance(first, torch.Tensor):
            if _is_streamed(first):
                arrays.append(first)
                continue
            a = np.asarray(first)
            if leaf.dtype == "bfloat16":
                a = a.astype(np.float32)
            arrays.append(a)
            continue
        dt = _saved_torch_dtype(leaf, first)
        stacked = len(leaf.parts) > 1 or leaf.shape != tuple(first.shape)
        if buffers is not None and first.is_cuda:
            buf = _pinned(buffers, i, leaf.shape, dt)
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
        out.append(a if _is_streamed(a) else np.ascontiguousarray(a))
    return HostSnapshot(out, [lf.dtype for lf in leaves],
                        [lf.shape for lf in leaves],
                        [lf.path for lf in leaves],
                        time.perf_counter() - t0,
                        sum(a.nbytes for a in out))


def host_nbytes(tree: Any, *, pinned: bool = False) -> int:
    """Bytes of ``tree``'s host copy (a :func:`snapshot`'s ``nbytes``),
    from its leaves' shapes and saved dtypes; copies nothing. ``pinned``:
    as PyTorch's pinned host allocator holds a copy into pinned buffers
    (each leaf's buffer rounded up to a power of two)."""
    if isinstance(tree, HostSnapshot):
        return tree.nbytes
    total = 0
    for leaf in _leaves(tree):
        first = leaf.parts[0]
        if isinstance(first, torch.Tensor):
            item = torch.empty(0, dtype=_saved_torch_dtype(leaf, first)
                               ).element_size()
        elif leaf.dtype == "bfloat16":
            item = 4
        else:
            item = np.dtype(leaf.dtype).itemsize
        n = int(np.prod(leaf.shape, dtype=np.int64)) * item
        total += 1 << (n - 1).bit_length() if pinned and n > 1 else n
    return total


def host_template(tree: Any) -> HostSnapshot:
    """The leaf paths, shapes and saved dtypes of ``snapshot(tree)``, with
    no arrays: a template :func:`restore` fills on the host. Copies
    nothing (a table leaf may be a zero-strided ``np.broadcast_to`` array
    of the full table's shape)."""
    leaves = _leaves(tree)
    return HostSnapshot([], [lf.dtype for lf in leaves],
                        [lf.shape for lf in leaves],
                        [lf.path for lf in leaves], 0.0, host_nbytes(tree))


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
#: (``zlib.crc32``, file reads and writes and fsync release the GIL).
_IO_THREADS = 4

#: Bytes of a leaf checksummed and written, or read, at a time.
PIECE_BYTES = 64 << 20

#: Threads that checksum at once (``zlib.crc32`` and positioned reads
#: release the GIL). A leaf of more than :data:`CRC_SPLIT_BYTES` is cut in
#: up to this many segments of whole pieces, each checksummed on a thread
#: of its own, and their CRCs combined (:func:`crc32_combine`): one thread
#: checksums ~1.7 GB/s, so a 17 GB table took 10 s on one.
CRC_THREADS = max(1, min(8, os.cpu_count() or 1))

#: Host memory a save's or a restore's piece buffers hold at most (a
#: restore checks up to ``CRC_THREADS`` segments at once, a piece buffer
#: each, then reads one piece at a time; a leaf of at most a piece is read
#: whole).
IO_BUFFER_BYTES = max(_IO_THREADS, CRC_THREADS) * PIECE_BYTES


def _byte_pieces(a: Any):
    """A leaf's C-order bytes in pieces (uint8 arrays) of at most
    :data:`PIECE_BYTES`: views of a numpy array, or a streamed leaf's
    pieces (each valid until the next is taken)."""
    if _is_streamed(a):
        for p in a.pieces():
            yield np.ascontiguousarray(p).reshape(-1).view(np.uint8)
        return
    b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    for lo in range(0, max(b.size, 1), PIECE_BYTES):
        yield b[lo:lo + PIECE_BYTES]


def _crc32(a: Any) -> int:
    """zlib's CRC32 of a leaf's C-order bytes (a streamed leaf is read)."""
    crc = 0
    for piece in _byte_pieces(a):
        crc = zlib.crc32(piece, crc)
    return crc


#: A leaf of more than this is checksummed in segments (:data:`CRC_THREADS`).
CRC_SPLIT_BYTES = 4 * PIECE_BYTES


def _segments(nbytes: int) -> List[Tuple[int, int]]:
    if nbytes <= CRC_SPLIT_BYTES:
        return [(0, nbytes)]
    per = -(-nbytes // CRC_THREADS)
    per = -(-per // PIECE_BYTES) * PIECE_BYTES
    return [(lo, min(lo + per, nbytes)) for lo in range(0, nbytes, per)]


def _segment_crc(src: Any, lo: int, hi: int,
                 abort: Optional[threading.Event] = None) -> int:
    """zlib's CRC32 of bytes [lo, hi) of a leaf, a piece at a time: a host
    array's own bytes; a card tensor's through a pinned piece buffer; a
    :class:`LeafFile` 's read from its file (stops once ``abort`` is
    set)."""
    crc = 0
    if isinstance(src, LeafFile):
        mv = memoryview(bytearray(min(PIECE_BYTES, max(hi - lo, 1))))
        try:
            for p in range(lo, hi, len(mv)):
                if abort is not None and abort.is_set():
                    return crc
                piece = mv[:min(len(mv), hi - p)]
                _pread(src, piece, src.offset + p)
                crc = zlib.crc32(piece, crc)
        except BaseException as e:
            if abort is not None:
                abort.set()                  # the other segments stop early
            if isinstance(e, OSError):
                raise CheckpointCorrupt(f"unreadable leaf {src.path}: "
                                        f"{e}") from e
            raise
        return crc
    if isinstance(src, torch.Tensor):
        flat = src.reshape(-1).view(torch.uint8)
        buf = torch.empty(min(PIECE_BYTES, max(hi - lo, 1)),
                          dtype=torch.uint8, pin_memory=True)
        for p in range(lo, hi, PIECE_BYTES):
            n = min(PIECE_BYTES, hi - p)
            buf[:n].copy_(flat[p:p + n])
            crc = zlib.crc32(buf[:n].numpy(), crc)
        return crc
    b = np.ascontiguousarray(src).reshape(-1).view(np.uint8)
    for p in range(lo, hi, PIECE_BYTES):
        crc = zlib.crc32(b[p:min(p + PIECE_BYTES, hi)], crc)
    return crc


def _source_nbytes(src: Any) -> int:
    if isinstance(src, torch.Tensor):
        return src.numel() * src.element_size()
    return int(src.nbytes)


def _leaf_crcs(srcs: List[Any],
               abort: Optional[threading.Event] = None) -> List[int]:
    """The CRC32 of each leaf's C-order bytes, the leaves' segments on
    :data:`CRC_THREADS` threads; a leaf streamed from a cache's host store
    (read once, in order) on one. A source is a host array, a contiguous
    card tensor of the saved dtype, a :class:`LeafFile` or a streamed
    leaf."""
    with ThreadPoolExecutor(CRC_THREADS) as ex:
        futs = []
        for src in srcs:
            if _is_streamed(src) and not isinstance(src, LeafFile):
                futs.append([(ex.submit(_crc32, src), src.nbytes)])
                continue
            futs.append([(ex.submit(_segment_crc, src, lo, hi, abort),
                          hi - lo)
                         for lo, hi in _segments(_source_nbytes(src))])
    out = []
    for segs in futs:
        crc = segs[0][0].result()
        for f, n in segs[1:]:
            crc = crc32_combine(crc, f.result(), n)
        out.append(crc)
    return out


def crc32s(snap: HostSnapshot) -> List[int]:
    """The CRC32 of each leaf of a host snapshot, as a save of it records
    them in its manifest; like a save, it reads and closes the streamed
    leaves."""
    try:
        return _leaf_crcs(list(snap.arrays))
    finally:
        release(snap)


@torch.no_grad()
def _leaf_source(leaf: _Leaf) -> Any:
    """A leaf's bytes as a save writes them: a card tensor of the saved
    dtype (stacked parts stacked on the card), or a host array."""
    first = leaf.parts[0]
    stacked = len(leaf.parts) > 1 or leaf.shape != tuple(np.shape(first))
    if isinstance(first, torch.Tensor):
        dt = _saved_torch_dtype(leaf, first)
        t = (torch.stack([p.to(dt) for p in leaf.parts]).reshape(leaf.shape)
             if stacked else first.to(dt).contiguous())
        return t if t.is_cuda else t.numpy()
    if _is_streamed(first):
        return first
    a = (np.stack([np.asarray(p) for p in leaf.parts]) if stacked
         else np.asarray(first))
    return a.astype(np.float32) if leaf.dtype == "bfloat16" else a


def manifest_of(tree: Any) -> Dict[str, Any]:
    """What a save of ``tree`` (a state or a :class:`HostSnapshot`) records
    of its leaves: their CRC32s, shapes and dtype names, with no file
    written and, for a card state, no host copy of it: each leaf is
    checksummed from the card through piece buffers on threads."""
    if isinstance(tree, HostSnapshot):
        shapes, dtypes = list(tree.shapes), list(tree.dtypes)
        crcs = crc32s(tree)
    else:
        leaves = _leaves(tree)
        shapes = [lf.shape for lf in leaves]
        dtypes = [lf.dtype for lf in leaves]
        crcs = _leaf_crcs([_leaf_source(lf) for lf in leaves])
    return dict(crc32s=crcs, shapes=[[int(n) for n in sh] for sh in shapes],
                dtypes=dtypes)


def _write_leaf(d: str, i: int, a: Any, fsync: bool) -> int:
    """``arr_<i>.npy`` with ``np.save``'s bytes (format 1.0, C order),
    written a piece at a time with a running CRC32; returns the CRC."""
    path = os.path.join(d, f"arr_{i}.npy")
    shape = tuple(int(n) for n in a.shape)
    crc = 0
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": np.lib.format.dtype_to_descr(np.dtype(a.dtype)),
            "fortran_order": False, "shape": shape})
        for piece in _byte_pieces(a):
            crc = zlib.crc32(piece, crc)
            f.write(piece)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    return crc


def release(snap: Any) -> None:
    """Close a snapshot's streamed leaves (idempotent); a save calls it
    once its leaves are written, or have failed to be."""
    for a in getattr(snap, "arrays", ()):
        if _is_streamed(a):
            a.close()


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
    ``MetricsRegistry``) records the save's seconds as ``ckpt_save_s``.
    The snapshot's streamed leaves are closed when this returns."""
    _t0 = time.perf_counter()
    snap = snapshot(tree)
    try:
        final = _publish(ckpt_dir, step, snap, meta)
    finally:
        release(snap)
    _flip_latest(ckpt_dir, step, keep_last_n)
    _record_duration(registry, "ckpt_save", time.perf_counter() - _t0)
    return final


def _flip_latest(ckpt_dir: str, step: int,
                 keep_last_n: Optional[int]) -> None:
    """Point LATEST at a published step (atomically, durably), then apply
    the retention policy."""
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step}")
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    _fsync_path(ckpt_dir)
    if keep_last_n is not None:
        gc_steps(ckpt_dir, keep_last_n)


def _publish(ckpt_dir: str, step: int, snap: HostSnapshot,
             meta: Optional[Dict]) -> str:
    """Write the step's leaves and manifest into a tmp directory, fsync
    them, and rename it to ``step_<n>``; the step directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")
    try:
        crcs = _write_leaves(tmp, snap)
        return _seal(ckpt_dir, tmp, step, snap.paths, snap.shapes,
                     snap.dtypes, crcs, meta)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _seal(ckpt_dir: str, tmp: str, step: int, paths: List[str],
          shapes: List[Tuple[int, ...]], dtypes: List[str],
          crcs: List[int], meta: Optional[Dict]) -> str:
    """Write the manifest of a tmp directory whose leaves are durable,
    fsync it, and rename the directory to ``step_<n>``."""
    manifest = {
        "step": int(step),
        "treedef": "repro_torch:" + ",".join(paths),
        "num_leaves": len(paths),
        "shapes": [[int(n) for n in s] for s in shapes],
        "dtypes": list(dtypes),
        "crc32s": [int(c) for c in crcs],
        "meta": meta or {},
    }
    mpath = os.path.join(tmp, "manifest.msgpack")
    with open(mpath, "wb") as f:
        f.write(packb(manifest))
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)                          # directory entries durable
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_path(ckpt_dir)                     # the rename itself durable
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
    each copy's (step, seconds, bytes), ``completed`` the steps whose save
    finished without error."""

    def __init__(self, ckpt_dir: str, keep_last_n: Optional[int] = None,
                 registry: Any = None):
        self.ckpt_dir = ckpt_dir
        self.keep_last_n = keep_last_n
        self.registry = registry
        self._buffers: Dict[int, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self.snapshots: List[Tuple[int, float, int]] = []
        self.completed: List[int] = []

    def copy(self, tree: Any) -> HostSnapshot:
        """``tree``'s host copy in this saver's buffers, as ``save_async``
        takes it (call after :meth:`wait`: the save in flight writes from
        them)."""
        return snapshot(tree, buffers=self._buffers)

    def save_async(self, step: int, tree: Any,
                   meta: Optional[Dict] = None) -> None:
        self.wait()
        snap = self.copy(tree)
        self.snapshots.append((step, snap.seconds, snap.nbytes))

        def work():
            try:
                save(self.ckpt_dir, step, snap, meta,
                     keep_last_n=self.keep_last_n, registry=self.registry)
                self.completed.append(step)
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


class _OpenFile:
    """A file descriptor open for reading, closed when the last
    :class:`LeafFile` holding it goes (its data stays readable if the step
    directory is removed meanwhile)."""

    def __init__(self, path: str):
        self.fd = os.open(path, os.O_RDONLY)

    def __del__(self):
        if getattr(self, "fd", None) is not None:
            os.close(self.fd)


class LeafFile:
    """A leaf of a step directory, read from its open file on demand (no
    host copy of its own): ``np.asarray(leaf)`` reads it whole,
    :meth:`read_into` reads rows of it into a given array, :meth:`pieces`
    streams it, and ``leaf[j]`` is its j-th slice along the leading axis (a
    stacked leaf's layer). ``shape`` is the manifest's (a 0-d leaf may be
    stored as (1,)); ``dtype`` the stored one. Reads are positioned
    (``preadv``), so threads may share a leaf."""

    def __init__(self, file: _OpenFile, path: str, offset: int,
                 shape: Tuple[int, ...], dtype: Any):
        self.file = file
        self.path = path
        self.offset = int(offset)
        self.shape = tuple(int(n) for n in shape)
        self.dtype = np.dtype(dtype)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def _row_bytes(self) -> int:
        return self.nbytes // self.shape[0] if self.shape and \
            self.shape[0] else 0

    def __getitem__(self, j: int) -> "LeafFile":
        if not self.shape or not 0 <= int(j) < self.shape[0]:
            raise IndexError(f"{j} out of range for {self.shape}")
        return LeafFile(self.file, self.path,
                        self.offset + int(j) * self._row_bytes(),
                        self.shape[1:], self.dtype)

    def read_into(self, out: np.ndarray, row0: int = 0) -> None:
        """Fill ``out`` (C-contiguous, the leaf's dtype) with the leaf's
        bytes from row ``row0`` on."""
        if out.dtype != self.dtype or not out.flags.c_contiguous:
            raise ValueError(f"read_into needs a C-contiguous {self.dtype} "
                             f"array, got {out.dtype}")
        start = row0 * self._row_bytes()
        if out.nbytes > self.nbytes - start:
            raise ValueError(f"{out.nbytes} bytes from row {row0} overrun "
                             f"the leaf's {self.nbytes}")
        _pread(self, memoryview(out.reshape(-1).view(np.uint8)),
               self.offset + start)

    def pieces(self):
        """The leaf in pieces of whole rows of at most
        :data:`PIECE_BYTES` (one piece when a row is larger), each valid
        until the next is taken."""
        rb = self._row_bytes()
        if not rb or self.nbytes <= PIECE_BYTES:
            yield np.asarray(self)
            return
        rows = max(1, PIECE_BYTES // rb)
        buf = np.empty((rows,) + self.shape[1:], self.dtype)
        for lo in range(0, self.shape[0], rows):
            piece = buf[:min(rows, self.shape[0] - lo)]
            self.read_into(piece, lo)
            yield piece

    def close(self) -> None:
        """Nothing to release early: the file closes with its last leaf."""

    def reshape(self, *shape) -> np.ndarray:
        return np.asarray(self).reshape(*shape)

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = np.empty(self.shape, self.dtype)
        if out.size:
            self.read_into(out)
        return out if dtype is None else out.astype(dtype, copy=False)


def _pread(leaf: LeafFile, mv: memoryview, offset: int) -> None:
    """Fill ``mv`` from the leaf's file at ``offset``, a piece at a time."""
    pos = 0
    while pos < len(mv):
        n = os.preadv(leaf.file.fd, [mv[pos:pos + PIECE_BYTES]],
                      offset + pos)
        if not n:
            raise CheckpointCorrupt(f"short read of {leaf.path}")
        pos += n


def _open_leaf(path: str, shape: Optional[List[int]]) -> LeafFile:
    """A leaf file opened, its header checked (format, C order, a file
    long enough for its data) and its shape matched to the manifest's
    ``shape``; CheckpointCorrupt otherwise."""
    try:
        file = _OpenFile(path)
        with os.fdopen(os.dup(file.fd), "rb") as f:
            version = np.lib.format.read_magic(f)
            read = {(1, 0): np.lib.format.read_array_header_1_0,
                    (2, 0): np.lib.format.read_array_header_2_0}.get(version)
            if read is None:
                raise ValueError(f"npy format {version}")
            got, fortran, dtype = read(f)
            offset = f.tell()
            size = os.fstat(f.fileno()).st_size
    except Exception as e:
        raise CheckpointCorrupt(f"unreadable leaf {path}: {e}")
    if (fortran and len(got) > 1) or dtype.hasobject:
        raise CheckpointCorrupt(f"unreadable leaf {path}: not a C-order "
                                f"array of numbers")
    leaf = LeafFile(file, path, offset, got, dtype)
    if size < offset + leaf.nbytes:
        raise CheckpointCorrupt(f"truncated leaf {path}: {size} bytes, "
                                f"{offset + leaf.nbytes} needed")
    if shape is not None:
        # 0-d leaves are saved as (1,) arrays; the manifest holds the true
        # shape
        want = LeafFile(file, path, offset, shape, dtype)
        if want.size != leaf.size:
            raise CheckpointCorrupt(f"shape mismatch on {path}: {got} vs "
                                    f"{tuple(shape)}")
        leaf = want
    return leaf


def _load_step_arrays(ckpt_dir: str, step: int, num_leaves: int,
                      verify: bool = True) -> Tuple[List[LeafFile], Dict]:
    """Check one step directory and return its leaves as
    :class:`LeafFile` s: every header, and (``verify``) every leaf's CRC32
    streamed from the file, before anything is read for use;
    CheckpointCorrupt on any missing, truncated or mismatching leaf."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    manifest = read_manifest(d)
    if manifest["num_leaves"] != num_leaves:
        raise CheckpointCorrupt(
            f"leaf count mismatch: ckpt {manifest['num_leaves']} vs "
            f"{num_leaves}")
    crcs = manifest.get("crc32s")
    shapes = manifest.get("shapes")
    leaves = [_open_leaf(os.path.join(d, f"arr_{i}.npy"),
                         None if shapes is None else shapes[i])
              for i in range(num_leaves)]
    if verify and crcs is not None:
        got = _leaf_crcs(leaves, threading.Event())
        for leaf, crc, want in zip(leaves, got, crcs):
            if crc != want:
                raise CheckpointCorrupt(f"CRC mismatch on {leaf.path}: "
                                        f"{crc} != {want}")
    return leaves, manifest


# -- restore -----------------------------------------------------------------

def _copy_in(dst: torch.Tensor, a: Any) -> None:
    """Host array or :class:`LeafFile` → ``dst`` in place, cast to its
    dtype (no device-sized temporary; a leaf file is read a piece at a
    time)."""
    if not isinstance(a, LeafFile):
        dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        return
    if a.ndim == 0 or dst.dim() == 0:
        dst.copy_(torch.from_numpy(np.asarray(a)).reshape(dst.shape))
        return
    lo = 0
    for piece in a.pieces():
        dst[lo:lo + len(piece)].copy_(torch.from_numpy(piece))
        lo += len(piece)


def to_tensor(a: Any, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A host array or :class:`LeafFile` as a new tensor on ``device``,
    read a piece at a time."""
    t = torch.empty(tuple(a.shape), dtype=dtype, device=device)
    if t.numel():
        _copy_in(t, a)
    return t


def _check_shape(path: str, a: np.ndarray, shape: Tuple[int, ...]) -> None:
    if tuple(a.shape) != tuple(shape):
        raise CheckpointCorrupt(f"{path}: checkpoint shape {a.shape} vs "
                                f"{tuple(shape)}")


def _scalar(a: np.ndarray) -> int:
    """A 0-d leaf's value (a snapshot keeps it as a (1,) array)."""
    return int(np.asarray(a).reshape(-1)[0])


def compact_carry(ids: Any, rows: Any) -> Tuple[np.ndarray, Any]:
    """A saved τ=1 carry (the port's compact pairs, or the reference's N
    slots with −1 sentinels) → (unique ids ≥ 0 ascending int32, their rows
    fp32). Compact pairs keep their rows as given (a :class:`LeafFile`
    stays on disk)."""
    ids = np.asarray(ids).reshape(-1).astype(np.int64)
    if ids.size == 0 or (ids[0] >= 0 and np.all(ids[1:] > ids[:-1])):
        return ids.astype(np.int32), rows
    rows = np.asarray(rows, np.float32)
    keep = ids >= 0
    order = np.argsort(ids[keep], kind="stable")
    return (ids[keep][order].astype(np.int32),
            np.ascontiguousarray(rows[keep][order]))


_CARRY = ("pending_ids", "pending_rows")


@torch.no_grad()
def _load_state(st: GRTrainState, arrays: List[np.ndarray], *,
                table: bool = True) -> GRTrainState:
    """Write checkpoint leaves into ``st``'s tensors in place (every shape
    is checked first); returns the state with the restored carry, count
    and step. ``table=False`` leaves the table's tensors as they are (a
    cached engine loads the full table into its cache)."""
    leaves = _state_leaves(st)
    if len(arrays) != len(leaves):
        raise CheckpointCorrupt(f"leaf count mismatch: {len(arrays)} vs "
                                f"{len(leaves)}")
    pairs = list(zip(leaves, arrays))
    by_path = {lf.path: a for lf, a in pairs}
    loaded = ("dense.", "dense_opt.mu.", "dense_opt.nu.") + (
        ("table.master", "table.accum") if table else ())
    in_place = [(lf, a) for lf, a in pairs if lf.path.startswith(loaded)]
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
    if shadow is not None and table:
        if shadow.shape == tbl.master.shape:
            shadow.copy_(tbl.master.to(shadow.dtype))
        else:
            shadow = tbl.master.to(shadow.dtype)
    ids, rows = compact_carry(*(by_path[k] for k in _CARRY))
    dev = tbl.master.device
    p_ids = torch.from_numpy(ids).to(dev)
    p_rows = to_tensor(rows, dev)
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


def _load_host(template: HostSnapshot, arrays: List[Any]) -> HostSnapshot:
    """Checkpoint leaves checked against a :func:`host_template`, kept as
    they are (a restore's :class:`LeafFile` s, read on demand), the carry
    made compact."""
    if len(arrays) != len(template.paths):
        raise CheckpointCorrupt(f"leaf count mismatch: {len(arrays)} vs "
                                f"{len(template.paths)}")
    arrays = list(arrays)
    for path, a, shape in zip(template.paths, arrays, template.shapes):
        if path not in _CARRY:
            _check_shape(path, a, shape)
    if all(k in template.paths for k in _CARRY):
        i, j = (template.paths.index(k) for k in _CARRY)
        arrays[i], arrays[j] = compact_carry(arrays[i], arrays[j])
    return HostSnapshot(arrays, list(template.dtypes),
                        [tuple(a.shape) for a in arrays],
                        list(template.paths), 0.0,
                        sum(a.nbytes for a in arrays))


def load_snapshot(template: Any, snap: HostSnapshot, *,
                  table: bool = True) -> Any:
    """Restore from a host snapshot (no files): what ``restore`` does after
    reading a step's leaves. ``table=False``: a GRTrainState template's
    table tensors are left as they are."""
    if isinstance(template, GRTrainState):
        return _load_state(template, snap.arrays, table=table)
    return _load_arrays(template, snap.arrays)


def _load_arrays(template: Any, arrays: List[np.ndarray]) -> Any:
    if isinstance(template, HostSnapshot):
        return _load_host(template, arrays)
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
    module docstring); the shadow is rebuilt from the restored master. A
    :func:`host_template` gives a :class:`HostSnapshot` of the checked
    leaves as :class:`LeafFile` s, the carry compact (a cached engine
    streams the full table into its host store).
    ``registry`` records the restore's seconds as ``ckpt_restore_s``."""
    _t0 = time.perf_counter()
    num_leaves = (len(template.paths) if isinstance(template, HostSnapshot)
                  else len(_leaves(template)))
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


# -- sharded states (hierarchical sparse parallelism) -------------------------

def _gf2_times(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: List[int]) -> List[int]:
    return [_gf2_times(mat, mat[n]) for n in range(32)]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC32 of A + B from ``crc1`` = CRC32(A), ``crc2`` = CRC32(B) and
    ``len2`` = len(B) (zlib's ``crc32_combine``, which Python's zlib does
    not expose): the parts of a leaf written by several ranks are checked
    as the one leaf they make."""
    if len2 <= 0:
        return crc1
    odd = [0xEDB88320] + [1 << n for n in range(31)]   # one zero bit
    even = _gf2_square(odd)                             # two zero bits
    odd = _gf2_square(even)                             # four zero bits
    while True:
        even = _gf2_square(odd)
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


#: Leaves of a sharded state written by the shards' owners, in parts.
SHARDED_LEAVES = ("table.master", "table.accum", "pending_ids",
                  "pending_rows")


def _npy_header(shape: Tuple[int, ...], dtype: Any) -> bytes:
    import io
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, {
        "descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
        "fortran_order": False, "shape": tuple(int(n) for n in shape)})
    return buf.getvalue()


@torch.no_grad()
def _write_part(path: str, offset: int, t: torch.Tensor) -> int:
    """Write ``t``'s C-order bytes at ``offset`` of a leaf file, a piece at
    a time through one host buffer (pinned for a card tensor), and fsync
    it; their CRC32."""
    crc = 0
    if t.numel() == 0:
        return crc
    n = t.shape[0]
    rows = max(1, PIECE_BYTES // max(1, t[0].numel() * t.element_size()))
    buf = torch.empty((min(rows, n),) + tuple(t.shape[1:]), dtype=t.dtype,
                      pin_memory=t.is_cuda)
    fd = os.open(path, os.O_WRONLY)
    try:
        pos = offset
        for lo in range(0, n, rows):
            piece = buf[:min(rows, n - lo)]
            piece.copy_(t[lo:lo + rows])
            b = piece.numpy().reshape(-1).view(np.uint8)
            crc = zlib.crc32(b, crc)
            done = 0
            while done < b.size:
                done += os.pwrite(fd, b[done:], pos + done)
            pos += b.size
        os.fsync(fd)
    finally:
        os.close(fd)
    return crc


def save_sharded(ckpt_dir: str, step: int, state: GRTrainState, hsp, *,
                 meta: Optional[Dict] = None,
                 keep_last_n: Optional[int] = None,
                 registry: Any = None) -> List[int]:
    """Save a state sharded over ``hsp``'s mesh in the full-table layout of
    :func:`save` (so a single-process engine, or the reference, restores
    it); every rank calls it, from the main thread, at the same step.

    Rank 0 writes the dense leaves (every rank holds the same), and each
    leaf file of the table and the τ=1 carry at its full size; then the
    owners of the shards' first replicas write their rows of the master
    and the accumulator, and their pairs of the carry (global ids,
    ascending across owners), into those files with positioned writes,
    each computing its part's CRC32; rank 0 combines the parts' CRCs into
    the leaves' (:func:`crc32_combine`), writes the manifest and publishes
    the step (LATEST flips after every part is durable). A step is intact
    only when every part is on disk. Returns the leaves' CRC32s on every
    rank."""
    t0 = time.perf_counter()
    mesh = hsp.mesh
    tbl = state.table
    V = hsp.vocab_of(tbl.master)
    lo, _ = hsp.shard_range(V)
    d = tbl.master.shape[1]
    writer = mesh.group(hsp.dp_axes).index == 0
    n_mine = int(state.pending_ids.numel()) if writer else 0
    counts = mesh.all_gather_object(n_mine, mesh.axes)
    n_carry = sum(counts)
    c0 = sum(counts[:mesh.rank])
    empty = tbl.master[:0]
    small = state._replace(
        table=ShadowedTable(empty, tbl.shadow, empty),
        pending_ids=state.pending_ids[:0], pending_rows=state.pending_rows[:0])
    leaves = _state_leaves(small)
    full_shape = {"table.master": (V, d), "table.accum": (V, d),
                  "pending_ids": (n_carry,), "pending_rows": (n_carry, d)}
    saved_dt = {"table.master": np.float32, "table.accum": np.float32,
                "pending_ids": np.int32, "pending_rows": np.float32}
    shapes = [full_shape.get(lf.path, lf.shape) for lf in leaves]
    heads = {i: _npy_header(shapes[i], saved_dt[lf.path])
             for i, lf in enumerate(leaves) if lf.path in SHARDED_LEAVES}
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}_sharded")
    crcs: Dict[int, int] = {}
    if mesh.rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        snap = snapshot(small)
        for i, lf in enumerate(leaves):
            if i not in heads:
                crcs[i] = _write_leaf(tmp, i, snap.arrays[i], True)
                continue
            with open(os.path.join(tmp, f"arr_{i}.npy"), "wb") as f:
                f.write(heads[i])
                f.truncate(len(heads[i]) + int(np.prod(shapes[i])) * 4)
    mesh.barrier()
    parts: Dict[int, Tuple[int, int, int]] = {}
    if writer:
        mine = {"table.master": (tbl.master, lo),
                "table.accum": (tbl.accum, lo),
                "pending_ids": ((state.pending_ids.to(torch.int64) + lo).to(
                    torch.int32), c0),
                "pending_rows": (state.pending_rows, c0)}

        def write(i: int) -> Tuple[int, int, int]:
            t, row0 = mine[leaves[i].path]
            off = row0 * int(np.prod(shapes[i][1:], dtype=np.int64)) * 4
            crc = _write_part(os.path.join(tmp, f"arr_{i}.npy"),
                              len(heads[i]) + off, t)
            return off, t.numel() * 4, crc

        with ThreadPoolExecutor(_IO_THREADS) as ex:
            parts = dict(zip(heads, ex.map(write, heads)))
    everyone = mesh.all_gather_object(parts, mesh.axes)
    out = None
    if mesh.rank == 0:
        for i in heads:
            crc, pos = 0, 0
            for off, n, c in sorted(p[i] for p in everyone if i in p):
                if off != pos:
                    raise CheckpointCorrupt(f"{leaves[i].path}: parts leave "
                                            f"a gap at byte {pos}")
                crc = crc32_combine(crc, c, n)
                pos += n
            if pos != int(np.prod(shapes[i])) * 4:
                raise CheckpointCorrupt(f"{leaves[i].path}: parts cover "
                                        f"{pos} bytes")
            crcs[i] = crc
        out = [crcs[i] for i in range(len(leaves))]
        _seal(ckpt_dir, tmp, step, [lf.path for lf in leaves], shapes,
              [lf.dtype for lf in leaves], out,
              dict(meta or {}, mesh=list(mesh.shape)))
        _flip_latest(ckpt_dir, step, keep_last_n)
    out = mesh.all_gather_object(out, mesh.axes)[0]
    _record_duration(registry, "ckpt_save", time.perf_counter() - t0)
    return out


@torch.no_grad()
def _read_rows(leaf: "LeafFile", dst: torch.Tensor, row0: int) -> None:
    """Rows [row0, row0 + len(dst)) of a leaf file into ``dst`` in place, a
    piece at a time (positioned reads) through one host buffer (pinned for
    a card tensor)."""
    n = dst.shape[0]
    if n == 0:
        return
    row_bytes = leaf.nbytes // leaf.shape[0]
    rows = max(1, PIECE_BYTES // row_bytes)
    buf = torch.empty((min(rows, n),) + tuple(leaf.shape[1:]),
                      dtype=torch.from_numpy(np.empty(0, leaf.dtype)).dtype,
                      pin_memory=dst.is_cuda)
    for lo in range(0, n, rows):
        piece = buf[:min(rows, n - lo)]
        leaf.read_into(piece.numpy(), row0 + lo)
        dst[lo:lo + len(piece)].copy_(piece)


@torch.no_grad()
def restore_sharded(ckpt_dir: str, state: GRTrainState, hsp,
                    step: Optional[int] = None, registry: Any = None
                    ) -> Tuple[GRTrainState, int]:
    """Restore a full-table checkpoint (of any world, or of a
    single-process run) into this rank's sharded ``state`` in place; every
    rank calls it. Rank 0 picks the newest intact step (every leaf's CRC32
    checked, falling back past corrupt ones; ``step``: that one or raise)
    and tells the others; each rank then reads the dense leaves and only
    its own rows of the table and the carry, with positioned reads, so a
    world of another data degree restores the same files. Returns (the
    state, the step restored); FileNotFoundError on every rank when no
    step is intact."""
    t0 = time.perf_counter()
    mesh = hsp.mesh
    n = len(_state_leaves(state))
    used, arrs, err = None, None, None
    if mesh.rank == 0:
        candidates = ([step] if step is not None
                      else intact_steps(ckpt_dir))
        for s in candidates:
            try:
                arrs, _ = _load_step_arrays(ckpt_dir, s, n, verify=True)
                used = s
                break
            except (CheckpointCorrupt, FileNotFoundError) as e:
                err = repr(e)
    used, err = mesh.all_gather_object((used, err), mesh.axes)[0]
    if used is None:
        raise FileNotFoundError(f"no intact checkpoint under {ckpt_dir}"
                                + (f": {err}" if err else ""))
    if arrs is None:
        arrs, _ = _load_step_arrays(ckpt_dir, used, n, verify=False)
    leaves = _state_leaves(state)
    by_path = {lf.path: i for i, lf in enumerate(leaves)}
    tbl = state.table
    V = hsp.vocab_of(tbl.master)
    lo, hi = hsp.shard_range(V)
    for key in ("table.master", "table.accum"):
        a = arrs[by_path[key]]
        if tuple(a.shape) != (V, tbl.master.shape[1]):
            raise CheckpointCorrupt(f"{key}: checkpoint shape {a.shape} vs "
                                    f"{(V, tbl.master.shape[1])}")
    ids, rows = compact_carry(arrs[by_path["pending_ids"]],
                              arrs[by_path["pending_rows"]])
    a, b = carry_span(ids, lo, hi)
    if isinstance(rows, LeafFile):
        mine = np.empty((b - a,) + tuple(rows.shape[1:]), rows.dtype)
        if b > a:
            rows.read_into(mine, a)
    else:
        mine = np.ascontiguousarray(np.asarray(rows)[a:b])
    arrs = list(arrs)
    arrs[by_path["pending_ids"]] = (ids[a:b] - lo).astype(np.int32)
    arrs[by_path["pending_rows"]] = mine
    st = _load_state(state, arrs, table=False)
    with ThreadPoolExecutor(2) as ex:
        list(ex.map(lambda k: _read_rows(arrs[by_path["table." + k]],
                                         getattr(tbl, k), lo),
                    ("master", "accum")))
    if tbl.shadow is not None:
        tbl.shadow.copy_(tbl.master.to(tbl.shadow.dtype))
    _record_duration(registry, "ckpt_restore", time.perf_counter() - t0)
    return st, used
