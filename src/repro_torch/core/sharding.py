"""Logical-axis sharding context (the port of ``repro.core.sharding``).

Model code annotates tensors with *logical* axis names ("batch", "act_sp",
"tp", "vocab", ...); a plan maps each logical name to axes of a
``torch.distributed.device_mesh.DeviceMesh``. Outside a context every
:func:`constrain` returns its input unchanged, so the model code runs as it
is on one device. Inside one, a DTensor is redistributed to the placements
the rules resolve to, and a plain tensor passes through.

The rules are the reference's: a logical axis resolves to mesh axes, an
axis whose mesh size does not divide the tensor's dimension is dropped
(replicated) rather than raising (e.g. 2 KV heads on a 16-way ``model``
axis), and :func:`logical_axis_size` is 1 outside a context. The plans
that set the rules per (arch, shape, mesh) are not ported yet.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Union

import torch

if TYPE_CHECKING:                       # pragma: no cover
    from torch.distributed.device_mesh import DeviceMesh

Axes = Union[None, str, Tuple[str, ...]]


def _axis_size(mesh: "DeviceMesh", name: str) -> int:
    return int(mesh.shape[list(mesh.mesh_dim_names).index(name)])


def _as_tuple(ax: Axes) -> Tuple[str, ...]:
    return (ax,) if isinstance(ax, str) else tuple(ax)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: "DeviceMesh"
    # logical axis name -> mesh axes (None = replicate)
    rules: Dict[str, Axes]

    def resolve(self, dims: Sequence[Optional[str]]) -> Tuple[Axes, ...]:
        """Each logical dim's mesh axes (None: replicated), unchecked."""
        return tuple(None if d is None else self.rules.get(d) for d in dims)

    def resolve_for(self, shape: Sequence[int],
                    dims: Sequence[Optional[str]]) -> Tuple[Axes, ...]:
        """:meth:`resolve` for a tensor of ``shape``: a dim whose mesh size
        does not divide it is dropped (replicated)."""
        spec = list(dims) + [None] * (len(shape) - len(dims))
        out: List[Axes] = []
        for size, ax in zip(shape, self.resolve(spec)):
            if ax is None:
                out.append(None)
                continue
            n = 1
            for a in _as_tuple(ax):
                n *= _axis_size(self.mesh, a)
            out.append(None if n == 0 or size % n else ax)
        return tuple(out)

    def placements(self, shape: Sequence[int],
                   dims: Sequence[Optional[str]]) -> list:
        """DTensor placements on :attr:`mesh` for :meth:`resolve_for`: a
        mesh axis that a tensor dim maps to shards that dim, the others
        replicate."""
        from torch.distributed.tensor import Replicate, Shard
        by_axis: Dict[str, int] = {}
        for t_dim, ax in enumerate(self.resolve_for(shape, dims)):
            for a in () if ax is None else _as_tuple(ax):
                by_axis[a] = t_dim
        return [Shard(by_axis[a]) if a in by_axis else Replicate()
                for a in self.mesh.mesh_dim_names]


_CTX: contextvars.ContextVar[Optional[ShardCtx]] = contextvars.ContextVar(
    "repro_torch_shard_ctx", default=None)


@contextlib.contextmanager
def shard_ctx(mesh: "DeviceMesh", rules: Dict[str, Axes]):
    tok = _CTX.set(ShardCtx(mesh, dict(rules)))
    try:
        yield
    finally:
        _CTX.reset(tok)


def current_ctx() -> Optional[ShardCtx]:
    return _CTX.get()


def constrain(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """Constrain x's layout by logical dim names: unchanged outside a
    context and for a plain tensor; a DTensor is redistributed to the
    resolved placements (a dim whose mesh size does not divide it is
    replicated)."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = ctx.placements(x.shape, dims)
    if list(x.placements) == want:
        return x
    return x.redistribute(ctx.mesh, want)


def logical_axis_size(name: str) -> int:
    """Mesh size mapped to a logical axis (1 outside a context): lets model
    code pick between sharding strategies."""
    ctx = _CTX.get()
    if ctx is None:
        return 1
    ax = ctx.rules.get(name)
    if ax is None:
        return 1
    n = 1
    for a in _as_tuple(ax):
        n *= _axis_size(ctx.mesh, a)
    return n
