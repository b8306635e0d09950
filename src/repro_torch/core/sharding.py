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
that set the rules per (arch, shape, mesh) are ``launch/partition.py``'s;
:func:`guard` and :func:`placements_of` are the steps both share.
:func:`per_shard` runs a function on each device's shards (the
reference's ``shard_map``), as the model code does for its batched
products over samples and heads; :func:`to_local_summed` is its step
that sums the grads of inputs whole on a split mesh dim.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Union

import torch

if TYPE_CHECKING:                       # pragma: no cover
    from torch.distributed.device_mesh import DeviceMesh

Axes = Union[None, str, Tuple[str, ...]]


def _axis_size(mesh: "DeviceMesh", name: str) -> int:
    return int(mesh.shape[list(mesh.mesh_dim_names).index(name)])


def _as_tuple(ax: Axes) -> Tuple[str, ...]:
    return (ax,) if isinstance(ax, str) else tuple(ax)


def axes_size(mesh: "DeviceMesh", ax: Axes) -> int:
    """The number of devices over mesh axes ``ax`` (1 for None)."""
    n = 1
    for a in () if ax is None else _as_tuple(ax):
        n *= _axis_size(mesh, a)
    return n


def guard(mesh: "DeviceMesh", shape: Sequence[int],
          axes: Sequence[Axes]) -> Tuple[Axes, ...]:
    """Each dim's mesh axes, None where their size does not divide the
    dim (the reference's divisibility guard: replicated, not padded). A
    dim of size 1 is never split (over axes of one device, where the
    reference's guard would keep it, DTensor refuses a view that drops
    or flattens it)."""
    spec = list(axes) + [None] * (len(shape) - len(axes))
    out: List[Axes] = []
    for size, ax in zip(shape, spec):
        n = axes_size(mesh, ax)
        out.append(None if ax is None or n == 0 or size % n or size == 1
                   else ax)
    return tuple(out)


def placements_of(mesh: "DeviceMesh", axes: Sequence[Axes]) -> list:
    """DTensor placements on ``mesh`` of a tensor whose dim i is split
    over mesh axes ``axes[i]``: a mesh axis that some dim maps to shards
    that dim, the others replicate. A dim over several axes is split over
    them in the mesh's axis order, as the reference's tuple of axes is."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis: Dict[str, int] = {}
    for t_dim, ax in enumerate(axes):
        for a in () if ax is None else _as_tuple(ax):
            by_axis[a] = t_dim
    return [Shard(by_axis[a]) if a in by_axis else Replicate()
            for a in mesh.mesh_dim_names]


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
        return guard(self.mesh, shape, self.resolve(spec))

    def placements(self, shape: Sequence[int],
                   dims: Sequence[Optional[str]]) -> list:
        """DTensor placements on :attr:`mesh` for :meth:`resolve_for`: a
        mesh axis that a tensor dim maps to shards that dim, the others
        replicate."""
        return placements_of(self.mesh, self.resolve_for(shape, dims))


_CTX: contextvars.ContextVar[Optional[ShardCtx]] = contextvars.ContextVar(
    "repro_torch_shard_ctx", default=None)
#: The contexts open in this process, innermost last: the backward pass on
#: the card runs in autograd's device thread, which sees no context
#: variable of the caller's, and a checkpoint's recomputation there must
#: lay tensors out as the forward did.
_OPEN: List[ShardCtx] = []


@contextlib.contextmanager
def shard_ctx(mesh: "DeviceMesh", rules: Dict[str, Axes]):
    ctx = ShardCtx(mesh, dict(rules))
    tok = _CTX.set(ctx)
    _OPEN.append(ctx)
    try:
        yield
    finally:
        _OPEN.remove(ctx)
        _CTX.reset(tok)


def current_ctx() -> Optional[ShardCtx]:
    """This thread's context, else the innermost one open in the process
    (a backward pass in autograd's thread)."""
    ctx = _CTX.get()
    if ctx is None and _OPEN:
        ctx = _OPEN[-1]
    return ctx


_RULES_REGISTERED = False


def register_dtensor_rules() -> None:
    """Sharding rules DTensor lacks for ops the port's models call:
    ``aten.bmm.dtype`` (``torch.bmm(..., out_dtype=torch.float32)``, the
    LM's fp32 products of bf16 operands on the card) takes
    ``aten.bmm.default``'s, as its shapes and layouts are the same. Once
    per process; a no-op once registered."""
    global _RULES_REGISTERED
    if _RULES_REGISTERED:
        return
    from torch.distributed.tensor import DTensor
    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    single = getattr(prop, "op_single_dim_strategy_funcs", {})
    if aten.bmm.default in single:
        prop.register_single_dim_op_strategy(
            aten.bmm.dtype, single[aten.bmm.default],
            prop.op_to_schema_info_for_single_dim_strategy.get(
                aten.bmm.default))
    else:
        prop.register_op_strategy(
            aten.bmm.dtype, prop.op_strategy_funcs[aten.bmm.default],
            prop.op_to_schema_info.get(aten.bmm.default))
    _RULES_REGISTERED = True


def _grad_to(mesh, want, g):
    return g if tuple(g.placements) == want else g.redistribute(mesh, want)


def constrain(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """Constrain x's layout by logical dim names: unchanged outside a
    context and for a plain tensor; a DTensor is redistributed to the
    resolved placements (a dim whose mesh size does not divide it is
    replicated), and so is its grad in backward (a non-leaf's)."""
    ctx = current_ctx()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = tuple(ctx.placements(x.shape, dims))
    y = x if tuple(x.placements) == want else x.redistribute(ctx.mesh, want)
    if y.requires_grad and not y.is_leaf and torch.is_grad_enabled():
        # the reference's constraint binds the cotangent too: without it
        # the grad keeps whatever layout the op after it gave, which a
        # later view (a head split the mesh does not divide) may refuse
        y.register_hook(functools.partial(_grad_to, ctx.mesh, want))
    return y


def is_split(x: torch.Tensor, dim: int) -> bool:
    """Whether ``x`` is a DTensor whose dim ``dim`` is split over the mesh."""
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(x, DTensor) and any(
        isinstance(pl, Shard) and pl.dim == dim % x.dim()
        for pl in x.placements)


def to_local_summed(x: torch.Tensor, axes) -> torch.Tensor:
    """``x.to_local()`` as the input of work that each device runs on its
    own shards, those split over the mesh dims ``axes``. Where ``x`` is
    whole on such a dim, the grad each device computes is its share of
    the sum (the reference's ``shard_map`` sums such cotangents): marked
    ``Partial``, DTensor sums it. Elsewhere the grad takes ``x``'s own
    layout (``to_local``'s default, which would take a share for the
    sum)."""
    from torch.distributed.tensor import Partial, Shard
    grad = [Partial() if m in axes and not isinstance(pl, Shard) else pl
            for m, pl in enumerate(x.placements)]
    return x.to_local(grad_placements=grad)


def per_shard(fn, args: Sequence[Optional[torch.Tensor]],
              dims: Sequence[Sequence[Optional[str]]],
              out_dims: Sequence[Optional[str]]):
    """``fn(*args)`` run on each device's shards (the reference's
    ``shard_map``): each tensor of ``args`` laid out by its logical dims
    ``dims[i]`` (:func:`constrain`; a plain tensor, whole on every device,
    first taken as replicated), ``fn`` called on the local tensors, and
    its output (a tensor, or a tuple whose tensors each take ``out_dims``
    in turn: then ``out_dims`` is a sequence of them) wrapped back as
    DTensors split as the inputs split the same logical dims. Outside a
    context, or with no DTensor among ``args``, just ``fn(*args)``.

    Sound only where ``fn`` is independent across every split dim (the
    caller splits samples and heads, never a dim ``fn`` reduces or mixes):
    each logical dim must be split alike in every input that names it, and
    every output must name every split dim; else it raises. An input whole
    on a mesh dim that splits another (B and C beside heads split over
    ``tp``, A beside samples split over the data axes) gets on each device
    its share of the grad, which DTensor sums (:func:`to_local_summed`).
    A batched product over (samples, heads) then runs as one local
    ``bmm``, where DTensor would flatten two split dims: torch 2.11
    refuses that view, and 2.13 prices it with its graph search over
    every strategy of the mesh (too slow on three mesh dims)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ctx = current_ctx()
    dts = [a for a in args if isinstance(a, DTensor)]
    if ctx is None or not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    split: Dict[str, Tuple[int, ...]] = {}
    laid = []
    for a, d in zip(args, dims):
        if not isinstance(a, torch.Tensor):
            laid.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        a = constrain(a, *d)
        names = list(d) + [None] * (a.dim() - len(d))
        for t_dim, name in enumerate(names):
            if name is None:                # constrain replicated it
                continue
            axes = tuple(m for m, pl in enumerate(a.placements)
                         if isinstance(pl, Shard) and pl.dim == t_dim)
            if split.setdefault(name, axes) != axes:
                raise ValueError(f"per_shard: inputs split {name!r} over "
                                 f"mesh dims {split[name]} and {axes}")
        laid.append(a)
    split_axes = {m for axes in split.values() for m in axes}
    out = fn(*(to_local_summed(a, split_axes) if isinstance(a, DTensor)
               else a for a in laid))

    def wrap(t, od):
        if t is None:
            return None
        od = list(od) + [None] * (t.dim() - len(od))
        pls = [Replicate()] * mesh.ndim
        for name, axes in split.items():
            if not axes:
                continue
            if name not in od:
                raise ValueError(f"per_shard: an output drops the split "
                                 f"dim {name!r}")
            for m in axes:
                pls[m] = Shard(od.index(name))
        return DTensor.from_local(t, mesh, pls, run_check=False)

    if isinstance(out, tuple):
        return tuple(wrap(t, od) for t, od in zip(out, out_dims))
    return wrap(out, out_dims)


def logical_axis_size(name: str) -> int:
    """Mesh size mapped to a logical axis (1 outside a context): lets model
    code pick between sharding strategies."""
    ctx = current_ctx()
    if ctx is None:
        return 1
    return axes_size(ctx.mesh, ctx.rules.get(name))
