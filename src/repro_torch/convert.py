"""Carry state between numpy arrays and the port, both ways.

``gr_params_from_numpy`` takes the JAX package's ``init_gr`` pytree as
numpy arrays (the block params stacked along a leading layer axis) and
returns the port's :class:`GRModel`; ``gr_params_to_numpy`` is its
inverse. ``table_from_numpy`` builds a serving :class:`ShadowedTable`,
``shadowed_table_from_numpy``/``table_to_numpy`` a training one (master,
shadow, accumulator); ``adamw_from_numpy``/``adamw_to_numpy`` carry the
AdamW moments in the params' pytree layout; ``pending_to_numpy`` reads a
τ=1 carry as its (id, row) pairs. bfloat16 numpy arrays (the ml_dtypes
type) cannot go through ``torch.from_numpy``: they cross as their uint16
bits and are viewed back as bfloat16, bit for bit; the way out gives
bfloat16 tensors as float32 arrays (exact).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.embedding.tables import ShadowedTable
from repro_torch.models.gr import GRModel
from repro_torch.training.optim import AdamWState


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy → torch on ``device``, bit-exact, bfloat16 included."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # torch tensors may not alias read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def gr_params_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig,
                         device: DeviceLike = None) -> GRModel:
    """The ``init_gr`` pytree as numpy arrays → a :class:`GRModel` holding
    the same values, for HSTU, FuXi and SASRec blocks alike (FuXi's FFN
    leaves and its functional time encoder's ``time_amp``/
    ``time_log_sigma``/``time_rho`` in place of ``time_table``; SASRec's
    ``w_qkv``, ``w_o``, ``ffn_w1``/``ffn_b1``/``ffn_w2``/``ffn_b2`` and
    ``ln1_*``/``ln2_*``, and no RAB). The stacked layer axis is
    split per block; ``w_uvqk`` keeps its (d, H·(2dv+2dqk)) u, v, q, k
    layout; the RAB leaves keep their own dtype (fp32) whatever the
    weights' dtype. The tree's block leaves and RAB leaves must be the
    config's, key for key."""
    device = resolve_device(device)
    blocks = tree["blocks"]
    dtype = tensor_from_numpy(np.asarray(tree["out_ln_w"])[:1],
                              torch.device("cpu")).dtype
    n_layers = np.asarray(next(v for k, v in sorted(blocks.items())
                               if k != "rab")).shape[0]
    if n_layers != cfg.num_layers:
        raise ValueError(f"tree has {n_layers} layers, config "
                         f"{cfg.num_layers}")
    model = GRModel(cfg, dtype=dtype, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))

    def put(dst: torch.nn.Parameter, src) -> None:
        t = tensor_from_numpy(np.asarray(src), device)
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"shape/dtype {tuple(t.shape)} {t.dtype} vs "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.data.copy_(t)

    for i, bp in enumerate(model.blocks):
        own = dict(bp.named_parameters(recurse=False))
        if set(blocks) - {"rab"} != set(own):
            raise ValueError(f"block leaves {sorted(set(blocks) - {'rab'})} "
                             f"vs config {sorted(own)}")
        for name, p in own.items():
            put(p, np.asarray(blocks[name])[i])
        rab = blocks.get("rab", {})
        if set(rab) != set(bp.rab.keys()):
            raise ValueError(f"RAB tables {sorted(rab)} vs config "
                             f"{sorted(bp.rab.keys())}")
        for name, p in bp.rab.items():
            put(p, np.asarray(rab[name])[i])
    put(model.out_ln_w, tree["out_ln_w"])
    put(model.out_ln_b, tree["out_ln_b"])
    return model


def table_from_numpy(master: np.ndarray, shadow: Optional[np.ndarray] = None,
                     device: DeviceLike = None) -> ShadowedTable:
    """A serving table: the fp32 master, the given shadow (or none), and a
    (0, D) accumulator."""
    device = resolve_device(device)
    m = tensor_from_numpy(np.asarray(master, np.float32), device)
    s = None if shadow is None else tensor_from_numpy(np.asarray(shadow),
                                                      device)
    return ShadowedTable(master=m, shadow=s,
                         accum=torch.zeros((0, m.shape[-1]),
                                           dtype=torch.float32,
                                           device=device))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch → numpy on the host; bfloat16 comes out as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _tree_key(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """A GRModel parameter name → (pytree path, layer index or None):
    ``blocks.3.rab.pos_table`` → (("blocks", "rab", "pos_table"), 3)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tuple(parts), None
    return ("blocks", *parts[2:]), int(parts[1])


def named_to_tree(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors by GRModel parameter name → the ``init_gr`` pytree layout
    (numpy, block leaves stacked along a leading layer axis)."""
    stacks: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    tree: Dict[str, Any] = {}
    for name, t in named.items():
        path, layer = _tree_key(name)
        if layer is None:
            tree[path[0]] = tensor_to_numpy(t)
        else:
            stacks.setdefault(path, {})[layer] = tensor_to_numpy(t)
    for path, layers in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([layers[i] for i in sorted(layers)])
    return tree


def _tree_leaf(tree: Mapping[str, Any], name: str) -> np.ndarray:
    path, layer = _tree_key(name)
    node: Any = tree
    for key in path:
        node = node[key]
    node = np.asarray(node)
    return node if layer is None else node[layer]


def gr_params_to_numpy(model: GRModel) -> Dict[str, Any]:
    """Inverse of :func:`gr_params_from_numpy`: the ``init_gr`` pytree."""
    return named_to_tree(dict(model.named_parameters()))


def shadowed_table_from_numpy(master: np.ndarray,
                              shadow: Optional[np.ndarray],
                              accum: np.ndarray,
                              device: DeviceLike = None) -> ShadowedTable:
    """A training table: fp32 master, its shadow (or none), fp32 AdaGrad
    accumulator, bit for bit."""
    device = resolve_device(device)
    return ShadowedTable(
        master=tensor_from_numpy(np.asarray(master, np.float32), device),
        shadow=(None if shadow is None
                else tensor_from_numpy(np.asarray(shadow), device)),
        accum=tensor_from_numpy(np.asarray(accum, np.float32), device))


def table_to_numpy(t: ShadowedTable) -> Dict[str, Optional[np.ndarray]]:
    return {"master": tensor_to_numpy(t.master),
            "shadow": None if t.shadow is None else tensor_to_numpy(t.shadow),
            "accum": tensor_to_numpy(t.accum)}


def adamw_from_numpy(mu: Mapping[str, Any], nu: Mapping[str, Any],
                     count: int, model: GRModel) -> AdamWState:
    """The reference's AdamW state (moments as params-shaped pytrees) →
    the port's, keyed by ``model``'s parameter names."""
    dev = next(model.parameters()).device
    names = [n for n, _ in model.named_parameters()]
    return AdamWState(
        mu={n: tensor_from_numpy(_tree_leaf(mu, n), dev) for n in names},
        nu={n: tensor_from_numpy(_tree_leaf(nu, n), dev) for n in names},
        count=int(count))


def adamw_to_numpy(state: AdamWState) -> Dict[str, Any]:
    return {"mu": named_to_tree(state.mu), "nu": named_to_tree(state.nu),
            "count": int(state.count)}


def pending_to_numpy(ids: torch.Tensor, rows: torch.Tensor
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """A τ=1 carry as numpy (ids ascending, rows): the pairs with id ≥ 0,
    which is how either package's carry compares as a set."""
    i = tensor_to_numpy(ids).astype(np.int64)
    r = tensor_to_numpy(rows)
    keep = i >= 0
    order = np.argsort(i[keep], kind="stable")
    return i[keep][order], r[keep][order]


def pending_from_numpy(ids: np.ndarray, rows: np.ndarray,
                       device: DeviceLike = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Numpy (id, row) pairs (−1 = empty slot) → a port carry."""
    device = resolve_device(device)
    i, r = pending_to_numpy(torch.from_numpy(np.asarray(ids)),
                            torch.from_numpy(np.asarray(rows, np.float32)))
    return (tensor_from_numpy(i.astype(np.int32), device),
            tensor_from_numpy(r, device))
