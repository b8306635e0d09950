"""Carry weights from numpy arrays into the port.

``gr_params_from_numpy`` takes the JAX package's ``init_gr`` pytree as
numpy arrays (the block params stacked along a leading layer axis) and
returns the port's :class:`GRModel`; ``table_from_numpy`` builds a
serving :class:`ShadowedTable`. bfloat16 numpy arrays (the ml_dtypes
type) cannot go through ``torch.from_numpy``: they cross as their uint16
bits and are viewed back as bfloat16, bit for bit.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.embedding.tables import ShadowedTable
from repro_torch.models.gr import GRModel


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
    the same values. The stacked layer axis is split per block;
    ``w_uvqk`` keeps its (d, H·(2dv+2dqk)) u, v, q, k layout; the RAB
    tables keep their own dtype (fp32) whatever the weights' dtype."""
    device = resolve_device(device)
    blocks = tree["blocks"]
    dtype = tensor_from_numpy(np.asarray(tree["out_ln_w"])[:1],
                              torch.device("cpu")).dtype
    n_layers = np.asarray(blocks["ln_w"]).shape[0]
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
        for name in ("ln_w", "ln_b", "w_uvqk", "w_o"):
            put(getattr(bp, name), np.asarray(blocks[name])[i])
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
