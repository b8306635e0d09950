"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU, the port with ``device="cpu"`` (its kernels' plain
versions)."""
import jax
import numpy as np
import torch

import repro.configs as JC
import repro_torch.configs as PC
from repro.embedding.tables import make_shadowed
from repro.models.model_zoo import get_bundle
from repro_torch.convert import gr_params_from_numpy, table_from_numpy

CPU = torch.device("cpu")


def configs(dtype="float32", n_items=600, max_seq_len=64):
    """(JAX config, port config): reduced hstu-tiny, field for field."""
    kw = dict(vocab_size=n_items, max_seq_len=max_seq_len, dtype=dtype)
    cj = JC.reduced(JC.get_arch("hstu-tiny")).replace(**kw)
    cp = PC.reduced(PC.get_arch("hstu-tiny")).replace(**kw)
    return cj, cp


def tree_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def models(seed=0, dtype="float32", n_items=600, max_seq_len=64):
    """JAX (dense params, ShadowedTable) and the port's (GRModel,
    ShadowedTable) holding the same values."""
    cj, cp = configs(dtype, n_items, max_seq_len)
    b = get_bundle(cj)
    key = jax.random.PRNGKey(seed)
    dense = b.init_dense(key)
    table = make_shadowed(b.init_table(key))
    model = gr_params_from_numpy(tree_numpy(dense), cp, device=CPU)
    ptable = table_from_numpy(np.asarray(table.master),
                              np.asarray(table.shadow), device=CPU)
    return (cj, dense, table), (cp, model, ptable)


def jagged_pack(rng, cap, lens, H, D, dtype=np.float32, ts_gap=500):
    """q, k, v (cap, H, D), offsets (S+1,), timestamps (cap,) as numpy."""
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    q, k, v = (rng.standard_normal((cap, H, D)).astype(dtype)
               for _ in range(3))
    ts = np.cumsum(rng.integers(0, ts_gap, cap)).astype(np.int32)
    return q, k, v, offsets, ts


def to_t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def to_f32(x):
    """numpy float32 copy of a JAX array or a torch tensor (bf16 too)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)
