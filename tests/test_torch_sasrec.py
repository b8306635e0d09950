"""SASRec in the port against the JAX package, on the CPU: the configs
field for field, the block's forward and its gradients against
``jax.grad``, the GR stack (keyless padding rows included), the serving
engine and the training step, on weights carried by ``convert``.

SASRec's softmax attention is plain PyTorch in the port, as it is inline
XLA in the reference (no TPU kernel computes it), so the two compute the
same fp32 arithmetic in other orders. Forwards are held per row by
relative L2 (``max_row_rel_err``): fp32 1e-5 (a few ulps of O(1)
activations through two matmuls and a softmax; the readings are 3e-7 for
the block and 4e-7 for the stack), bf16 2e-2 (the reference's XLA keeps
some intermediates in fp32 where the port rounds each matmul to bf16: a
flip is 2^-8 ≈ 3.9e-3 of a value, and the layers add a few; the stack
reads 6.4e-3, the block 0). fp32 gradients 1e-4 of the largest value of
each (sums over every token and key)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as PC
from repro.models import gr as JG
from repro.models.sasrec import sasrec_block as j_sasrec_block
from repro_torch.convert import (gr_params_from_numpy, gr_params_to_numpy,
                                 tensor_from_numpy)
from repro_torch.kernels.jagged_attention.ref import max_row_rel_err
from repro_torch.models import gr as PG
from repro_torch.models.sasrec import (SASRecBlock, causal_softmax_attention,
                                       sasrec_block)
from test_torch_serving import recall_engine_vs_reference
from test_torch_training import train_vs_reference
from torch_parity import CPU, models, to_f32, tree_numpy

ARCH = "sasrec-tiny"
SASREC_NAMES = ["sasrec-tiny", "sasrec-small", "sasrec-medium",
                "sasrec-large"]
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # per-row relative L2
GRAD_TOL = 1e-4


@pytest.mark.parametrize("name", SASREC_NAMES)
def test_sasrec_configs_match_reference(name):
    assert PC.get_arch(name).__dict__ == JC.get_arch(name).__dict__
    assert PC.reduced(PC.get_arch(name)).__dict__ == \
        JC.reduced(JC.get_arch(name)).__dict__


def _pack(rng, G, cap, d, lens_per_pack):
    offs = []
    for lens in lens_per_pack:
        offs.append(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    x = (rng.standard_normal((G, cap, d)) * 0.5).astype(np.float32)
    ts = np.cumsum(rng.integers(0, 3000, (G, cap)), axis=1).astype(np.int32)
    return x, np.stack(offs), ts


def _row_rel(out, ref) -> float:
    """Max over tokens of |out − ref|₂ / |ref|₂; a row that is 0 in the
    reference must be 0 in the port."""
    return max_row_rel_err(torch.from_numpy(to_f32(out)),
                           torch.from_numpy(to_f32(ref)))


def _block0(dense):
    return {k: v[0] for k, v in dense["blocks"].items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sasrec_block_forward_matches_jax(dtype):
    (cj, dense, _), (cp, model, _) = models(seed=2, dtype=dtype, arch=ARCH)
    assert isinstance(model.blocks[0], SASRecBlock)
    rng = np.random.default_rng(0)
    x, offs, ts = _pack(rng, 1, 96, cj.d_model, [[30, 0, 41, 9]])
    xj = jnp.asarray(x[0]).astype(jnp.dtype(dtype))
    ref = j_sasrec_block(_block0(dense), cj, xj, jnp.asarray(offs[0]),
                         jnp.asarray(ts[0]))
    out = sasrec_block(model.blocks[0], cp, tensor_from_numpy(
        np.asarray(xj), CPU), torch.from_numpy(offs[0]),
        torch.from_numpy(ts[0]))
    assert _row_rel(out, ref) <= FWD_TOL[dtype]


def test_sasrec_block_grads_match_jax_grad():
    """d(Σ out·w) with respect to x and every block parameter, against
    ``jax.grad`` of the reference block, fp32, padding rows included."""
    (cj, dense, _), (cp, model, _) = models(seed=4, arch=ARCH)
    rng = np.random.default_rng(1)
    x, offs, ts = _pack(rng, 1, 64, cj.d_model, [[20, 1, 30]])
    w = rng.standard_normal(x[0].shape).astype(np.float32)
    bp = _block0(dense)

    def jloss(p, xx):
        out = j_sasrec_block(p, cj, xx, jnp.asarray(offs[0]),
                             jnp.asarray(ts[0]))
        return jnp.sum(out * w)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(bp, jnp.asarray(x[0]))
    blk = model.blocks[0]
    xt = torch.from_numpy(x[0]).requires_grad_(True)
    out = sasrec_block(blk, cp, xt, torch.from_numpy(offs[0]),
                       torch.from_numpy(ts[0]))
    (out * torch.from_numpy(w)).sum().backward()
    grads = {n: p.grad for n, p in blk.named_parameters()}
    assert set(grads) == set(jg_p)
    for name, g in list(grads.items()) + [("x", xt.grad)]:
        ref = np.asarray(jg_x if name == "x" else jg_p[name])
        scale = max(np.abs(ref).max(), 1e-6)
        err = np.abs(g.numpy() - ref).max() / scale
        assert err <= GRAD_TOL, (name, err)


def test_sasrec_keyless_rows_are_zero_before_the_residual():
    """Padding queries have no key: softmax over nothing is NaN in both
    packages, and both set those rows to exactly 0."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 48, 4, 16)).astype(
        np.float32)) for _ in range(3))
    offs = torch.tensor([[0, 10, 10, 25], [0, 0, 0, 0]], dtype=torch.int32)
    y = causal_softmax_attention(q, k, v, offs)
    assert torch.isfinite(y).all()
    assert torch.count_nonzero(y[0, 25:]) == 0
    assert torch.count_nonzero(y[1]) == 0
    assert torch.count_nonzero(y[0, :25].abs().sum(-1)) == 25 * 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sasrec_gr_hidden_matches_jax(dtype):
    """G = 2 packs (one of them padding past a short pack, rows of length 0
    and 1) through the reduced SASRec stack and its final norm."""
    (cj, dense, _), (cp, model, _) = models(seed=3, dtype=dtype, arch=ARCH)
    assert PG.default_attn_fn(cp) is None
    rng = np.random.default_rng(3)
    x, offs, ts = _pack(rng, 2, 80, cj.d_model, [[25, 0, 1, 40],
                                                  [7, 3, 0, 0]])
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    ref = JG.gr_hidden_sharded(dense, cj, xj, jnp.asarray(offs),
                               jnp.asarray(ts), remat=False)
    out = PG.gr_hidden_sharded(model, cp,
                               tensor_from_numpy(np.asarray(xj), CPU),
                               torch.from_numpy(offs), torch.from_numpy(ts),
                               remat=False)
    assert torch.isfinite(out.float()).all()
    assert _row_rel(out, ref) <= FWD_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sasrec_convert_round_trip(dtype):
    (cj, dense, _), (cp, model, _) = models(seed=5, dtype=dtype, arch=ARCH)
    back = gr_params_to_numpy(model)
    ref = tree_numpy(dense)
    flat_b, tb = jax.tree_util.tree_flatten(back)
    flat_r, tr = jax.tree_util.tree_flatten(ref)
    assert tb == tr
    for a, b in zip(flat_b, flat_r):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    again = gr_params_from_numpy(back, cp, device=CPU)
    for (na, a), (nb, b) in zip(model.named_parameters(),
                                again.named_parameters()):
        assert na == nb and torch.equal(a, b)


def test_sasrec_recall_engine_matches_jax():
    """Cold, pure-hit and incremental rounds of ``RecallEngine`` on reduced
    SASRec against the reference ``RecallEngine`` (the serving slice's
    tolerances: fp32, 1e-4)."""
    recall_engine_vs_reference("xla", arch=ARCH)


def test_sasrec_train_steps_match_reference():
    """3 sync + 3 τ=1 steps of ``make_gr_train_step`` on reduced SASRec
    against the reference trainer, the training slice's fp32 tolerances
    (losses within 1e-5)."""
    train_vs_reference("fp32", arch=ARCH)
