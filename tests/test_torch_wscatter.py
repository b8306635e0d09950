"""K5, the weighted run-sum scatter: its plain version against the
reference's Pallas kernel (interpret mode) and ``"fused"`` scatter, and the
port's own contract that K5 over factored rows gives the bits of building
the rows and summing them with K6 (``"two_pass"``): for the scatter, for
``_table_grad_pairs`` and for whole training steps. The kernel itself runs
only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.jagged_lookup import ops as JL
from repro.kernels.jagged_lookup.kernel import weighted_runsum_scatter
from repro_torch.kernels.jagged_lookup import ops as PL
from repro_torch.kernels.jagged_lookup.ref import weighted_run_totals_plain
from repro_torch.models.model_zoo import GRBundle
from repro_torch.training import (TableContribs, gr_train_state,
                                  make_gr_train_step, state_tensors,
                                  to_device)
from repro_torch.training.trainer import _table_grad_pairs
from torch_parity import configs

# fp32 sums of the same rows in another order (the reference's kernel
# walks the slots in its own sorted order and XLA on the CPU contracts its
# multiply-add; the plain version rounds the product first): 1e-6 of the
# largest total.
REL_TOL = 1e-6


def _factored(seed, T, R, D, V, n_drop=0):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((T, D)).astype(np.float32)
    w = rng.standard_normal((T, R)).astype(np.float32)
    ids = rng.integers(0, V, T * R).astype(np.int32)
    ids[:7] = 3                                       # one longer run
    ids[rng.choice(T * R, n_drop, replace=False)] = -1
    return o, w, ids


@pytest.mark.parametrize("T,R,D,V,n_drop", [(24, 6, 16, 40, 9),
                                             (25, 8, 8, 300, 0)])
def test_plain_matches_reference_kernel(T, R, D, V, n_drop):
    """K5's plain version against ``weighted_runsum_scatter`` in interpret
    mode, called directly on the same sorted slots, on the touched rows."""
    o, w, ids = _factored(0, T, R, D, V, n_drop)
    scale = 0.7
    keyed = np.where(ids >= 0, ids, V).astype(np.int32)
    order = np.argsort(keyed, kind="stable")
    ref = np.asarray(weighted_runsum_scatter(
        jnp.asarray(o), jnp.asarray(w.reshape(-1)[order] * (ids[order] >= 0)),
        jnp.asarray(keyed[order]), jnp.asarray((order // R).astype(np.int32)),
        V, scale=scale, interpret=True))
    p_order, sids = PL.sort_pairs(torch.from_numpy(ids))
    np.testing.assert_array_equal(p_order.numpy(), order)
    _, _, n_runs, u, uids = PL._runs(sids)
    got = weighted_run_totals_plain(
        torch.from_numpy(o), torch.from_numpy(w), torch.zeros((0, D)),
        p_order, sids, n_runs, PL.DROP_KEY, scale)[:u]
    touched = np.unique(ids[ids >= 0])
    np.testing.assert_array_equal(uids[:u].numpy(), touched)
    want = ref[touched]
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err


@pytest.mark.parametrize("T,R,D,V", [(64, 4, 16, 100), (33, 3, 8, 50)])
def test_scatter_fused_matches_reference(T, R, D, V):
    """The cases of the reference's ``test_scatter_fused_matches_two_pass``,
    out-of-range ids included: the port's ``"fused"`` against the
    reference's ``"fused"`` and ``"two_pass"`` to its own tolerance, and
    against the port's ``"two_pass"`` bit for bit."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((T, R)).astype(np.float32)
    o = rng.standard_normal((T, D)).astype(np.float32)
    ids = rng.integers(-2, V + 3, T * R).astype(np.int32)
    got = PL.scatter_add_weighted_rows(*map(torch.from_numpy, (w, o, ids)),
                                       V, scale=0.7)
    assert got.shape == (V, D)
    for impl in ("fused", "two_pass"):
        want = JL.scatter_add_weighted_rows(
            *map(jnp.asarray, (w, o, ids)), V, scale=0.7, impl=impl,
            interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=impl)
    assert torch.equal(got, PL.scatter_add_weighted_rows(
        *map(torch.from_numpy, (w, o, ids)), V, scale=0.7, impl="two_pass"))


def test_table_grad_pairs_fused_equals_two_pass_bitwise():
    """One batch's contributions — negative slots with repeats and ids out
    of [0, V) (clipped, as the trainer clips), then ready input and label
    rows — reduced by K5 from the factored form and by K6 from the built
    rows: the same unique ids and the same bits."""
    T, R, D, V = 40, 5, 12, 60
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.standard_normal((T + 8, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((T + 8, R)).astype(np.float32))
    neg = rng.integers(-4, V + 4, (T, R)).astype(np.int32)
    inp = rng.integers(0, 10, T).astype(np.int32)
    lab = rng.integers(0, V, T).astype(np.int32)
    extra = torch.from_numpy(rng.standard_normal((2 * T, D)).astype(
        np.float32))
    ids = torch.from_numpy(np.concatenate([neg.reshape(-1), inp, lab]))
    scale = 1 / 0.7
    rows = torch.cat([(w[:T, :, None] * (o[:T] * scale)[:, None]).reshape(
        T * R, D), extra])
    two = _table_grad_pairs(TableContribs(ids, rows, None), V)
    fused = _table_grad_pairs(TableContribs(ids, extra, (w, o, scale)), V)
    assert torch.equal(two[0], torch.unique(ids.clamp(0, V - 1)))
    assert torch.equal(fused[0], two[0]) and torch.equal(fused[1], two[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_fused_equal_two_pass_bitwise(dtype):
    """Two sync then two τ=1 steps of a reduced HSTU from one init, with the
    default ``neg_scatter_impl="fused"`` and with ``"two_pass"``: the same
    losses and the same bits in every state tensor and the carry."""
    from repro.data.loader import GRLoader
    from repro.data.synthetic import SyntheticKuaiRand
    _, cp = configs(dtype, n_items=400, max_seq_len=32)
    cp = cp.replace(num_negatives=6)
    gen = SyntheticKuaiRand(num_users=30, num_items=400, mean_len=25,
                            max_len=60, seed=1)
    seqs = {u: (d["item"], d["ts"]) for u, d in
            ((u, gen.interactions(u)) for u in range(30))}
    batches = list(GRLoader(seqs, 2, 3, 32, 6, 400, seed=2).batches(4))
    b = GRBundle(cp)
    runs = {}
    for impl in ("fused", "two_pass"):
        g = torch.Generator().manual_seed(0)
        state = gr_train_state(b.init_dense(g, device="cpu"),
                               b.init_table(g, device="cpu"))
        losses = []
        for i, batch in enumerate(batches):
            step = make_gr_train_step(
                lambda d, t, bt, **kw: b.loss(d, t, bt, neg_segment=32,
                                              neg_scatter_impl=impl, **kw),
                input_gather=b.input_gather, semi_async=i >= 2)
            state, m = step(state, to_device(batch, "cpu"))
            losses.append(float(m["loss"]))
        runs[impl] = (state, losses)
    (sf, lf), (st, lt) = runs["fused"], runs["two_pass"]
    assert lf == lt
    assert sf.pending_ids.numel() > 0
    for a, c in zip(state_tensors(sf), state_tensors(st)):
        assert torch.equal(a, c)

