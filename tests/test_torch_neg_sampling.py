"""The port's fused negative-sampling path (K3/K4's plain versions through
the autograd Function) and its sorted run-sum scatters (K6's plain
version) against the JAX package.

The Pallas K3/K4 do not run on this JAX (``pl.load`` is gone), so the port
is held against the reference's XLA twin ``fused_recall_lse_xla`` and its
materialised oracle ``fused_recall_lse_ref``, values and grads, with the
reference's sharing permutations injected."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import negative_sampling as JNS
from repro.kernels.jagged_lookup import ops as JL
from repro.kernels.neg_logits.ops import make_share_perms as j_perms
from repro.kernels.neg_logits.ref import fused_recall_lse_ref as j_ref
from repro_torch.core import negative_sampling as PNS
from repro_torch.kernels import jagged_lookup as PL
from repro_torch.kernels.jagged_lookup import ref as PLR
from repro_torch.kernels.neg_logits import (TableGradSink,
                                            fused_recall_lse,
                                            make_share_perms)
from torch_parity import to_f32

SEG = 32


def _inputs(seed, T=100, R=8, D=64, V=300, n_invalid=17):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((T, D)).astype(np.float32) * 0.3
    pos = rng.standard_normal(T).astype(np.float32)
    table = (rng.standard_normal((V, D)) * 0.5).astype(np.float32)
    ids = rng.integers(0, V, (T, R)).astype(np.int32)
    ids[:5, :3] = 7                                  # repeated ids
    valid = np.ones(T, bool)
    valid[rng.choice(T, n_invalid, replace=False)] = False
    g = rng.standard_normal(T).astype(np.float32)
    return o, pos, table, ids, valid, g


def _jax_perms(T, expansion, key):
    n_seg = -(-T // SEG)
    return np.asarray(j_perms(key, n_seg, SEG, expansion))


# fp32 throughout; both sides do the same fp32 ops with sums over D and
# over the logsumexp columns in another order: 1e-5 bounds a few ulps of
# the O(1) lse and grads.
TOL = 1e-5
# With fp16 rows, the reference's XLA twin and oracle differentiate through
# the fp16 gather, so each (token, slot) contribution to the table grad is
# rounded to fp16 (2^-11 relative) before the sum; the port, like the
# Pallas kernel, builds the rows w·o/τ in fp32. The table grads then agree
# to 2^-11 of the summed magnitude: 1e-3 relative to the largest grad.
TABLE_TOL_FP16 = 1e-3


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("expansion", [1, 3])
def test_fused_lse_values_and_grads_match_reference(expansion, shadow):
    """Without the shadow the rows are fp32 (no fetch rounding) and every
    output agrees to TOL; with the fp16 shadow, lse and the grads of o and
    pos still agree to TOL, the table grads to TABLE_TOL_FP16."""
    o, pos, table, ids, valid, g = _inputs(expansion)
    key = jax.random.PRNGKey(11)
    T = o.shape[0]
    fetch = jnp.float16 if shadow else None
    jshadow = jnp.asarray(table).astype(jnp.float16) if shadow else None

    def jlse(oo, pp, tb, fn):
        kw = dict(segment=SEG, tau=0.7, expansion=expansion, key=key,
                  valid=jnp.asarray(valid), fetch_dtype=fetch)
        if fn is j_ref:
            return fn(oo, pp, tb, jnp.asarray(ids), **kw)
        return fn(oo, pp, tb, jnp.asarray(ids), gather_table=jshadow, **kw)

    args = (jnp.asarray(o), jnp.asarray(pos), jnp.asarray(table))
    outs = {}
    for name, fn in (("xla", JNS.fused_recall_lse_xla), ("ref", j_ref)):
        val = jlse(*args, fn)
        grads = jax.grad(lambda *a: jnp.sum(jlse(*a, fn) * jnp.asarray(g)),
                         argnums=(0, 1, 2))(*args)
        outs[name] = (val, grads)

    leaves = [torch.from_numpy(x).clone().requires_grad_()
              for x in (o, pos, table)]
    perms = _jax_perms(T, expansion, key) if expansion > 1 else None
    lse = fused_recall_lse(
        *leaves, torch.from_numpy(ids), segment=SEG, tau=0.7,
        expansion=expansion, perms=perms, valid=torch.from_numpy(valid),
        fetch_dtype=None,
        gather_table=leaves[2].detach().half() if shadow else None,
        scatter_impl="two_pass")
    (lse * torch.from_numpy(g)).sum().backward()
    for name, (val, grads) in outs.items():
        np.testing.assert_allclose(to_f32(lse), to_f32(val), atol=TOL,
                                   rtol=TOL, err_msg=name)
        for field, a, b in zip(("out_emb", "pos", "table"), grads, leaves):
            tol = TOL
            if shadow and field == "table":
                tol = TABLE_TOL_FP16 * np.abs(to_f32(a)).max()
            np.testing.assert_allclose(to_f32(b.grad), to_f32(a), atol=tol,
                                       rtol=TOL, err_msg=f"{name} {field}")


def test_invalid_tokens_never_reach_the_pool():
    """An invalid token's logits are masked out of every borrower's pool:
    changing them (through its ids) moves no valid token's lse."""
    o, pos, table, ids, valid, _ = _inputs(3, n_invalid=40)
    perms = make_share_perms(4, SEG, 4, generator=torch.Generator()
                             .manual_seed(0))
    kw = dict(segment=SEG, expansion=4, perms=perms,
              valid=torch.from_numpy(valid), scatter_impl="two_pass")
    a = fused_recall_lse(*map(torch.from_numpy, (o, pos, table, ids)), **kw)
    ids2 = ids.copy()
    ids2[~valid] = (ids2[~valid] + 1) % table.shape[0]
    b = fused_recall_lse(*map(torch.from_numpy, (o, pos, table, ids2)), **kw)
    assert torch.equal(a[torch.from_numpy(valid)], b[torch.from_numpy(valid)])


def test_sink_receives_the_dense_grad_as_pairs():
    """With ``table_grad_pairs`` the table grad arrives as (ids, rows)
    pairs whose per-id sums equal the dense grad of the same call."""
    o, pos, table, ids, valid, g = _inputs(5)
    kw = dict(segment=SEG, valid=torch.from_numpy(valid),
              scatter_impl="two_pass")
    tb = torch.from_numpy(table).requires_grad_()
    lse = fused_recall_lse(torch.from_numpy(o), torch.from_numpy(pos), tb,
                           torch.from_numpy(ids), **kw)
    (lse * torch.from_numpy(g)).sum().backward()
    sink = TableGradSink(extra_rows=3)
    lse2 = fused_recall_lse(torch.from_numpy(o).requires_grad_(),
                            torch.from_numpy(pos), torch.from_numpy(table),
                            torch.from_numpy(ids),
                            table_grad_pairs=sink, **kw)
    (lse2 * torch.from_numpy(g)).sum().backward()
    assert sink.ids.shape == (ids.size,)
    assert sink.rows.shape == (ids.size + 3, table.shape[1])
    dense = PLR.scatter_add_ref(sink.rows[:ids.size], sink.ids,
                                table.shape[0])
    torch.testing.assert_close(dense, tb.grad, atol=1e-6, rtol=0)


def test_fused_scatter_is_not_ported_and_raises():
    o, pos, table, ids, _, _ = _inputs(6)
    with pytest.raises(NotImplementedError, match="K5"):
        fused_recall_lse(*map(torch.from_numpy, (o, pos, table, ids)),
                         segment=SEG)
    with pytest.raises(NotImplementedError, match="K5"):
        PL.scatter_add_weighted_rows(torch.zeros(2, 3), torch.zeros(2, 4),
                                     torch.zeros(6, dtype=torch.int32), 5)


def test_make_share_perms_are_cyclic_shifts():
    p = make_share_perms(6, SEG, 5, generator=torch.Generator()
                         .manual_seed(1)).numpy()
    assert p.shape == (6, 4, SEG) and p.dtype == np.int32
    shift = (p - np.arange(SEG)) % SEG
    assert (shift == shift[:, :, :1]).all() and (shift > 0).all()
    assert (make_share_perms(3, SEG, 1).numpy() == 0).all()


@pytest.mark.parametrize("expansion", [1, 2])
def test_fused_sampled_softmax_loss_matches_reference(expansion):
    """The loss entry (pos logit from the label rows, mean over valid
    tokens) against the reference's, XLA path, shadow gather; fp32."""
    o, pos_unused, table, ids, valid, _ = _inputs(8)
    rng = np.random.default_rng(9)
    pos_emb = rng.standard_normal(o.shape).astype(np.float32) * 0.3
    key = jax.random.PRNGKey(2)
    shadow = jnp.asarray(table).astype(jnp.float16)
    jl = JNS.fused_sampled_softmax_loss(
        jnp.asarray(o), jnp.asarray(pos_emb), jnp.asarray(table),
        jnp.asarray(ids), key=key, valid=jnp.asarray(valid), segment=SEG,
        expansion=expansion, shadow=shadow, impl="xla")
    perms = (_jax_perms(o.shape[0], expansion, key) if expansion > 1
             else None)
    pl = PNS.fused_sampled_softmax_loss(
        torch.from_numpy(o), torch.from_numpy(pos_emb),
        torch.from_numpy(table), torch.from_numpy(ids), perms=perms,
        valid=torch.from_numpy(valid), segment=SEG, expansion=expansion,
        shadow=torch.from_numpy(table).half(), scatter_impl="two_pass")
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6, atol=1e-6)
    lp = rng.standard_normal(64).astype(np.float32)
    ln = rng.standard_normal((64, 20)).astype(np.float32)
    vv = rng.random(64) < 0.7
    np.testing.assert_allclose(
        float(PNS.sampled_softmax_loss(*map(torch.from_numpy, (lp, ln, vv)))),
        float(JNS.sampled_softmax_loss(*map(jnp.asarray, (lp, ln, vv)))),
        rtol=1e-6)


# --------------------------------------------------------------------------
# sorted run-sum (K6's plain version) and the scatters on it
# --------------------------------------------------------------------------

def _pairs(seed, n=500, D=12, V=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, V, n).astype(np.int32)     # some dropped (< 0)
    ids[:60] = 5                                      # one long run
    rows = rng.standard_normal((n, D)).astype(np.float32)
    return rows, ids, V


def test_dedup_rows_matches_reference():
    """Same run ends in the same sorted order; totals equal to fp32
    summation order (the reference sums with an XLA segment-sum)."""
    rows, ids, _ = _pairs(0)
    ju, js = JL.dedup_rows(jnp.asarray(rows), jnp.asarray(ids))
    pu, ps = PL.dedup_rows(torch.from_numpy(rows), torch.from_numpy(ids))
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    keep = pu.numpy() >= 0
    np.testing.assert_allclose(ps.numpy()[keep], np.asarray(js)[keep],
                               atol=1e-5, rtol=0)
    assert torch.count_nonzero(ps[~torch.from_numpy(keep)]) == 0


def test_scatter_add_rows_matches_reference():
    rows, ids, V = _pairs(1)
    ids[3] = V + 4                                    # out of range: dropped
    a = JL.scatter_add_rows(jnp.asarray(rows), jnp.asarray(ids), V)
    b = PL.scatter_add_rows(torch.from_numpy(rows), torch.from_numpy(ids), V)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)


def test_two_pass_weighted_scatter_matches_reference():
    rng = np.random.default_rng(2)
    T, Rn, D, V = 30, 6, 10, 25
    w = rng.standard_normal((T, Rn)).astype(np.float32)
    o = rng.standard_normal((T, D)).astype(np.float32)
    ids = rng.integers(-1, V + 2, T * Rn).astype(np.int32)
    a = JL.scatter_add_weighted_rows(jnp.asarray(w), jnp.asarray(o),
                                     jnp.asarray(ids), V, scale=0.5,
                                     impl="two_pass")
    b = PL.scatter_add_weighted_rows(torch.from_numpy(w), torch.from_numpy(o),
                                     torch.from_numpy(ids), V, scale=0.5,
                                     impl="two_pass")
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)


def test_runsum_plain_long_and_single_runs():
    """Run totals, one row per run of ids >= 0 in ascending order, the
    dropped run left out, on a mix of run lengths (1 to 300 rows); against
    an exact float64 sum. dedup_rows puts them at the run ends, zeros
    elsewhere."""
    rng = np.random.default_rng(4)
    lens = [1] * 50 + [300, 2, 17, 1, 120]
    sids = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    sids[-5:] = PL.ops.DROP_KEY
    n = sids.size
    rows = rng.standard_normal((n, 8)).astype(np.float32)
    order = rng.permutation(n)
    src = np.empty_like(rows)
    src[order] = rows                                 # rows[order] sorted
    u, out = PL.ops.run_totals(torch.from_numpy(src), torch.from_numpy(order),
                               torch.from_numpy(sids))
    ends = np.r_[sids[1:] != sids[:-1], True]
    starts = np.r_[True, sids[1:] != sids[:-1]]
    kept = [(s, e) for s, e in zip(np.flatnonzero(starts),
                                   np.flatnonzero(ends))
            if sids[s] < PL.ops.DROP_KEY]
    np.testing.assert_array_equal(u.numpy(), [sids[s] for s, _ in kept])
    for r, (s, e) in enumerate(kept):
        want = rows[s:e + 1].astype(np.float64).sum(0)
        np.testing.assert_allclose(out[r].numpy(), want, atol=1e-4, rtol=0)
    ids = np.empty_like(sids)
    ids[order] = np.where(sids < PL.ops.DROP_KEY, sids, -1)
    uids, sums = PL.dedup_rows(torch.from_numpy(src), torch.from_numpy(ids))
    keep = uids.numpy() >= 0
    np.testing.assert_array_equal(keep, ends & (sids < PL.ops.DROP_KEY))
    # dedup_rows sorts the ids itself (stably), so runs add in another order
    np.testing.assert_allclose(sums.numpy()[keep], out.numpy(), atol=1e-4,
                               rtol=0)
    assert np.count_nonzero(sums.numpy()[~keep]) == 0
