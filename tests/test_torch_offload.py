"""The asynchronous negative offload (paper §4.3.1) in the port against the
JAX package, on the CPU: ``offload_negatives`` leaves a CPU tensor as it is
(the reference's branch without pinned host memory), and
``neg_logits_offloaded`` (the segmented consumer of offloaded rows; K9's
plain versions a segment at a time on the CPU) gives the reference's
``neg_logits_baseline`` and ``neg_logits_segmented`` logits on the same
numpy rows and ids, and their grads under ``jax.grad``: of the output
embedding, of the rows, and (summed by id) of the table. On the card the
rows stream from pinned host memory; tests/test_torch_gpu.py holds that
path bit for bit to K9 on the same segments held on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import negative_sampling as NS
from repro_torch.core.negative_sampling import (neg_logits_offloaded,
                                                offload_negatives)
from torch_parity import to_f32

T, R, D, V, SEG = 256, 8, 32, 500, 64


def _inputs(seed=0):
    """out (T, D) fp32, table (V, D) fp32, ids (T, R) and the fp16 rows
    table[ids] the segmented path fetches, as numpy."""
    rng = np.random.default_rng(seed)
    out = rng.standard_normal((T, D)).astype(np.float32)
    table = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    ids = rng.integers(0, V, (T, R)).astype(np.int32)
    rows = table[ids].astype(np.float16)
    return out, table, ids, rows


def test_offload_negatives_cpu_is_identity():
    """As the reference's test: a tensor that is not on the card stays
    where it is, the same object and values."""
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    y = offload_negatives(x)
    assert y is x
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(NS.offload_negatives(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_offloaded_logits_match_reference_paths(tau):
    """The logits against the reference's materialised and segmented
    paths on the same fp16 rows: o·n in fp32 over τ (the port multiplies
    by 1/τ, exact at both τ here), a few ulps of the O(1) logits."""
    out, table, ids, rows = _inputs()
    base = NS.neg_logits_baseline(jnp.asarray(out), jnp.asarray(rows),
                                  tau=tau)
    seg = NS.neg_logits_segmented(jnp.asarray(out), jnp.asarray(table),
                                  jnp.asarray(ids), segment=SEG, tau=tau,
                                  fetch_dtype=jnp.float16)
    got = neg_logits_offloaded(torch.from_numpy(out), torch.from_numpy(rows),
                               segment=SEG, tau=tau)
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, R)
    for want in (base, seg):
        np.testing.assert_allclose(to_f32(got), to_f32(want), atol=1e-5,
                                   rtol=1e-6)


def test_offloaded_grads_match_jax_grad():
    """d out (fp32, summed over R rows: 1e-5) and d rows (fp16, one
    rounding of gs·o: within an fp16 ulp, 2^-10 relative) against
    ``jax.grad`` of the baseline; the rows' grad summed by id against
    ``jax.grad`` of the segmented path in the table (fp32 sums of fp16
    cotangents)."""
    out, table, ids, rows = _inputs(1)
    cot = np.random.default_rng(2).standard_normal((T, R)).astype(np.float32)

    def base_loss(o, n):
        return jnp.sum(NS.neg_logits_baseline(o, n) * cot)

    def seg_loss(o, t):
        return jnp.sum(NS.neg_logits_segmented(o, t, jnp.asarray(ids),
                                               segment=SEG,
                                               fetch_dtype=jnp.float16)
                       * cot)

    jdo, jdn = jax.grad(base_loss, argnums=(0, 1))(jnp.asarray(out),
                                                   jnp.asarray(rows))
    jdo_s, jdt = jax.grad(seg_loss, argnums=(0, 1))(jnp.asarray(out),
                                                    jnp.asarray(table))
    o = torch.from_numpy(out).requires_grad_()
    n = torch.from_numpy(rows).requires_grad_()
    logits = neg_logits_offloaded(o, n, segment=SEG)
    (logits * torch.from_numpy(cot)).sum().backward()
    assert o.grad.dtype == torch.float32 and n.grad.dtype == torch.float16
    assert n.grad.device.type == "cpu"
    for want in (jdo, jdo_s):
        np.testing.assert_allclose(to_f32(o.grad), to_f32(want), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(to_f32(n.grad), to_f32(jdn), rtol=2 ** -10,
                               atol=1e-6)
    dtable = torch.zeros(V, D).index_add_(
        0, torch.from_numpy(ids).reshape(-1).long(),
        n.grad.reshape(-1, D).float())
    np.testing.assert_allclose(dtable.numpy(), to_f32(jdt), atol=1e-5,
                               rtol=1e-5)


def test_offloaded_equals_per_segment_plain_k9():
    """Each segment's logits and grads are K9's plain versions on that
    segment alone (on the card: the kernels, bit for bit)."""
    from repro_torch.kernels.neg_logits import neg_logits_bwd, neg_logits_fwd
    out, _, _, rows = _inputs(3)
    o, n = torch.from_numpy(out), torch.from_numpy(rows)
    g = torch.randn(T, R, generator=torch.Generator().manual_seed(0))
    oo = o.clone().requires_grad_()
    nn_ = n.clone().requires_grad_()
    logits = neg_logits_offloaded(oo, nn_, segment=SEG)
    logits.backward(g)
    for lo in range(0, T, SEG):
        s = slice(lo, lo + SEG)
        assert torch.equal(logits[s], neg_logits_fwd(o[s], n[s],
                                                     inv_tau=1.0))
        do, dn = neg_logits_bwd(o[s], n[s], g[s], inv_tau=1.0)
        assert torch.equal(oo.grad[s], do) and torch.equal(nn_.grad[s], dn)


def test_offloaded_refuses_what_it_does_not_take():
    """T not a segment multiple (as the reference asserts), shapes that do
    not pair up."""
    out, _, _, rows = _inputs()
    o, n = torch.from_numpy(out), torch.from_numpy(rows)
    with pytest.raises(ValueError, match="multiple of the segment"):
        neg_logits_offloaded(o[:200], n[:200], segment=SEG)
    with pytest.raises(ValueError, match="takes"):
        neg_logits_offloaded(o[:, :16], n, segment=SEG)
    with pytest.raises(ValueError, match="takes"):
        neg_logits_offloaded(o, n[0], segment=SEG)
