"""The kernel lookup and its surroundings against the JAX package: the
jagged lookup (K7's plain version through its autograd Function) and the
stacked ``multi_table_lookup`` against the Pallas gather in interpret mode,
bit for bit forward and backward; the ``JaggedBatch`` helpers,
``lookup_quantized``, the KJT-style ``multi_table_lookup``, the dense Eq.-1
``adagrad_update`` and ``synth_jagged_batch``. K7 itself is held against
the plain version on the card in tests/test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jagged as JJ
from repro.data.synthetic import synth_jagged_batch as j_synth
from repro.embedding import tables as JET
from repro.kernels.jagged_lookup import ops as JLK
from repro.training import optim as JO
from repro_torch.core import jagged as PJ
from repro_torch.data import synth_jagged_batch
from repro_torch.embedding import tables as PET
from repro_torch.kernels import jagged_lookup as PL
from repro_torch.kernels.jagged_lookup import ref as PLR
from repro_torch.training import adagrad_init, adagrad_update
from torch_parity import to_f32

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _ids(rng, n, V):
    """Ids with padding (−1), repeats and ids ≥ V (clipped to row V − 1)."""
    ids = rng.integers(0, V, n).astype(np.int32)
    ids[::7] = -1
    ids[1:30:9] = 5
    ids[3] = V + 2
    return ids


# Pure data movement, one cast: bitwise forward. The backward sums the
# row grads per id (the reference's run-sum twin, the port's K6 plain
# version): fp32 sums in order, bitwise as well at these sizes (each id's
# grads are added in slot order on both sides).
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_jagged_lookup_matches_reference(dtype):
    jd, pd = DTYPES[dtype]
    rng = np.random.default_rng(0)
    V, D, n = 60, 16, 90
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = _ids(rng, n, V)
    g = rng.standard_normal((n, D)).astype(np.float32)

    def jl(t):
        out = JLK.jagged_lookup(t, jnp.asarray(ids), compute_dtype=jd,
                                interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, jout), jgrad = jax.value_and_grad(jl, has_aux=True)(
        jnp.asarray(table))
    pt = torch.from_numpy(table).requires_grad_()
    before = PL.KERNEL_LAUNCHES["gather"]
    pout = PL.jagged_lookup(pt, torch.from_numpy(ids), compute_dtype=pd)
    assert PL.KERNEL_LAUNCHES["gather"] == before           # CPU: plain
    (pout.float() * torch.from_numpy(g)).sum().backward()
    assert pout.dtype == pd and tuple(pout.shape) == jout.shape
    np.testing.assert_array_equal(to_f32(pout), to_f32(jout))
    np.testing.assert_array_equal(to_f32(pt.grad), to_f32(jgrad))
    assert torch.equal(pout, PLR.jagged_lookup_ref(
        torch.from_numpy(table), torch.from_numpy(ids), compute_dtype=pd))
    # any ids shape: (..., D)
    two = PL.jagged_lookup(torch.from_numpy(table),
                           torch.from_numpy(ids[:84].reshape(4, 21)),
                           compute_dtype=pd)
    assert torch.equal(two.reshape(84, D), pout.detach()[:84])


def test_multi_table_lookup_matches_reference():
    rng = np.random.default_rng(1)
    D = 8
    tables = [rng.standard_normal((V, D)).astype(np.float32)
              for V in (20, 35, 7)]
    ids = [_ids(rng, n, t.shape[0]) for n, t in zip((30, 12, 9), tables)]
    gs = [rng.standard_normal((i.size, D)).astype(np.float32) for i in ids]

    def jl(*ts):
        outs = JLK.multi_table_lookup(list(ts), [jnp.asarray(i) for i in ids],
                                      compute_dtype=jnp.bfloat16,
                                      interpret=True)
        return sum(jnp.sum(o.astype(jnp.float32) * g)
                   for o, g in zip(outs, gs)), outs

    (_, jouts), jgrads = jax.value_and_grad(
        jl, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, tables))
    pts = [torch.from_numpy(t).requires_grad_() for t in tables]
    pouts = PL.multi_table_lookup(pts, [torch.from_numpy(i) for i in ids])
    sum((o.float() * torch.from_numpy(g)).sum()
        for o, g in zip(pouts, gs)).backward()
    for a, b in zip(pouts, jouts):
        np.testing.assert_array_equal(to_f32(a), to_f32(b))
    for a, b in zip(pts, jgrads):
        np.testing.assert_array_equal(to_f32(a.grad), to_f32(b))
    with pytest.raises(ValueError, match="widths"):
        PL.multi_table_lookup([torch.zeros(3, 8), torch.zeros(3, 4)],
                              [torch.zeros(1, dtype=torch.int32)] * 2)


# --------------------------------------------------------------------------
# core/jagged.py, embedding/tables.py
# --------------------------------------------------------------------------

def test_jagged_batch_helpers_match_reference():
    rng = np.random.default_rng(2)
    B, L = 4, 6
    lengths = np.array([3, 0, 6, 2], np.int32)
    dense = rng.standard_normal((B, L, 5)).astype(np.float32)
    for cap in (None, 30):
        jb = JJ.from_dense(jnp.asarray(dense), jnp.asarray(lengths), cap)
        pb = PJ.from_dense(torch.from_numpy(dense), torch.from_numpy(lengths),
                           cap)
        np.testing.assert_array_equal(to_f32(pb.values), to_f32(jb.values))
        np.testing.assert_array_equal(pb.offsets.numpy(),
                                      np.asarray(jb.offsets))
        assert pb.capacity == jb.capacity and pb.num_rows == jb.num_rows
        assert int(pb.total()) == int(jb.total())
        for f in ("lengths", "valid_mask", "segment_ids", "positions"):
            np.testing.assert_array_equal(getattr(pb, f)().numpy(),
                                          np.asarray(getattr(jb, f)()), f)
        for pad in (0.0, -1.5):
            jd, jm = JJ.to_dense(jb, 5, pad)
            pdn, pm = PJ.to_dense(pb, 5, pad)
            np.testing.assert_array_equal(to_f32(pdn), to_f32(jd))
            np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    rows = [rng.standard_normal((n, 3)).astype(np.float32) for n in (2, 0, 5)]
    jr, pr = JJ.from_row_list(rows, 10), PJ.from_row_list(rows, 10)
    np.testing.assert_array_equal(pr.values.numpy(), np.asarray(jr.values))
    np.testing.assert_array_equal(pr.offsets.numpy(), np.asarray(jr.offsets))
    with pytest.raises(ValueError, match="exceed capacity"):
        PJ.from_row_list(rows, 6)
    with pytest.raises(ValueError, match="worst-case"):
        PJ.from_dense(torch.from_numpy(dense), torch.from_numpy(lengths), 10)
    offs = np.array([0, 3, 3, 7], np.int32)
    for causal in (True, False):
        np.testing.assert_array_equal(
            PJ.segment_matrix_mask(torch.from_numpy(offs), 9,
                                   causal).numpy(),
            np.asarray(JJ.segment_matrix_mask(jnp.asarray(offs), 9, causal)))


def test_table_lookups_match_reference():
    rng = np.random.default_rng(3)
    t = {"item": rng.standard_normal((40, 8)).astype(np.float32),
         "cat": rng.standard_normal((9, 8)).astype(np.float32)}
    ids = rng.integers(0, 40, 25).astype(np.int32)
    for q in ("float16", "bfloat16"):
        np.testing.assert_array_equal(
            to_f32(PET.lookup_quantized(torch.from_numpy(t["item"]),
                                        torch.from_numpy(ids),
                                        DTYPES[q][1])),
            to_f32(JET.lookup_quantized(jnp.asarray(t["item"]),
                                        jnp.asarray(ids), DTYPES[q][0])))
    rows = {"item": [ids[:7], ids[7:10], ids[10:18]],
            "cat": [np.array([1, 8], np.int32), np.array([3], np.int32)]}
    jf = {k: JJ.from_row_list(v, 20) for k, v in rows.items()}
    pf = {k: PJ.from_row_list(v, 20) for k, v in rows.items()}
    jo = JET.multi_table_lookup({k: jnp.asarray(v) for k, v in t.items()},
                                jf)
    po = PET.multi_table_lookup({k: torch.from_numpy(v)
                                 for k, v in t.items()}, pf)
    for k in rows:
        np.testing.assert_array_equal(to_f32(po[k].values),
                                      to_f32(jo[k].values), k)
        assert torch.count_nonzero(po[k].values[int(pf[k].total()):]) == 0
    spec = PET.TableSpec("item", 50, 8, init_scale=0.1)
    w = PET.init_table(spec, torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, device="cpu")
    assert w.shape == (50, 8) and w.dtype == torch.bfloat16
    assert 0.05 < float(w.float().std()) < 0.2


def test_adagrad_update_matches_reference():
    """Dense Eq. 1, three steps: fp32 on both sides (rsqrt may differ in
    the last bit: 1e-6 relative)."""
    rng = np.random.default_rng(4)
    p = {"w": rng.standard_normal((6, 4)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = JO.adagrad_init(jp, init=0.1)
    pp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ps = adagrad_init(pp, init=0.1)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        jp, js = JO.adagrad_update({k: jnp.asarray(v) for k, v in g.items()},
                                   js, jp, lr=0.05)
        ps = adagrad_update({k: torch.from_numpy(v) for k, v in g.items()},
                            ps, pp, lr=0.05)
    for k in p:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ps.accum[k].numpy(),
                                   np.asarray(js.accum[k]), rtol=1e-6)


def test_synth_jagged_batch_fields_match_reference():
    """The fields, shapes, dtypes and ranges of the reference's (its
    numbers come from a jax key, the port's from a generator), on the
    device asked for."""
    jb = j_synth(jax.random.PRNGKey(0), 2, 64, 100, 5)
    pb = synth_jagged_batch(torch.Generator().manual_seed(0), 2, 64, 100, 5,
                            device="cpu")
    assert pb.keys() == jb.keys()
    for k in jb:
        assert tuple(pb[k].shape) == jb[k].shape, k
        assert pb[k].device.type == "cpu"
    np.testing.assert_array_equal(pb["offsets"].numpy(),
                                  np.asarray(jb["offsets"]))
    assert int(pb["labels"].min()) >= 1 and int(pb["ids"].max()) < 100
    assert (torch.diff(pb["timestamps"], dim=1) >= 0).all()
    offs = np.array([[0, 10, 64], [0, 0, 30]], np.int32)
    assert torch.equal(synth_jagged_batch(None, 2, 64, 100, 5, offsets=offs,
                                          device="cpu")["offsets"],
                       torch.from_numpy(offs))
