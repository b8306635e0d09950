"""The training slice: the port's ``make_gr_train_step`` against the JAX
package's on the same reduced HSTU (fp32, 2 layers, d 128, vocab 600),
from the same init, on the reference ``GRLoader``'s batches: N sync steps,
then N τ=1 steps (``input_gather`` dataflow, as ``GREngine`` runs it),
with ``neg_scatter_impl="two_pass"``. Compared: every loss, the final
dense params and AdamW state, master, accumulator and shadow, and the τ=1
carry as a set of (id, row) pairs. Also the port's optimizer pieces and
numpy copies (loader, load balance, candidate dedup) against the
reference's."""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import load_balance as JLB
from repro.data.loader import GRLoader as JLoader
from repro.data.synthetic import SyntheticKuaiRand as JSynth
from repro.embedding import tables as JET
from repro.models.model_zoo import get_bundle as j_bundle
from repro.training import optim as JO
from repro.training import trainer as JT
from repro_torch.convert import (adamw_to_numpy, gr_params_from_numpy,
                                 gr_params_to_numpy, pending_to_numpy,
                                 shadowed_table_from_numpy, table_to_numpy)
from repro_torch.core import load_balance as PLB
from repro_torch.data import GRLoader as PLoader
from repro_torch.data import SyntheticKuaiRand as PSynth
from repro_torch.embedding.tables import (ShadowedTable, rebuild_shadow,
                                          shadow_consistent, strip_shadow)
from repro_torch.kernels import jagged_lookup as PL
from repro_torch.models.model_zoo import GRBundle
from repro_torch.training import (adagrad_sparse_update, adamw_init,
                                  adamw_update, gr_train_state,
                                  host_unique_candidates, make_gr_train_step,
                                  to_device)
from torch_parity import configs, tree_numpy

CPU = torch.device("cpu")
SEG = 64
R = 8
N_STEPS = 3


def _loader(cls_loader, cls_synth, vocab):
    gen = cls_synth(num_users=60, num_items=vocab, mean_len=30, max_len=80,
                    seed=3)
    seqs = {u: (d["item"], d["ts"]) for u, d in
            ((u, gen.interactions(u)) for u in range(60))}
    return cls_loader(seqs, num_devices=2, users_per_device=3,
                      max_seq_len=32, num_negatives=R, num_items=vocab,
                      seed=4)


def _batches(vocab, n):
    return list(_loader(JLoader, JSynth, vocab).batches(n))


def _run_reference(cj, dense, table, batches, qdtype):
    b = j_bundle(cj)
    state = JT.gr_train_state(dense, table, qdtype=qdtype,
                              pending_slots=JT.gr_pending_slots(batches[0]))

    def step_fn(semi):
        return jax.jit(JT.make_gr_train_step(
            lambda d, t, bt, **kw: b.loss(d, t, bt, neg_mode="fused",
                                          neg_segment=SEG, fetch_dtype=qdtype,
                                          neg_scatter_impl="two_pass", **kw),
            semi_async=semi, input_gather=b.input_gather))

    losses = []
    for i, batch in enumerate(batches):
        step = step_fn(i >= N_STEPS) if i in (0, N_STEPS) else step
        nb = {k: jnp.asarray(v) for k, v in batch.items() if k != "weights"}
        state, m = step(state, nb)
        losses.append(float(m["loss"]))
    return state, losses


def _run_port(cp, dense_np, table_np, batches, qdtype):
    pb = GRBundle(cp)
    model = gr_params_from_numpy(dense_np, cp, device=CPU)
    master = np.asarray(table_np)
    shadow = None if qdtype is None else master.astype(np.float16)
    table = shadowed_table_from_numpy(master, shadow, np.zeros_like(master),
                                      device=CPU)
    state = gr_train_state(model, table)
    losses = []
    for i, batch in enumerate(batches):
        if i in (0, N_STEPS):
            step = make_gr_train_step(
                lambda d, t, bt, **kw: pb.loss(d, t, bt, neg_segment=SEG,
                                               fetch_dtype=qdtype,
                                               neg_scatter_impl="two_pass",
                                               **kw),
                input_gather=pb.input_gather, semi_async=i >= N_STEPS)
        state, m = step(state, to_device(batch, CPU))
        losses.append(float(m["loss"]))
    return state, losses


class Tol(NamedTuple):
    """An absolute limit ``atol`` that up to ``n`` elements of a compared
    array may exceed, each by no more than ``outlier``."""
    atol: float
    n: int
    outlier: float


def _assert_close(a, b, atol, rtol, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if isinstance(atol, Tol):
        over = np.abs(a - b) > atol.atol + rtol * np.abs(b)
        assert over.sum() <= atol.n, (what, int(over.sum()), atol)
        atol = atol.outlier
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=what)


def _assert_trees(a, b, atol, rtol, what):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb, (what, ta, tb)
    for i, (x, y) in enumerate(zip(la, lb)):
        _assert_close(x, y, atol, rtol, f"{what} leaf {i}")


# Absolute tolerances per compared field. "fp32": both packages do the
# same fp32 arithmetic, summed in other orders (attention pairs, scatters,
# run-sums), so grads agree to a few ulps; AdamW (step ≈ lr·m/√v) and
# AdaGrad (first step -lr·g/√(g²+1e-10)) turn that into a few 1e-6 of lr
# (4e-3) where a grad element is near zero, so params and master rows are
# held to 5e-5 and 1e-5, the moments and the accumulators (up to ~25) to
# about 1e-5 of their largest values. "fp16_shadow": the reference's XLA
# negative path differentiates through the fp16 gather and so rounds every
# (token, slot) contribution to the table grad to fp16 (2^-11) before
# summing, where the port, like the Pallas kernel, keeps w·o/τ in fp32;
# six steps of that moves losses by ~2e-5, table rows and carried grads by
# up to an eighth of an lr step, and the dense params through them.
TOLS = {
    "fp32": dict(loss=1e-5, dense=5e-5, mu=1e-6, nu=1e-8, master=1e-5,
                 accum=3e-4, rows=5e-5),
    "fp16_shadow": dict(loss=1e-4, dense=2e-4, mu=2e-4, nu=1e-6,
                        master=1e-3, accum=5e-3, rows=1e-2),
}


@pytest.mark.parametrize("rows", ["fp32", "fp16_shadow"])
def test_train_slice_matches_reference(rows):
    train_vs_reference(rows)


def train_vs_reference(rows, arch="hstu-tiny", tweak=None, tols=None):
    """The body of :func:`test_train_slice_matches_reference` for reduced
    ``arch``; ``tweak(dense) -> dense`` edits the JAX init first; ``tols``
    replaces ``TOLS``."""
    tol = (tols or TOLS)[rows]
    qdtype = None if rows == "fp32" else jnp.float16
    cj, cp = configs("float32", n_items=600, max_seq_len=32, arch=arch)
    cj = cj.replace(num_negatives=R)
    cp = cp.replace(num_negatives=R)
    batches = _batches(cj.vocab_size, 2 * N_STEPS)
    assert any((np.diff(b["offsets"], axis=1) == 0).any() for b in batches)
    key = jax.random.PRNGKey(0)
    jb = j_bundle(cj)
    dense = jb.init_dense(key)
    if tweak is not None:
        dense = tweak(dense)
    table = jb.init_table(key)
    jstate, jl = _run_reference(cj, dense, table, batches, qdtype)
    pstate, pl = _run_port(cp, tree_numpy(dense), table, batches,
                           None if qdtype is None else torch.float16)

    np.testing.assert_allclose(pl, jl, rtol=0, atol=tol["loss"])
    _assert_trees(gr_params_to_numpy(pstate.dense), tree_numpy(jstate.dense),
                  tol["dense"], 0, "dense")
    opt = adamw_to_numpy(pstate.dense_opt)
    assert opt["count"] == int(jstate.dense_opt.count) == 2 * N_STEPS
    _assert_trees(opt["mu"], tree_numpy(jstate.dense_opt.mu), tol["mu"], 0,
                  "adamw mu")
    _assert_trees(opt["nu"], tree_numpy(jstate.dense_opt.nu), tol["nu"], 0,
                  "adamw nu")
    t = table_to_numpy(pstate.table)
    _assert_close(t["master"], jstate.table.master, tol["master"], 0,
                  "master")
    _assert_close(t["accum"], jstate.table.accum, tol["accum"], 0, "accum")
    if qdtype is not None:
        np.testing.assert_array_equal(t["shadow"],
                                      t["master"].astype(np.float16))
        _assert_close(t["shadow"], jstate.table.shadow, tol["master"], 0,
                      "shadow")
    pi, pr = pending_to_numpy(pstate.pending_ids, pstate.pending_rows)
    ji, jr = pending_to_numpy(torch.from_numpy(np.array(jstate.pending_ids)),
                              torch.from_numpy(np.array(jstate.pending_rows)))
    np.testing.assert_array_equal(pi, ji)
    _assert_close(pr, jr, tol["rows"], 0, "pending rows")


def test_adagrad_sparse_update_matches_reference_and_keeps_shadow():
    rng = np.random.default_rng(0)
    V, D = 50, 16
    master = rng.standard_normal((V, D)).astype(np.float32)
    accum = rng.random((V, D)).astype(np.float32)
    ids = rng.integers(-2, V, 200).astype(np.int32)
    rows = rng.standard_normal((200, D)).astype(np.float32)
    jt = JET.make_shadowed(jnp.asarray(master), accum=jnp.asarray(accum))
    jt = JO.adagrad_sparse_update(jt, jnp.asarray(ids), jnp.asarray(rows),
                                  lr=0.05)
    pt = shadowed_table_from_numpy(master, master.astype(np.float16), accum,
                                   device=CPU)
    before = PL.KERNEL_LAUNCHES["runsum"]
    adagrad_sparse_update(pt, torch.from_numpy(ids), torch.from_numpy(rows),
                          lr=0.05)
    assert PL.KERNEL_LAUNCHES["runsum"] == before     # CPU: plain version
    assert shadow_consistent(pt)
    np.testing.assert_array_equal(
        pt.shadow.numpy(), pt.master.numpy().astype(np.float16))
    untouched = np.setdiff1d(np.arange(V), ids)
    np.testing.assert_array_equal(pt.master.numpy()[untouched],
                                  master[untouched])
    _assert_close(pt.master.numpy(), jt.master, 1e-6, 0, "master")
    _assert_close(pt.accum.numpy(), jt.accum, 1e-5, 1e-6, "accum")


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(1)
    p = {"a": rng.standard_normal((4, 5)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = JO.adamw_init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ps = adamw_init(pp)
    for i in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        jp, js = JO.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp, weight_decay=0.1)
        ps = adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                          ps, pp, weight_decay=0.1)
    assert ps.count == int(js.count) == 3
    for k in p:
        _assert_close(pp[k].numpy(), jp[k], 1e-6, 1e-6, k)
        _assert_close(ps.mu[k].numpy(), js.mu[k], 1e-7, 1e-6, k)
        _assert_close(ps.nu[k].numpy(), js.nu[k], 1e-7, 1e-6, k)


def test_loader_and_load_balance_match_reference():
    jb = list(_loader(JLoader, JSynth, 600).batches(4))
    pb = list(_loader(PLoader, PSynth, 600).batches(4))
    for a, b in zip(jb, pb):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    rng = np.random.default_rng(2)
    for _ in range(10):
        lens = rng.integers(1, 500, int(rng.integers(3, 30))).tolist()
        G = int(rng.integers(1, 5))
        assert (JLB.fixed_batches(lens, G, 4)
                == PLB.fixed_batches(lens, G, 4))
        budget = int(np.ceil(sum(lens) / G))
        a = JLB.token_aware_batches(lens, G, budget)
        assert a == PLB.token_aware_batches(lens, G, budget)
        np.testing.assert_array_equal(JLB.sample_count_weights(a),
                                      PLB.sample_count_weights(a))


def test_host_unique_candidates_match_reference():
    batch = _batches(600, 1)[0]
    for a, b in zip(JT.host_unique_candidates(batch, 600),
                    host_unique_candidates(batch, 600)):
        np.testing.assert_array_equal(a, b)


def test_shadow_strip_and_rebuild():
    m = torch.randn(10, 4)
    t = ShadowedTable(m, m.half(), torch.zeros(10, 4))
    s = strip_shadow(t)
    assert s.shadow.shape == (0, 4) and s.shadow.dtype == torch.float16
    assert torch.equal(rebuild_shadow(t._replace(shadow=s.shadow)).shadow,
                       m.half())
    assert strip_shadow(t._replace(shadow=None)).shadow is None
