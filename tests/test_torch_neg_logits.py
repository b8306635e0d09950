"""The §4.3 / Table-7 ablation's negative paths against the JAX package: the
logits over materialised rows (K9's plain version through its autograd
Function) against the Pallas kernel in interpret mode, values and both
grads; ``neg_logits_baseline``/``_segmented``, ``share_logits`` (with the
reference's draws injected) and ``recall_loss``; ``GRBundle.loss`` in the
baseline and segmented modes, with and without sharing and a bound
``lookup_fn``; one train step per mode, sync and τ=1, against the
reference's; the engine's bitwise contract in those modes; and the CLI's
``--neg-mode baseline|segmented``. K9 itself is held against the plain
version on the card in tests/test_torch_gpu.py."""
import contextlib
import io
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import negative_sampling as JNS
from repro.kernels.jagged_lookup import ops as JLK
from repro.kernels.neg_logits.ops import neg_logits as j_neg_logits
from repro.kernels.neg_logits.ref import neg_logits_ref as j_neg_logits_ref
from repro.models.model_zoo import get_bundle as j_bundle
from repro.training import trainer as JT
from repro_torch.convert import (gr_params_from_numpy, gr_params_to_numpy,
                                 pending_to_numpy, shadowed_table_from_numpy,
                                 table_to_numpy)
from repro_torch.core import negative_sampling as PNS
from repro_torch.kernels import jagged_lookup as PL
from repro_torch.kernels import neg_logits as NL
from repro_torch.kernels.jagged_lookup import jagged_lookup
from repro_torch.launch import train as cli
from repro_torch.models.model_zoo import GRBundle
from repro_torch.training import (GREngine, clone_state, gr_train_state,
                                  make_gr_step_fn, make_gr_train_step,
                                  state_tensors, to_device)
from test_torch_training import Tol, _assert_close, _assert_trees, _batches
from torch_parity import configs, to_f32, tree_numpy

CPU = torch.device("cpu")
SEG = 32
R = 8


# --------------------------------------------------------------------------
# K9: the op against the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------

def _k9_inputs(seed, T, R_, D, n_dtype):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((T, D)).astype(np.float32) * 0.5
    n = (rng.standard_normal((T, R_, D)) * 0.3).astype(np.float32)
    g = rng.standard_normal((T, R_)).astype(np.float32)
    jn = jnp.asarray(n).astype(n_dtype)
    pn = torch.from_numpy(n).to({jnp.float32: torch.float32,
                                 jnp.bfloat16: torch.bfloat16,
                                 jnp.float16: torch.float16}[n_dtype])
    return o, jn, pn, g


# fp32: the same products, summed over D (logits, dn exact) or R (do) in
# another order: 1e-5 of O(1) values. Half-precision n: both sides widen
# the same n to fp32 and round dn = g·o/τ once to n's dtype; a product
# that lands within an ulp of a rounding boundary may round the other way
# after the two sides' g·(1/τ) differ in the last fp32 bit, so dn is held
# to one half-precision ulp (2^-8 of bf16, 2^-11 of fp16), relative.
@pytest.mark.parametrize("n_dtype", [jnp.float32, jnp.bfloat16, jnp.float16])
@pytest.mark.parametrize("T,tau", [(64, 1.0), (50, 0.7)])
def test_neg_logits_values_and_grads_match_pallas(n_dtype, T, tau):
    o, jn, pn, g = _k9_inputs(0, T, 6, 24, n_dtype)
    jo = jnp.asarray(o)

    def jloss(oo, nn):
        lg = j_neg_logits(oo, nn, segment=SEG, tau=tau, interpret=True)
        return jnp.sum(lg * g), lg

    (_, jl), (jdo, jdn) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jo, jn)
    po = torch.from_numpy(o).requires_grad_()
    pn = pn.clone().requires_grad_()
    seen = []
    pl = NL.neg_logits(po, pn, segment=SEG, tau=tau, on_neg_grad=seen.append)
    (pl * torch.from_numpy(g)).sum().backward()
    assert pl.dtype == torch.float32 and tuple(pl.shape) == jl.shape
    np.testing.assert_allclose(to_f32(pl), to_f32(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_f32(po.grad), to_f32(jdo), atol=1e-5,
                               rtol=1e-5)
    assert pn.grad.dtype == pn.dtype and po.grad.dtype == torch.float32
    ulp = {jnp.float32: 1e-6, jnp.bfloat16: 2 ** -8,
           jnp.float16: 2 ** -11}[n_dtype]
    np.testing.assert_allclose(to_f32(pn.grad), to_f32(jdn), rtol=ulp,
                               atol=1e-6)
    assert len(seen) == 1 and torch.equal(seen[0], pn.grad)
    np.testing.assert_allclose(
        to_f32(NL.neg_logits_ref(po.detach(), pn.detach(), tau)),
        to_f32(j_neg_logits_ref(jo, jn, tau)), atol=1e-5, rtol=1e-5)


def test_neg_logits_plain_versions_are_the_kernel_arithmetic():
    """The plain K9-bwd takes gs = g·(1/τ) first and rounds dn once: dn
    equals (gs·o) cast bit for bit; do and the logits are the fp32
    sums."""
    from repro_torch.kernels.neg_logits import ref as NR
    o, _, pn, g = _k9_inputs(1, 40, 5, 16, jnp.bfloat16)
    o, g = torch.from_numpy(o), torch.from_numpy(g)
    inv = 1 / 0.7
    do, dn = NR.neg_logits_bwd_plain(o, pn, g, inv_tau=inv)
    gs = g * inv
    assert torch.equal(dn, (gs[:, :, None] * o[:, None, :]).to(torch.bfloat16))
    torch.testing.assert_close(do, torch.einsum("tr,trd->td", gs, pn.float()))
    torch.testing.assert_close(
        NR.neg_logits_fwd_plain(o, pn, inv_tau=inv),
        torch.einsum("td,trd->tr", o, pn.float()) * inv)


# --------------------------------------------------------------------------
# core/negative_sampling.py
# --------------------------------------------------------------------------

def _ns_inputs(seed=3, T=96, R_=R, D=32, V=200):
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((T, D)) * 0.3).astype(np.float32)
    pos = (rng.standard_normal((T, D)) * 0.3).astype(np.float32)
    table = (rng.standard_normal((V, D)) * 0.5).astype(np.float32)
    ids = rng.integers(0, V, (T, R_)).astype(np.int32)
    ids[:4, :2] = 11                                   # repeated ids
    valid = np.ones(T, bool)
    valid[rng.choice(T, 13, replace=False)] = False
    return o, pos, table, ids, valid


def _j_draws(key, T, R_, expansion):
    """The reference's raw draws in share_logits, before the own-block
    skip: per token, randint(k_t, ((k−1)·R,), 0, (T−1)·R)."""
    keys = jax.random.split(key, T)
    return np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, ((expansion - 1) * R_,), 0, (T - 1) * R_))(keys))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("expansion", [1, 3])
def test_share_logits_matches_reference(expansion, masked):
    """With the reference's draws injected the shared logits are the same
    pool entries (exact), and their grads flow back to the source slots;
    generator draws never pick a token's own block."""
    rng = np.random.default_rng(4)
    T, R_ = 20, 4
    lg = rng.standard_normal((T, R_)).astype(np.float32)
    valid = rng.random(T) > 0.3 if masked else None
    key = jax.random.PRNGKey(7)
    jv = None if valid is None else jnp.asarray(valid)
    jout = JNS.share_logits(key, jnp.asarray(lg), expansion, jv)
    draws = (None if expansion == 1
             else torch.from_numpy(_j_draws(key, T, R_, expansion).copy()))
    pl = torch.from_numpy(lg).requires_grad_()
    pv = None if valid is None else torch.from_numpy(valid)
    pout = PNS.share_logits(pl, expansion, pv, draws=draws)
    np.testing.assert_array_equal(to_f32(pout), to_f32(jout))
    gout = rng.standard_normal(pout.shape).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(JNS.share_logits(key, x, expansion, jv)
                                    * gout))(jnp.asarray(lg))
    (pout * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(to_f32(pl.grad), to_f32(jg), atol=1e-6)
    if expansion > 1:
        gen = torch.Generator().manual_seed(0)
        drawn = PNS.share_logits(torch.arange(T * R_, dtype=torch.float32)
                                 .view(T, R_), expansion, generator=gen)
        src = drawn[:, R_:].long() // R_
        assert drawn.shape == (T, expansion * R_)
        assert not (src == torch.arange(T)[:, None]).any()


@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_baseline_and_segmented_logits_match_reference(tau):
    """Both logit paths and their table grads against the reference's
    (fp32 rows: the same sums in another order, 1e-5; segmented fetches
    fp16 rows on both sides and rounds dn to fp16 on both, 1e-5 of the
    summed grads), and the sink's rows form sums to the dense grad."""
    o, _, table, ids, _ = _ns_inputs()
    g = np.random.default_rng(5).standard_normal(ids.shape).astype(np.float32)
    jo, jt, ji = map(jnp.asarray, (o, table, ids))

    def jb(oo, tt):
        return jnp.sum(JNS.neg_logits_baseline(
            oo, jnp.take(tt, ji, axis=0), tau=tau) * g)

    def js(oo, tt):
        return jnp.sum(JNS.neg_logits_segmented(
            oo, tt, ji, segment=SEG, tau=tau, fetch_dtype=jnp.float16) * g)

    for name, jf in (("baseline", jb), ("segmented", js)):
        jval, (jdo, jdt) = jax.value_and_grad(jf, argnums=(0, 1))(jo, jt)
        po = torch.from_numpy(o).requires_grad_()
        pt = torch.from_numpy(table).requires_grad_()
        pi = torch.from_numpy(ids)
        if name == "baseline":
            lg = PNS.neg_logits_baseline(po, pt[pi.long()], tau)
        else:
            lg = PNS.neg_logits_segmented(po, pt, pi, segment=SEG, tau=tau,
                                          fetch_dtype=torch.float16)
        val = (lg * torch.from_numpy(g)).sum()
        val.backward()
        np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
        np.testing.assert_allclose(to_f32(po.grad), to_f32(jdo), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(to_f32(pt.grad), to_f32(jdt), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
        if name == "segmented":
            sink = NL.TableGradSink(extra_rows=2)
            lg2 = PNS.neg_logits_segmented(
                torch.from_numpy(o).requires_grad_(),
                torch.from_numpy(table), pi, segment=SEG, tau=tau,
                fetch_dtype=torch.float16, table_grad_pairs=sink)
            (lg2 * torch.from_numpy(g)).sum().backward()
            assert sink.rows.shape == (ids.size + 2, o.shape[1])
            assert sink.neg is None
            dense = PL.scatter_add_rows(sink.rows[:ids.size], sink.ids,
                                        table.shape[0])
            torch.testing.assert_close(dense, pt.grad, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="multiple of the segment"):
        PNS.neg_logits_segmented(po, pt, pi[:50], segment=SEG)


def test_recall_loss_and_sampling_match_reference():
    o, pos, table, ids, valid = _ns_inputs()
    rng = np.random.default_rng(6)
    lg = rng.standard_normal((o.shape[0], 3 * R)).astype(np.float32)
    for v in (None, valid):
        jl = JNS.recall_loss(jnp.asarray(o), jnp.asarray(pos),
                             jnp.asarray(lg), tau=0.8,
                             valid=None if v is None else jnp.asarray(v))
        pl = PNS.recall_loss(torch.from_numpy(o), torch.from_numpy(pos),
                             torch.from_numpy(lg), tau=0.8,
                             valid=None if v is None else torch.from_numpy(v))
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    ids = PNS.sample_negative_ids(torch.Generator().manual_seed(0),
                                  num_tokens=50, num_negatives=7,
                                  vocab_size=30)
    assert ids.shape == (50, 7) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < 30
    assert len(torch.unique(ids)) > 20


# --------------------------------------------------------------------------
# GRBundle.loss in the new modes
# --------------------------------------------------------------------------

def _j_lookup(dtype):
    def look(t, i):
        flat = JLK.jagged_lookup(t, i.reshape(-1), compute_dtype=dtype,
                                 interpret=True)
        return flat.reshape(*i.shape, t.shape[1])
    return look


def _j_loss_draws(batch, cap, expansion):
    keys = jax.random.split(jax.random.PRNGKey(int(batch["rng"][0])),
                            batch["ids"].shape[0])
    return torch.from_numpy(np.stack([_j_draws(k, cap, R, expansion)
                                      for k in keys]).copy())


@pytest.mark.parametrize("lookup", [False, True])
@pytest.mark.parametrize("expansion", [1, 2])
@pytest.mark.parametrize("mode", ["baseline", "segmented"])
def test_bundle_loss_new_modes_match_reference(mode, expansion, lookup):
    """GRBundle.loss in the baseline and segmented modes (with §4.3.3
    sharing, the reference's draws injected; with the kernel lookup
    bound as ``lookup_fn``) against the reference on one loader batch:
    the loss to 1e-5 (fp32 model, sums in another order) and the table
    grad to 1e-5 of its largest value (fp16 rows round dn once on both
    sides)."""
    cj, cp = configs("float32", n_items=600, max_seq_len=32)
    cj, cp = (c.replace(num_negatives=R) for c in (cj, cp))
    batch = _batches(600, 1)[0]
    key = jax.random.PRNGKey(1)
    jb = j_bundle(cj)
    dense = jb.init_dense(key)
    table = np.asarray(jb.init_table(key))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "weights"}
    jkw = dict(neg_mode=mode, expansion=expansion, neg_segment=SEG)
    pkw = dict(jkw)
    if lookup:
        jkw["lookup_fn"] = _j_lookup(jnp.float32)
        pkw["lookup_fn"] = partial(jagged_lookup,
                                   compute_dtype=torch.float32)
    jl, jg = jax.value_and_grad(
        lambda t: jb.loss(dense, t, jbatch, **jkw))(jnp.asarray(table))
    pb = GRBundle(cp)
    model = gr_params_from_numpy(tree_numpy(dense), cp, device=CPU)
    pt = torch.from_numpy(table.copy()).requires_grad_()
    pbatch = to_device(batch, CPU)
    if expansion > 1:
        pkw["share_draws"] = _j_loss_draws(batch, batch["ids"].shape[1],
                                           expansion)
    pl = pb.loss(model, pt, pbatch, **pkw)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5, atol=1e-5)
    gmax = float(np.abs(to_f32(jg)).max())
    assert np.abs(to_f32(pt.grad) - to_f32(jg)).max() <= 1e-5 * gmax


def test_bundle_loss_modes_agree_and_refuse_unknown():
    """The three modes give one loss on one init (fp32 rows everywhere,
    so baseline = segmented = fused up to summation order), and an
    unknown mode raises."""
    _, cp = configs("float32", n_items=300, max_seq_len=32)
    cp = cp.replace(num_negatives=R)
    pb = GRBundle(cp)
    g = torch.Generator().manual_seed(0)
    model = pb.init_dense(g, device=CPU)
    table = pb.init_table(g, device=CPU)
    batch = to_device(_batches(300, 1)[0], CPU)
    with torch.no_grad():
        losses = {m: float(pb.loss(model, table, batch, neg_mode=m,
                                   neg_segment=SEG, fetch_dtype=None))
                  for m in ("fused", "baseline", "segmented")}
    assert max(losses.values()) - min(losses.values()) <= 1e-5, losses
    with pytest.raises(ValueError, match="neg_mode"):
        pb.loss(model, table, batch, neg_mode="offloaded")


# --------------------------------------------------------------------------
# one train step per mode against the reference
# --------------------------------------------------------------------------

# fp32 model and rows; the reference differentiates the dense master and
# gathers its grad at the candidates, the port sums sparse pairs: the same
# fp32 terms in other orders (see test_torch_training.TOLS). AdamW's first
# step is lr·sign(g) per element, so an element whose grad is near zero
# can move apart by up to lr: up to 2 elements per dense leaf may exceed
# 5e-5, by at most lr (4e-3). AdaGrad's first step, −lr·g/√(g² + 1e-10),
# does the same to a table element whose grad sums to ~1e-5 (the
# segmented mode's fp16 contributions nearly cancelling, summed in
# another order): up to 4 master elements may exceed 1e-5, by at most lr.
STEP_TOL = dict(loss=1e-5, dense=Tol(5e-5, 2, 4e-3),
                master=Tol(1e-5, 4, 4e-3), accum=3e-4, rows=5e-5)


def _ref_step(cj, dense, table, batch, kw, lookup, semi):
    b = j_bundle(cj)
    state = JT.gr_train_state(dense, table, qdtype=jnp.float16,
                              pending_slots=JT.gr_pending_slots(batch))
    step = jax.jit(JT.make_gr_train_step(
        lambda d, t, bt, **k: b.loss(d, t, bt, **kw, **k), semi_async=semi,
        input_gather=None if lookup else b.input_gather))
    nb = {k: jnp.asarray(v) for k, v in batch.items() if k != "weights"}
    state, m = step(state, nb)
    return state, float(m["loss"])


def _port_step(cp, dense_np, table, batch, kw, semi):
    pb = GRBundle(cp)
    model = gr_params_from_numpy(dense_np, cp, device=CPU)
    master = np.asarray(table)
    st = gr_train_state(model, shadowed_table_from_numpy(
        master, master.astype(np.float16), np.zeros_like(master),
        device=CPU))
    step = make_gr_step_fn(pb, loss_kwargs=kw, semi_async=semi)
    st, m = step(st, to_device(batch, CPU))
    return st, float(m["loss"])


@pytest.mark.parametrize("semi", [False, True])
@pytest.mark.parametrize("mode,lookup", [("baseline", False),
                                         ("segmented", False),
                                         ("baseline", True)])
def test_train_step_new_modes_match_reference(mode, lookup, semi):
    """One step of ``make_gr_step_fn`` (the engine's flat step) from one
    init, sync or τ=1, in the baseline / segmented mode, the last case
    with the kernel lookup as ``lookup_fn``, against the reference's: the
    loss, the dense params, the master and accumulator (every row: the
    touched ones moved, the others not) after a sync step, the τ=1 carry
    (ids exactly, rows) after a τ=1 step."""
    cj, cp = configs("float32", n_items=600, max_seq_len=32)
    cj, cp = (c.replace(num_negatives=R) for c in (cj, cp))
    batch = _batches(600, 1)[0]
    key = jax.random.PRNGKey(2)
    jb = j_bundle(cj)
    dense = jb.init_dense(key)
    table = jb.init_table(key)
    jkw = dict(neg_mode=mode, neg_segment=SEG)
    pkw = dict(jkw)
    if lookup:
        jkw["lookup_fn"] = _j_lookup(jnp.float32)
        pkw["lookup_fn"] = partial(jagged_lookup,
                                   compute_dtype=torch.float32)
    jst, jl = _ref_step(cj, dense, table, batch, jkw, lookup, semi)
    pst, pl = _port_step(cp, tree_numpy(dense), table, batch, pkw, semi)
    tol = STEP_TOL
    np.testing.assert_allclose(pl, jl, rtol=0, atol=tol["loss"])
    _assert_trees(gr_params_to_numpy(pst.dense), tree_numpy(jst.dense),
                  tol["dense"], 0, "dense")
    t = table_to_numpy(pst.table)
    _assert_close(t["master"], jst.table.master, tol["master"], 0, "master")
    _assert_close(t["accum"], jst.table.accum, tol["accum"], 0, "accum")
    np.testing.assert_array_equal(t["shadow"], t["master"].astype(np.float16))
    pi, pr = pending_to_numpy(pst.pending_ids, pst.pending_rows)
    ji, jr = pending_to_numpy(torch.from_numpy(np.array(jst.pending_ids)),
                              torch.from_numpy(np.array(jst.pending_rows)))
    np.testing.assert_array_equal(pi, ji)
    assert (pi.size > 0) == semi
    _assert_close(pr, jr, tol["rows"], 0, "pending rows")
    if not semi:
        moved = np.flatnonzero((t["master"] != np.asarray(table)).any(1))
        assert moved.size > 0


@pytest.mark.parametrize("mode", ["baseline", "segmented"])
def test_engine_new_modes_match_flat_step(mode):
    """Inside the port: GREngine in both schedules, τ=1, with the mode,
    sharing and the kernel lookup bound, equals the flat step bit for bit
    (losses and every state tensor, the carry included)."""
    _, cp = configs("bfloat16", n_items=500, max_seq_len=32)
    cp = cp.replace(num_negatives=R)
    b = GRBundle(cp)
    batches = _batches(500, 4)
    lk = dict(neg_mode=mode, neg_segment=SEG, expansion=2,
              lookup_fn=partial(jagged_lookup, compute_dtype=torch.bfloat16))

    def mk_state():
        g = torch.Generator().manual_seed(0)
        return gr_train_state(b.init_dense(g, device=CPU),
                              b.init_table(g, device=CPU))

    step = make_gr_step_fn(b, loss_kwargs=lk)
    ref, losses = mk_state(), []
    for bt in batches:
        ref, m = step(ref, to_device(bt, CPU))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and ref.pending_ids.numel() > 0
    for sched in ("algorithm1", "flat"):
        eng = GREngine(b, lambda i: batches[i], state=mk_state(),
                       loss_kwargs=lk, schedule=sched)
        assert [r["loss"] for r in eng.run(len(batches))] == losses, sched
        for x, y in zip(state_tensors(eng.state), state_tensors(ref)):
            assert torch.equal(x, y), sched


def test_lookup_fn_drops_grads_of_negative_ids():
    """With a bound lookup_fn, slots of ids < 0 read zero rows and pass no
    gradient to any table row (the plain gather would read row V − 1)."""
    _, cp = configs("float32", n_items=300, max_seq_len=32)
    cp = cp.replace(num_negatives=R)
    b = GRBundle(cp)
    g = torch.Generator().manual_seed(1)
    st = gr_train_state(b.init_dense(g, device=CPU),
                        b.init_table(g, device=CPU))
    batch = _batches(300, 1)[0]
    # row 0, where a clipped id −1 would land, is read by no slot
    for k in ("ids", "labels", "neg_ids"):
        batch[k] = np.where(batch[k] == 0, 1, batch[k]).astype(batch[k].dtype)
    batch["ids"] = np.where(np.arange(batch["ids"].shape[1]) % 5 == 0, -1,
                            batch["ids"]).astype(batch["ids"].dtype)
    used = np.unique(np.concatenate([
        batch["ids"][batch["ids"] >= 0], batch["labels"].ravel(),
        batch["neg_ids"].ravel()]))
    before = st.table.master.clone()
    step = make_gr_step_fn(b, loss_kwargs=dict(
        lookup_fn=partial(jagged_lookup, compute_dtype=torch.float32)),
        semi_async=False)
    st, m = step(clone_state(st), to_device(batch, CPU))
    changed = torch.nonzero((st.table.master != before).any(1)).flatten()
    assert np.isfinite(float(m["loss"]))
    assert 0 not in used and len(changed) > 0
    assert set(changed.tolist()) <= set(used.tolist())


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["baseline", "segmented"])
def test_cli_neg_modes_train_on_cpu(mode):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        recs = cli.main(["--device", "cpu", "--arch", "hstu-tiny",
                         "--steps", "12", "--synthetic-users", "300",
                         "--num-items", "3000", "--max-seq-len", "64",
                         "--log-every", "4", "--neg-mode", mode])
    text = out.getvalue()
    assert "[done] 12 steps" in text
    losses = [r["loss"] for r in recs]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0]


@pytest.mark.parametrize("T,R", [(8192, 128), (128, 128), (300, 24),
                                 (70, 5), (1, 128), (512, 256)])
def test_fwd_row_split_fills_the_card_only_where_it_must(T, R):
    """K9-fwd's CTAs per token: 1 at the baseline's T = 8192, more for a
    128-token segment, a power of two, never fewer than NL_FWD_MIN_ROWS
    rows a CTA once split, and no larger than it takes to reach
    NL_FWD_CTAS CTAs."""
    from repro_torch.kernels.neg_logits import ops as NO
    split = NO.fwd_row_split(T, R)
    assert split >= 1 and split & (split - 1) == 0
    if split > 1:
        assert R // split >= NO.NL_FWD_MIN_ROWS
        assert T * (split // 2) < NO.NL_FWD_CTAS
    grows = R >= 2 * split * NO.NL_FWD_MIN_ROWS
    assert T * split >= NO.NL_FWD_CTAS or not grows
    assert {(8192, 128): 1, (128, 128): 4}.get((T, R), split) == split


@pytest.mark.parametrize("T,R", [(8192, 128), (128, 128), (300, 24),
                                 (64, 99), (128, 33), (1, 128), (70, 5)])
def test_bwd_row_split_fills_the_card_only_where_it_must(T, R):
    """K9-bwd's row groups per token: 1 at the baseline's T = 8192 (each
    do summed in r order, as before), more for a 128-token segment, a power
    of two up to NL_BWD_MAX_SPLIT, never fewer than NL_BWD_MIN_ROWS rows a
    group once split, and no larger than it takes to reach NL_BWD_CTAS."""
    from repro_torch.kernels.neg_logits import ops as NO
    split = NO.bwd_row_split(T, R)
    assert split >= 1 and split & (split - 1) == 0
    assert split <= NO.NL_BWD_MAX_SPLIT
    if split > 1:
        assert R // split >= NO.NL_BWD_MIN_ROWS
        assert T * (split // 2) < NO.NL_BWD_CTAS
    grows = (R >= 2 * split * NO.NL_BWD_MIN_ROWS
             and split < NO.NL_BWD_MAX_SPLIT)
    assert T * split >= NO.NL_BWD_CTAS or not grows
    assert {(8192, 128): 1, (128, 128): 4}.get((T, R), split) == split


def _uneven_perms(n_seg, seg, expansion, seed):
    """Per-segment sharing perms that are no permutation: in every slot
    some sources have two or three consumers and others none."""
    rng = np.random.default_rng(seed)
    perms = np.empty((n_seg, expansion - 1, seg), np.int32)
    for s in range(n_seg):
        for e in range(expansion - 1):
            p = (np.arange(seg) + rng.integers(1, seg)) % seg
            c = rng.choice(seg, 4, replace=False)
            p[c[1]] = p[c[0]]                  # a source with two consumers
            p[c[2]] = p[c[3]] = p[c[0]]        # ... or with four
            perms[s, e] = p
    return torch.from_numpy(perms)


@pytest.mark.parametrize("expansion", [1, 2, 3])
def test_neg_bwd_plain_is_the_grad_of_the_plain_lse(expansion):
    """K4's plain version, which the kernel is held to on the card, is the
    gradient of K3's plain version: with perms where sources have several
    consumers or none, and invalid tokens, its dout and dpos equal autograd
    of Σ g·lse through ``neg_fwd_plain``, and its w (each slot's gathered
    row once, distinct ids) gives the table grad w·o/τ. fp32 sums in
    another order: 1e-5 of the largest value."""
    from repro_torch.kernels.neg_logits import ref as NR
    rng = np.random.default_rng(21 + expansion)
    seg, n_seg, R_, D = 16, 2, 4, 8
    Tp = seg * n_seg
    o = torch.from_numpy(rng.standard_normal((Tp, D)).astype(np.float32))
    pos = torch.from_numpy(rng.standard_normal(Tp).astype(np.float32))
    table = torch.from_numpy(
        (rng.standard_normal((Tp * R_, D)) * 0.5).astype(np.float32))
    ids = torch.from_numpy(rng.permutation(Tp * R_).astype(np.int32))
    valid = torch.from_numpy((rng.random(Tp) > 0.25).astype(np.float32))
    g = torch.from_numpy(rng.random(Tp).astype(np.float32))
    perms = (_uneven_perms(n_seg, seg, expansion, 5) if expansion > 1
             else torch.zeros((n_seg, 1, seg), dtype=torch.int32))
    if expansion > 1:
        counts = np.bincount(perms[0, 0].numpy(), minlength=seg)
        assert counts.max() >= 2 and counts.min() == 0
    kw = dict(segment=seg, R=R_, expansion=expansion, inv_tau=1 / 0.8,
              fetch_dtype=None)
    o_, pos_, tb_ = (t.clone().requires_grad_() for t in (o, pos, table))
    lse = NR.neg_fwd_plain(o_, pos_, tb_, ids, valid, perms, **kw)
    (lse * g).sum().backward()
    w, dout, dpos = NR.neg_bwd_plain(o, pos, table, ids, valid, perms,
                                     lse.detach(), g, **kw)
    rows = w[:, :, None] * o[:, None, :] * kw["inv_tau"]
    for got, want in ((dout, o_.grad), (dpos, pos_.grad),
                      (rows.reshape(-1, D), tb_.grad[ids.long()])):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-5 * scale

