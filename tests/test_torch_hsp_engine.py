"""The training step and ``GREngine`` over a sharded table (``hsp``) in
worlds of 1, 2 and 4 gloo rank processes on the CPU (meshes (1, 1),
(1, 2), (2, 2)): 3 sync + 3 τ=1 flat steps from one converted init on the
global batches of the port's ``GRLoader(num_devices=world)`` (each rank
trains its pack), against the reference's ``make_gr_train_step`` on the
same global batches and against the port's single-process step on them;
``GREngine`` in both schedules bit for bit the flat τ=1 step on every rank.
The same at ``expansion`` 2 (§4.3.3 logit sharing, the pool the global
batch's) at three segments of the 64-token packs: 32 (aligned), 48 (a
segment straddles two ranks' packs: its tokens travel to the rank that
holds its first one) and 128 (larger than a pack: some ranks own no
segment); against the reference with its perms injected, and each
exchange's bytes against the count the layout gives.

Tolerances. Against the port's single process: the training slice's fp32
ones (``test_torch_training.TOLS``, the reasons there): the ranks sum the
loss, its valid count and the dense grads in rank order where one process
sums them over the whole batch, a few ulps apart (measured at most 2e-6 on
a param, 1.1e-5 on an accumulator). A world of one is held to it bit for
bit (its exchanges send each rank's pairs to itself). Against the
reference: the limits the port's single process itself needs on these
batches (the world of one is bit for bit that process; measured: master
3.2e-4 at 16 elements, accumulator 4.3e-4, a param 5.4e-5, moments 1.8e-6
and 1.3e-8), because AdaGrad's and AdamW's first steps, −lr·g/√(g² + ε)
and lr·m/√v, move an element whose grad is near zero by up to lr (4e-3)
on a few ulps of its grad: 32 master elements a table and 2 params a leaf
may exceed the fp32 limits by up to one lr step, the moments are held to
1e-4 of their largest values and the accumulators (up to ~25) to 1e-3;
the carry's rows are grads taken through those master rows, so 128 of
their elements may exceed 5e-5, by up to 1e-3 (measured 1.7e-4 at 66 of
63232).

At ``expansion`` 2 the reference's perms are injected (declared divergence
"RNG draws": the port draws its own from a torch generator), and each
case is held to ``TOL`` (against the single process) and ``TOL_REF``
(against the reference) but one. Sharing couples each token's loss to
another's logits, and one configuration's trajectory turns chaotic at the
ulp: world 2, segment 128 (both packs in one segment). There a one-ulp
change of one table row of the init moves the port's single process by
1.9e-5 in its losses, by 2.2e-5 in mu, 1.9e-4 at 92 master elements,
1.5e-3 in the accumulators and 8.6e-4 at 538 carried elements over the 6
steps, and the ranks lie that far from the reference (losses 2.3e-5, mu
2.9e-5, nu 1.1e-7, master 2.8e-4 at 111 elements, accumulators 1.9e-3,
carried rows 1.0e-3 at 674) and 1.3e-5 at 2 master elements from the
single process; so that case alone is held to ``TOL_SHARE`` (``TOL`` with
the master's AdaGrad outliers of ``TOL_REF``) and ``TOL_REF_SHARE``
(about twice the readings). The other cases lie within ``TOL``/``TOL_REF``
(largest readings: ranks vs single 1.8e-5 on a param and 9.4e-6 on the
master at world 4, segment 48; ranks vs reference mu 4.2e-6, master 13
and carried rows 77 elements over the fp32 limits at world 4, segment 48,
where a one-ulp change moves mu by 7.3e-6). All readings are
``scripts/share_sensitivity.py``'s (CPU, fp32). The first step's table
grads agree with the reference's to 4e-7 of their largest.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.neg_logits.ops import make_share_perms as j_perms
from repro.models.model_zoo import get_bundle as j_bundle
from repro.training import trainer as JT
from repro_torch.convert import (adamw_to_numpy, gr_params_from_numpy,
                                 gr_params_to_numpy, shard_table_state,
                                 unshard_table_states)
from repro_torch.data import GRLoader as PLoader
from repro_torch.data import SyntheticKuaiRand as PSynth
from repro_torch.kernels.neg_logits import share_layout
from repro_torch.launch import mesh as M
from repro_torch.models.model_zoo import GRBundle
from repro_torch.training import (AdamWState, GREngine, gr_train_state,
                                  make_gr_step_fn, to_device)
from test_torch_training import TOLS, Tol, _assert_close, _assert_trees
from torch_parity import configs, tree_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
SEG, R, N, VOCAB = 32, 8, 3, 600
CAP = 64                          # tokens a pack: 2 users x 32 events
LK = dict(neg_segment=SEG, fetch_dtype=None)
SHAPES = {1: (1, 1), 2: (1, 2), 4: (2, 2)}
#: logit sharing's segments: aligned with the pack, straddling two packs,
#: larger than a pack
SHARE_SEGMENTS = (32, 48, 128)
LR = 4e-3
TOL = TOLS["fp32"]
TOL_REF = dict(TOL, dense=Tol(TOL["dense"], 2, LR), mu=5e-6, nu=5e-8,
               master=Tol(TOL["master"], 32, LR), accum=1e-3,
               rows=Tol(TOL["rows"], 128, 1e-3))
TOL_SHARE = dict(TOL, master=TOL_REF["master"])
TOL_REF_SHARE = dict(TOL_REF, loss=5e-5, mu=5e-5, nu=2e-7,
                     master=Tol(TOL["master"], 256, LR), accum=3e-3,
                     rows=Tol(TOL["rows"], 1024, 2e-3))
#: (world, segment) -> the sharing case's limits (against the single
#: process, against the reference) where they are not (TOL, TOL_REF): the
#: one configuration chaotic at the ulp (readings in the docstring)
SHARE_TOLS = {(2, 128): (TOL_SHARE, TOL_REF_SHARE)}


def _share_tols(world, seg):
    return SHARE_TOLS.get((world, seg), (TOL, TOL_REF))


def _batches(world, n):
    gen = PSynth(num_users=60, num_items=VOCAB, mean_len=30, max_len=80,
                 seed=3)
    seqs = {u: (d["item"], d["ts"]) for u, d in
            ((u, gen.interactions(u)) for u in range(60))}
    return list(PLoader(seqs, num_devices=world, users_per_device=2,
                        max_seq_len=32, num_negatives=R, num_items=VOCAB,
                        seed=4).batches(n))


def _ref_perms(batches, world, seg):
    """The reference's sharing perms of each global batch: what its
    flattened loss draws from the batch's key."""
    n_seg = -(-world * CAP // seg)
    return [np.asarray(j_perms(jax.random.PRNGKey(b["rng"][0]), n_seg, seg,
                               2)) for b in batches]


def _start(tmp, world):
    """Write the inputs of a world of ``world`` ranks and start its
    processes; (what the test compares with, the processes, where their
    results go)."""
    cj, cp = configs("float32", n_items=VOCAB, max_seq_len=32)
    cj, cp = cj.replace(num_negatives=R), cp.replace(num_negatives=R)
    key = jax.random.PRNGKey(0)
    jb = j_bundle(cj)
    dense, table = jb.init_dense(key), np.asarray(jb.init_table(key))
    batches = _batches(world, 2 * N)
    z = dict(arch="hstu-tiny", dense=tree_numpy(dense), master=table,
             batches=batches, n=N, engine_steps=4,
             loss_kwargs=LK, overrides=dict(vocab_size=VOCAB, max_seq_len=32,
                                            dtype="float32",
                                            num_negatives=R),
             share={seg: _ref_perms(batches, world, seg)
                    for seg in SHARE_SEGMENTS})
    run_dir = os.path.join(tmp, f"w{world}")
    os.makedirs(run_dir)
    path = os.path.join(run_dir, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(z, f)
    out = os.path.join(run_dir, "out{rank}.pkl")
    procs = M.spawn_ranks("torch_hsp_ranks:engine_cases",
                          dict(inputs=path, out=out), shape=SHAPES[world],
                          run_dir=run_dir, device="cpu", timeout_s=60,
                          sys_path=[HERE])
    return dict(cj=cj, cp=cp, dense=dense, table=table, z=z), procs, out


def _collect(w, procs, out):
    world = len(procs)
    rcs = M.wait_ranks(procs, 300)
    assert rcs == [0] * world, M.rank_logs(os.path.dirname(out), world)
    w["res"] = []
    for r in range(world):
        with open(out.format(rank=r), "rb") as f:
            w["res"].append(pickle.load(f))
    return w


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds, run side by side."""
    tmp = str(tmp_path_factory.mktemp("hsp_engine"))
    started = {w: _start(tmp, w) for w in SHAPES}
    return {w: _collect(*s) for w, s in started.items()}


def _full(res, world):
    """The full state from the ranks' shards (``convert``'s join)."""
    return unshard_table_states(res, SHAPES[world])


def _reference(w, seg=SEG, expansion=1):
    cj, z = w["cj"], w["z"]
    b = j_bundle(cj)
    state = JT.gr_train_state(w["dense"], jnp.asarray(w["table"]),
                              qdtype=None, pending_slots=JT.gr_pending_slots(
                                  z["batches"][0]))
    losses = []
    for i, batch in enumerate(z["batches"]):
        if i in (0, N):
            step = jax.jit(JT.make_gr_train_step(
                lambda d, t, bt, **kw: b.loss(d, t, bt, neg_mode="fused",
                                              neg_segment=seg,
                                              expansion=expansion,
                                              fetch_dtype=None, **kw),
                semi_async=i >= N, input_gather=b.input_gather))
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()
                                if k != "weights"})
        losses.append(float(m["loss"]))
    return state, losses


def _single(w, steps=None, engine=None, seg=None):
    """The port's single-process flat step (or ``engine``, a schedule) on
    the global batches from the same init; with ``seg``, at expansion 2
    and that segment, the flat step on the batches with the reference's
    perms (the engine on its own draws)."""
    cp, z = w["cp"], w["z"]
    b = GRBundle(cp)
    st = gr_train_state(gr_params_from_numpy(z["dense"], cp, device=CPU),
                        torch.from_numpy(w["table"].copy()), qdtype=None)
    lk, batches = LK, z["batches"]
    if seg is not None:
        lk = dict(LK, neg_segment=seg, expansion=2)
        if engine is None:
            batches = [dict(bt, share_perms=p)
                       for bt, p in zip(batches, z["share"][seg])]
    if engine is not None:
        eng = GREngine(b, lambda i: batches[i], state=st,
                       loss_kwargs=lk, schedule=engine)
        return eng.state, [r["loss"] for r in eng.run(steps)]
    losses = []
    for i, batch in enumerate(batches):
        if i in (0, N):
            step = make_gr_step_fn(b, loss_kwargs=lk, semi_async=i >= N)
        st, m = step(st, to_device(batch, CPU))
        losses.append(float(m["loss"]))
    return st, losses


def _check_reference(w, world, flats, seg=SEG, expansion=1, tol=TOL_REF):
    """The ranks' flat runs against the reference trainer on the global
    batch: losses, dense params, AdamW moments, master, accumulator and
    the τ=1 carry as (id, row) pairs."""
    js, jl = _reference(w, seg, expansion)
    got = _full([f["state"] for f in flats], world)
    for f in flats:
        np.testing.assert_allclose(f["losses"], jl, rtol=0,
                                   atol=tol["loss"])
    _assert_trees(_tree(w, got["dense"]), tree_numpy(js.dense),
                  tol["dense"], 0, "dense")
    opt = adamw_to_numpy(AdamWState(
        *({n: torch.from_numpy(v) for n, v in got[k].items()}
          for k in ("mu", "nu")), got["count"]))
    assert opt["count"] == int(js.dense_opt.count) == 2 * N
    _assert_trees(opt["mu"], tree_numpy(js.dense_opt.mu), tol["mu"], 0,
                  "adamw mu")
    _assert_trees(opt["nu"], tree_numpy(js.dense_opt.nu), tol["nu"], 0,
                  "adamw nu")
    _assert_close(got["master"], js.table.master, tol["master"], 0,
                  "master")
    _assert_close(got["accum"], js.table.accum, tol["accum"], 0, "accum")
    jids = np.asarray(js.pending_ids)
    keep = jids >= 0
    order = np.argsort(jids[keep], kind="stable")
    np.testing.assert_array_equal(got["pending_ids"], jids[keep][order])
    _assert_close(got["pending_rows"], np.asarray(js.pending_rows)[keep][
        order], tol["rows"], 0, "pending rows")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_hsp_train_steps_match_reference(worlds, world):
    """3 sync + 3 τ=1 steps over the sharded table against the reference
    trainer on the global batch."""
    w = worlds[world]
    _check_reference(w, world, [r["flat"] for r in w["res"]])


def _tree(w, named):
    """Named dense params (numpy) → the reference's init_gr tree."""
    model = gr_params_from_numpy(w["z"]["dense"], w["cp"], device=CPU)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(named[n]))
    return gr_params_to_numpy(model)


def _check_single(w, world, flats, seg=None, tol=TOL):
    """The ranks' flat runs against the port's single-process step on the
    same global batches: bit for bit at world 1, to the fp32 tolerances
    beyond."""
    st, losses = _single(w, seg=seg)
    got = _full([f["state"] for f in flats], world)
    want = dict(master=st.table.master.numpy(),
                accum=st.table.accum.numpy(),
                pending_ids=st.pending_ids.numpy(),
                pending_rows=st.pending_rows.detach().numpy())
    mine = {n: p.detach().numpy() for n, p in st.dense.named_parameters()}
    opt = adamw_to_numpy(st.dense_opt)
    if world == 1:
        assert flats[0]["losses"] == losses
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        for n, v in mine.items():
            np.testing.assert_array_equal(got["dense"][n], v, err_msg=n)
        for k in ("mu", "nu"):
            for n, v in getattr(st.dense_opt, k).items():
                np.testing.assert_array_equal(got[k][n], v.numpy(),
                                              err_msg=f"{k} {n}")
        assert got["count"] == opt["count"]
        return
    for f in flats:
        np.testing.assert_allclose(f["losses"], losses, rtol=0,
                                   atol=tol["loss"])
    for n, v in mine.items():
        _assert_close(got["dense"][n], v, tol["dense"], 0, n)
    _assert_close(got["master"], want["master"], tol["master"], 0, "master")
    _assert_close(got["accum"], want["accum"], tol["accum"], 0, "accum")
    np.testing.assert_array_equal(got["pending_ids"], want["pending_ids"])
    _assert_close(got["pending_rows"], want["pending_rows"], tol["rows"], 0,
                  "pending rows")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_hsp_train_steps_match_single_process(worlds, world):
    """Against the port's single-process step on the same global batches:
    bit for bit at world 1, to the fp32 tolerances beyond."""
    w = worlds[world]
    _check_single(w, world, [r["flat"] for r in w["res"]])


def _check_engine(w, world, engines, seg=None):
    """``GREngine`` (algorithm1 and flat, τ=1) on every rank equals the
    flat τ=1 step bit for bit (losses and every state tensor); every rank
    reports the same global losses; at world 1 the losses are the
    single-process engine's, beyond it within the fp32 loss tolerance."""
    ref = engines[0]["losses"]
    for e in engines:
        assert e["losses"] == ref
        for sched in ("algorithm1", "flat"):
            assert e[sched]["bitwise"], (sched, e[sched]["losses"], ref)
    _, single = _single(w, steps=4, engine="algorithm1", seg=seg)
    if world == 1:
        assert ref == single
    else:
        np.testing.assert_allclose(ref, single, rtol=0, atol=TOL["loss"])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_hsp_engine_schedules_match_flat_step(worlds, world):
    """``GREngine`` in both schedules on every rank bit for bit the flat
    τ=1 step; the dense replicas were checked every step."""
    w = worlds[world]
    _check_engine(w, world, [r["engine"] for r in w["res"]])
    for r in w["res"]:
        if world > 1:
            assert r["checks"]["dense"] >= 2 * N + 3 * 4
    if world == 4:
        assert all(r["checks"]["table"] > 0 for r in w["res"])


SHARE_CASES = [(world, seg) for world in (1, 2, 4) for seg in SHARE_SEGMENTS]


@pytest.mark.parametrize("world,seg", SHARE_CASES)
def test_hsp_sharing_matches_single_process(worlds, world, seg):
    """Expansion 2 over the sharded table, the reference's perms given as
    ``share_perms``: bit for bit the single process at world 1 (losses
    and every state tensor), within ``TOL`` at 2 and 4 (``TOL_SHARE`` at
    world 2, segment 128)."""
    w = worlds[world]
    _check_single(w, world, [r["share"][seg]["flat"] for r in w["res"]],
                  seg=seg, tol=_share_tols(world, seg)[0])


@pytest.mark.parametrize("world,seg", [(world, seg) for world in (2, 4)
                                       for seg in SHARE_SEGMENTS])
def test_hsp_sharing_matches_reference(worlds, world, seg):
    """Expansion 2 over 2 and 4 ranks against the reference trainer's
    flattened draw (its perms injected), within ``TOL_REF``
    (``TOL_REF_SHARE`` at world 2, segment 128)."""
    w = worlds[world]
    _check_reference(w, world, [r["share"][seg]["flat"] for r in w["res"]],
                     seg=seg, expansion=2, tol=_share_tols(world, seg)[1])


@pytest.mark.parametrize("world,seg", SHARE_CASES)
def test_hsp_sharing_engine_matches_flat_step(worlds, world, seg):
    """Expansion 2, the perms drawn by the loss: ``GREngine`` in both
    schedules bit for bit the flat τ=1 step on every rank, and the
    single-process engine's losses (bit for bit at world 1)."""
    w = worlds[world]
    _check_engine(w, world, [r["share"][seg]["engine"] for r in w["res"]],
                  seg=seg)


@pytest.mark.parametrize("world,seg", SHARE_CASES)
def test_hsp_sharing_exchange_bytes(worlds, world, seg):
    """Each rank's ``share_tokens`` bytes are its straddling tokens' (o
    row fp32, positive logit, valid flag, R int32 ids) and its
    ``share_grads`` bytes the borrowed tokens' grads (dout fp32, dpos),
    each 2N steps; zero when the pack is a segment multiple or the world
    one rank. The layout puts every token in one segment, computed once."""
    w = worlds[world]
    d = w["cp"].d_model
    borrowed = 0
    for r in w["res"]:
        lay = share_layout(world, r["rank"], CAP, seg)
        stats = r["share"][seg]["stats"]
        got = {k: stats.get(k, {}).get("bytes", 0)
               for k in ("share_tokens", "share_grads")}
        moves = world > 1 and CAP % seg != 0
        want = dict(share_tokens=2 * N * lay.keep * (4 * d + 8 + 4 * R)
                    if moves else 0,
                    share_grads=2 * N * lay.borrow * (4 * d + 4)
                    if moves else 0)
        assert got == want, (r["rank"], lay, got, want)
        borrowed += lay.borrow
        sent = sum(share_layout(world, q, CAP, seg).keep
                   for q in range(world)
                   if share_layout(world, q, CAP, seg).owner == r["rank"]
                   and q != r["rank"])
        assert lay.borrow == sent
    assert sum(share_layout(world, q, CAP, seg).seg_hi
               - share_layout(world, q, CAP, seg).seg_lo
               for q in range(world)) == -(-world * CAP // seg)
    if seg == 48 and world > 1:
        assert borrowed > 0
    if seg == 128 and world > 1:
        assert any(share_layout(world, q, CAP, seg).seg_lo
                   == share_layout(world, q, CAP, seg).seg_hi
                   for q in range(world))


def test_shard_and_unshard_round_trip(worlds):
    """``convert``'s split of the reference's full state into each rank's
    part on (1, 2) and (2, 2) meshes and the join back give the same
    arrays; a part holds its shard's rows and carry (relative ids)."""
    js, _ = _reference(worlds[2])
    full = dict(master=np.asarray(js.table.master),
                accum=np.asarray(js.table.accum),
                pending_ids=np.asarray(js.pending_ids),
                pending_rows=np.asarray(js.pending_rows), step=6)
    keep = full["pending_ids"] >= 0
    for shape in ((1, 2), (2, 2), (1, 4)):
        parts = [shard_table_state(full, r, shape)
                 for r in range(int(np.prod(shape)))]
        back = unshard_table_states(parts, shape)
        np.testing.assert_array_equal(back["master"], full["master"])
        np.testing.assert_array_equal(back["accum"], full["accum"])
        order = np.argsort(full["pending_ids"][keep], kind="stable")
        np.testing.assert_array_equal(back["pending_ids"],
                                      full["pending_ids"][keep][order])
        np.testing.assert_array_equal(back["pending_rows"],
                                      full["pending_rows"][keep][order])
        assert back["step"] == 6
        for p in parts:
            assert p["master"].shape[0] == VOCAB // shape[1]
            assert (p["pending_ids"] < VOCAB // shape[1]).all()
