"""The port's continuous-batching serving against the JAX package, on the
CPU (the kernels' plain versions): the bucket ladder, the compile cache,
the slot buffer's invariants, the continuous scheduler's typed admission
and tick formation (each also against the reference's on the same
operations), the port's own bitwise contract (chained warm appends equal
a from-scratch cold encode, a 1-wide append and a ring wraparound
included), and the streaming engine against the reference's streaming
engine and against the port's ``RecallEngine`` on the same traces.

Tolerances: the port's engine and the reference's run the same fp32
arithmetic in other orders (K1-fwd's 128-key tiles against XLA's blocked
scan), so embeddings and scores agree to 1e-4, and every item that scores
clearly above the (k+1)-th (by 4e-4) is in both top-k lists. Against the
port's ``RecallEngine`` the same limits hold: the two place a user at other
offsets of a pack, so K1-fwd sums its keys in other tiles."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as j_reduced
from repro.embedding.tables import make_shadowed as j_make_shadowed
from repro.models.model_zoo import get_bundle as j_get_bundle
from repro.serving import ContinuousScheduler as JSched
from repro.serving import SequenceBuffer as JBuffer
from repro.serving import StreamingRecallEngine as JStream
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import gr_params_from_numpy, table_from_numpy
from repro_torch.kernels.jagged_attention import ops as attn_ops
from repro_torch.models import gr as PG
from repro_torch.serving import (BucketLadder, CompileCache,
                                 ContinuousScheduler, RecallEngine,
                                 SequenceBuffer, StreamingRecallEngine)
from torch_parity import CPU, tree_numpy

EMB_TOL = 1e-4
SCORE_TOL = 1e-4


# --------------------------------------------------------------------------
# bucket ladder / compile cache
# --------------------------------------------------------------------------

def test_bucket_ladder_rounds_up_within_bound():
    lad = BucketLadder(48)
    assert lad.rungs == (1, 2, 4, 8, 16, 32, 48)
    assert lad.bucket(1) == 1 and lad.bucket(3) == 4
    assert lad.bucket(33) == 48 and lad.bucket(48) == 48
    with pytest.raises(ValueError):
        lad.bucket(49)
    assert BucketLadder(64, min_size=2).rungs == (2, 4, 8, 16, 32, 64)


def test_compile_cache_counts_distinct_shape_keys():
    cc = CompileCache()
    builds = []
    fn = lambda: builds.append(1) or (lambda: None)     # noqa: E731
    cc.get("cold", (8,), fn)
    cc.get("cold", (8,), fn)
    cc.get("cold", (16,), fn)
    cc.get("warm", (8, 4), fn)
    assert cc.compiles == 3 and cc.calls == 4 and len(builds) == 3
    assert cc.stats()["per_fn"] == {"cold": 2, "warm": 1}


# --------------------------------------------------------------------------
# slot buffer
# --------------------------------------------------------------------------

def _buf(n=4, s=8, d=4, kv=False):
    return SequenceBuffer(n, s, d, kv_shape=(2, 2, 3, 3) if kv else None)


def test_slot_alloc_free_partition_and_eviction_handshake():
    b = _buf(n=2)
    s0 = b.alloc(10)
    s1 = b.alloc(11)
    assert {s0, s1} == {0, 1} and b.slots_used == 2
    assert b.alloc(12, evict=False) is None
    b.touch(s1)
    s2 = b.alloc(12)
    assert s2 == s0 and b.slot_of(10) is None
    assert b.take_evicted(10) and not b.take_evicted(10)
    assert b.alloc(13, busy={s1, s2}) is None
    b.release(12)
    assert b.slot_of(12) is None and not b.take_evicted(12)
    assert b.slots_used == 1


def test_append_ring_semantics_and_version():
    b = _buf(n=1, s=4)
    s = b.alloc(7)
    b.seed(s, [1, 2], [10, 20])
    v0 = int(b.version[s])
    assert b.needs_cold[s] and int(b.length[s]) == 2
    b.mark_encoded(s)
    assert b.emb_fresh(s) and not b.needs_cold[s]
    b.append(s, [3], [30])
    assert int(b.version[s]) == v0 + 1 and not b.needs_cold[s]
    assert b.pending_new(s) == 1 and not b.emb_fresh(s)
    b.append(s, [4, 5], [40, 50])
    np.testing.assert_array_equal(b.h_ids[s], [2, 3, 4, 5])
    np.testing.assert_array_equal(b.h_ts[s], [20, 30, 40, 50])
    assert b.needs_cold[s] and int(b.length[s]) == 4
    b.append(s, [6, 7, 8, 9, 10], [60, 70, 80, 90, 100])
    np.testing.assert_array_equal(b.h_ids[s], [7, 8, 9, 10])


def test_warm_eligibility_guards_window_overflow():
    b = _buf(n=1, s=8, kv=True)
    s = b.alloc(1)
    b.seed(s, [1, 2, 3], [1, 2, 3])
    assert not b.warm_eligible(s, 1)
    b.mark_encoded(s)
    assert b.warm_eligible(s, 4) and b.warm_eligible(s, 5)
    assert not b.warm_eligible(s, 6)
    bn = _buf(n=1, s=8, kv=False)
    sn = bn.alloc(1)
    bn.seed(sn, [1], [1])
    bn.mark_encoded(sn)
    assert not bn.warm_eligible(sn, 1)


def test_topk_cache_is_version_stamped():
    b = _buf(n=1)
    s = b.alloc(1)
    b.seed(s, [1], [1])
    b.store_topk(s, np.arange(3), np.ones(3))
    assert b.topk(s) is not None
    b.append(s, [2], [2])
    assert b.topk(s) is None


def test_kv_cache_layout_is_layer_first_and_tile_padded():
    b = SequenceBuffer(3, 200, 8, kv_shape=(2, 4, 16, 16))
    assert tuple(b.kv_k.shape) == (2, 4, 256, 4, 16)
    assert b.kv_k[1].is_contiguous()
    assert not b.kv_k.any() and not b.kv_v.any()
    ref = JBuffer(3, 200, 8, kv_shape=(2, 4, 16, 16))
    assert b.stats()["device_bytes"] == ref.device_bytes + 2 * 2 * 4 * 56 \
        * 4 * 16 * 2


def test_slot_buffer_matches_reference_on_random_ops():
    """The same random alloc / release / seed / append / encode sequence
    through both packages' buffers leaves the same host state after every
    operation (slot map, lengths, versions, mirrors, eviction handshake)."""
    rng = np.random.default_rng(0)
    pb = SequenceBuffer(3, 8, 4, kv_shape=(1, 1, 2, 2))
    jb = JBuffer(3, 8, 4, kv_shape=(1, 1, 2, 2))
    for _ in range(300):
        op = rng.choice(["alloc", "release", "seed", "append", "encode",
                         "evicted"])
        user, n = int(rng.integers(0, 8)), int(rng.integers(1, 7))
        ids = rng.integers(1, 50, n)
        for b in (pb, jb):
            slot = b.slot_of(user)
            if op == "alloc" and slot is None:
                s = b.alloc(user, busy={0} if n == 1 else ())
                if s is not None:
                    b.seed(s, ids, ids)
            elif op == "release" and slot is not None:
                b.release(user)
            elif op == "seed" and slot is not None:
                b.seed(slot, ids, ids)
            elif op == "append" and slot is not None:
                b.append(slot, ids, ids)
            elif op == "encode" and slot is not None:
                b.mark_encoded(slot)
        if op == "evicted":
            assert pb.take_evicted(user) == jb.take_evicted(user)
        for f in ("h_ids", "h_ts", "user", "length", "version", "enc_len",
                  "enc_version", "needs_cold", "last_used"):
            np.testing.assert_array_equal(getattr(pb, f), getattr(jb, f), f)
        assert pb._slot_of == jb._slot_of and pb._free == jb._free
        assert pb.evictions == jb.evictions
        for s in range(3):
            assert pb.warm_eligible(s, 2) == jb.warm_eligible(s, 2)
            assert pb.emb_fresh(s) == jb.emb_fresh(s)


def test_slot_alloc_free_version_properties():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(ops=st.lists(
        st.tuples(st.sampled_from(["alloc", "release", "seed",
                                   "append", "encode"]),
                  st.integers(0, 9), st.integers(1, 6)),
        min_size=1, max_size=60))
    def prop(ops):
        b = SequenceBuffer(3, 8, 4, kv_shape=(1, 1, 2, 2))
        last_version = {}
        for op, user, n in ops:
            slot = b.slot_of(user)
            if op == "alloc" and slot is None:
                b.take_evicted(user)
                s = b.alloc(user)
                if s is not None:
                    b.seed(s, np.arange(n) + 1, np.arange(n) + 1)
            elif op == "release" and slot is not None:
                b.release(user)
            elif op == "seed" and slot is not None:
                b.seed(slot, np.arange(n) + 1, np.arange(n) + 1)
            elif op == "append" and slot is not None:
                b.append(slot, np.arange(n) + 1, np.arange(n) + 1)
            elif op == "encode" and slot is not None:
                b.mark_encoded(slot)
            live = dict(b._slot_of)
            assert len(set(live.values())) == len(live)
            assert (set(live.values()) | set(b._free)
                    == set(range(b.max_users)))
            assert not (set(live.values()) & set(b._free))
            for u, s in live.items():
                assert 0 < int(b.length[s]) <= b.max_seq_len
                if u in last_version and last_version[u][1] == s:
                    assert int(b.version[s]) >= last_version[u][0]
                last_version[u] = (int(b.version[s]), s)
                if b.emb_fresh(s):
                    assert int(b.enc_len[s]) == int(b.length[s])

    prop()


# --------------------------------------------------------------------------
# continuous scheduler
# --------------------------------------------------------------------------

def test_latency_stats_honest_under_overload():
    for S in (ContinuousScheduler, JSched):
        s = S(max_rows_per_tick=1, queue_limit=100)
        for i in range(5):
            rid = s.admit(i, now=float(i))
            s.enqueue(i, rid)
        plan = s.form_tick(now=10.0, cost_of=lambda slot: ("cold", 1))
        assert plan.rows == 1
        done = [r for _, rids in plan.cold for r in rids]
        s.mark_done(done, now=10.5)
        st = s.latency_stats(now=20.0)
        assert st["count"] == 1
        assert st["queue_depth"] == 4
        assert st["oldest_inflight_age_s"] == pytest.approx(19.0)
        occ = s.occupancy()
        assert occ["ticks"] == 1 and occ["row_utilization"] == 1.0


def test_form_tick_token_budget_never_deadlocks():
    s = ContinuousScheduler(max_rows_per_tick=4, max_tokens_per_tick=10)
    r0 = s.admit(0, 0.0)
    s.enqueue(0, r0)
    r1 = s.admit(1, 0.0)
    s.enqueue(1, r1)
    costs = {0: 25, 1: 3}
    plan = s.form_tick(0.0, lambda sl: ("cold", costs[sl]))
    assert [sl for sl, _ in plan.cold] == [0]
    plan2 = s.form_tick(0.0, lambda sl: ("cold", costs[sl]))
    assert [sl for sl, _ in plan2.cold] == [1]


def test_continuous_scheduler_matches_reference_on_random_traffic():
    rng = np.random.default_rng(4)
    ps = ContinuousScheduler(max_rows_per_tick=3, max_tokens_per_tick=20,
                             queue_limit=12)
    js = JSched(max_rows_per_tick=3, max_tokens_per_tick=20, queue_limit=12)
    cost = {s: (("warm", "cold")[s % 2], int(rng.integers(1, 15)))
            for s in range(8)}
    for t in range(60):
        now = float(t)
        for _ in range(int(rng.integers(0, 4))):
            slot = int(rng.integers(0, 8))
            if ps.has_capacity() != js.has_capacity():
                raise AssertionError(t)
            if not ps.has_capacity():
                ps.shed("shed_queue")
                js.shed("shed_queue")
                continue
            hit = bool(rng.random() < 0.2)
            a, b = ps.admit(slot, now, hit=hit), js.admit(slot, now, hit=hit)
            assert a == b
            if hit:
                ps.enqueue_rank(slot, a)
                js.enqueue_rank(slot, b)
            else:
                ps.enqueue(slot, a)
                js.enqueue(slot, b)
        pp = ps.form_tick(now, lambda s: cost[s])
        jp = js.form_tick(now, lambda s: cost[s])
        assert (pp.warm, pp.cold, pp.rank_only, pp.rows, pp.tokens) == \
            (jp.warm, jp.cold, jp.rank_only, jp.rows, jp.tokens)
        done = [r for _, rids in pp.warm + pp.cold + pp.rank_only
                for r in rids]
        ps.mark_done(done, now=now + 0.5)
        js.mark_done(done, now=now + 0.5)
    assert ps.records == js.records and ps.outcomes == js.outcomes
    assert ps.latency_stats(now=99.0) == js.latency_stats(now=99.0)
    assert ps.occupancy() == js.occupancy()


# --------------------------------------------------------------------------
# the port's bitwise contract: warm appends = cold encodes
# --------------------------------------------------------------------------

def _tiny(dtype="float32", seq=200, vocab=300, seed=0, arch="hstu-tiny"):
    cfg = reduced(get_arch(arch)).replace(vocab_size=vocab, max_seq_len=seq,
                                          dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    model = PG.GRModel(cfg, device="cpu", generator=g)
    table = torch.randn(vocab, cfg.d_model, generator=g)
    return cfg, model, table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chained_warm_appends_equal_cold_encode_bitwise(dtype):
    """The plain versions: after every append (3, a 1-wide one, one that
    crosses position 128, ...) the window encode gives the cold encode's
    embedding and the live K/V of every layer bit for bit."""
    cfg, model, table = _tiny(dtype)
    S, dt = cfg.max_seq_len, PG.torch_dtype(dtype)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, S))
    ts = np.cumsum(rng.integers(1, 50, S)).astype(np.int32)

    def cold(n):
        row_ids = torch.zeros(S, dtype=torch.int64)
        row_ids[:n] = ids[:n]
        row_ts = np.zeros(S, np.int32)
        row_ts[:n] = ts[:n]
        return PG.gr_serve_row_kv(model, cfg, table[row_ids].to(dt),
                                  torch.from_numpy(row_ts), n)

    n0 = 120
    emb, k, v = cold(n0)
    row_ts = np.zeros(S, np.int32)
    row_ts[:n0] = ts[:n0]
    pos = n0
    for q in (3, 1, 5, 9, 2):
        row_ts[pos:pos + q] = ts[pos:pos + q]
        qc = BucketLadder(S, min_size=2).bucket(q)
        xw = torch.zeros(qc, cfg.d_model, dtype=dt)
        xw[:q] = table[ids[pos:pos + q]].to(dt)
        emb, k, v = PG.gr_serve_row_append(model, cfg, xw,
                                           torch.from_numpy(row_ts), k, v,
                                           pos, q)
        pos += q
        fe, fk, fv = cold(pos)
        assert torch.equal(emb, fe), pos
        assert torch.equal(k[:, :pos], fk[:, :pos]), pos
        assert torch.equal(v[:, :pos], fv[:, :pos]), pos


def test_engine_warm_rows_equal_cold_encodes_across_wraparound():
    """The streaming engine over rounds of seeds, appends (warm: +3, a
    1-wide +1, +8), a ring wraparound and appends to a full row (cold
    fallbacks): every result's embedding, and after each round every live
    user's K/V, equal a from-scratch cold encode of the host history bit
    for bit."""
    S = 32
    cfg, model, table = _tiny(seq=S)
    eng = StreamingRecallEngine(cfg, model, table, max_users=8, k=10,
                                retrieval_block=128, max_rows_per_tick=4,
                                device="cpu")
    rng = np.random.default_rng(3)
    users = list(range(6))
    hist = {u: (rng.integers(0, cfg.vocab_size, 60).astype(np.int32),
                np.cumsum(rng.integers(1, 40, 60)).astype(np.int32))
            for u in users}
    prev = 0
    for cut in (10, 13, 14, 22, 40, 41):
        reqs = [(u, hist[u][0][prev:cut], hist[u][1][prev:cut])
                for u in users]
        before = eng.warm_rows
        res = {r.user: r for r in eng.serve(reqs)}
        assert eng.warm_rows - before == (len(users) if cut in (13, 14, 22)
                                          else 0)
        b = eng.buffer
        for u in users:
            s = b.slot_of(u)
            n = int(b.length[s])
            ids = torch.from_numpy(b.h_ids[s].astype(np.int64))
            ids[n:] = 0
            ts = torch.from_numpy(np.where(np.arange(S) < n, b.h_ts[s], 0))
            fe, fk, fv = PG.gr_serve_row_kv(model, cfg, table[ids], ts, n)
            np.testing.assert_array_equal(res[u].user_emb, fe.numpy())
            assert torch.equal(b.kv_k[:, s, :n], fk[:, :n])
            assert torch.equal(b.kv_v[:, s, :n], fv[:, :n])
        prev = cut
    st = eng.stats()["encode"]
    assert st["warm_rows"] > 0 and st["cold_rows"] > 0


# --------------------------------------------------------------------------
# the streaming engine: against the reference's, and the port's own
# RecallEngine
# --------------------------------------------------------------------------

def _models(arch, seq=16, vocab=300, seed=0):
    cj = j_reduced(JARCHS[arch]).replace(vocab_size=vocab, max_seq_len=seq,
                                         dtype="float32")
    cp = reduced(get_arch(arch)).replace(vocab_size=vocab, max_seq_len=seq,
                                         dtype="float32")
    b = j_get_bundle(cj)
    key = jax.random.PRNGKey(seed)
    dense = b.init_dense(key)
    table = j_make_shadowed(b.init_table(key))
    model = gr_params_from_numpy(tree_numpy(dense), cp, device=CPU)
    ptable = table_from_numpy(np.asarray(table.master),
                              np.asarray(table.shadow), device=CPU)
    return (cj, dense, table), (cp, model, ptable)


def _rounds(rng, users, vocab, n=50):
    hist = {u: (rng.integers(0, vocab, n).astype(np.int32),
                np.cumsum(rng.integers(1, 40, n)).astype(np.int32))
            for u in users}
    # at max_seq_len 16: seed 10 (cold), +3 and +1 (warm), +8 (wraparound:
    # cold), +20 (full replacement: cold), +2 (a full row: cold), then a
    # pure-hit round
    out, prev = [], 0
    for cut in (10, 13, 14, 22, 42, 44):
        out.append([(u, hist[u][0][prev:cut], hist[u][1][prev:cut])
                    for u in users])
        prev = cut
    out.append([(u, [], []) for u in users])
    return out


def _assert_close_results(a, b, scan):
    assert [r.user for r in a] == [r.user for r in b]
    assert [r.cache_hit for r in a] == [r.cache_hit for r in b]
    for x, y in zip(a, b):
        xe = np.asarray(x.user_emb, np.float32)
        np.testing.assert_allclose(y.user_emb, xe, atol=EMB_TOL, rtol=0)
        np.testing.assert_allclose(y.scores, x.scores, atol=SCORE_TOL,
                                   rtol=0)
        true = scan.astype(np.float64) @ xe.astype(np.float64)
        kth1 = np.sort(true)[::-1][len(x.item_ids)]
        sure = set(np.flatnonzero(true > kth1 + 4 * SCORE_TOL).tolist())
        assert sure <= set(x.item_ids.tolist())
        assert sure <= set(y.item_ids.tolist())


@pytest.mark.parametrize("arch", ["hstu-tiny", "fuxi-tiny", "sasrec-tiny"])
def test_streaming_engine_matches_reference(arch):
    """Seeds, warm appends (HSTU), wraparound, full replacement and a hit
    round through both packages' streaming engines; FuXi and SASRec serve
    cold-only in both (prefix reuse is HSTU's)."""
    (cj, dense, jt), (cp, model, pt) = _models(arch)
    kw = dict(max_users=8, k=10, retrieval_block=128, max_rows_per_tick=4)
    je = JStream(cj, dense, jt, **kw)
    pe = StreamingRecallEngine(cp, model, pt, device="cpu", **kw)
    assert pe.prefix_reuse == je.prefix_reuse == (arch == "hstu-tiny")
    scan = np.asarray(jt.shadow, np.float32)
    rng = np.random.default_rng(5)
    for rnd, reqs in enumerate(_rounds(rng, range(6), cj.vocab_size)):
        jr, pr = je.serve(reqs, now=float(rnd)), pe.serve(reqs,
                                                          now=float(rnd))
        assert [r.rid for r in jr] == [r.rid for r in pr]
        _assert_close_results(jr, pr, scan)
    js, ps = je.stats(), pe.stats()
    assert ps["encode"] == js["encode"]
    assert ps["admission"] == js["admission"]
    assert ps["compile"]["per_fn"] == js["compile"]["per_fn"]
    assert ps["compile"]["graph_captures"] == 0          # CPU: eager
    assert ps["latency"] == js["latency"]


@pytest.mark.parametrize("arch", ["hstu-tiny", "sasrec-tiny"])
def test_streaming_engine_matches_recall_engine(arch):
    """The port's two engines on the same trace (max_seq_len 64, so a
    RecallEngine pack holds several users at other offsets)."""
    _, (cp, model, pt) = _models(arch, seq=64)
    base = RecallEngine(cp, model, pt, num_shards=2, users_per_shard=3,
                        k=10, retrieval_block=128, max_delay_ms=0.0,
                        device="cpu")
    eng = StreamingRecallEngine(cp, model, pt, max_users=8, k=10,
                                retrieval_block=128, max_rows_per_tick=4,
                                device="cpu")
    scan = pt.shadow.float().numpy()
    rng = np.random.default_rng(6)
    before = dict(attn_ops.KERNEL_LAUNCHES)
    for reqs in _rounds(rng, range(6), cp.vocab_size, n=120)[:4]:
        _assert_close_results(base.serve(reqs), eng.serve(reqs), scan)
    assert attn_ops.KERNEL_LAUNCHES == before            # CPU: no kernel


def test_streaming_hit_skips_device_and_matches():
    _, (cp, model, pt) = _models("hstu-tiny")
    eng = StreamingRecallEngine(cp, model, pt, max_users=4, k=10,
                                retrieval_block=128, max_rows_per_tick=4,
                                device="cpu")
    ids = np.arange(1, 9, dtype=np.int32)
    first = eng.serve([(0, ids, ids * 10)])[0]
    rank0 = eng.rank_batches
    hit = eng.serve([(0, [], [])])[0]
    assert hit.cache_hit and eng.rank_batches == rank0
    np.testing.assert_array_equal(first.item_ids, hit.item_ids)
    np.testing.assert_array_equal(first.scores, hit.scores)
    np.testing.assert_array_equal(first.user_emb, hit.user_emb)


def test_admission_typed_outcomes():
    _, (cp, model, pt) = _models("hstu-tiny")
    eng = StreamingRecallEngine(cp, model, pt, max_users=2, k=5,
                                retrieval_block=128, max_rows_per_tick=2,
                                queue_limit=3, admission="shed",
                                device="cpu")
    ids = np.arange(1, 5, dtype=np.int32)
    ts = ids * 10
    assert eng.submit(0, ids, ts, now=0.0).accepted
    assert eng.submit(1, ids, ts, now=0.0).accepted
    a2 = eng.submit(2, ids, ts, now=0.0)
    assert a2.outcome == "shed_slots" and not a2.accepted
    assert eng.submit(0, ids + 10, ts + 100, now=0.0).accepted
    assert eng.submit(1, ids + 20, ts + 200, now=0.0).outcome == "shed_queue"
    st = eng.stats()["admission"]
    assert st["shed_slots"] == 1 and st["shed_queue"] == 1
    eng.tick(now=1.0)
    with pytest.raises(ValueError, match="delta mismatch"):
        eng.submit(5, ids, ts[:2])

    ev = StreamingRecallEngine(cp, model, pt, max_users=1, k=5,
                               retrieval_block=128, max_rows_per_tick=2,
                               device="cpu")
    ev.serve([(0, ids, ts)])
    ev.serve([(1, ids, ts)])                 # evicts user 0
    a = ev.submit(0, ids + 1, ts + 1, now=0.0)
    assert a.outcome == "resend_full" and not a.accepted
    assert ev.submit(0, ids, ts, now=0.0).accepted


def test_same_user_burst_coalesces_into_one_encode():
    _, (cp, model, pt) = _models("hstu-tiny")
    eng = StreamingRecallEngine(cp, model, pt, max_users=4, k=5,
                                retrieval_block=128, max_rows_per_tick=4,
                                device="cpu")
    rids = [eng.submit(0, [i + 1], [10 * (i + 1)], now=0.0).rid
            for i in range(3)]
    res = eng.tick(now=1.0)
    assert [r.rid for r in res] == rids
    assert eng.cold_rows == 1
    for r in res[1:]:
        np.testing.assert_array_equal(res[0].item_ids, r.item_ids)


def test_warmup_builds_every_bucket_once():
    _, (cp, model, pt) = _models("hstu-tiny")
    eng = StreamingRecallEngine(cp, model, pt, max_users=4, k=5,
                                retrieval_block=128, max_rows_per_tick=4,
                                device="cpu")
    n = eng.warmup(q_caps=(1, 3))
    # rows 1, 2, 4 × (cold, rank, warm at q 2 and 4)
    assert n == 3 * 4
    assert eng.warmup(q_caps=(1, 3)) == 0
    assert eng.stats()["compile"]["per_fn"] == {"cold": 3, "warm": 6,
                                                "rank": 3}
    res = eng.serve([(0, [1, 2, 3], [5, 6, 9])])
    assert len(res) == 1 and eng.compile_cache.compiles == 12
