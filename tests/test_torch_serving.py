"""The port's serving path against the JAX package: the request scheduler
packs and spills identically, blocked top-k equals the dense oracle, and a
port RecallEngine on CPU serves a cold / pure-hit / incremental trace as
the JAX RecallEngine does with either of its attention paths."""
import numpy as np
import pytest
import torch

from repro.core import load_balance as JLB
from repro.kernels.jagged_attention import make_attn_fn as j_make_attn_fn
from repro.serving import RecallEngine as JEngine
from repro.serving import RequestScheduler as JScheduler
from repro.serving import UserStateCache as JCache
from repro.serving import table_scan_bytes as j_scan_bytes
from repro_torch.core import load_balance as PLB
from repro_torch.kernels.jagged_attention import ops as attn_ops
from repro_torch.serving import RecallEngine, RequestScheduler
from repro_torch.serving import UserStateCache, table_scan_bytes
from repro_torch.serving import topk_blocked, topk_dense
from torch_parity import models

# --------------------------------------------------------------------------
# scheduler / cache / load balance: numpy copies, equal outputs
# --------------------------------------------------------------------------


def _requests(rng, n, max_len):
    out = []
    for u in range(n):
        m = int(rng.integers(1, max_len + 1))
        out.append((u, rng.integers(0, 1000, m).astype(np.int32),
                    np.cumsum(rng.integers(1, 50, m)).astype(np.int32)))
    return out


@pytest.mark.parametrize("G,S,L,n,tokens", [(1, 4, 16, 9, None),
                                            (4, 2, 32, 25, None),
                                            (3, 5, 8, 40, 20),
                                            (2, 4, 64, 30, 100)])
def test_scheduler_flush_matches_jax(G, S, L, n, tokens):
    rng = np.random.default_rng(G * 100 + n)
    reqs = _requests(rng, n, int(L * 1.5))
    js = JScheduler(G, S, L, tokens_per_shard=tokens, max_delay_ms=0.0)
    ps = RequestScheduler(G, S, L, tokens_per_shard=tokens, max_delay_ms=0.0)
    for u, ids, ts in reqs:
        assert js.submit(u, ids, ts, now=0.0) == ps.submit(u, ids, ts,
                                                           now=0.0)
    jm, pm = js.flush(now=1.0), ps.flush(now=1.0)
    assert len(jm) == len(pm) > 0
    for a, b in zip(jm, pm):
        for f in ("ids", "timestamps", "offsets", "last_pos"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert [tuple(vars(s).values()) for s in a.slots] == \
            [tuple(vars(s).values()) for s in b.slots]
    assert js.records == ps.records


def test_global_token_reallocation_matches_jax():
    rng = np.random.default_rng(9)
    for _ in range(20):
        lens = rng.integers(0, 3000, int(rng.integers(1, 40))).tolist()
        G = int(rng.integers(1, 6))
        assert (JLB.global_token_reallocation(lens, G)
                == PLB.global_token_reallocation(lens, G))


def test_user_state_cache_matches_jax():
    rng = np.random.default_rng(10)
    jc, pc = JCache(16, max_users=5), UserStateCache(16, max_users=5)
    for _ in range(200):
        u = int(rng.integers(0, 8))
        n = int(rng.integers(0, 20))
        ids = rng.integers(0, 100, n)
        _, ja = jc.update(u, ids, ids)
        _, pa = pc.update(u, ids, ids)
        assert ja == pa
        if rng.random() < 0.5:
            emb = rng.standard_normal(4)
            jc.store(u, emb)
            pc.store(u, emb)
        for c in (jc, pc):
            st = c.get(u)
            assert st is not None
        np.testing.assert_array_equal(jc.get(u).history()[0],
                                      pc.get(u).history()[0])
    assert jc.stats() == pc.stats()


# --------------------------------------------------------------------------
# retrieval
# --------------------------------------------------------------------------

@pytest.mark.parametrize("V,block_v,shadow", [(1000, 256, False),
                                              (1000, 300, False),
                                              (777, 256, True),
                                              (64, 4096, False)])
def test_topk_blocked_equals_dense(V, block_v, shadow):
    g = torch.Generator().manual_seed(V)
    table = torch.randn(V, 32, generator=g)
    if shadow:
        table = table.to(torch.float16)
    emb = torch.randn(5, 32, generator=g)
    dv, di = topk_dense(emb, table, 20)
    bv, bi = topk_blocked(emb, table, k=20, block_v=block_v)
    assert bi.dtype == torch.int32 and bv.dtype == torch.float32
    torch.testing.assert_close(bv, dv, atol=1e-5, rtol=0)
    assert torch.equal(bi, di)


def test_shadowed_table_helpers_match_jax():
    """make_shadowed / live_shadow / shadow_consistent / lookup: the same
    shadow bits and the same verdicts as the JAX package."""
    import jax.numpy as jnp
    from repro.embedding import tables as JT
    from repro_torch.embedding import tables as PT
    master = np.random.default_rng(8).standard_normal((50, 6)).astype(
        np.float32)
    jt = JT.make_shadowed(jnp.asarray(master))
    pt = PT.make_shadowed(torch.from_numpy(master))
    np.testing.assert_array_equal(pt.shadow.numpy(), np.asarray(jt.shadow))
    assert pt.accum.shape == (50, 6)
    assert PT.shadow_consistent(pt) and bool(JT.shadow_consistent(jt))
    stale = pt._replace(shadow=pt.shadow.clone().index_fill_(0, torch.tensor(
        [3]), 1.0))
    assert not PT.shadow_consistent(stale)
    stripped = pt._replace(shadow=pt.shadow[:0])
    assert PT.live_shadow(stripped) is None and PT.live_shadow(pt) is pt.shadow
    assert PT.make_shadowed(torch.from_numpy(master), qdtype=None).shadow is None
    ids = np.array([[0, 7, 49], [3, 3, 1]], np.int32)
    np.testing.assert_array_equal(
        PT.lookup(pt.master, torch.from_numpy(ids), torch.float32).numpy(),
        np.asarray(JT.lookup(jt.master, jnp.asarray(ids), jnp.float32)))


def test_table_scan_bytes_matches_jax():
    import jax.numpy as jnp
    for V, D, bv, dt in [(1000, 32, 256, np.float16), (1024, 8, 256,
                                                       np.float32),
                         (500, 16, None, np.float32)]:
        j = j_scan_bytes(jnp.zeros((V, D), dt), bv)
        p = table_scan_bytes(torch.zeros(V, D, dtype={
            np.float16: torch.float16, np.float32: torch.float32}[dt]), bv)
        assert j == p


# --------------------------------------------------------------------------
# the slice: RecallEngine, cold / pure-hit / incremental rounds
# --------------------------------------------------------------------------

EMB_TOL = 1e-4       # fp32: see tests/test_torch_hstu.py
SCORE_TOL = 1e-4


def _trace(rng, users, n_items, max_len):
    hist = {}
    for u in range(users):
        n = int(rng.integers(2, max_len))
        hist[u] = (rng.integers(0, n_items, n).astype(np.int32),
                   np.cumsum(rng.integers(1, 400, n)).astype(np.int32))
    cold = [(u, *hist[u]) for u in hist]
    hit = [(u, [], []) for u in hist]
    inc = []
    for u in list(hist)[::2]:
        m = int(rng.integers(1, 4))
        last = int(hist[u][1][-1])
        inc.append((u, rng.integers(0, n_items, m).astype(np.int32),
                    (last + np.cumsum(rng.integers(1, 400, m))).astype(
                        np.int32)))
    return [cold, hit, inc]


def _assert_same_results(jr, pr, scan):
    assert [r.rid for r in jr] == [r.rid for r in pr]
    assert [r.user for r in jr] == [r.user for r in pr]
    assert [r.cache_hit for r in jr] == [r.cache_hit for r in pr]
    for a, b in zip(jr, pr):
        ja = np.asarray(a.user_emb, np.float32)
        np.testing.assert_allclose(b.user_emb, ja, atol=EMB_TOL, rtol=0)
        np.testing.assert_allclose(b.scores, a.scores, atol=SCORE_TOL,
                                   rtol=0)
        # ids must agree wherever the ranking is decided by more than the
        # tolerance: every item scoring clearly above the (k+1)-th
        true = np.sort(scan.astype(np.float64) @ ja.astype(np.float64))
        kth1 = true[::-1][len(a.item_ids)]
        sure = set(np.flatnonzero(scan.astype(np.float64) @ ja
                                  > kth1 + 4 * SCORE_TOL).tolist())
        assert sure <= set(a.item_ids.tolist())
        assert sure <= set(b.item_ids.tolist())


@pytest.mark.parametrize("jax_attn", ["xla", "pallas"])
def test_recall_engine_matches_jax(jax_attn):
    recall_engine_vs_reference(jax_attn)


def recall_engine_vs_reference(jax_attn, **model_kw):
    """The body of :func:`test_recall_engine_matches_jax`; ``model_kw``
    go to ``torch_parity.models`` (``arch``, ``tweak``)."""
    (cj, dense, jtable), (cp, model, ptable) = models(seed=11, **model_kw)
    kw = dict(num_shards=2, users_per_shard=3, tokens_per_shard=160, k=10,
              retrieval_block=128, max_delay_ms=0.0)
    attn = (None if jax_attn == "xla" else
            j_make_attn_fn(block=32, max_row_len=cj.max_seq_len,
                           pairs_per_step=1, interpret=True))
    je = JEngine(cj, dense, jtable, attn_fn=attn, **kw)
    pe = RecallEngine(cp, model, ptable, device="cpu", **kw)
    rng = np.random.default_rng(12)
    scan = np.asarray(jtable.shadow, np.float32)   # what retrieval scans
    for rnd, reqs in enumerate(_trace(rng, 8, cj.vocab_size,
                                      cj.max_seq_len + 20)):
        jr, pr = je.serve(reqs, now=float(rnd)), pe.serve(reqs,
                                                          now=float(rnd))
        assert len(pr) == len(reqs)
        assert all(r.cache_hit for r in pr) == (rnd == 1)
        _assert_same_results(jr, pr, scan)
    assert pe.encoded_batches == je.encoded_batches
    assert pe.retrieval_batches == je.retrieval_batches
    assert pe.stats()["cache"] == je.stats()["cache"]


def test_recall_engine_hit_round_is_bit_identical_and_encodes_nothing():
    _, (cp, model, ptable) = models(seed=13)
    eng = RecallEngine(cp, model, ptable, num_shards=2, users_per_shard=4,
                       k=10, retrieval_block=128, max_delay_ms=0.0,
                       device="cpu")
    rng = np.random.default_rng(14)
    cold, hit, _ = _trace(rng, 6, cp.vocab_size, cp.max_seq_len)
    first = eng.serve(cold)
    n_enc, n_ret = eng.encoded_batches, eng.retrieval_batches
    launches = attn_ops.KERNEL_LAUNCHES["attn_fwd"]
    second = eng.serve(hit)
    assert eng.encoded_batches == n_enc and eng.retrieval_batches == n_ret
    assert attn_ops.KERNEL_LAUNCHES["attn_fwd"] == launches  # CPU: no kernel
    for a, b in zip(first, second):
        assert b.cache_hit and not a.cache_hit
        np.testing.assert_array_equal(a.item_ids, b.item_ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.user_emb, b.user_emb)


def test_recall_engine_serving_only_table_from_master():
    _, (cp, model, ptable) = models(seed=15)
    eng = RecallEngine(cp, model, ptable.master, num_shards=1,
                       users_per_shard=2, k=10, retrieval_block=256,
                       device="cpu")
    assert eng.table.accum.shape[0] == 0
    assert eng.table.shadow.dtype == torch.float16
    res = eng.serve([(0, [1, 2, 3], [5, 6, 9]), (1, [4], [1])])
    assert len(res) == 2 and res[0].item_ids.shape == (10,)
    assert ((res[0].item_ids >= 0) & (res[0].item_ids < cp.vocab_size)).all()


def test_recall_engine_rejects_model_on_other_device():
    _, (cp, model, ptable) = models(seed=16)
    with pytest.raises(ValueError, match="lies on"):
        RecallEngine(cp, model, ptable, device="meta")
