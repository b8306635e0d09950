"""The port on the card: the CUDA kernels against their plain versions, and
the serving and training slices on CUDA against the same slices on the
CPU.

Every test here carries the ``gpu`` marker and skips without a card (the
kernels are CUDA C++ and have no interpret mode). This file imports no jax,
so it also runs on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import RABConfig, get_arch, reduced
from repro_torch.kernels.jagged_attention import (attention_fwd_plain,
                                                  build_attn_plan,
                                                  jagged_attention,
                                                  jagged_attention_ref, ops)
from repro_torch.kernels.jagged_attention.ref import (max_row_rel_err,
                                                      time_buckets)
from repro_torch.models.gr import GRModel
from repro_torch.serving import RecallEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pack(dev, dtype, H, D, lens_per_pack, cap, seed=7):
    rng = np.random.default_rng(seed)
    S = max(len(lens) for lens in lens_per_pack)
    offs = np.zeros((len(lens_per_pack), S + 1), np.int32)
    for g, lens in enumerate(lens_per_pack):
        o = np.concatenate([[0], np.cumsum(lens)])
        offs[g, :len(o)], offs[g, len(o):] = o, o[-1]
    G = len(lens_per_pack)
    ts = np.cumsum(rng.integers(0, 4000, (G, cap)), axis=1).astype(np.int32)
    q, k, v = (torch.from_numpy(rng.standard_normal((G, cap, H, D))
                                .astype(np.float32)).to(dev, dtype)
               for _ in range(3))
    return q, k, v, torch.from_numpy(offs).to(dev), torch.from_numpy(ts).to(
        dev)


# fp32: same fp32 arithmetic, keys summed in another order (1e-4 max abs
# bounds a few ulps of O(1) outputs). bf16: the weights round to bf16
# before a·v and the output rounds to bf16; a one-ulp flip moves a value by
# at most 2^-7 of itself, and long rows' outputs are small, so bf16 is held
# per (token, head) by the relative L2 error along the head dim.
@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, dtype, D):
    H, cap = 8, 1024
    q, k, v, offs, ts = _pack(cuda, dtype, H, D,
                              [[500, 3, 0, 300, 129], [0, 0, 0]], cap)
    rab = {"pos_table": torch.randn(256, H, device=cuda) * 0.5,
           "time_table": torch.randn(32, H, device=cuda) * 0.5}
    cfg = RABConfig()
    plan = build_attn_plan(offs, ts, cap, block=128, max_row_len=1024)
    before = ops.KERNEL_LAUNCHES["attn_fwd"]
    out = jagged_attention(q, k, v, offs, ts, rab, cfg, plan=plan)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES["attn_fwd"] == before + 1
    plain = jagged_attention_ref(q, k, v, offs, ts, rab, cfg, plan=plan)
    if dtype == torch.float32:
        assert (out.float() - plain.float()).abs().max().item() <= 1e-4
    else:
        assert max_row_rel_err(out, plain) <= 1e-2
    assert torch.count_nonzero(out[1]) == 0              # all-padding pack
    p = ops._as_batched(plan)
    direct = attention_fwd_plain(
        q, k, v, rab["pos_table"], rab["time_table"], p, scale=D ** -0.5,
        tb_denom=ops.time_bucket_denom(cfg.time_bucket_scale), use_pos=True,
        use_time=True)
    torch.testing.assert_close(ops._masked(p.meta_i32, direct), plain)


def test_kernel_time_buckets_match_plain_version(cuda):
    rng = np.random.default_rng(3)
    ts = torch.from_numpy(np.cumsum(rng.integers(0, 5000, 3000))
                          .astype(np.int32)).to(cuda)
    denom = ops.time_bucket_denom(0.301)
    kb = ops.kernel_time_buckets(ts, ts, 0.301, 32)
    pb = time_buckets((ts[:, None] - ts[None, :]).abs(), denom, 32)
    assert torch.equal(kb.long(), pb)


def test_kernel_wrapper_raises_on_what_it_does_not_take(cuda):
    H, D, cap = 4, 128, 256
    q, k, v, offs, ts = _pack(cuda, torch.bfloat16, H, D, [[100, 20]], cap)
    rab = {"pos_table": torch.zeros(256, H, device=cuda),
           "time_table": torch.zeros(32, H, device=cuda)}
    with pytest.raises(ValueError, match="does not match q"):
        jagged_attention(q, k.float(), v, offs, ts, rab, RABConfig())
    with pytest.raises(ValueError, match="block"):
        jagged_attention(q, k, v, offs, ts, rab, RABConfig(), block=64)
    with pytest.raises(ValueError, match="head dim"):
        jagged_attention(q[..., :48], k[..., :48], v[..., :48], offs, ts,
                         rab, RABConfig())


def test_recall_engine_on_card_matches_cpu(cuda):
    """The slice at a reduced size, fp32: the engine on the card (kernel)
    against the same engine on the CPU (plain version); the hit round is
    bit-identical to the cold round and encodes nothing."""
    recall_engine_on_card_vs_cpu(cuda, "hstu-tiny", "attn_fwd")


def test_fuxi_recall_engine_on_card_matches_cpu(cuda):
    """As the HSTU case, on reduced FuXi: every layer launches K1-fwd's
    functional branch."""
    recall_engine_on_card_vs_cpu(cuda, "fuxi-tiny", "attn_fwd_functional")


def recall_engine_on_card_vs_cpu(cuda, arch, counter):
    cfg = reduced(get_arch(arch)).replace(vocab_size=2000, max_seq_len=300,
                                          dtype="float32")
    g = torch.Generator().manual_seed(0)
    model_cpu = GRModel(cfg, device="cpu", generator=g)
    master = torch.randn(cfg.vocab_size, cfg.d_model, generator=g) * 0.02
    model_gpu = GRModel(cfg, device=cuda)
    model_gpu.load_state_dict(model_cpu.state_dict())
    kw = dict(num_shards=2, users_per_shard=4, tokens_per_shard=600, k=20,
              retrieval_block=512, max_delay_ms=0.0)
    on_card = RecallEngine(cfg, model_gpu, master.to(cuda), **kw)
    on_cpu = RecallEngine(cfg, model_cpu, master, device="cpu", **kw)
    rng = np.random.default_rng(1)
    reqs = []
    for u in range(12):
        n = int(rng.integers(1, cfg.max_seq_len))
        reqs.append((u, rng.integers(0, cfg.vocab_size, n),
                     np.cumsum(rng.integers(1, 3600, n))))
    before = ops.KERNEL_LAUNCHES[counter]
    a, b = on_card.serve(reqs), on_cpu.serve(reqs)
    assert (ops.KERNEL_LAUNCHES[counter] - before
            == cfg.num_layers * on_card.encoded_batches)
    for x, y in zip(a, b):
        assert x.rid == y.rid and x.user == y.user
        np.testing.assert_allclose(x.user_emb, y.user_emb, atol=1e-4, rtol=0)
        np.testing.assert_allclose(x.scores, y.scores, atol=1e-4, rtol=0)
    n_enc = on_card.encoded_batches
    hits = on_card.serve([(u, [], []) for u, _, _ in reqs])
    assert on_card.encoded_batches == n_enc
    for x, h in zip(a, hits):
        assert h.cache_hit
        np.testing.assert_array_equal(x.item_ids, h.item_ids)
        np.testing.assert_array_equal(x.user_emb, h.user_emb)


# --------------------------------------------------------------------------
# training kernels: K2 (attention backward), K3/K4 (fused negatives), K6
# --------------------------------------------------------------------------

def _rel_to_max(a, b):
    """max |a - b| over max |b|: fp32 results summed in another order."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def _functional_time(dev, H, tiny_sigma_head=False):
    """FuXi's packed (3, H) [amp; σ; ρ] at working values: amp near 1, σ
    from e^2 to e^12, ρ from 0.43 to 1.57; ``tiny_sigma_head`` gives the
    last head (largest ρ) σ = e^-40, where z^ρ overflows to inf on
    int32-wide Δt."""
    ls = torch.linspace(2.0, 12.0, H)
    if tiny_sigma_head:
        ls[-1] = -40.0
    return ops.functional_time_table(
        {"time_amp": torch.linspace(0.6, 1.4, H), "time_log_sigma": ls,
         "time_rho": torch.linspace(-2.0, 2.0, H)}).to(dev)


@pytest.mark.parametrize("wide_dt", [False, True])
@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functional_kernels_match_plain_version(cuda, dtype, D, wide_dt):
    """K1-fwd and K2 in the functional time mode against their plain
    versions, beside an all-padding pack; ``wide_dt`` spreads timestamps
    over the int32 range (|Δt| to 2^31 − 1) with a head whose z^ρ
    overflows. Tolerances as the bucket mode's: fp32 outputs 1e-4 max
    abs, bf16 per (token, head) relative L2 1e-2, grads 1e-4 of their
    largest value (the time grads too: ~10^5 terms each, summed in
    another order); K2 bit-identical run to run; every result finite."""
    from repro_torch.kernels.jagged_attention.ref import attention_bwd_plain
    H, cap = 8, 1024
    q, k, v, offs, ts = _pack(cuda, dtype, H, D,
                              [[500, 3, 0, 300, 129], [0, 0, 0]], cap)
    if wide_dt:
        ts = torch.where(torch.arange(cap, device=cuda) % 2 == 0,
                         2 ** 31 - 1 - ts % 50, ts % 50).to(torch.int32)
    pt = torch.randn(256, H, device=cuda) * 0.5
    tt = _functional_time(cuda, H, tiny_sigma_head=wide_dt)
    plan = ops._as_batched(build_attn_plan(offs, ts, cap, block=128,
                                           max_row_len=1024))
    kw = dict(scale=D ** -0.5, tb_denom=1.0, use_pos=True, use_time=True,
              time_functional=True)
    before = dict(ops.KERNEL_LAUNCHES)
    out = ops._launch_fwd(q, k, v, pt, tt, plan, **kw)
    dy = ops._masked(plan.meta_i32, torch.randn_like(q))
    got = ops._launch_bwd(q, k, v, dy, pt, tt, plan, **kw)
    again = ops._launch_bwd(q, k, v, dy, pt, tt, plan, **kw)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES["attn_fwd_functional"] == \
        before["attn_fwd_functional"] + 1
    assert ops.KERNEL_LAUNCHES["attn_bwd_functional"] == \
        before["attn_bwd_functional"] + 2
    assert ops.KERNEL_LAUNCHES["attn_fwd"] == before["attn_fwd"]
    plain = attention_fwd_plain(q, k, v, pt, tt, plan, **kw)
    out, plain = (ops._masked(plan.meta_i32, t) for t in (out, plain))
    assert torch.isfinite(out.float()).all()
    if dtype == torch.float32:
        assert (out - plain).abs().max().item() <= 1e-4
    else:
        assert max_row_rel_err(out, plain) <= 1e-2
    want = attention_bwd_plain(q, k, v, dy, pt, tt, plan, **kw)
    for name, a, b, c in zip(("dq", "dk", "dv", "dpt", "dtt"), got, want,
                             again):
        assert torch.equal(a, c), f"{name} differs between runs"
        assert torch.isfinite(a.float()).all(), name
        if name in ("dpt", "dtt") or dtype == torch.float32:
            assert _rel_to_max(a, b) <= 1e-4, (name, _rel_to_max(a, b))
        else:
            assert max_row_rel_err(a, b) <= 1e-2, name
    assert got[4].shape == (3, H)

@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attn_bwd_kernel_matches_plain_version(cuda, dtype, D):
    """K2 against its plain version on a long-tail pack beside an
    all-padding pack: fp32 grads to 1e-4 of their largest value (another
    summation order), bf16 q/k/v grads per (token, head) by relative L2
    (one bf16 rounding of an fp32 sum), the fp32 table grads to 1e-4 of
    their largest value; the kernel is bit-identical run to run."""
    from repro_torch.kernels.jagged_attention.ref import attention_bwd_plain
    H, cap = 8, 1024
    q, k, v, offs, ts = _pack(cuda, dtype, H, D,
                              [[500, 3, 0, 300, 129], [0, 0, 0]], cap)
    dy = torch.randn_like(q)
    pt = torch.randn(256, H, device=cuda) * 0.5
    tt = torch.randn(32, H, device=cuda) * 0.5
    plan = ops._as_batched(build_attn_plan(offs, ts, cap, block=128,
                                           max_row_len=1024))
    kw = dict(scale=D ** -0.5, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=True)
    before = ops.KERNEL_LAUNCHES["attn_bwd"]
    got = ops._launch_bwd(q, k, v, dy, pt, tt, plan, **kw)
    again = ops._launch_bwd(q, k, v, dy, pt, tt, plan, **kw)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES["attn_bwd"] == before + 2
    want = attention_bwd_plain(q, k, v, dy, pt, tt, plan, **kw)
    for name, a, b, c in zip(("dq", "dk", "dv", "dpt", "dtt"), got, want,
                             again):
        assert torch.equal(a, c), f"{name} differs between runs"
        assert torch.isfinite(a.float()).all(), name
        if name in ("dpt", "dtt") or dtype == torch.float32:
            assert _rel_to_max(a, b) <= 1e-4, (name, _rel_to_max(a, b))
        else:
            assert max_row_rel_err(a, b) <= 1e-2, name
    for t in got[:3]:
        assert torch.count_nonzero(ops._masked(plan.meta_i32, t)[1]) == 0


@pytest.mark.parametrize("case", ["bf16_o_fp16_table_e1", "fp32_e4",
                                  "bf16_o_fp32_round_e2"])
def test_neg_kernels_match_plain_version(cuda, case):
    """K3 and K4 against their plain versions with invalid tokens, at
    expansion 1, 2 and 4 (generator-drawn perms): lse and dpos to 1e-5
    absolute, w to 1e-6, dout to 1e-4 of its largest value (sums over D
    and R in another order); bit-identical run to run."""
    from repro_torch.kernels import neg_logits as NL
    from repro_torch.kernels.neg_logits import ref as NR
    o_dt, t_dt, fetch, expansion, D = {
        "bf16_o_fp16_table_e1": (torch.bfloat16, torch.float16, None, 1,
                                 1024),
        "fp32_e4": (torch.float32, torch.float32, None, 4, 256),
        "bf16_o_fp32_round_e2": (torch.bfloat16, torch.float32,
                                 torch.float16, 2, 512)}[case]
    g = torch.Generator(device=cuda).manual_seed(3)
    T, R, V, seg = 1000, 32, 5000, 128
    o = (torch.randn(T, D, device=cuda, generator=g) * 0.05).to(o_dt)
    table = (torch.randn(V, D, device=cuda, generator=g) * 0.3).to(t_dt)
    ids = torch.randint(0, V, (T, R), device=cuda, generator=g)
    valid = torch.rand(T, device=cuda, generator=g) > 0.2
    pos = torch.randn(T, device=cuda, generator=g)
    o_p, pos_p, ids_p, valid_p, perms, _ = NL.prepare_fused_inputs(
        o, pos, V, ids, segment=seg, expansion=expansion, generator=g,
        valid=valid)
    kw = dict(segment=seg, R=R, expansion=expansion, inv_tau=1.25,
              fetch_dtype=fetch)
    args = (o_p, pos_p, table, ids_p, valid_p, perms)
    lse = NL.neg_fwd(*args, **kw)
    gr = torch.randn_like(lse) * valid_p
    w, dout, dpos = NL.neg_bwd(*args, lse, gr, **kw)
    w2, dout2, _ = NL.neg_bwd(*args, lse, gr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(NL.neg_fwd(*args, **kw), lse)
    assert torch.equal(w, w2) and torch.equal(dout, dout2)
    p_lse = NR.neg_fwd_plain(*args, **kw)
    pw, pdout, pdpos = NR.neg_bwd_plain(*args, p_lse, gr, **kw)
    assert (lse - p_lse).abs().max().item() <= 1e-5
    assert (dpos - pdpos).abs().max().item() <= 1e-5
    assert (w - pw).abs().max().item() <= 1e-6
    assert _rel_to_max(dout, pdout) <= 1e-4


def test_runsum_kernel_matches_plain_version(cuda):
    """K6 against its plain version on runs of 1 to 3000 rows and a run of
    dropped ids: totals to 1e-5 of their largest value (the plain version
    adds on the card with atomics), single-row runs bitwise (a sum of one
    row is exact in any order); bit-identical run to run; dedup_rows puts
    the same totals at the run ends."""
    from repro_torch.kernels.jagged_lookup import ops as JL
    from repro_torch.kernels.jagged_lookup.ref import run_totals_plain
    g = torch.Generator(device=cuda).manual_seed(5)
    ids = torch.cat([torch.randint(0, 1 << 22, (20000,), device=cuda,
                                   generator=g),
                     torch.full((3000,), 17, device=cuda),
                     torch.full((50,), -1, device=cuda),
                     torch.randint(0, 40, (2000,), device=cuda,
                                   generator=g)]).to(torch.int32)
    rows = torch.randn(ids.numel(), 1024, device=cuda, generator=g)
    order, sids = JL.sort_pairs(ids)
    before = JL.KERNEL_LAUNCHES["runsum"]
    u, out = JL.run_totals(rows, order, sids)
    u2, again = JL.run_totals(rows, order, sids)
    torch.cuda.synchronize()
    assert JL.KERNEL_LAUNCHES["runsum"] == before + 2
    assert torch.equal(out, again) and torch.equal(u, u2)
    assert torch.equal(u, torch.unique(ids[ids >= 0]))
    starts, num_runs = JL.run_starts(sids)
    plain = run_totals_plain(rows, order, sids, int(num_runs),
                             JL.DROP_KEY)[:u.numel()]
    assert _rel_to_max(out, plain) <= 1e-5
    single = torch.diff(starts[:u.numel() + 1]) == 1
    assert int(single.sum()) > 10000
    assert torch.equal(out[single], plain[single])
    uids, sums = JL.dedup_rows(rows, ids)
    assert torch.equal(uids[uids >= 0], u)
    assert torch.equal(sums[uids >= 0], out)
    assert torch.count_nonzero(sums[uids < 0]) == 0
    assert JL.KERNEL_LAUNCHES["runsum"] == before + 3


def test_train_steps_on_card_match_cpu(cuda):
    """The training slice at a reduced size (fp32, d 256 so the negative
    kernels take it): 2 sync then 2 τ=1 steps on the card (kernels)
    against the same steps on the CPU (plain versions) from the same init.
    The dense learning rate is 0 here: AdamW's first step is lr·sign(g)
    per element, so a grad element near zero would send the two dense
    trajectories apart by design, and everything after would differ with
    them. With the dense params fixed, losses agree to 1e-4, the carried
    pairs' rows to 1e-4 of their largest value (the kernels sum in other
    orders), and master elements to 1e-6 but for at most 1 in 1000, all to
    1e-4 (AdaGrad's step −lr·g/√(g²+1e-10) follows g's relative error,
    large where g's contributions cancel to near zero). The shadow stays
    the master's fp16 image bit for bit; each step launches every kernel
    of the path."""
    from repro_torch.data import GRLoader, SyntheticKuaiRand
    from repro_torch.kernels import jagged_lookup as JL
    from repro_torch.kernels import neg_logits as NL
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import (gr_train_state, make_gr_train_step,
                                      to_device)
    cfg = reduced(get_arch("hstu-tiny")).replace(
        d_model=256, vocab_size=3000, max_seq_len=256, dtype="float32",
        num_negatives=16)
    gen = SyntheticKuaiRand(num_users=40, num_items=cfg.vocab_size,
                            mean_len=150, max_len=400, seed=2)
    seqs = {u: (d["item"], d["ts"]) for u, d in
            ((u, gen.interactions(u)) for u in range(40))}
    batches = list(GRLoader(seqs, 2, 3, cfg.max_seq_len, 16,
                            cfg.vocab_size).batches(4))
    b = GRBundle(cfg)
    g = torch.Generator().manual_seed(0)
    model_cpu = b.init_dense(g, device="cpu")
    master = b.init_table(g, device="cpu")
    model_gpu = b.init_dense(device=cuda)
    model_gpu.load_state_dict(model_cpu.state_dict())
    runs = {}
    for dev, model in (("cuda", model_gpu), ("cpu", model_cpu)):
        state = gr_train_state(model, master.to(dev).clone())
        losses, counts = [], []
        for i, batch in enumerate(batches):
            step = make_gr_train_step(
                lambda d, t, bt, **kw: b.loss(d, t, bt,
                                              neg_scatter_impl="two_pass",
                                              **kw),
                input_gather=b.input_gather, lr_dense=0.0,
                semi_async=i >= 2)
            for c in (ops.KERNEL_LAUNCHES, NL.KERNEL_LAUNCHES,
                      JL.KERNEL_LAUNCHES):
                c.update({k: 0 for k in c})
            state, m = step(state, to_device(batch, dev))
            losses.append(float(m["loss"]))
            counts.append({**ops.KERNEL_LAUNCHES, **NL.KERNEL_LAUNCHES,
                           **JL.KERNEL_LAUNCHES})
        runs[dev] = (state, losses, counts)
    (sg, lg, cg), (sc, lc, cc) = runs["cuda"], runs["cpu"]
    L = cfg.num_layers
    want = {k: 0 for k in cg[0]}
    want.update({"attn_fwd": 2 * L, "attn_bwd": L, "neg_fwd": 1,
                 "neg_bwd": 1, "runsum": 1})
    assert cg == [want] * 4
    assert all(v == 0 for c in cc for v in c.values())
    np.testing.assert_allclose(lg, lc, atol=1e-4, rtol=0)
    assert torch.equal(sg.table.shadow, sg.table.master.half())
    dm = (sg.table.master.cpu() - sc.table.master).abs()
    assert dm.max() <= 1e-4 and (dm > 1e-6).float().mean() <= 1e-3
    assert torch.equal(sg.pending_ids.cpu(), sc.pending_ids)
    assert _rel_to_max(sg.pending_rows.cpu(), sc.pending_rows) <= 1e-4


@pytest.mark.parametrize("o_dtype", [torch.float32, torch.bfloat16])
def test_wscatter_kernel_matches_plain_version(cuda, o_dtype):
    """K5 on 96 K negative slots (runs of 1 to 3000) and 3 K ready rows,
    with a run of dropped ids: the unique ids ≥ 0, totals to 1e-5 of their
    largest value against the plain version (which adds on the card with
    atomics), bit for bit against two-pass rows + K6 (the same rounded
    products added in the same order) and run to run; the wrapper refuses
    an o it does not take."""
    from repro_torch.kernels.jagged_lookup import ops as JL
    from repro_torch.kernels.jagged_lookup.ref import \
        weighted_run_totals_plain
    g = torch.Generator(device=cuda).manual_seed(6)
    T, R, D = 768, 128, 1024
    neg = torch.randint(0, 1 << 22, (T * R,), device=cuda, generator=g)
    neg[:3000] = 17
    ids = torch.cat([neg, torch.randint(0, 40, (3000,), device=cuda,
                                        generator=g),
                     torch.full((50,), -1, device=cuda)]).to(torch.int32)
    o = torch.randn(T, D, device=cuda, generator=g).to(o_dtype)
    w = torch.rand(T, R, device=cuda, generator=g)
    extra = torch.randn(ids.numel() - T * R, D, device=cuda, generator=g)
    order, sids = JL.sort_pairs(ids)
    before = JL.KERNEL_LAUNCHES["wscatter"]
    u, out = JL.weighted_run_totals(o, w, extra, order, sids, scale=1 / 0.7)
    u2, again = JL.weighted_run_totals(o, w, extra, order, sids,
                                       scale=1 / 0.7)
    torch.cuda.synchronize()
    assert JL.KERNEL_LAUNCHES["wscatter"] == before + 2
    assert torch.equal(out, again) and torch.equal(u, u2)
    assert torch.equal(u, torch.unique(ids[ids >= 0]))
    _, _, n_runs, _, _ = JL._runs(sids)
    plain = weighted_run_totals_plain(o, w, extra, order, sids, n_runs,
                                      JL.DROP_KEY, 1 / 0.7)[:u.numel()]
    assert _rel_to_max(out, plain) <= 1e-5
    rows = torch.cat([(w[:, :, None] * (o.float() * (1 / 0.7))[:, None])
                      .reshape(T * R, D), extra])
    u6, out6 = JL.run_totals(rows, order, sids)
    assert torch.equal(u6, u) and torch.equal(out6, out)
    with pytest.raises(ValueError, match="wscatter kernel"):
        JL.weighted_run_totals(o.half(), w, extra, order, sids, scale=1.0)


def test_engine_on_card_matches_flat_step(cuda):
    """GREngine on the card (fp32, d 256 so the negative kernels take it),
    algorithm1 and flat, τ=1, 4 steps, against make_gr_train_step from the
    same init: the same losses and the same bits in every state tensor and
    the carry; every step launches K5 once and K6 never."""
    from repro_torch.data import GRLoader, SyntheticKuaiRand
    from repro_torch.kernels import jagged_lookup as JL
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import (GREngine, clone_state, gr_train_state,
                                      make_gr_step_fn, state_tensors,
                                      to_device)
    cfg = reduced(get_arch("hstu-tiny")).replace(
        d_model=256, vocab_size=3000, max_seq_len=256, dtype="float32",
        num_negatives=16)
    gen = SyntheticKuaiRand(num_users=40, num_items=cfg.vocab_size,
                            mean_len=150, max_len=400, seed=2)
    seqs = {u: (d["item"], d["ts"]) for u, d in
            ((u, gen.interactions(u)) for u in range(40))}
    batches = list(GRLoader(seqs, 2, 3, cfg.max_seq_len, 16,
                            cfg.vocab_size).batches(4))
    b = GRBundle(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    init = gr_train_state(b.init_dense(g, device=cuda),
                          b.init_table(g, device=cuda))

    step = make_gr_step_fn(b)
    ref, losses = clone_state(init), []
    for batch in batches:
        ref, m = step(ref, to_device(batch, cuda))
        losses.append(float(m["loss"]))
    for sched in ("algorithm1", "flat"):
        JL.KERNEL_LAUNCHES.update(runsum=0, wscatter=0, gather=0)
        eng = GREngine(b, lambda i: batches[i], state=clone_state(init),
                       schedule=sched)
        assert [r["loss"] for r in eng.run(4)] == losses, sched
        assert JL.KERNEL_LAUNCHES == {"runsum": 0, "wscatter": 4,
                                      "gather": 0}
        assert all(torch.equal(x, y) for x, y in
                   zip(state_tensors(eng.state), state_tensors(ref))), sched


@pytest.mark.parametrize("mode", ["bucket", "functional"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_schedule_kernels_match_worklist_and_plain(cuda, dtype, mode):
    """K8 (``schedule="dense"``) against K1-fwd/K2 on the same plan, bit
    for bit (the dense grid visits each CTA's live blocks in the
    work-list's order), and against the plain version at K1/K2's
    tolerances; only the dense counters move."""
    H, D, cap = 8, 128, 1024
    q, k, v, offs, ts = _pack(cuda, dtype, H, D,
                              [[500, 3, 0, 300, 129], [0, 0, 0]], cap)
    pt = torch.randn(256, H, device=cuda) * 0.5
    functional = mode == "functional"
    tt = (_functional_time(cuda, H) if functional
          else torch.randn(32, H, device=cuda) * 0.5)
    plan = ops._as_batched(build_attn_plan(offs, ts, cap, block=128,
                                           max_row_len=1024))
    kw = dict(scale=D ** -0.5, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=True, time_functional=functional)
    dy = ops._masked(plan.meta_i32, torch.randn_like(q))
    before = dict(ops.KERNEL_LAUNCHES)
    out = ops._launch_fwd(q, k, v, pt, tt, plan, dense=True, **kw)
    got = ops._launch_bwd(q, k, v, dy, pt, tt, plan, dense=True, **kw)
    torch.cuda.synchronize()
    moved = {n: ops.KERNEL_LAUNCHES[n] - before[n] for n in before}
    fwd = ops.launch_counter("fwd", dense=True, functional=functional)
    bwd = ops.launch_counter("bwd", dense=True, functional=functional)
    assert moved == {n: int(n in (fwd, bwd)) for n in before}
    wl_out = ops._launch_fwd(q, k, v, pt, tt, plan, **kw)
    wl = ops._launch_bwd(q, k, v, dy, pt, tt, plan, **kw)
    assert torch.equal(out, wl_out)
    for name, a, b in zip(("dq", "dk", "dv", "dpt", "dtt"), got, wl):
        assert torch.equal(a, b), name
    plain = attention_fwd_plain(q, k, v, pt, tt, plan, **kw)
    out, plain = (ops._masked(plan.meta_i32, t) for t in (out, plain))
    if dtype == torch.float32:
        assert (out - plain).abs().max().item() <= 1e-4
    else:
        assert max_row_rel_err(out, plain) <= 1e-2


def test_dense_schedule_through_the_entry_points(cuda):
    """``make_attn_fn(schedule="dense")`` launches K8 and never K1/K2, and
    gives ``jagged_attention``'s worklist output and grads bit for bit; an
    unknown schedule raises."""
    from repro_torch.kernels.jagged_attention import make_attn_fn
    H, D, cap = 8, 64, 512
    q, k, v, offs, ts = _pack(cuda, torch.bfloat16, H, D,
                              [[300, 0, 200, 12]], cap)
    rab = {"pos_table": torch.randn(256, H, device=cuda) * 0.5,
           "time_table": torch.randn(32, H, device=cuda) * 0.5}
    outs, grads = {}, {}
    for schedule in ("worklist", "dense"):
        fn = make_attn_fn(schedule=schedule, max_row_len=512)
        plan = fn.make_plan(offs[0], ts[0], cap)
        qq, kk, vv = (t[0].clone().requires_grad_() for t in (q, k, v))
        before = dict(ops.KERNEL_LAUNCHES)
        outs[schedule] = fn(qq, kk, vv, offs[0], ts[0], rab, RABConfig(),
                            plan=plan)
        outs[schedule].float().square().sum().backward()
        moved = {n for n in before if ops.KERNEL_LAUNCHES[n] != before[n]}
        assert moved == ({"attn_fwd_dense", "attn_bwd_dense"}
                         if schedule == "dense" else
                         {"attn_fwd", "attn_bwd"})
        grads[schedule] = (qq.grad, kk.grad, vv.grad)
    assert torch.equal(outs["dense"], outs["worklist"])
    for a, b in zip(grads["dense"], grads["worklist"]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown schedule"):
        make_attn_fn(schedule="diagonal")


@pytest.mark.parametrize("case", ["bf16_o_bf16_n", "bf16_o_fp16_n",
                                  "fp32_o_fp32_n_tau"])
def test_neg_logits_kernels_match_plain_version(cuda, case):
    """K9 against its plain version: the logits and do are fp32 sums over D
    and R in another order (1e-4 of their largest value), dn is one
    rounding of the same fp32 product (bitwise); both bit-identical run to
    run; D of a few widths."""
    from repro_torch.kernels import neg_logits as NL
    from repro_torch.kernels.neg_logits import ref as NR
    o_dt, n_dt, tau, D = {
        "bf16_o_bf16_n": (torch.bfloat16, torch.bfloat16, 1.0, 1024),
        "bf16_o_fp16_n": (torch.bfloat16, torch.float16, 1.0, 256),
        "fp32_o_fp32_n_tau": (torch.float32, torch.float32, 0.7, 68)}[case]
    g = torch.Generator(device=cuda).manual_seed(5)
    T, R = 300, 24
    o = torch.randn(T, D, device=cuda, generator=g).to(o_dt)
    n = (torch.randn(T, R, D, device=cuda, generator=g) * 0.05).to(n_dt)
    gr = torch.randn(T, R, device=cuda, generator=g)
    before = dict(NL.KERNEL_LAUNCHES)
    out = NL.neg_logits_fwd(o, n, inv_tau=1 / tau)
    do, dn = NL.neg_logits_bwd(o, n, gr, inv_tau=1 / tau)
    torch.cuda.synchronize()
    assert NL.KERNEL_LAUNCHES["neg_logits_fwd"] == \
        before["neg_logits_fwd"] + 1
    assert NL.KERNEL_LAUNCHES["neg_logits_bwd"] == \
        before["neg_logits_bwd"] + 1
    assert torch.equal(NL.neg_logits_fwd(o, n, inv_tau=1 / tau), out)
    do2, dn2 = NL.neg_logits_bwd(o, n, gr, inv_tau=1 / tau)
    assert torch.equal(do, do2) and torch.equal(dn, dn2)
    assert dn.dtype == n_dt and do.dtype == torch.float32
    assert _rel_to_max(out, NR.neg_logits_ref(o, n, tau)) <= 1e-4
    p_do, p_dn = NR.neg_logits_bwd_plain(o, n, gr, inv_tau=1 / tau)
    assert _rel_to_max(do, p_do) <= 1e-4
    assert torch.equal(dn, p_dn)


def test_neg_logits_op_and_wrapper_checks(cuda):
    """``neg_logits`` pads T to a segment multiple and hands dn to its
    callback; the wrapper raises on a row width that is no whole number of
    16-byte vectors."""
    from repro_torch.kernels import neg_logits as NL
    o = torch.randn(70, 64, device=cuda, requires_grad=True)
    n = torch.randn(70, 5, 64, device=cuda).to(torch.bfloat16)
    seen = []
    out = NL.neg_logits(o, n, segment=32, on_neg_grad=seen.append)
    out.sum().backward()
    assert out.shape == (70, 5) and seen[0].shape == (70, 5, 64)
    assert torch.equal(seen[0], (o.detach()[:, None, :]
                                 .expand(70, 5, 64)).to(torch.bfloat16))
    with pytest.raises(ValueError, match="16-byte vectors"):
        NL.neg_logits_fwd(o.detach()[:, :60].contiguous(),
                          n[:, :, :60].contiguous(), inv_tau=1.0)


@pytest.mark.parametrize("tdt,odt", [(torch.float32, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.float16, torch.float16)])
def test_gather_kernel_matches_plain_version(cuda, tdt, odt):
    """K7 bitwise against its plain version and against index_select +
    mask + cast, with ids < 0 (zero rows) and ids ≥ V (row V − 1); the
    lookup's grad is the dense scatter of the row grads."""
    from repro_torch.kernels import jagged_lookup as JL
    from repro_torch.kernels.jagged_lookup import ref as JR
    V, D, n = 1000, 96, 777
    g = torch.Generator(device=cuda).manual_seed(9)
    table = torch.randn(V, D, device=cuda, generator=g).to(tdt)
    ids = torch.randint(-3, V + 4, (n,), device=cuda, generator=g)
    before = JL.KERNEL_LAUNCHES["gather"]
    out = JL.gather_rows(table, ids, odt)
    torch.cuda.synchronize()
    assert JL.KERNEL_LAUNCHES["gather"] == before + 1
    assert torch.equal(out, JR.jagged_lookup_ref(table, ids,
                                                 compute_dtype=odt))
    lib = torch.index_select(table, 0, ids.clamp(0, V - 1)).to(odt)
    lib = lib * (ids >= 0)[:, None].to(odt)
    assert torch.equal(out, lib)
    t = table.float().requires_grad_()
    y = JL.jagged_lookup(t, ids, compute_dtype=odt)
    dy = torch.randn(y.shape, device=cuda, generator=g)
    (y.float() * dy).sum().backward()
    # the rows' cotangent reaches the lookup in the compute dtype
    keep = (ids >= 0) & (ids < V)
    want = torch.zeros_like(t).index_add_(0, ids[keep],
                                          dy.to(odt).float()[keep])
    assert _rel_to_max(t.grad, want) <= 1e-6


# --------------------------------------------------------------------------
# the redesigned kernels: K2's tensor-core path, K5's tiles of runs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bucket", "functional"])
def test_attn_bwd_tensor_cores_on_a_2048_token_row(cuda, mode):
    """bf16 K2 (the tensor-core kernels) at hstu-large's head dim 128 on a
    pack with a 2048-token row beside an all-padding pack, in both time
    modes: dq, dk, dv per (token, head) within 1e-2 relative L2 of the
    plain version (which keeps a and ds in fp32: the kernels' bf16
    operands are a declared divergence), the fp32 table grads within 1e-4
    of their largest value, every result the same bits run to run, pad
    rows zero, and K8-bwd (the dense grid) bitwise equal to K2."""
    from repro_torch.kernels.jagged_attention.ref import attention_bwd_plain
    H, D, cap = 8, 128, 4096
    q, k, v, offs, ts = _pack(cuda, torch.bfloat16, H, D,
                              [[2048, 700, 3, 0, 300], [0, 0, 0]], cap)
    functional = mode == "functional"
    pt = torch.randn(256, H, device=cuda) * 0.5
    tt = (_functional_time(cuda, H) if functional
          else torch.randn(32, H, device=cuda) * 0.5)
    plan = ops._as_batched(build_attn_plan(offs, ts, cap, block=128,
                                           max_row_len=2048))
    kw = dict(scale=D ** -0.5, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=True, time_functional=functional)
    dy = ops._masked(plan.meta_i32, torch.randn_like(q))
    got = ops._launch_bwd(q, k, v, dy, pt, tt, plan, **kw)
    again = ops._launch_bwd(q, k, v, dy, pt, tt, plan, **kw)
    dense = ops._launch_bwd(q, k, v, dy, pt, tt, plan, dense=True, **kw)
    torch.cuda.synchronize()
    want = attention_bwd_plain(q, k, v, dy, pt, tt, plan, **kw)
    for name, a, b, c, d in zip(("dq", "dk", "dv", "dpt", "dtt"), got,
                                want, again, dense):
        assert torch.equal(a, c), f"{name} differs between runs"
        assert torch.equal(a, d), f"{name}: K8-bwd differs from K2"
        assert torch.isfinite(a.float()).all(), name
        if name in ("dpt", "dtt"):
            assert _rel_to_max(a, b) <= 1e-4, (name, _rel_to_max(a, b))
        else:
            assert max_row_rel_err(a, b) <= 1e-2, name
            assert torch.count_nonzero(a[1]) == 0, name


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("o_dtype,D", [(torch.bfloat16, 1024),
                                       (torch.float32, 1024),
                                       (torch.bfloat16, 2048),
                                       (torch.bfloat16, 1020)])
def test_wscatter_every_class_of_run_length(cuda, o_dtype, D):
    """K5 over runs of 1, of 2 to 32 rows (one warp each), of 33 to 4096
    (the whole CTA), ready-row-only runs, a dropped run longer than a warp
    takes, and rows of −0.0 (a run of them totals +0.0, as K6's does); D
    1024, 2048 (four 512-column passes of a warp) and 1020 (a ragged last
    pass). Bitwise equal to two-pass rows + K6, the same bits run to run,
    within 1e-5 of the largest total of the plain version."""
    from repro_torch.kernels.jagged_lookup import ops as JL
    from repro_torch.kernels.jagged_lookup.ref import \
        weighted_run_totals_plain
    rng = np.random.default_rng(11)
    R = 16
    lens = [1] * 400 + list(range(2, 33)) * 3 + [33, 34, 64, 200, 777, 4096]
    neg = np.concatenate([np.full(n, i) for i, n in enumerate(lens)])
    n_ids = len(lens)
    T = -(-(neg.size + 40) // R)
    neg = np.concatenate([neg, np.full(T * R - neg.size, -1)])
    rng.shuffle(neg)
    ready = np.concatenate([rng.integers(0, n_ids, 150),       # shared
                            n_ids + rng.integers(0, 60, 120),  # ready only
                            np.full(30, -1)])
    ids = torch.from_numpy(np.concatenate([neg, ready]).astype(np.int32)
                           ).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(12)
    o = torch.randn(T, D, device=cuda, generator=g).to(o_dtype)
    o[::7] = -0.0
    w = torch.rand(T, R, device=cuda, generator=g) - 0.5
    extra = torch.randn(ready.size, D, device=cuda, generator=g)
    extra[::5] = -0.0
    extra[-31] = -0.0                     # a ready-only id of one −0 row
    ids[-31] = n_ids + 100
    order, sids = JL.sort_pairs(ids)
    scale = 1 / 0.7
    before = JL.KERNEL_LAUNCHES["wscatter"]
    u, out = JL.weighted_run_totals(o, w, extra, order, sids, scale=scale)
    u2, again = JL.weighted_run_totals(o, w, extra, order, sids,
                                       scale=scale)
    torch.cuda.synchronize()
    assert JL.KERNEL_LAUNCHES["wscatter"] == before + 2
    assert torch.equal(u, u2) and torch.equal(_bits(out), _bits(again))
    assert torch.equal(u, torch.unique(ids[ids >= 0]))
    rows = torch.cat([(w[:, :, None] * (o.float() * scale)[:, None])
                      .reshape(T * R, D), extra])
    u6, out6 = JL.run_totals(rows, order, sids)
    assert torch.equal(u6, u) and torch.equal(_bits(out6), _bits(out))
    lone = int((u == n_ids + 100).nonzero())
    assert torch.equal(_bits(out[lone]), torch.zeros_like(_bits(out[lone])))
    _, _, n_runs, _, _ = JL._runs(sids)
    plain = weighted_run_totals_plain(o, w, extra, order, sids, n_runs,
                                      JL.DROP_KEY, scale)[:u.numel()]
    assert _rel_to_max(out, plain) <= 1e-5


# --------------------------------------------------------------------------
# K1-fwd on the tensor cores, the fp32 K2 at the training pack, K9-fwd's grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bucket", "functional"])
def test_attn_fwd_tensor_cores_on_a_2048_token_row(cuda, mode):
    """bf16 K1-fwd (the tensor-core kernel) at hstu-large's head dim 128 on
    a pack with a 2048-token row beside an all-padding pack, in both time
    modes: per (token, head) within 1e-2 relative L2 of the plain version,
    the same bits run to run, pad rows zero, and K8-fwd (the dense grid)
    bitwise equal to it."""
    H, D, cap = 8, 128, 4096
    q, k, v, offs, ts = _pack(cuda, torch.bfloat16, H, D,
                              [[2048, 700, 3, 0, 300], [0, 0, 0]], cap)
    functional = mode == "functional"
    pt = torch.randn(256, H, device=cuda) * 0.5
    tt = (_functional_time(cuda, H) if functional
          else torch.randn(32, H, device=cuda) * 0.5)
    plan = ops._as_batched(build_attn_plan(offs, ts, cap, block=128,
                                           max_row_len=2048))
    kw = dict(scale=D ** -0.5, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=True, time_functional=functional)
    before = dict(ops.KERNEL_LAUNCHES)
    got = ops._launch_fwd(q, k, v, pt, tt, plan, **kw)
    again = ops._launch_fwd(q, k, v, pt, tt, plan, **kw)
    dense = ops._launch_fwd(q, k, v, pt, tt, plan, dense=True, **kw)
    torch.cuda.synchronize()
    name = "attn_fwd_functional" if functional else "attn_fwd"
    assert ops.KERNEL_LAUNCHES[name] == before[name] + 2
    want = attention_fwd_plain(q, k, v, pt, tt, plan, **kw)
    assert torch.equal(got, again)
    assert torch.equal(got, dense)
    assert max_row_rel_err(ops._masked(plan.meta_i32, got),
                           ops._masked(plan.meta_i32, want)) <= 1e-2
    assert torch.count_nonzero(got[0, 3051:]) == 0
    assert torch.count_nonzero(got[1]) == 0


def test_fp32_attn_bwd_functional_training_pack_against_float64(cuda):
    """fp32 K2 in the functional time mode at the engine's training pack
    (1 x 4 rows of 2048): every grad within 1e-4 of the largest value of
    the float64 plain version. The far position bucket sums millions of
    terms of both signs, so the fp32 plain version's own order is no
    yardstick there."""
    from repro_torch.kernels.jagged_attention.ref import attention_bwd_plain
    H, D, cap = 8, 128, 8192
    q, k, v, offs, ts = _pack(cuda, torch.float32, H, D, [[2048] * 4], cap)
    pt = torch.randn(256, H, device=cuda) * 0.5
    tt = _functional_time(cuda, H)
    plan = ops._as_batched(build_attn_plan(offs, ts, cap, block=128,
                                           max_row_len=2048))
    kw = dict(scale=D ** -0.5, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=True, time_functional=True)
    dy = torch.randn_like(q)
    got = ops._launch_bwd(q, k, v, dy, pt, tt, plan, **kw)
    want = attention_bwd_plain(q, k, v, dy, pt, tt, plan,
                               acc_dtype=torch.float64, **kw)
    for name, a, b in zip(("dq", "dk", "dv", "dpt", "dtt"), got, want):
        assert _rel_to_max(a, b) <= 1e-4, (name, _rel_to_max(a, b))


@pytest.mark.parametrize("T", [128, 8192])
@pytest.mark.parametrize("n_dtype", [torch.float16, torch.bfloat16])
def test_neg_logits_fwd_grid_at_segment_and_baseline_shapes(cuda, T,
                                                            n_dtype):
    """K9-fwd at a 128-token segment (several CTAs a token) and at the
    baseline's 8192 tokens (one), R = 128, d 1024, bf16 o: within 1e-4 of
    the largest logit of the plain version, the same bits run to run."""
    from repro_torch.kernels import neg_logits as NL
    from repro_torch.kernels.neg_logits import ref as NR
    g = torch.Generator(device=cuda).manual_seed(11)
    R, D = 128, 1024
    o = torch.randn(T, D, device=cuda, generator=g).to(torch.bfloat16)
    n = (torch.randn(T, R, D, device=cuda, generator=g) * 0.02).to(n_dtype)
    out = NL.neg_logits_fwd(o, n, inv_tau=1.0)
    assert torch.equal(out, NL.neg_logits_fwd(o, n, inv_tau=1.0))
    assert _rel_to_max(out, NR.neg_logits_ref(o, n)) <= 1e-4
    assert NL.fwd_row_split(T, R) == (4 if T == 128 else 1)


@pytest.mark.parametrize("T,n_dtype", [(128, torch.float16),
                                       (8192, torch.bfloat16)])
def test_k9_fwd_row_split_knob_keeps_bits(cuda, tmp_path, monkeypatch, T,
                                          n_dtype):
    """K9-fwd's tunable row split (``kernels/autotune.py``): every valid
    candidate gives the heuristic split's bits; a split stored for the
    shape is what ``neg_logits_fwd`` launches with when given none."""
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import neg_logits as NL
    monkeypatch.setenv("REPRO_TORCH_TUNED_JSON", str(tmp_path / "t.json"))
    g = torch.Generator(device=cuda).manual_seed(26)
    R, D = 128, 1024
    o = torch.randn(T, D, device=cuda, generator=g).to(torch.bfloat16)
    n = (torch.randn(T, R, D, device=cuda, generator=g) * 0.02).to(n_dtype)
    want = NL.neg_logits_fwd(o, n, inv_tau=1.0)
    assert NL.LAUNCH_KNOBS["neg_logits_fwd"]["row_split"] == \
        NL.fwd_row_split(T, R)
    dims = NL.nl_fwd_dims(o, n)
    cands = [c["row_split"] for c in AT.enumerate_candidates(
        "neg_logits_fwd", dims)]
    assert cands == [1, 2, 4]
    for split in cands:
        assert torch.equal(NL.neg_logits_fwd(o, n, inv_tau=1.0,
                                             row_split=split), want), split
        st = AT.TunedStore()
        st.put("neg_logits_fwd", dims, {"row_split": split})
        st.save()
        assert torch.equal(NL.neg_logits_fwd(o, n, inv_tau=1.0), want)
        assert NL.LAUNCH_KNOBS["neg_logits_fwd"]["row_split"] == split


def _uneven_perms(n_seg, seg, expansion, seed):
    """Sharing perms that are no permutation: in every slot some sources
    have two or four consumers and others none."""
    rng = np.random.default_rng(seed)
    perms = np.empty((n_seg, expansion - 1, seg), np.int32)
    for s in range(n_seg):
        for e in range(expansion - 1):
            p = (np.arange(seg) + rng.integers(1, seg)) % seg
            c = rng.choice(seg, 4, replace=False)
            p[c[1]] = p[c[0]]
            p[c[2]] = p[c[3]] = p[c[0]]
            perms[s, e] = p
    return torch.from_numpy(perms)


@pytest.mark.parametrize("case", ["e1", "e4", "e3_uneven"])
def test_neg_bwd_at_the_engine_shape(cuda, case):
    """K4 at the engine's shape (T 8192, R 128, d 1024, bf16 o, fp16
    shadow) with a quarter of the tokens invalid: at expansion 1, 4
    (generator-drawn shifts) and 3 with perms where sources have several
    consumers or none. w to 1e-6 and dpos to 1e-5 absolute, dout to 1e-4
    of its largest value against the plain version (sums over D and R in
    another order); the same bits run to run."""
    from repro_torch.kernels import neg_logits as NL
    from repro_torch.kernels.neg_logits import ref as NR
    expansion = {"e1": 1, "e4": 4, "e3_uneven": 3}[case]
    gen = torch.Generator(device=cuda).manual_seed(17)
    T, R, D, V, seg = 8192, 128, 1024, 1 << 20, 128
    shadow = (torch.randn(V, D, device=cuda, generator=gen) * 0.02).half()
    o = torch.randn(T, D, device=cuda, generator=gen).to(torch.bfloat16)
    ids = torch.randint(0, V, (T, R), device=cuda, generator=gen)
    valid = torch.rand(T, device=cuda, generator=gen) > 0.25
    pos = torch.randn(T, device=cuda, generator=gen) * 0.64
    perms = (_uneven_perms(T // seg, seg, expansion, 3).to(cuda)
             if case.endswith("uneven") else None)
    o_p, pos_p, ids_p, valid_p, perms, _ = NL.prepare_fused_inputs(
        o, pos, V, ids, segment=seg, expansion=expansion, generator=gen,
        valid=valid, perms=perms)
    kw = dict(segment=seg, R=R, expansion=expansion, inv_tau=1.0,
              fetch_dtype=None)
    args = (o_p, pos_p, shadow, ids_p, valid_p, perms)
    lse = NL.neg_fwd(*args, **kw)
    g = torch.rand(T, device=cuda, generator=gen) * valid_p / T
    before = NL.KERNEL_LAUNCHES["neg_bwd"]
    got = NL.neg_bwd(*args, lse, g, **kw)
    again = NL.neg_bwd(*args, lse, g, **kw)
    torch.cuda.synchronize()
    assert NL.KERNEL_LAUNCHES["neg_bwd"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    w, dout, dpos = got
    pw, pdout, pdpos = NR.neg_bwd_plain(*args, lse, g, **kw)
    assert (w - pw).abs().max().item() <= 1e-6
    assert (dpos - pdpos).abs().max().item() <= 1e-5
    assert _rel_to_max(dout, pdout) <= 1e-4


@pytest.mark.parametrize("T,R,D,n_dtype,o_dtype", [
    (128, 128, 1024, torch.float16, torch.bfloat16),
    (128, 128, 1024, torch.bfloat16, torch.bfloat16),
    (8192, 128, 1024, torch.float16, torch.bfloat16),
    (8192, 128, 1024, torch.bfloat16, torch.bfloat16),
    (64, 99, 68, torch.float32, torch.float32),
    (128, 33, 1032, torch.bfloat16, torch.float32),
    (300, 24, 68, torch.float32, torch.bfloat16)])
def test_neg_logits_bwd_split_at_segment_and_baseline_shapes(cuda, T, R, D,
                                                             n_dtype,
                                                             o_dtype):
    """K9-bwd at a 128-token segment (4 row groups a token), at the
    baseline's 8192 tokens (one), and at R and d that the split leaves
    uneven (99 rows in 4 groups, 33 in 2; d 68 and 1032, more than one
    column vector a thread): dn bitwise equal to the plain version, do
    within 1e-4 of its largest value, both the same bits run to run."""
    from repro_torch.kernels import neg_logits as NL
    from repro_torch.kernels.neg_logits import ref as NR
    g = torch.Generator(device=cuda).manual_seed(13)
    o = torch.randn(T, D, device=cuda, generator=g).to(o_dtype)
    n = (torch.randn(T, R, D, device=cuda, generator=g) * 0.02).to(n_dtype)
    gr = torch.randn(T, R, device=cuda, generator=g) * 1e-3
    do, dn = NL.neg_logits_bwd(o, n, gr, inv_tau=1 / 0.9)
    do2, dn2 = NL.neg_logits_bwd(o, n, gr, inv_tau=1 / 0.9)
    torch.cuda.synchronize()
    assert torch.equal(do, do2) and torch.equal(dn, dn2)
    p_do, p_dn = NR.neg_logits_bwd_plain(o, n, gr, inv_tau=1 / 0.9)
    assert torch.equal(dn, p_dn)
    assert _rel_to_max(do, p_do) <= 1e-4
    assert NL.bwd_row_split(T, R) == {(128, 128): 4, (8192, 128): 1,
                                      (64, 99): 4, (128, 33): 2,
                                      (300, 24): 1}[(T, R)]


# --------------------------------------------------------------------------
# K1-fwd's append launch and the streaming engine
# --------------------------------------------------------------------------

def _append_case(dev, dtype, H, D, seed=3, mode="bucket"):
    """Two slots of a cache of cap 512 (one the scratch lane), three window
    rows: a window inside a q-block, one crossing into the next, and a
    1-wide one; the RAB inputs of ``mode``."""
    rng = np.random.default_rng(seed)
    N1, cap, Q = 5, 512, 6
    kc, vc = (torch.from_numpy(rng.standard_normal((N1, cap, H, D))
                               .astype(np.float32)).to(dev, dtype)
              for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((3, Q, H, D)).astype(
        np.float32)).to(dev, dtype)
    rows = torch.tensor([2, 0, 3], dtype=torch.int32, device=dev)
    pref = torch.tensor([40, 125, 300], dtype=torch.int32, device=dev)
    total = pref + torch.tensor([6, 5, 1], dtype=torch.int32, device=dev)
    ts = torch.from_numpy(np.cumsum(rng.integers(0, 4000, (3, cap)), axis=1)
                          .astype(np.int32)).to(dev)
    if mode == "bucket":
        pt = torch.randn(256, H, device=dev) * 0.5
        tt = torch.randn(32, H, device=dev) * 0.5
    else:
        pt, tt = torch.randn(256, H, device=dev) * 0.5, _functional_time(
            dev, H)
    kw = dict(scale=D ** -0.5, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=True,
              time_functional=mode == "functional")
    return (q, kc, vc, rows, ts, pref, total, pt, tt,
            ops.position_ninv(cap, dev)), kw


@pytest.mark.parametrize("mode", ["bucket", "functional"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_append_launch_matches_plain_version(cuda, dtype, mode):
    from repro_torch.kernels.jagged_attention import attention_append_plain
    args, kw = _append_case(cuda, dtype, 8, 128, mode=mode)
    counter = ops.launch_counter("fwd_append", dense=False,
                                 functional=mode == "functional")
    before = ops.KERNEL_LAUNCHES[counter]
    out = ops.attention_append(*args, **kw)
    again = ops.attention_append(*args, **kw)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES[counter] == before + 2
    assert torch.equal(out, again)                      # run to run
    plain = attention_append_plain(*args, block=128, **kw)
    if dtype == torch.float32:
        assert (out - plain).abs().max().item() <= 1e-4
    else:
        assert max_row_rel_err(out, plain) <= 1e-2
    total, pref = args[6], args[5]
    for r in range(3):                         # window rows past T are 0
        n = int(total[r] - pref[r])
        assert torch.count_nonzero(out[r, n:]) == 0


@pytest.mark.parametrize("mode", ["bucket", "functional"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_append_launch_gives_the_cold_launch_bits(cuda, dtype, mode):
    """Each row of the window: the bits the cold work-list launch gives the
    same queries on a pack holding the row alone."""
    args, kw = _append_case(cuda, dtype, 8, 128, mode=mode)
    q, kc, vc, rows, ts, pref, total, pt, tt, _ = args
    out = ops.attention_append(*args, **kw)
    for r in range(3):
        p, T, slot = int(pref[r]), int(total[r]), int(rows[r])
        qr = torch.zeros_like(kc[slot])
        qr[p:T] = q[r, :T - p]
        offs = torch.tensor([0, T], dtype=torch.int32, device=cuda)
        plan = ops._as_batched(build_attn_plan(offs, ts[r], 512, block=128))
        cold = ops._launch_fwd(qr[None], kc[slot][None].contiguous(),
                               vc[slot][None].contiguous(), pt, tt, plan,
                               **kw)[0]
        assert torch.equal(out[r, :T - p], cold[p:T]), r


def _stream_models(dev, seq=300):
    cfg = reduced(get_arch("hstu-tiny")).replace(vocab_size=2000,
                                                 max_seq_len=seq)
    g = torch.Generator().manual_seed(0)
    model = GRModel(cfg, device="cpu", generator=g).to(dev)
    master = (torch.randn(cfg.vocab_size, cfg.d_model, generator=g)
              * 0.02).to(dev)
    return cfg, model, master


def test_warm_append_equals_cold_encode_bitwise(cuda):
    """Chained warm appends (a 1-wide one padded to the 2-wide window, and
    one crossing position 128) give the cold encode's emb and live K/V of
    every layer bit for bit, on the card."""
    from repro_torch.models import gr as GR
    from repro_torch.serving import BucketLadder
    cfg, model, master = _stream_models(cuda)
    S, dt = cfg.max_seq_len, GR.torch_dtype(cfg.dtype)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 2000, S).astype(np.int64))
    ts = np.cumsum(rng.integers(1, 3600, S)).astype(np.int32)

    def cold(n):
        row_ids = torch.zeros(S, dtype=torch.int64)
        row_ids[:n] = ids[:n]
        row_ts = np.zeros(S, np.int32)
        row_ts[:n] = ts[:n]
        return GR.gr_serve_row_kv(model, cfg, master[row_ids.to(cuda)].to(dt),
                                  torch.from_numpy(row_ts).to(cuda), n)

    n0 = 120
    emb, k, v = cold(n0)
    row_ts = np.zeros(S, np.int32)
    row_ts[:n0] = ts[:n0]
    pos = n0
    counter = ops.launch_counter("fwd_append", dense=False, functional=False)
    for q in (3, 1, 5, 9, 2):
        row_ts[pos:pos + q] = ts[pos:pos + q]
        qc = BucketLadder(S, min_size=2).bucket(q)
        xw = torch.zeros(qc, cfg.d_model, dtype=dt, device=cuda)
        xw[:q] = master[ids[pos:pos + q].to(cuda)].to(dt)
        before = ops.KERNEL_LAUNCHES[counter]
        emb, k, v = GR.gr_serve_row_append(
            model, cfg, xw, torch.from_numpy(row_ts).to(cuda), k, v, pos, q)
        assert ops.KERNEL_LAUNCHES[counter] == before + cfg.num_layers
        pos += q
        fe, fk, fv = cold(pos)
        assert torch.equal(emb, fe), pos
        assert torch.equal(k[:, :pos], fk[:, :pos]), pos
        assert torch.equal(v[:, :pos], fv[:, :pos]), pos


def test_rank_graph_replay_equals_eager(cuda):
    from repro_torch.serving import StreamingRecallEngine, topk_from_slots
    cfg, model, master = _stream_models(cuda)
    eng = StreamingRecallEngine(cfg, model, master, max_users=16, k=20,
                                retrieval_block=256, max_rows_per_tick=8)
    rng = np.random.default_rng(2)
    reqs = [(u, rng.integers(0, 2000, n), np.cumsum(rng.integers(1, 99, n)))
            for u, n in enumerate((5, 130, 299, 40, 7))]
    res = eng.serve(reqs)
    assert eng.stats()["compile"]["graph_captures"] > 0
    rows = torch.tensor([eng.buffer.slot_of(u) for u, _, _ in reqs]
                        + [eng.buffer.pad_row] * 3, dtype=torch.int32,
                        device=cuda)
    graph = eng._rank_fn(8)(rows)
    graph = [t.clone() for t in graph]
    eager = topk_from_slots(eng.buffer.emb, rows, eng._scan, k=20,
                            block_v=256)
    for a, b in zip(graph, eager):
        assert torch.equal(a, b)
    for r, g_ids in zip(res, graph[1][:5].cpu().numpy()):
        np.testing.assert_array_equal(r.item_ids, g_ids)


@pytest.fixture(scope="module")
def hstu_large_dense():
    """One hstu-large HSTU block's row-local dense ops (``ops(x, y)`` →
    u, v, q, k, the block output and the final norm) and their outputs
    on a cold encode's (32, 2048) tensor, the largest the streaming engine
    builds at 32 rows a tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")
    from types import SimpleNamespace
    from repro_torch.models.gr import _final_norm
    from repro_torch.models.hstu import HSTUBlock, _hstu_output, _hstu_uvqk
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_arch("hstu-large")
    g = torch.Generator(device=dev).manual_seed(0)
    blk = HSTUBlock(cfg, dtype=torch.bfloat16, device=dev, generator=g)
    fin = SimpleNamespace(
        out_ln_w=torch.randn(cfg.d_model, device=dev, generator=g).bfloat16(),
        out_ln_b=torch.randn(cfg.d_model, device=dev, generator=g).bfloat16())
    H, D = cfg.num_heads, cfg.qkv_dim
    X = torch.randn((32, 2048, cfg.d_model), device=dev,
                    generator=g).bfloat16()
    Y = torch.randn((32, 2048, H, D), device=dev, generator=g).bfloat16()

    def ops(x, y):
        u, v, q, k = _hstu_uvqk(blk, cfg, x)
        o = _hstu_output(blk, cfg, x, y, u)
        return u, v, q, k, o, _final_norm(fin, cfg, o)
    return ops, X, Y, ops(X, Y), g


def _stream_rungs():
    """Every (row rung, window rung) the streaming engine builds at
    hstu-large with 32 rows a tick: rows 1..32, windows 2..2048."""
    from repro_torch.serving import BucketLadder
    S = get_arch("hstu-large").max_seq_len
    return [(R, Q) for R in BucketLadder(32).rungs
            for Q in BucketLadder(S, min_size=2).rungs]


@pytest.mark.parametrize("R,Q", _stream_rungs())
def test_hstu_dense_ops_are_row_invariant(hstu_large_dense, R, Q):
    """The warm path's premise on the card: the HSTU block's row-local
    dense ops (the norms, both GEMMs, SiLU, the final norm) give a token
    the same bits in an (R, Q) append window as in the cold encode's
    (32, 2048) tensor, at hstu-large's widths, for every row and window
    rung of the streaming engine (windows are ≥ 2 wide). A cold encode of
    R rows is the case Q = 2048. A row-count-dependent reduction moves a
    norm's output bits in about one row in a hundred, so each rung is
    held on up to 256 windows (at least 4096 rows where the rung is
    smaller)."""
    ops, X, Y, full, g = hstu_large_dense
    dev = X.device
    for _ in range(min(256, max(1, 4096 // (R * Q)))):
        rows = torch.randperm(32, device=dev, generator=g)[:R]
        start = torch.randint(0, 2048 - Q + 1, (R,), device=dev,
                              generator=g)
        pos = start[:, None] + torch.arange(Q, device=dev)
        window = ops(X[rows[:, None], pos], Y[rows[:, None], pos])
        for name, a, b in zip("uvqko", window, full):
            assert torch.equal(a, b[rows[:, None], pos]), name
        assert torch.equal(window[5], full[5][rows[:, None], pos]), \
            "final norm"


@pytest.mark.parametrize("M", [1, 2, 3, 4, 6, 8, 16, 64, 512])
def test_row_stats_do_not_depend_on_the_row_count(cuda, M):
    """Every norm's statistics (hstu._row_stats) give a row of
    hstu-large's width the same fp32 mean and variance in a tensor of M
    rows as in one of 32768: below 16 rows PyTorch's own reduction sums
    the row in another order, so on 2-8 rows about one variance in six
    took another last bit before the statistics were padded."""
    from repro_torch.models.hstu import _row_stats
    g = torch.Generator(device=cuda).manual_seed(M)
    X = (torch.randn(32768, 1024, device=cuda, generator=g) * 3 + 0.5
         ).bfloat16().float()
    mu, var = _row_stats(X)
    for _ in range(max(1, 4096 // M)):
        idx = torch.randint(0, X.shape[0], (M,), device=cuda, generator=g)
        m, v = _row_stats(X[idx])
        assert torch.equal(m, mu[idx]) and torch.equal(v, var[idx])


def test_engine_random_traffic_warm_equals_cold(cuda):
    """Random open-loop traffic (new users of lognormal(5.5, 1.3) events,
    hits, 1-3-event appends, bursts of three, evictions and full resends)
    through the streaming engine on hstu-large (vocab 2^16, 16 slots, 8
    rows a tick): after every tick each user it encoded holds the emb and
    live K/V of every layer of a from-scratch cold encode, bit for bit."""
    from repro_torch.serving import StreamingRecallEngine
    from torch_stream_traffic import drive
    cfg = get_arch("hstu-large").replace(vocab_size=1 << 16)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = GRModel(cfg, device=cuda, generator=g)
    master = torch.randn(cfg.vocab_size, cfg.d_model, device=cuda,
                         generator=g) * 0.02
    eng = StreamingRecallEngine(cfg, model, master, max_users=16, k=20,
                                max_rows_per_tick=8)
    out = drive(eng, np.random.default_rng(0), 150, new_len=(5.5, 1.3))
    assert out["warm_rows"] >= 100 and out["evictions"] > 0, out


def _card_engine_setup(cuda, steps):
    from repro_torch.data import GRLoader, SyntheticKuaiRand
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import gr_train_state
    cfg = reduced(get_arch("hstu-tiny")).replace(
        d_model=256, vocab_size=3000, max_seq_len=256, dtype="float32",
        num_negatives=16)
    gen = SyntheticKuaiRand(num_users=40, num_items=cfg.vocab_size,
                            mean_len=150, max_len=400, seed=2)
    seqs = {u: (d["item"], d["ts"]) for u, d in
            ((u, gen.interactions(u)) for u in range(40))}
    batches = list(GRLoader(seqs, 2, 3, cfg.max_seq_len, 16,
                            cfg.vocab_size).batches(steps))
    b = GRBundle(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    init = gr_train_state(b.init_dense(g, device=cuda),
                          b.init_table(g, device=cuda))
    return b, batches, init


@pytest.mark.parametrize("schedule", ["algorithm1", "flat"])
def test_resilient_run_on_card_equals_uninterrupted(cuda, schedule):
    """GREngine.run_resilient on the card (fp32 hstu-tiny at d 256, τ=1, 8
    steps, async checkpoints every 2, keep 2) with an escalated stage
    exception, a NaN-poisoned batch and a torn save, each followed by a
    restore: every step's loss and every state tensor equal an
    uninterrupted run's bit for bit, and the replayed steps launched the
    attention, the fused negative kernels and K5."""
    import tempfile
    from repro_torch.kernels import jagged_lookup as JL
    from repro_torch.kernels import neg_logits as NL
    from repro_torch.training import GREngine, clone_state, state_tensors
    from repro_torch.training import resilience as R
    b, batches, init = _card_engine_setup(cuda, 8)
    ref = GREngine(b, lambda i: batches[i], state=clone_state(init),
                   schedule=schedule)
    losses = [r["loss"] for r in ref.run(8)]
    faults = [R.FaultSpec("emb_bwd", 2, "exception"),
              R.FaultSpec("dense_fwd", 5, "nan"),
              R.FaultSpec(R.SAVE_SITE, 6, "torn_save", tear="truncated")]
    eng = GREngine(b, lambda i: batches[i], state=clone_state(init),
                   schedule=schedule)
    for c in (ops.KERNEL_LAUNCHES, NL.KERNEL_LAUNCHES, JL.KERNEL_LAUNCHES):
        for k in c:
            c[k] = 0
    with tempfile.TemporaryDirectory() as d:
        recs = eng.run_resilient(8, ckpt_dir=d, ckpt_every=2, keep_last_n=2,
                                 policy=R.FaultPolicy(retries={}),
                                 injector=R.FaultInjector(faults))
    assert len(eng.recoveries) == 3, eng.recoveries
    replayed = sum(ev.steps_lost for ev in eng.recoveries)
    assert replayed > 0
    assert [r["loss"] for r in recs] == losses
    assert all(torch.equal(x, y) for x, y in
               zip(state_tensors(eng.state), state_tensors(ref.state)))
    L = b.cfg.num_layers
    assert ops.KERNEL_LAUNCHES["attn_fwd"] >= 2 * L * (8 + replayed)
    assert NL.KERNEL_LAUNCHES["neg_fwd"] >= 8 + replayed
    assert JL.KERNEL_LAUNCHES["wscatter"] >= 8 + replayed


def test_checkpoint_snapshot_pinned_equals_pageable_and_restores(cuda):
    """A card state's host copy through reused pinned buffers equals the
    pageable one leaf for leaf (twice: the buffers are reused), and a save
    restores into a fresh card state in place, bit for bit."""
    import tempfile
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import gr_train_state, state_tensors
    b, batches, init = _card_engine_setup(cuda, 1)
    bufs = {}
    plain = CKPT.snapshot(init)
    for _ in range(2):
        pinned = CKPT.snapshot(init, buffers=bufs)
        assert pinned.paths == plain.paths and pinned.nbytes == plain.nbytes
        for x, y in zip(pinned.arrays, plain.arrays):
            np.testing.assert_array_equal(x, y)
    assert bufs and all(t.is_pinned() for t in bufs.values() if t.numel())
    with tempfile.TemporaryDirectory() as d:
        CKPT.save(d, 1, init)
        g = torch.Generator(device=cuda).manual_seed(7)
        fresh = gr_train_state(b.init_dense(g, device=cuda),
                               b.init_table(g, device=cuda))
        master = fresh.table.master
        got = CKPT.restore(d, fresh)
    assert got.table.master is master          # in place
    assert all(torch.equal(x, y) for x, y in
               zip(state_tensors(got), state_tensors(init)))


def test_all_finite_on_card_tensors(cuda):
    from repro_torch.training.resilience import all_finite
    x = torch.randn(1000, 64, device=cuda, dtype=torch.bfloat16)
    assert all_finite({"a": x, "b": [torch.ones(3, device=cuda),
                                     torch.arange(5, device=cuda)]})
    x[17, 3] = float("nan")
    assert not all_finite({"a": x})
    y = torch.zeros(8, device=cuda)
    y[-1] = float("-inf")
    assert not all_finite([torch.ones(2, device=cuda), y])


def _banded_card_batch(i, vocab=512, chunk=32, bands=8, cap=64, negs=8):
    """Every id feature of batch i from one rotating band of 2 chunks: with
    a window of 10 chunks under Algorithm 1 (4 batches pinned) each new
    band evicts 2 dirty chunks."""
    rng = np.random.default_rng(1000 + i)
    lo = (i % bands) * 2 * chunk
    hi = lo + 2 * chunk
    return {"ids": rng.integers(lo, hi, (2, cap)).astype(np.int32),
            "labels": rng.integers(lo, hi, (2, cap)).astype(np.int32),
            "timestamps": np.cumsum(rng.integers(1, 60, (2, cap)), 1
                                    ).astype(np.int32),
            "offsets": np.tile(np.asarray([0, cap // 2, cap], np.int32),
                               (2, 1)),
            "neg_ids": rng.integers(lo, hi, (2, cap, negs)).astype(np.int32),
            "rng": np.zeros((2,), np.uint32)}


@pytest.mark.parametrize("schedule", ["algorithm1", "flat"])
def test_cached_engine_on_card_equals_uncached_with_queued_landings(
        cuda, schedule):
    """The embedding cache's two streams on the card: 56 τ=1 steps with a
    window of 10 of 16 chunks (evictions of dirty chunks every band
    rotation), and before each landing a ~5 ms sleep kernel enqueued on the
    main stream, so a victim's landing is still queued when a worker's
    prefetch writes the victim back (the writeback must wait on the
    release's event) and the splice into its slot follows. Every loss and
    the full state (master, accumulator, carry, dense params, moments) bit
    for bit the uncached engine's; the window's shadow is its master
    rounded."""
    from repro_torch.embedding import CachedShadowedTable
    from repro_torch.embedding.tables import shadow_consistent
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import GREngine
    cfg = reduced(get_arch("hstu-tiny")).replace(
        d_model=256, vocab_size=512, max_seq_len=64, dtype="float32",
        num_negatives=8)
    b = GRBundle(cfg)
    N = 56
    lk = dict(neg_segment=32)

    def sleep(i, rec, state):
        torch.cuda._sleep(10_000_000)

    ref = GREngine(b, _banded_card_batch, seed=0, device=cuda,
                   loss_kwargs=lk, schedule=schedule)
    losses = [r["loss"] for r in ref.run(N)]
    g = torch.Generator(device=cuda).manual_seed(0)
    b.init_dense(g, device=cuda)
    cache = CachedShadowedTable(b.init_table(g, device=cuda),
                                capacity_chunks=10, chunk_rows=32,
                                device=cuda)
    cache.warm_up(None)
    eng = GREngine(b, _banded_card_batch, seed=0, loss_kwargs=lk,
                   schedule=schedule, cache=cache, step_callback=sleep)
    got = [r["loss"] for r in eng.run(N)]
    assert got == losses
    k = cache.counters()
    assert k["evictions"] >= N and k["writebacks"] >= N // 2, k
    assert shadow_consistent(cache.window)
    full, want = eng.full_snapshot(), ref.full_snapshot()
    assert full.paths == want.paths
    for p, shape, x, y in zip(full.paths, full.shapes, full.arrays,
                              want.arrays):
        np.testing.assert_array_equal(x.reshape(shape), y.reshape(shape),
                                      err_msg=p)


def test_cached_run_resilient_at_full_vocab(cuda):
    """The embedding cache's checkpoints and recovery at full-width
    hstu-large and the full vocab 2^22 (``chip_smoke.
    check_cached_resilient``): a fresh cached ``run_resilient`` (window 512
    of 4096 chunks, Zipf ids, checkpoints streamed from the host store)
    through a torn first save and a fault after the first intact save,
    bit for bit the uninterrupted uncached run (losses, the final save's
    CRC32s), its peak host RSS within what it counted, and its final step
    restored into a fresh cached engine that trains on bit for bit. About
    6 minutes and ~90 GB of host memory."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    out = chip_smoke.check_cached_resilient()
    assert out["hwm_gb"] <= out["limit_gb"]


def _card_world(entry, kwargs, shape, tmp_path):
    import os
    from repro_torch.launch import mesh as M
    here = os.path.dirname(os.path.abspath(__file__))
    procs = M.spawn_ranks(f"torch_hsp_ranks:{entry}", kwargs, shape=shape,
                          run_dir=str(tmp_path), device="cuda",
                          timeout_s=120, sys_path=[here])
    rcs = M.wait_ranks(procs, 600)
    assert rcs == [0] * len(procs), M.rank_logs(str(tmp_path), len(procs))
    return M.rank_results(str(tmp_path), len(procs))


def test_hsp_lookup_two_ranks_on_card(cuda, tmp_path):
    """Two ranks sharing the card (gloo between them): the HSP lookup's
    forward bit for bit a torch gather of the full table (fp32 and bf16),
    its backward within 1e-5 of the largest grad of ``index_add_`` (fp32
    sums in another order), on the card (K7 at the owners, K6 in the
    exchange)."""
    res = _card_world("card_lookup", dict(V=1 << 16, d=1024, n=8192,
                                          seed=3), (1, 2), tmp_path)
    for r in res:
        assert r["fwd"] and r["bf16"] and r["on"].startswith("cuda"), r
        assert r["grad_rel"] < 1e-5, r


def test_hsp_world_of_one_equals_single_process_on_card(cuda, tmp_path):
    """A world of one rank on the card: ``GREngine`` over the sharded
    table (hstu-large widths, 2 layers, vocab 2^18) bit for bit the
    single-process engine, 3 tau=1 steps."""
    r, = _card_world("card_world1", dict(V=1 << 18, layers=2, upd=2,
                                         steps=3), (1, 1), tmp_path)
    assert r["bitwise"], r


def test_hsp_sharing_world_of_one_equals_single_process_on_card(cuda,
                                                                tmp_path):
    """Logit sharing (expansion 2, segment 96) over a sharded table in a
    world of one on the card: bit for bit the single-process engine."""
    r, = _card_world("card_world1", dict(
        V=1 << 18, layers=2, upd=2, steps=3,
        loss_kwargs=dict(expansion=2, neg_segment=96)), (1, 1), tmp_path)
    assert r["bitwise"], r


# --------------------------------------------------------------------------
# the non-causal mask (K1-fwd, K2 and K8's acausal instantiations)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bucket", "functional"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_acausal_kernels_match_plain_version(cuda, dtype, mode):
    """K1-fwd and K2 on an acausal plan (every key of the row, weights over
    the row length) against the float64 plain versions (an acausal tile
    sends up to 127 diagonals to position bucket 0, a long sum of both
    signs): bf16 outputs and q/k/v grads per (token, head) by relative L2
    ≤ 1e-2, fp32 ones and every table grad (fp32 in either dtype) within
    1e-4 of the largest value; bit-identical run to run; K8 (the dense
    grid) bit for bit K1/K2 on the plan, its counters alone moving."""
    from repro_torch.kernels.jagged_attention.ref import attention_bwd_plain
    H, D, cap = 8, 128, 1024
    q, k, v, offs, ts = _pack(cuda, dtype, H, D,
                              [[500, 3, 0, 300, 129], [0, 0, 0]], cap)
    pt = torch.randn(256, H, device=cuda) * 0.5
    functional = mode == "functional"
    tt = (_functional_time(cuda, H) if functional
          else torch.randn(32, H, device=cuda) * 0.5)
    plan = ops._as_batched(build_attn_plan(offs, ts, cap, block=128,
                                           max_row_len=1024, causal=False))
    kw = dict(scale=D ** -0.5, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=True, time_functional=functional)
    dy = ops._masked(plan.meta_i32, torch.randn_like(q))
    out = ops._launch_fwd(q, k, v, pt, tt, plan, **kw)
    got = ops._launch_bwd(q, k, v, dy, pt, tt, plan, **kw)
    again = ops._launch_bwd(q, k, v, dy, pt, tt, plan, **kw)
    f64 = torch.float64
    plain = attention_fwd_plain(q, k, v, pt, tt, plan, acc_dtype=f64, **kw)
    want = attention_bwd_plain(q, k, v, dy, pt, tt, plan, acc_dtype=f64,
                               **kw)
    out_m, plain_m = (ops._masked(plan.meta_i32, t) for t in (out, plain))
    if dtype == torch.float32:
        assert _rel_to_max(out_m, plain_m) <= 1e-4
    else:
        assert max_row_rel_err(out_m, plain_m) <= 1e-2
    for name, a, b, c in zip(("dq", "dk", "dv", "dpt", "dtt"), got, want,
                             again):
        assert torch.equal(a, c), f"{name} differs between runs"
        assert torch.isfinite(a.float()).all(), name
        if dtype == torch.float32 or name in ("dpt", "dtt"):
            assert _rel_to_max(a, b) <= 1e-4, (name, _rel_to_max(a, b))
        else:
            assert max_row_rel_err(ops._masked(plan.meta_i32, a),
                                   ops._masked(plan.meta_i32, b)) <= 1e-2
    before = dict(ops.KERNEL_LAUNCHES)
    d_out = ops._launch_fwd(q, k, v, pt, tt, plan, dense=True, **kw)
    d_got = ops._launch_bwd(q, k, v, dy, pt, tt, plan, dense=True, **kw)
    torch.cuda.synchronize()
    moved = {n: ops.KERNEL_LAUNCHES[n] - before[n] for n in before}
    fwd = ops.launch_counter("fwd", dense=True, functional=functional)
    bwd = ops.launch_counter("bwd", dense=True, functional=functional)
    assert moved == {n: int(n in (fwd, bwd)) for n in before}
    assert torch.equal(d_out, out)
    assert all(torch.equal(a, b) for a, b in zip(d_got, got))


def test_acausal_entry_points_on_card(cuda):
    """``make_attn_fn(causal=False)`` through the autograd Function on the
    card against the same call on the CPU's plain versions (fp32), and a
    causal plan refused for an acausal call."""
    H, D, cap = 4, 32, 512
    q, k, v, offs, ts = _pack(cuda, torch.float32, H, D, [[300, 0, 150]],
                              cap)
    rab = {"pos_table": torch.randn(256, H, device=cuda) * 0.5,
           "time_table": torch.randn(32, H, device=cuda) * 0.5}
    fn = ops.make_attn_fn(max_row_len=512, causal=False)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t[0].to(dev).requires_grad_() for t in (q, k, v)]
        r = {n: t.to(dev) for n, t in rab.items()}
        o, t_ = offs[0].to(dev), ts[0].to(dev)
        out = fn(*leaves, o, t_, r, RABConfig(), plan=fn.make_plan(o, t_,
                                                                   cap))
        out.sum().backward()
        outs.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    for a, b in zip(*outs):
        assert _rel_to_max(a, b) <= 1e-4
    causal_plan = build_attn_plan(offs[0], ts[0], cap, block=128)
    with pytest.raises(ValueError, match="causal"):
        fn(q[0], k[0], v[0], offs[0], ts[0], rab, RABConfig(),
           plan=causal_plan)


# --------------------------------------------------------------------------
# the asynchronous negative offload (K9 over rows streamed from the host)
# --------------------------------------------------------------------------

def test_offloaded_neg_logits_bitwise_per_segment_k9(cuda):
    """Logits, do and dn of the offloaded path (pinned host rows streamed a
    128-token segment at a time) bit for bit K9 on the same segments held
    on the card; the host rows and their grad are pinned, and the card
    never holds more than a few segments of rows."""
    from repro_torch.core.negative_sampling import (neg_logits_offloaded,
                                                    offload_negatives)
    from repro_torch.kernels.neg_logits import (KERNEL_LAUNCHES,
                                                neg_logits_bwd,
                                                neg_logits_fwd)
    T, R, D, seg = 1024, 64, 256, 128
    gen = torch.Generator(device=cuda).manual_seed(0)
    o = torch.randn(T, D, device=cuda, generator=gen).to(torch.bfloat16)
    rows = torch.randn(T, R, D, device=cuda, generator=gen).half()
    g = torch.randn(T, R, device=cuda, generator=gen)
    host = offload_negatives(rows).requires_grad_()
    assert host.is_pinned() and host.dtype == torch.float16
    assert torch.equal(host.detach().to(cuda), rows)
    oo = o.clone().requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(KERNEL_LAUNCHES)
    logits = neg_logits_offloaded(oo, host, segment=seg)
    logits.backward(g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert KERNEL_LAUNCHES["neg_logits_fwd"] - before["neg_logits_fwd"] \
        == T // seg
    assert KERNEL_LAUNCHES["neg_logits_bwd"] - before["neg_logits_bwd"] \
        == T // seg
    assert host.grad.is_pinned() and host.grad.dtype == torch.float16
    # two card buffers of rows and two of dn, plus the logits and do: under
    # five segments of rows, of the eight the full rows take
    assert peak < 5 * rows[:seg].numel() * rows.element_size(), peak
    for lo in range(0, T, seg):
        s = slice(lo, lo + seg)
        want = neg_logits_fwd(o[s], rows[s], inv_tau=1.0)
        do, dn = neg_logits_bwd(o[s], rows[s], g[s], inv_tau=1.0)
        assert torch.equal(logits[s], want)
        assert torch.equal(oo.grad[s], do.to(o.dtype))
        assert torch.equal(host.grad[s].to(cuda), dn)


def test_offloaded_neg_logits_refuses_pageable_rows(cuda):
    from repro_torch.core.negative_sampling import neg_logits_offloaded
    o = torch.randn(128, 256, device=cuda)
    with pytest.raises(ValueError, match="pinned"):
        neg_logits_offloaded(o, torch.randn(128, 8, 256))
    with pytest.raises(ValueError, match="host rows"):
        neg_logits_offloaded(o, torch.randn(128, 8, 256, device=cuda))


# -- the LM zoo ---------------------------------------------------------------

def _lm_on(cfg, device, seed=0):
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.models.model_zoo import get_bundle
    cpu = get_bundle(cfg).init(torch.Generator().manual_seed(seed),
                               device="cpu")
    return lm_params_from_numpy(lm_params_to_numpy(cpu), cfg, device=device)


def test_moe_combine_is_run_to_run_bitwise_on_the_card(cuda):
    """The combine adds each token's kept slots in a fixed order (no
    index_add_), so two runs on the card give the same bits; capacity
    factor 1 forces drops."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as E
    cfg = reduced(get_arch("olmoe-1b-7b"))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    mod = E.MoE(cfg, dtype=torch.bfloat16, device=cuda,
                generator=torch.Generator(device=cuda).manual_seed(1))
    x = torch.randn(4, 512, cfg.d_model, device=cuda, dtype=torch.bfloat16,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    with E.dispatch_stats() as st:
        a, aux_a = E.moe_apply(mod, cfg, x)
    b, aux_b = E.moe_apply(mod, cfg, x)
    assert st.dropped > 0
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# fp32 on both sides (TF32 off): the same fp32 arithmetic with sums in
# other orders (cuBLAS against the CPU's BLAS), through a 2-layer (jamba:
# 16) stack: the loss to 1e-5 relative.
@pytest.mark.parametrize("name", ["starcoder2-3b", "olmoe-1b-7b",
                                  "mamba2-2.7b", "jamba-1.5-large-398b",
                                  "deepseek-moe-16b", "musicgen-large"])
def test_reduced_lm_loss_on_the_card_equals_the_cpu(cuda, name):
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import get_bundle
    cfg = reduced(get_arch(name)).replace(dtype="float32")
    bundle = get_bundle(cfg)
    rng = np.random.default_rng(3)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (2, 64))}
    if cfg.frontend == "stub_embed":
        batch["embeds"] = rng.standard_normal((2, 64, cfg.d_model))
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (2, 64))
    losses = []
    for dev in (torch.device("cpu"), cuda):
        model = _lm_on(cfg, dev)
        b = {k: torch.from_numpy(v).to(dev, torch.int32 if v.dtype.kind == "i"
                                       else torch.float32)
             for k, v in batch.items()}
        losses.append(float(bundle.loss(model, b, q_block=32).detach()))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_matmul_f32_on_the_tensor_cores(cuda):
    """Two bf16 card tensors: exact products and fp32 sums on the tensor
    cores (against float64: fp32 accumulation of 128 terms, 1e-6 of the
    largest), and the grads of the fp32 path (the same fp32 products)."""
    from repro_torch.models.layers import matmul_f32
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(3, 64, 128, device=cuda, generator=g,
                    dtype=torch.bfloat16).requires_grad_()
    b = torch.randn(3, 128, 96, device=cuda, generator=g,
                    dtype=torch.bfloat16).requires_grad_()
    out = matmul_f32(a, b)
    assert out.dtype == torch.float32
    want = torch.bmm(a.detach().double(), b.detach().double())
    assert float((out.double() - want).abs().max()) \
        <= 1e-6 * float(want.abs().max())
    cot = torch.randn(out.shape, device=cuda, generator=g)
    da, db = torch.autograd.grad(out, (a, b), cot)
    a2, b2 = (t.detach().clone().requires_grad_() for t in (a, b))
    da2, db2 = torch.autograd.grad(torch.bmm(a2.float(), b2.float()),
                                   (a2, b2), cot)
    assert da.dtype == torch.bfloat16 and db.dtype == torch.bfloat16
    for x, y in ((da, da2), (db, db2)):
        assert float((x.float() - y.float()).abs().max()) \
            <= 2 ** -8 * float(y.float().abs().max())
