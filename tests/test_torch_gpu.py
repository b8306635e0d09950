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
