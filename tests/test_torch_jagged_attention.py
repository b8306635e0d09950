"""The port's jagged attention against the JAX package: the plan's integer
fields equal JAX ``build_attn_plan(..., pairs_per_step=1)`` exactly, and
the wrapper (on CPU tensors, i.e. the kernel's plain version) matches the
Pallas kernel in interpret mode and the dense oracle. The CUDA kernel
itself is held against the plain version on the card in
tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RABConfig as JRAB
from repro.kernels.jagged_attention import build_attn_plan as j_build
from repro.kernels.jagged_attention import jagged_attention as j_attn
from repro.models.hstu import jagged_pointwise_attention as j_oracle
from repro.models.hstu import jagged_pointwise_attention_blocked as j_blocked
from repro_torch.configs.base import RABConfig as PRAB
from repro_torch.kernels.jagged_attention import ops
from repro_torch.kernels.jagged_attention import ref as R
from repro_torch.kernels.jagged_attention import (build_attn_plan,
                                                  jagged_attention,
                                                  jagged_attention_ref)
from repro_torch.models.hstu import (jagged_pointwise_attention,
                                     jagged_pointwise_attention_blocked)
from torch_parity import jagged_pack, to_f32, to_t

JR = JRAB(num_pos_buckets=64, num_time_buckets=16)
PR = PRAB(num_pos_buckets=64, num_time_buckets=16)

# (capacity, row lengths, block, max_row_len)
PACKS = {
    "long_tail": (512, [300, 90, 40, 12, 5, 1, 1], 64, 320),
    "empty_rows": (256, [0, 70, 0, 0, 100, 0, 30], 64, 128),
    "full_capacity": (256, [128, 64, 64], 64, 128),
    "all_padding": (256, [0, 0, 0], 64, 128),
    "cap_not_block_multiple": (300, [120, 77, 50], 64, 128),
}


def _plans(name, tight_bound=True, seed=0):
    """Both packages' plans of one pack; ``tight_bound`` passes the pack's
    max_row_len, else the work-list takes the dense causal bound."""
    cap, lens, block, mrl = PACKS[name]
    mrl = mrl if tight_bound else None
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ts = np.cumsum(rng.integers(0, 500, cap)).astype(np.int32)
    jp = j_build(jnp.asarray(offs), jnp.asarray(ts), cap, block=block,
                 max_row_len=mrl, pairs_per_step=1)
    pp = build_attn_plan(*to_t(offs, ts), cap, block=block, max_row_len=mrl)
    return jp, pp


@pytest.mark.parametrize("tight_bound", [True, False])
@pytest.mark.parametrize("name", sorted(PACKS))
def test_plan_fields_equal_jax(name, tight_bound):
    jp, pp = _plans(name, tight_bound)
    for field in jp._fields:
        a, b = np.asarray(getattr(jp, field)), getattr(pp, field).numpy()
        assert a.dtype == b.dtype, (field, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("name", sorted(PACKS))
def test_plan_run_pointers_cover_live_pairs(name):
    """q_rowptr partitions the live prefix of q_wl into per-q-block runs."""
    _, pp = _plans(name)
    n = int(pp.n_live[0])
    ptr = pp.q_rowptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == n and (np.diff(ptr) >= 0).all()
    wl = pp.q_wl.numpy()
    for b in range(pp.num_blocks):
        assert (wl[ptr[b]:ptr[b + 1], 0] == b).all()


def test_plan_batched_equals_stacked_packs():
    rng = np.random.default_rng(3)
    cap, G = 256, 3
    lens = [[100, 60, 0, 40], [0, 0, 0, 0], [256, 0, 0, 0]]
    offs = np.stack([np.concatenate([[0], np.cumsum(l)]) for l in lens])
    offs = offs.astype(np.int32)
    ts = np.cumsum(rng.integers(0, 500, (G, cap)), axis=1).astype(np.int32)
    batched = build_attn_plan(*to_t(offs, ts), cap, block=64,
                              max_row_len=256)
    for g in range(G):
        one = build_attn_plan(*to_t(offs[g], ts[g]), cap, block=64,
                              max_row_len=256)
        for field, a, b in zip(one._fields, batched, one):
            assert torch.equal(a[g], b), field


def _attn_inputs(name, dtype, seed=1):
    cap, lens, block, mrl = PACKS[name]
    rng = np.random.default_rng(seed)
    H, D = 4, 16
    q, k, v, offs, ts = jagged_pack(rng, cap, lens, H, D)
    pt = (rng.standard_normal((64, H)) * 0.5).astype(np.float32)
    tt = (rng.standard_normal((16, H)) * 0.5).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    pq, pk, pv = (t.to(tdt) for t in to_t(q, k, v))
    jrab = {"pos_table": jnp.asarray(pt), "time_table": jnp.asarray(tt)}
    prab = {"pos_table": torch.from_numpy(pt),
            "time_table": torch.from_numpy(tt)}
    return ((jq, jk, jv, jnp.asarray(offs), jnp.asarray(ts), jrab),
            (pq, pk, pv, *to_t(offs, ts), prab), block, mrl)


# fp32: both sides do the same fp32 arithmetic in a different summation
# order, so they agree to a few ulps of the O(1) outputs. bf16: the
# weights a are rounded to bf16 before the a·v product and the output is
# rounded to bf16; a one-ulp flip of either (different summation order
# upstream) moves an O(1) output by up to 2^-7.
TOL = {jnp.float32: 1e-5, jnp.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("name", ["long_tail", "empty_rows",
                                  "cap_not_block_multiple"])
def test_attention_matches_jax_kernel_and_oracle(name, dtype):
    (jq, jk, jv, joff, jts, jrab), (pq, pk, pv, poff, pts, prab), block, \
        mrl = _attn_inputs(name, dtype)
    ker = j_attn(jq, jk, jv, joff, jts, jrab, JR, block=block,
                 max_row_len=mrl, pairs_per_step=1, interpret=True)
    ora = j_oracle(jq, jk, jv, joff, jts, jrab, JR)
    out = jagged_attention(pq, pk, pv, poff, pts, prab, PR, block=block,
                           max_row_len=mrl)
    assert out.dtype == pq.dtype and out.shape == pq.shape
    np.testing.assert_allclose(to_f32(out), to_f32(ker), atol=TOL[dtype],
                               rtol=0)
    np.testing.assert_allclose(to_f32(out), to_f32(ora), atol=TOL[dtype],
                               rtol=0)


def test_attention_all_padding_pack_is_zero():
    _, (pq, pk, pv, poff, pts, prab), block, mrl = _attn_inputs(
        "all_padding", jnp.float32)
    out = jagged_attention(pq, pk, pv, poff, pts, prab, PR, block=block,
                           max_row_len=mrl)
    assert torch.count_nonzero(out) == 0


def test_attention_pad_slots_zero_and_batched_equals_per_pack():
    """G packs in one call equal the packs one at a time; pad slots are
    zero (the _masked contract)."""
    rng = np.random.default_rng(5)
    cap, H, D, G = 256, 4, 16, 2
    packs = [jagged_pack(rng, cap, lens, H, D)
             for lens in ([100, 60, 0, 40], [30, 0, 0, 0])]
    q, k, v, offs, ts = (np.stack(x) for x in zip(*packs))
    pt = torch.randn(64, H, generator=torch.Generator().manual_seed(0))
    rab = {"pos_table": pt, "time_table": torch.zeros(16, H)}
    out = jagged_attention(*to_t(q, k, v, offs, ts), rab, PR, block=64)
    for g in range(G):
        one = jagged_attention(*to_t(q[g], k[g], v[g], offs[g], ts[g]), rab,
                               PR, block=64)
        torch.testing.assert_close(out[g], one, atol=1e-6, rtol=0)
        assert torch.count_nonzero(out[g, offs[g, -1]:]) == 0


@pytest.mark.parametrize("which", ["oracle", "blocked"])
def test_model_attention_paths_match_jax(which):
    """The port's dense oracle and blocked scan against the JAX package's
    (fp32, same summation structure; a few ulps)."""
    (jq, jk, jv, joff, jts, jrab), (pq, pk, pv, poff, pts, prab), _, _ = \
        _attn_inputs("long_tail", jnp.float32)
    if which == "oracle":
        a = j_oracle(jq, jk, jv, joff, jts, jrab, JR)
        b = jagged_pointwise_attention(pq, pk, pv, poff, pts, prab, PR)
    else:
        a = j_blocked(jq, jk, jv, joff, jts, jrab, JR, block=128)
        b = jagged_pointwise_attention_blocked(pq, pk, pv, poff, pts, prab,
                                               PR, block=128)
    np.testing.assert_allclose(to_f32(b), to_f32(a), atol=1e-5, rtol=0)


def test_ref_entry_equals_wrapper_on_cpu():
    """jagged_attention_ref (the explicit plain call) is what the wrapper
    computes for CPU tensors."""
    _, (pq, pk, pv, poff, pts, prab), block, mrl = _attn_inputs(
        "long_tail", jnp.bfloat16)
    a = jagged_attention(pq, pk, pv, poff, pts, prab, PR, block=block,
                         max_row_len=mrl)
    b = jagged_attention_ref(pq, pk, pv, poff, pts, prab, PR, block=block,
                             max_row_len=mrl)
    assert torch.equal(a, b)


def test_row_relative_check_sees_a_lost_k_block():
    """max_row_rel_err, the bf16 limit of the kernel checks, is 0 on equal
    results and zero pad rows, and flags a result whose plan lost the
    farthest k-block of the long row's last q-block."""
    _, (pq, pk, pv, poff, pts, prab), block, mrl = _attn_inputs(
        "long_tail", jnp.bfloat16)
    plan = ops._as_batched(build_attn_plan(poff, pts, 512, block=block,
                                           max_row_len=mrl))
    kw = dict(scale=0.25, tb_denom=ops.time_bucket_denom(PR.time_bucket_scale),
              use_pos=True, use_time=True)
    args = (pq[None], pk[None], pv[None], prab["pos_table"],
            prab["time_table"])
    good = ops._masked(plan.meta_i32, R.attention_fwd_plain(*args, plan, **kw))
    assert R.max_row_rel_err(good, good.clone()) == 0.0
    n = int(plan.n_live[0, 0])
    wl = plan.q_wl[0, :n].tolist()
    drop = wl.index([4, 0])              # row 0 spans q-blocks 0..4
    keep = [i for i in range(plan.num_pairs) if i != drop] + [n - 1]
    lost = plan._replace(q_wl=plan.q_wl[:, keep], n_live=plan.n_live - 1)
    bad = ops._masked(plan.meta_i32, R.attention_fwd_plain(*args, lost, **kw))
    assert R.max_row_rel_err(bad, good) > 0.1


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper raises on what the kernel does not take; it never
    computes on the CPU itself."""
    _, (pq, pk, pv, poff, pts, prab), _, _ = _attn_inputs(
        "full_capacity", jnp.float32)
    plan = ops._as_batched(build_attn_plan(poff, pts, 256, block=128))
    with pytest.raises(ValueError, match="not on the card"):
        ops._launch_fwd(pq[None], pk[None], pv[None], prab["pos_table"],
                        prab["time_table"], plan, scale=0.25, tb_denom=0.7,
                        use_pos=True, use_time=True)


def test_functional_time_mode_matches_oracle():
    """FuXi's functional time mode on the full-capacity pack (amp near 1,
    ρ ≠ 1): the wrapper's plain version against the JAX package's dense
    oracle (fp32; pow against exp(ρ·ln z), a few ulps), and the bucket
    table is not read in that mode. tests/test_torch_fuxi.py holds the
    other packs, bf16 and the grads."""
    (jq, jk, jv, joff, jts, jrab), (pq, pk, pv, poff, pts, prab), block, \
        _ = _attn_inputs("full_capacity", jnp.float32)
    H = pq.shape[1]
    tp = {"time_amp": np.linspace(0.6, 1.4, H, dtype=np.float32),
          "time_log_sigma": np.linspace(2.0, 12.0, H, dtype=np.float32),
          "time_rho": np.linspace(-2.0, 2.0, H, dtype=np.float32)}
    jrab = {**jrab, **{n: jnp.asarray(a) for n, a in tp.items()}}
    prab = {**prab, **{n: torch.from_numpy(a) for n, a in tp.items()}}
    ora = j_oracle(jq, jk, jv, joff, jts, jrab, JR, time_mode="functional")
    out = jagged_attention(pq, pk, pv, poff, pts, prab, PR, block=block,
                           time_mode="functional")
    np.testing.assert_allclose(to_f32(out), to_f32(ora), atol=1e-5, rtol=0)
    no_table = {n: t for n, t in prab.items() if n != "time_table"}
    assert torch.equal(out, jagged_attention(
        pq, pk, pv, poff, pts, no_table, PR, block=block,
        time_mode="functional"))
    with pytest.raises(ValueError, match="time_mode"):
        jagged_attention(pq, pk, pv, poff, pts, prab, PR, block=block,
                         time_mode="linear")


def _bwd_with_bf16_operands(q, k, v, dy, pt, tt, plan, *, scale, tb_denom,
                            functional):
    """The bf16 K2 kernels' rounding points, emulated densely on one pack
    (G = 1): s and dy·vᵀ from bf16 q, k, v, dy in fp32, a and ds in fp32,
    then each rounded to bf16 once as the operand of dv = aᵀ·dy, dk =
    dsᵀ·q·scale and dq = ds·k·scale (fp32 sums, bf16 outputs)."""
    seg = plan.meta_i32[0, :, 0].long()
    ts = plan.meta_i32[0, :, 2]
    ninv = plan.meta_f32[0, :, 0]
    qf, kf, vf, dyf = (t[0].float() for t in (q, k, v, dy))
    cap = qf.shape[0]
    i = torch.arange(cap)
    s = torch.einsum("qhd,khd->qkh", qf, kf) * scale
    s = s + pt[(i[:, None] - i[None, :]).clamp(0, pt.shape[0] - 1)]
    dt = (ts[:, None] - ts[None, :]).abs()
    if functional:
        s = s + tt[0] * R.functional_terms(dt, tt)[0]
    else:
        s = s + tt[R.time_buckets(dt, tb_denom, tt.shape[0])]
    live = ((seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
            & (i[:, None] >= i[None, :]))
    mw = (live.float() * ninv[:, None])[..., None]
    sig = torch.sigmoid(s)
    a = s * sig * mw
    da = torch.einsum("qhd,khd->qkh", dyf, vf)
    ds = da * (sig * (1.0 + s * (1.0 - sig))) * mw
    a16, ds16 = (t.to(torch.bfloat16).float() for t in (a, ds))
    dv = torch.einsum("qkh,qhd->khd", a16, dyf)
    dk = torch.einsum("qkh,qhd->khd", ds16, qf) * scale
    dq = torch.einsum("qkh,khd->qhd", ds16, kf) * scale
    return tuple(t[None].to(torch.bfloat16) for t in (dq, dk, dv))


# The bf16 K2 kernels round a and ds to bf16 before the dv, dk and dq
# products (the reference multiplies them in fp32): a declared divergence.
# Its budget at hstu-large's head dim 128 and a 2048-key row, in both time
# modes, against the plain version (fp32 a and ds, the function the
# existing tests hold against the reference): the 1e-2 per-(token, head)
# relative L2 that the card checks allow bf16 grads.
@pytest.mark.parametrize("layout", ["one_row_2048", "long_tail_padded"])
@pytest.mark.parametrize("mode", ["bucket", "functional"])
def test_bf16_operand_rounding_within_grad_budget(mode, layout):
    cap, lens = {"one_row_2048": (2048, [2048]),
                 "long_tail_padded": (2176, [1200, 600, 1, 300])}[layout]
    rng = np.random.default_rng(17)
    H, D = 2, 128
    q, k, v, offs, ts = jagged_pack(rng, cap, lens, H, D, ts_gap=4000)
    dy = rng.standard_normal((cap, H, D)).astype(np.float32)
    q, k, v, dy = (torch.from_numpy(x)[None].to(torch.bfloat16)
                   for x in (q, k, v, dy))
    offs, ts = to_t(offs, ts)
    pt = torch.from_numpy((rng.standard_normal((256, H)) * 0.5)
                          .astype(np.float32))
    functional = mode == "functional"
    if functional:
        tt = ops.functional_time_table(
            {"time_amp": torch.tensor([0.8, 1.2]),
             "time_log_sigma": torch.tensor([2.0, 12.0]),
             "time_rho": torch.tensor([-2.0, 2.0])})
    else:
        tt = torch.from_numpy((rng.standard_normal((32, H)) * 0.5)
                              .astype(np.float32))
    plan = ops._as_batched(build_attn_plan(offs[None], ts[None], cap,
                                           block=128, max_row_len=2048))
    kw = dict(scale=D ** -0.5, tb_denom=ops.time_bucket_denom(0.301))
    plain = R.attention_bwd_plain(q, k, v, dy, pt, tt, plan, use_pos=True,
                                  use_time=True, time_functional=functional,
                                  **kw)
    emul = _bwd_with_bf16_operands(q, k, v, dy, pt, tt, plan,
                                   functional=functional, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), emul, plain):
        err = R.max_row_rel_err(a, b)
        assert 0.0 < err <= 1e-2, (name, err)


# The plain versions' accumulation dtype: float32 by default (the kernels'
# arithmetic, which every other test here holds against the reference),
# float64 as the yardstick of an fp32 kernel's long sums. On a small pack
# the two agree to 1e-4 of the largest value (fp32 summation order only),
# and the default is the explicit float32 call bit for bit.
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("mode", ["bucket", "functional"])
def test_plain_versions_accumulate_in_float64_on_request(mode, direction):
    rng = np.random.default_rng(23)
    cap, H, D = 384, 2, 16
    q, k, v, offs, ts = jagged_pack(rng, cap, [200, 41, 0, 1, 90], H, D,
                                    ts_gap=4000)
    dy = rng.standard_normal((cap, H, D)).astype(np.float32)
    q, k, v, dy = (torch.from_numpy(x)[None] for x in (q, k, v, dy))
    offs, ts = to_t(offs, ts)
    pt = torch.from_numpy((rng.standard_normal((64, H)) * 0.5)
                          .astype(np.float32))
    functional = mode == "functional"
    if functional:
        tt = ops.functional_time_table(
            {"time_amp": torch.tensor([0.8, 1.2]),
             "time_log_sigma": torch.tensor([2.0, 12.0]),
             "time_rho": torch.tensor([-2.0, 2.0])})
    else:
        tt = torch.from_numpy((rng.standard_normal((16, H)) * 0.5)
                              .astype(np.float32))
    plan = ops._as_batched(build_attn_plan(offs[None], ts[None], cap,
                                           block=128, max_row_len=256))
    kw = dict(scale=D ** -0.5, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=True, time_functional=functional)
    if direction == "fwd":
        def run(**acc):
            return (R.attention_fwd_plain(q, k, v, pt, tt, plan, **kw, **acc),)
        names = ("out",)
    else:
        def run(**acc):
            return R.attention_bwd_plain(q, k, v, dy, pt, tt, plan, **kw,
                                         **acc)
        names = ("dq", "dk", "dv", "dpt", "dtt")
    default, f32, f64 = run(), run(acc_dtype=torch.float32), run(
        acc_dtype=torch.float64)
    for name, a, b, c in zip(names, default, f32, f64):
        assert torch.equal(a, b), name
        assert a.dtype == torch.float32, name
        assert c.dtype == (torch.float64 if name in ("dpt", "dtt")
                           else torch.float32), name
        assert not torch.equal(a.double(), c.double()), name  # float64 ran
        rel = ((a.double() - c.double()).abs().max()
               / c.double().abs().max()).item()
        assert rel <= 1e-4, (name, rel)
