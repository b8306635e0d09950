"""The non-causal mask of the port's jagged attention against the JAX
package, on the CPU (the kernels' plain versions): with ``causal=False`` a
query sees every key of its row and its weights are divided by the row
length. The plan (``_token_meta``, ``_live_block_matrix``,
``num_pairs_bound``, the compacted work-lists) equals the reference's field
for field; the forward and every gradient (q, k, v, the position table and
the time table or (amp, σ, ρ)) match the Pallas kernels in interpret mode
under ``jax.grad``, in both time modes, and the port's oracles match the
reference's. The causal mask is unchanged, plans record their mask, a call
with the other mask is refused, and so is prefix reuse (the append launch)
with an acausal mask. The CUDA instantiations are held against the plain
versions on the card in tests/test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RABConfig as JRAB
from repro.kernels.jagged_attention import build_attn_plan as j_build
from repro.kernels.jagged_attention import jagged_attention as j_attn
from repro.kernels.jagged_attention import ops as j_ops
from repro.models.hstu import jagged_pointwise_attention as j_oracle
from repro.models.hstu import jagged_pointwise_attention_blocked as j_blocked
from repro_torch.configs.base import RABConfig as PRAB
from repro_torch.kernels.jagged_attention import (build_attn_plan,
                                                  jagged_attention,
                                                  make_attn_fn, ops)
from repro_torch.kernels.jagged_attention import ref as R
from repro_torch.models import hstu as PH
from torch_parity import jagged_pack, to_f32, to_t

JR = JRAB(num_pos_buckets=64, num_time_buckets=16)
PR = PRAB(num_pos_buckets=64, num_time_buckets=16)
TIME_KEYS = ("time_amp", "time_log_sigma", "time_rho")

# (capacity, row lengths, block, max_row_len): block 128 as the kernels
# tile, a row straddling three blocks, empty rows, a capacity that is not a
# block multiple, and an all-padding pack
PACKS = {
    "straddle": (512, [300, 0, 90, 40, 1], 128, 320),
    "empty_rows": (256, [0, 70, 0, 0, 100, 30], 128, 128),
    "cap_not_block_multiple": (300, [150, 77, 50], 128, 160),
    "all_padding": (256, [0, 0, 0], 128, 128),
}


def _inputs(name, dtype, mode, seed=3):
    """Both packages' q, k, v, offsets, timestamps and RAB params of one
    pack: H 2, D 16, pos table 64 and time table 16 buckets or FuXi's
    (amp, log σ, ρ) at working values (amp near 1, ρ ≠ 1)."""
    cap, lens, block, mrl = PACKS[name]
    rng = np.random.default_rng(seed)
    H, D = 2, 16
    q, k, v, offs, ts = jagged_pack(rng, cap, lens, H, D)
    rab = {"pos_table": (rng.standard_normal((64, H)) * 0.5)
           .astype(np.float32)}
    if mode == "bucket":
        rab["time_table"] = (rng.standard_normal((16, H)) * 0.5).astype(
            np.float32)
    else:
        rab.update(time_amp=rng.uniform(0.6, 1.4, H).astype(np.float32),
                   time_log_sigma=np.linspace(4.0, 8.0, H).astype(np.float32),
                   time_rho=np.linspace(-1.0, 1.0, H).astype(np.float32))
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    pq, pk, pv = (t.to(tdt) for t in to_t(q, k, v))
    jrab = {n: jnp.asarray(a) for n, a in rab.items()}
    prab = {n: torch.from_numpy(a) for n, a in rab.items()}
    return ((jq, jk, jv, jnp.asarray(offs), jnp.asarray(ts), jrab),
            (pq, pk, pv, *to_t(offs, ts), prab), block, mrl)


def _plans(name, causal, tight_bound=True):
    cap, lens, block, mrl = PACKS[name]
    mrl = mrl if tight_bound else None
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ts = np.cumsum(np.random.default_rng(0).integers(0, 500, cap)).astype(
        np.int32)
    jp = j_build(jnp.asarray(offs), jnp.asarray(ts), cap, block=block,
                 causal=causal, max_row_len=mrl, pairs_per_step=1)
    pp = build_attn_plan(*to_t(offs, ts), cap, block=block, max_row_len=mrl,
                         causal=causal)
    return jp, pp


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tight_bound", [True, False])
@pytest.mark.parametrize("name", sorted(PACKS))
def test_acausal_plan_fields_equal_jax(name, tight_bound):
    """meta (1/row length), segment ranges, both work-lists with their
    flags and live masks, the live count: field for field, dtype and all."""
    jp, pp = _plans(name, causal=False, tight_bound=tight_bound)
    assert pp.causal is False
    for field in jp._fields:
        a, b = np.asarray(getattr(jp, field)), getattr(pp, field).numpy()
        assert a.dtype == b.dtype, (field, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("name", sorted(PACKS))
def test_acausal_token_meta_and_live_blocks_equal_jax(name):
    """``_token_meta`` (1/max(row length, 1), 0 on padding) and
    ``_live_block_matrix`` (no band) against the reference's helpers; the
    acausal live pairs are the causal ones and their mirror images."""
    cap, lens, block, _ = PACKS[name]
    capp = cap + (-cap) % block
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ts = np.arange(capp, dtype=np.int32)
    for causal in (False, True):
        jm = j_ops._token_meta(capp, jnp.asarray(offs), jnp.asarray(ts),
                               causal)
        pm = ops._token_meta(capp, *to_t(offs, ts), causal)
        for a, b in zip(jm, pm):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    nb = capp // block
    seg = ops._token_meta(capp, *to_t(offs, ts), False)[0][:, 0]
    rng_p = ops._seg_ranges(seg, nb, block)
    live = {}
    for causal in (False, True):
        jl = j_ops._live_block_matrix(jnp.asarray(rng_p.numpy()), block,
                                      causal)
        live[causal] = ops._live_block_matrix(rng_p, block, causal)
        np.testing.assert_array_equal(np.asarray(jl), live[causal].numpy())
    assert torch.equal(live[False], live[True] | live[True].T)


def test_num_pairs_bound_equals_jax():
    """mr² per row and nb² dense when acausal, as the reference bounds."""
    for nb in (1, 2, 4, 16, 64):
        for rows in (1, 3, 8):
            for mrl in (None, 1, 100, 128, 129, 300, 2048):
                for causal in (False, True):
                    assert ops.num_pairs_bound(nb, 128, rows, mrl,
                                               causal) == \
                        j_ops.num_pairs_bound(nb, 128, rows, mrl, causal)


# --------------------------------------------------------------------------
# forward and grads against the reference
# --------------------------------------------------------------------------

# fp32: the same fp32 arithmetic summed in another order, a few ulps of the
# O(1) outputs (the functional bias's log/exp may differ in the last ulp
# between XLA and PyTorch). bf16: a weight or an output rounded the other
# way moves an O(1) output by up to 2^-7.
TOL = {jnp.float32: 1e-5, jnp.bfloat16: 2e-2}
FWD_PACKS = ["straddle", "empty_rows", "cap_not_block_multiple"]


@pytest.mark.parametrize("mode", ["bucket", "functional"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("name", FWD_PACKS)
def test_acausal_attention_matches_jax_kernel_and_oracles(name, dtype, mode):
    (jq, jk, jv, joff, jts, jrab), (pq, pk, pv, poff, pts, prab), block, \
        mrl = _inputs(name, dtype, mode)
    ker = j_attn(jq, jk, jv, joff, jts, jrab, JR, time_mode=mode,
                 causal=False, block=block, max_row_len=mrl,
                 pairs_per_step=1, interpret=True)
    ora = j_oracle(jq, jk, jv, joff, jts, jrab, JR, time_mode=mode,
                   causal=False)
    out = jagged_attention(pq, pk, pv, poff, pts, prab, PR, time_mode=mode,
                           block=block, max_row_len=mrl, causal=False)
    assert out.dtype == pq.dtype and out.shape == pq.shape
    for want in (ker, ora):
        np.testing.assert_allclose(to_f32(out), to_f32(want),
                                   atol=TOL[dtype], rtol=0)
    # the acausal function is not the causal one on these packs
    causal = jagged_attention(pq, pk, pv, poff, pts, prab, PR,
                              time_mode=mode, block=block, max_row_len=mrl)
    assert (to_f32(out) != to_f32(causal)).any()


@pytest.mark.parametrize("mode", ["bucket", "functional"])
@pytest.mark.parametrize("which", ["oracle", "blocked"])
def test_acausal_model_oracles_match_jax(which, mode):
    """The port's dense oracle and blocked scan at ``causal=False`` against
    the reference's (fp32, the same summation structure)."""
    (jq, jk, jv, joff, jts, jrab), (pq, pk, pv, poff, pts, prab), _, _ = \
        _inputs("straddle", jnp.float32, mode)
    if which == "oracle":
        a = j_oracle(jq, jk, jv, joff, jts, jrab, JR, time_mode=mode,
                     causal=False)
        b = PH.jagged_pointwise_attention(pq, pk, pv, poff, pts, prab, PR,
                                          time_mode=mode, causal=False)
    else:
        a = j_blocked(jq, jk, jv, joff, jts, jrab, JR, block=128,
                      time_mode=mode, causal=False)
        b = PH.jagged_pointwise_attention_blocked(
            pq, pk, pv, poff, pts, prab, PR, block=128, time_mode=mode,
            causal=False)
    np.testing.assert_allclose(to_f32(b), to_f32(a), atol=1e-5, rtol=0)


def _table_keys(mode):
    return ("pos_table",) + (("time_table",) if mode == "bucket"
                             else TIME_KEYS)


def _jax_grads(name, dtype, mode):
    (jq, jk, jv, joff, jts, jrab), _, block, mrl = _inputs(name, dtype, mode)
    keys = _table_keys(mode)

    def loss(q, k, v, *tables):
        out = j_attn(q, k, v, joff, jts, dict(zip(keys, tables)), JR,
                     time_mode=mode, causal=False, block=block,
                     max_row_len=mrl, pairs_per_step=1, interpret=True)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    return jax.grad(loss, argnums=tuple(range(3 + len(keys))))(
        jq, jk, jv, *(jrab[n] for n in keys))


def _port_grads(name, dtype, mode, schedule="worklist"):
    _, (pq, pk, pv, poff, pts, prab), block, mrl = _inputs(name, dtype, mode)
    keys = _table_keys(mode)
    leaves = [t.clone().requires_grad_() for t in
              (pq, pk, pv, *(prab[n] for n in keys))]
    out = jagged_attention(*leaves[:3], poff, pts,
                           dict(zip(keys, leaves[3:])), PR, time_mode=mode,
                           block=block, max_row_len=mrl, schedule=schedule,
                           causal=False)
    torch.sin(out.float()).sum().backward()
    return [t.grad for t in leaves]


# q, k, v and the position table: 1e-4 absolute and relative (the same fp32
# arithmetic summed in another order; an acausal tile sends every pair at
# a negative distance to position bucket 0, a sum of thousands of terms of
# either sign). The time grads each sum ~10^4 terms a head of either sign:
# held to 1e-4 of their largest value over the heads, as the causal tests
# hold them.
@pytest.mark.parametrize("mode", ["bucket", "functional"])
@pytest.mark.parametrize("name", FWD_PACKS)
def test_acausal_attention_grads_match_jax_kernel(name, mode):
    jg = _jax_grads(name, jnp.float32, mode)
    pg = _port_grads(name, jnp.float32, mode)
    fields = ("q", "k", "v") + _table_keys(mode)
    for field, a, b in zip(fields, jg, pg):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, field
        a32, b32 = to_f32(a), to_f32(b)
        if field.startswith("time_"):
            scale = max(np.abs(a32).max(), 1e-30)
            assert np.abs(a32 - b32).max() <= 1e-4 * scale, field
        else:
            np.testing.assert_allclose(b32, a32, rtol=1e-4, atol=1e-4,
                                       err_msg=field)


def test_acausal_grads_bf16_match_jax_kernel():
    """bf16 inputs: q, k, v grads one bf16 ulp apart at most; the fp32
    table grads sum bf16-rounded-forward cotangents and agree to 2e-2 of
    their size, as the causal bf16 test holds them."""
    jg = _jax_grads("straddle", jnp.bfloat16, "bucket")
    pg = _port_grads("straddle", jnp.bfloat16, "bucket")
    for field, a, b in zip("q k v pos_table time_table".split(), jg, pg):
        a32, b32 = to_f32(a), to_f32(b)
        scale = max(np.abs(a32).max(), 1e-6)
        assert np.abs(a32 - b32).max() <= 2e-2 * scale, field


def test_acausal_position_grad_sums_negative_distances_in_bucket_zero():
    """Every pair of a row at a negative distance adds its ds to bucket 0:
    with a zero time table and a cotangent that is 1 on one row, d pos
    table[0] is the sum over the diagonal and every pair above it, and the
    float64 plain version agrees with the fp32 one."""
    _, (pq, pk, pv, poff, pts, prab), block, mrl = _inputs(
        "straddle", jnp.float32, "bucket")
    plan = ops._as_batched(build_attn_plan(poff, pts, 512, block=block,
                                           max_row_len=mrl, causal=False))
    kw = dict(scale=0.25, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=False)
    dy = torch.zeros_like(pq)[None]
    dy[0, :300] = 1.0
    args = (pq[None], pk[None], pv[None], dy, prab["pos_table"],
            torch.zeros(16, 2))
    g32 = R.attention_bwd_plain(*args, plan, **kw)[3]
    g64 = R.attention_bwd_plain(*args, plan, acc_dtype=torch.float64,
                                **kw)[3]
    scale = g64.abs().max().item()
    assert (g32.double() - g64).abs().max().item() <= 1e-5 * scale
    # bucket 0 holds the diagonal and the 300·299/2 pairs above it
    causal = R.attention_bwd_plain(
        *args, ops._as_batched(build_attn_plan(poff, pts, 512, block=block,
                                               max_row_len=mrl)), **kw)[3]
    assert not torch.allclose(g32[0], causal[0])


# --------------------------------------------------------------------------
# the causal mask is unchanged; plans record their mask
# --------------------------------------------------------------------------

def test_causal_mask_is_the_unflagged_expression():
    """``ref._pair_mask`` with causal=True is the plain versions' mask
    before the flag, element for element: (same row) & (valid) & (key at
    or before the query)."""
    g = torch.Generator().manual_seed(0)
    qseg = torch.randint(-1, 3, (4, 16), generator=g)
    kseg = torch.randint(-1, 3, (4, 16), generator=g)
    qslot = torch.randint(0, 64, (4, 16), generator=g)
    kslot = torch.randint(0, 64, (4, 16), generator=g)
    old = ((qseg[:, :, None] == kseg[:, None, :])
           & (qseg[:, :, None] >= 0)
           & (qslot[:, :, None] >= kslot[:, None, :]))
    assert torch.equal(R._pair_mask(qseg, kseg, qslot, kslot, True), old)
    acausal = R._pair_mask(qseg, kseg, qslot, kslot, False)
    assert torch.equal(acausal & (qslot[:, :, None] >= kslot[:, None, :]),
                       old)


@pytest.mark.parametrize("mode", ["bucket", "functional"])
def test_causal_default_bitwise_equal_to_explicit(mode):
    """``causal=True`` spelled out gives the default call's bits, forward
    and grads; its plan equals the default plan field for field."""
    _, pp_default = _plans("straddle", causal=True)
    cap, lens, block, mrl = PACKS["straddle"]
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ts = np.cumsum(np.random.default_rng(0).integers(0, 500, cap)).astype(
        np.int32)
    pp = build_attn_plan(*to_t(offs, ts), cap, block=block, max_row_len=mrl)
    for a, b in zip(pp[:-1], pp_default[:-1]):
        assert torch.equal(a, b)
    assert pp.causal is True and pp_default.causal is True
    grads = []
    for kw in ({}, {"causal": True}):
        _, (pq, pk, pv, poff, pts, prab), block, mrl = _inputs(
            "straddle", jnp.float32, mode)
        leaves = [t.clone().requires_grad_() for t in (pq, pk, pv)]
        out = jagged_attention(*leaves, poff, pts, prab, PR, time_mode=mode,
                               block=block, max_row_len=mrl, **kw)
        out.sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_plan_mask_mismatch_is_refused():
    """A plan built for one mask refuses a call with the other (the
    reference cannot check it: its plan does not record the mask)."""
    _, (pq, pk, pv, poff, pts, prab), block, mrl = _inputs(
        "straddle", jnp.float32, "bucket")
    for causal in (True, False):
        plan = build_attn_plan(poff, pts, 512, block=block, max_row_len=mrl,
                               causal=causal)
        with pytest.raises(ValueError, match="causal"):
            jagged_attention(pq, pk, pv, poff, pts, prab, PR, block=block,
                             plan=plan, causal=not causal)
        with pytest.raises(ValueError, match="causal"):
            ops.attention_core(pq[None], pk[None], pv[None],
                               prab["pos_table"], prab["time_table"],
                               ops._as_batched(plan), scale=0.25,
                               tb_denom=1.0, use_pos=True, use_time=True,
                               causal=not causal)
    fn = make_attn_fn(block=block, max_row_len=mrl, causal=False)
    plan = fn.make_plan(poff, pts, 512)
    assert plan.causal is False
    a = fn(pq, pk, pv, poff, pts, prab, PR, plan=plan)
    b = jagged_attention(pq, pk, pv, poff, pts, prab, PR, block=block,
                         max_row_len=mrl, causal=False)
    assert torch.equal(a, b)


def test_dense_schedule_equals_worklist_acausal():
    """K8's schedule computes the same function acausal too (on the CPU one
    plain version serves both): forward and grads bit for bit."""
    a = _port_grads("straddle", jnp.float32, "bucket")
    b = _port_grads("straddle", jnp.float32, "bucket", schedule="dense")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------
# the append launch and prefix reuse stay causal
# --------------------------------------------------------------------------

def test_attention_append_refuses_acausal():
    H, D, cap = 2, 16, 256
    q = torch.zeros(1, 4, H, D)
    cache = torch.zeros(2, cap, H, D)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)    # noqa: E731
    args = (q, cache, cache, i32(0), torch.zeros(1, cap, dtype=torch.int32),
            i32(4), i32(8), torch.zeros(8, H), torch.zeros(8, H),
            ops.position_ninv(cap, "cpu"))
    kw = dict(scale=0.25, tb_denom=1.0, use_pos=True, use_time=True)
    out = ops.attention_append(*args, **kw)
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="causal only"):
        ops.attention_append(*args, causal=False, **kw)


def test_prefix_reuse_refuses_acausal_attention():
    """The streaming engine's warm path and its cold encode of the slots
    refuse an acausal attn_fn; with prefix reuse off it serves cold."""
    from repro_torch.models import gr as PG
    from repro_torch.serving import StreamingRecallEngine
    from torch_parity import models
    _, (cp, model, table) = models()
    fn = make_attn_fn(max_row_len=cp.max_seq_len, causal=False)
    with pytest.raises(ValueError, match="causal"):
        StreamingRecallEngine(cp, model, table, attn_fn=fn, device="cpu")
    StreamingRecallEngine(cp, model, table, attn_fn=fn, prefix_reuse=False,
                          device="cpu")
    with pytest.raises(ValueError, match="causal"):
        PG._check_prefix_reuse(cp, fn)


def test_acausal_instantiations_change_only_the_mask():
    """In the CUDA sources the mask is a template parameter that touches
    the in-tile live test, the dense grid's block test and K2's skips of
    chunk pairs past the causal band, and nothing else; the append launch
    is instantiated causal only. (The causal kernels' SASS is held to the
    previous build's on the card: scripts/compare_attn_sass.py.)"""
    from repro_torch.kernels import _build
    fwd = (_build.CSRC / _build.SOURCES["jagged_attn_fwd"]).read_text()
    bwd = (_build.CSRC / _build.SOURCES["jagged_attn_bwd"]).read_text()
    live = (_build.CSRC / "block_live.cuh").read_text()
    assert "(!CAUSAL || qb >= kb)" in live
    assert "static_assert(CAUSAL || !APPEND" in fwd
    assert "launch_dtype<T, false, false>" in fwd        # acausal, cold only
    assert fwd.count("CAUSAL ?") + fwd.count("!CAUSAL ||") == 2
    assert fwd.count("block_live<CAUSAL>(") == 2
    assert bwd.count("!CAUSAL || qslot >= kslot") == 2
    assert bwd.count("if (CAUSAL && ") == 4
    assert bwd.count("block_live<CAUSAL>(") == 4
    assert "block_live(" not in fwd + bwd
    # K2's source is built once per mask, each library refusing the other
    assert _build.SOURCES["jagged_attn_bwd_acausal"] == \
        _build.SOURCES["jagged_attn_bwd"]
    assert _build.DEFINES["jagged_attn_bwd_acausal"] == ["-DJAB_CAUSAL=0"]
    assert "causal != JAB_CAUSAL" in bwd
