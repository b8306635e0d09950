"""The port's jagged attention backward (K2's plain version, through the
autograd Function) against the JAX package's work-list kernels in
interpret mode under ``jax.grad``: the grads of q, k, v, ``pos_table`` and
``time_table`` on the packs of the forward tests. Also the plan's
``kv_rowptr``. The CUDA kernels themselves are held against the plain
version on the card in tests/test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.jagged_attention import jagged_attention as j_attn
from repro_torch.kernels.jagged_attention import (attention_bwd_plain,
                                                  build_attn_plan,
                                                  jagged_attention, ops)
from test_torch_jagged_attention import JR, PACKS, PR, _attn_inputs, _plans
from torch_parity import to_f32


def _jax_grads(name, dtype):
    (jq, jk, jv, joff, jts, jrab), _, block, mrl = _attn_inputs(name, dtype)

    def loss(q, k, v, pt, tt):
        out = j_attn(q, k, v, joff, jts, {"pos_table": pt, "time_table": tt},
                     JR, block=block, max_row_len=mrl, pairs_per_step=1,
                     interpret=True)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jq, jk, jv, jrab["pos_table"], jrab["time_table"])


def _port_grads(name, dtype):
    _, (pq, pk, pv, poff, pts, prab), block, mrl = _attn_inputs(name, dtype)
    leaves = [t.clone().requires_grad_() for t in
              (pq, pk, pv, prab["pos_table"], prab["time_table"])]
    q, k, v, pt, tt = leaves
    out = jagged_attention(q, k, v, poff, pts,
                           {"pos_table": pt, "time_table": tt}, PR,
                           block=block, max_row_len=mrl)
    torch.sin(out.float()).sum().backward()
    return [t.grad for t in leaves]


# fp32: the same fp32 arithmetic summed in another order (pairs, keys and
# the bucket sums of the tables, whose entries add up thousands of terms of
# either sign): 1e-4 absolute and relative bounds a few ulps of the O(1)-O(10)
# grads, as the reference's own worklist-vs-oracle grad test does.
@pytest.mark.parametrize("name", ["long_tail", "empty_rows",
                                  "cap_not_block_multiple", "all_padding"])
def test_attention_grads_match_jax_kernel(name):
    jg = _jax_grads(name, jnp.float32)
    pg = _port_grads(name, jnp.float32)
    for field, a, b in zip("q k v pos_table time_table".split(), jg, pg):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        np.testing.assert_allclose(to_f32(b), to_f32(a), rtol=1e-4,
                                   atol=1e-4, err_msg=field)


def test_attention_grads_bf16_match_jax_kernel():
    """bf16 inputs: both sides compute in fp32 and round q, k, v grads to
    bf16 once, so a grad may sit one bf16 ulp (2^-8 relative) apart; the
    fp32 table grads sum bf16-rounded-forward cotangents and agree to 2e-2
    of their size."""
    jg = _jax_grads("long_tail", jnp.bfloat16)
    pg = _port_grads("long_tail", jnp.bfloat16)
    for field, a, b in zip("q k v pos_table time_table".split(), jg, pg):
        a32, b32 = to_f32(a), to_f32(b)
        scale = max(np.abs(a32).max(), 1e-6)
        assert np.abs(a32 - b32).max() <= 2e-2 * scale, field


@pytest.mark.parametrize("name", sorted(PACKS))
def test_plan_kv_run_pointers_cover_live_pairs(name):
    """kv_rowptr partitions the live prefix of kv_wl into per-k-block runs,
    and each run holds the same pairs as that k-block's q-major entries."""
    _, pp = _plans(name)
    n = int(pp.n_live[0])
    ptr = pp.kv_rowptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == n and (np.diff(ptr) >= 0).all()
    kv = pp.kv_wl.numpy()
    q = pp.q_wl.numpy()[:n]
    for b in range(pp.num_blocks):
        run = kv[ptr[b]:ptr[b + 1]]
        assert (run[:, 1] == b).all()
        assert sorted(map(tuple, run)) == sorted(map(tuple, q[q[:, 1] == b]))


def test_backward_zero_cotangent_and_unused_tables():
    """A zero cotangent gives zero grads everywhere; with the RAB switched
    off the table grads are zero whatever dy is."""
    _, (pq, pk, pv, poff, pts, prab), block, mrl = _attn_inputs(
        "long_tail", jnp.float32)
    plan = ops._as_batched(build_attn_plan(poff, pts, 512, block=block,
                                           max_row_len=mrl))
    dy = torch.zeros_like(pq)[None]
    kw = dict(scale=0.25, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=True)
    outs = attention_bwd_plain(pq[None], pk[None], pv[None], dy,
                               prab["pos_table"], prab["time_table"], plan,
                               **kw)
    assert all(torch.count_nonzero(t) == 0 for t in outs)
    q = pq.clone().requires_grad_()
    pt = prab["pos_table"].clone().requires_grad_()
    out = jagged_attention(q, pk, pv, poff, pts, {"pos_table": pt}, None,
                           block=block, max_row_len=mrl)
    out.sum().backward()
    assert torch.count_nonzero(q.grad) > 0
    assert pt.grad is None or torch.count_nonzero(pt.grad) == 0
