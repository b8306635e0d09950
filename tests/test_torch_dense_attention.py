"""The dense-grid attention schedule (K8) against the JAX package: the port's
``jagged_attention(schedule="dense")`` (K8's plain version, which is
K1/K2's) against the reference's dense-grid Pallas kernels in interpret
mode, forward and the grads of q, k, v and the RAB parameters, in both time
modes; and the schedule argument through ``PlannedAttention`` /
``make_attn_fn``. K8 itself is held against K1/K2 and the plain version on
the card in tests/test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.jagged_attention import jagged_attention as j_attn
from repro_torch.kernels.jagged_attention import (jagged_attention,
                                                  jagged_attention_ref,
                                                  make_attn_fn, ops)
from test_torch_jagged_attention import JR, PR, _attn_inputs
from torch_parity import to_f32

FUNCTIONAL = {"time_amp": np.linspace(0.6, 1.4, 4, dtype=np.float32),
              "time_log_sigma": np.linspace(2.0, 12.0, 4, dtype=np.float32),
              "time_rho": np.linspace(-2.0, 2.0, 4, dtype=np.float32)}


def _grads(name, mode):
    """(reference dense-grid kernel, port dense schedule): the output and
    the grads of q, k, v and the RAB parameters of sum(sin(out))."""
    (jq, jk, jv, joff, jts, jrab), (pq, pk, pv, poff, pts, prab), block, \
        mrl = _attn_inputs(name, jnp.float32)
    names = ["pos_table", "time_table"]
    if mode == "functional":
        names = ["pos_table", *FUNCTIONAL]
        jrab = {**jrab, **{n: jnp.asarray(a) for n, a in FUNCTIONAL.items()}}
        prab = {**prab, **{n: torch.from_numpy(a.copy())
                           for n, a in FUNCTIONAL.items()}}

    def jloss(q, k, v, *tabs):
        out = j_attn(q, k, v, joff, jts, dict(zip(names, tabs)), JR,
                     time_mode=mode, block=block, schedule="dense",
                     interpret=True)
        return jnp.sum(jnp.sin(out.astype(jnp.float32))), out

    (_, jout), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(3 + len(names))), has_aux=True)(
            jq, jk, jv, *(jrab[n] for n in names))
    leaves = [t.clone().requires_grad_()
              for t in (pq, pk, pv, *(prab[n] for n in names))]
    out = jagged_attention(*leaves[:3], poff, pts,
                           dict(zip(names, leaves[3:])), PR, time_mode=mode,
                           block=block, schedule="dense", max_row_len=mrl)
    torch.sin(out.float()).sum().backward()
    return (jout, jg), (out, [t.grad for t in leaves]), names


# fp32, the same arithmetic summed in another order: 1e-5 for the O(1)
# outputs (as the work-list tests), 1e-4 for the grads, whose table
# entries sum thousands of terms of either sign (as
# test_torch_attention_grad); the functional time encoder takes z^ρ as
# exp(ρ·ln z) against the reference kernel's same form.
@pytest.mark.parametrize("mode", ["bucket", "functional"])
@pytest.mark.parametrize("name", ["long_tail", "empty_rows",
                                  "cap_not_block_multiple", "all_padding"])
def test_dense_schedule_matches_reference_dense_kernel(name, mode):
    (jout, jg), (out, pg), names = _grads(name, mode)
    np.testing.assert_allclose(to_f32(out), to_f32(jout), atol=1e-5,
                               rtol=0)
    for field, a, b in zip(["q", "k", "v", *names], jg, pg):
        assert b is not None and tuple(b.shape) == a.shape, field
        np.testing.assert_allclose(to_f32(b), to_f32(a), rtol=1e-4,
                                   atol=1e-4, err_msg=field)


def test_dense_schedule_entry_points():
    """``make_attn_fn(schedule="dense")`` plans and runs like the
    work-list function (one function; on the CPU both take the plain
    version, bit for bit, and launch no kernel); the reference entry
    takes the schedule too; an unknown schedule raises at every entry."""
    _, (pq, pk, pv, poff, pts, prab), block, mrl = _attn_inputs(
        "long_tail", jnp.bfloat16)
    outs = {}
    for schedule in ("worklist", "dense"):
        fn = make_attn_fn(block=block, schedule=schedule, max_row_len=mrl)
        assert fn.schedule == schedule
        plan = fn.make_plan(poff, pts, pq.shape[0])
        before = dict(ops.KERNEL_LAUNCHES)
        outs[schedule] = fn(pq, pk, pv, poff, pts, prab, PR, plan=plan)
        assert ops.KERNEL_LAUNCHES == before
    assert torch.equal(outs["dense"], outs["worklist"])
    assert torch.equal(outs["dense"], jagged_attention_ref(
        pq, pk, pv, poff, pts, prab, PR, block=block, schedule="dense",
        max_row_len=mrl))
    for bad in (lambda: make_attn_fn(schedule="band"),
                lambda: jagged_attention(pq, pk, pv, poff, pts, prab, PR,
                                         block=block, schedule="band")):
        with pytest.raises(ValueError, match="unknown schedule"):
            bad()
    assert ops.launch_counter("bwd", dense=True, functional=True) == \
        "attn_bwd_dense_functional"
    assert set(ops.KERNEL_LAUNCHES) == {
        ops.launch_counter(kind, dense=d, functional=f)
        for kind in ("fwd", "bwd") for d in (False, True)
        for f in (False, True)} | {
        ops.launch_counter("fwd_append", dense=False, functional=f)
        for f in (False, True)}
