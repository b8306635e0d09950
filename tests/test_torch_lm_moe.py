"""The port's MoE layer (``models/moe.py``) against the JAX package's on
the same numpy inputs, in fp32: the router's top-k and aux loss, the
capacity-bounded dispatch with forced drops, shared experts, and the
gradients.

Tolerances: fp32 arithmetic with sums in another order (the experts'
matmuls, the combine adds a token's slots in the reference's CPU order),
a few ulps of O(1) values: 2e-5 max abs; grads by max abs over the
largest value, 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as PC
from repro.models import moe as JE
from repro_torch.models import moe as PE
from test_torch_lm_layers import _t, load
from torch_parity import CPU, to_f32

ATOL = 2e-5
GRAD_TOL = 1e-4


def _cfg(name, cf=None, d_model=None):
    cj = JC.reduced(JC.get_arch(name)).replace(dtype="float32")
    cp = PC.reduced(PC.get_arch(name)).replace(dtype="float32")
    if cf is not None:
        cj = cj.replace(moe=dataclasses.replace(cj.moe, capacity_factor=cf))
        cp = cp.replace(moe=dataclasses.replace(cp.moe, capacity_factor=cf))
    return cj, cp


def _moe(name, cf=None, seed=0):
    cj, cp = _cfg(name, cf)
    p = JE.init_moe(jax.random.PRNGKey(seed), cj, jnp.float32)
    mod = load(PE.MoE(cp, dtype=torch.float32, device=CPU), p)
    return cj, cp, p, mod


def test_router_topk_and_aux():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((37, 8)).astype(np.float32) * 2
    w, idx, aux = PE.router_topk(_t(logits), 3)
    jw, jidx, jaux = JE.router_topk(jnp.asarray(logits), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_dispatch_with_drops(cf):
    """cf 0.5 forces drops; the kept slots, the combine and the aux loss are
    the reference's, and the drop count is the one the reference's ranks
    give (rank within the expert, by a stable sort, ≥ C)."""
    cj, cp, p, mod = _moe("olmoe-1b-7b", cf)
    rng = np.random.default_rng(1)
    T = 40
    x = rng.standard_normal((T, cj.d_model)).astype(np.float32)
    with PE.dispatch_stats() as st:
        out, aux = PE._moe_tokens(mod, cp, _t(x))
    jout, jaux = JE._moe_tokens(p, cj, jnp.asarray(x))
    np.testing.assert_allclose(to_f32(out), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    # the drops the reference's dispatch makes
    k, E = cj.moe.top_k, cj.moe.num_experts
    cap = max(1, min(int(np.ceil(T * k / E * cf)), T))
    logits = x @ np.asarray(p["router"])
    _, idx, _ = JE.router_topk(jnp.asarray(logits), k)
    flat = np.asarray(idx).reshape(-1)
    seen, dropped = {}, 0
    for e in flat:                              # token order = stable order
        seen[e] = seen.get(e, 0) + 1
        dropped += seen[e] > cap
    assert (st.slots, st.dropped) == (T * k, dropped)
    if cf == 0.5:
        assert dropped > 0
    if cf == 8.0:                               # C = T: nothing dropped
        assert dropped == 0


def test_moe_apply_shared_experts_and_grads():
    """deepseek-moe (routed + a shared expert), per-sample capacity: the
    output, the aux loss and every gradient (router included) against
    jax.grad."""
    cj, cp, p, mod = _moe("deepseek-moe-16b", seed=2)
    assert "shared_w_in" in p and mod.shared_w_in is not None
    x = np.random.default_rng(3).standard_normal(
        (2, 24, cj.d_model)).astype(np.float32)

    def jloss(pp, xx):
        o, a = JE.moe_apply(pp, cj, xx)
        return jnp.sum(jnp.sin(o)) + 3.0 * a, (o, a)

    (jl, (jout, jaux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    out, aux = PE.moe_apply(mod, cp, xt)
    (torch.sum(torch.sin(out)) + 3.0 * aux).backward()
    np.testing.assert_allclose(to_f32(out), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    for n, prm in mod.named_parameters():
        want = np.asarray(jg[n])
        err = np.abs(to_f32(prm.grad) - want).max() / np.abs(want).max()
        assert err < GRAD_TOL, (n, err)
    want = np.asarray(jgx)
    assert np.abs(to_f32(xt.grad) - want).max() / np.abs(want).max() \
        < GRAD_TOL


def test_combine_is_run_to_run_bitwise():
    cj, cp, p, mod = _moe("olmoe-1b-7b", cf=1.0)
    x = _t(np.random.default_rng(4).standard_normal(
        (3, 30, cj.d_model)).astype(np.float32))
    a, _ = PE.moe_apply(mod, cp, x)
    b, _ = PE.moe_apply(mod, cp, x)
    assert torch.equal(a, b)
