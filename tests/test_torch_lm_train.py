"""The port's LM train step (``training.make_lm_train_step``) against the
JAX package's: two steps of gradient accumulation over microbatches and
AdamW (lr 3e-4, weight decay 0.1, b1 0.9, b2 0.95) from the reference's
weights, in fp32, on a dense, a MoE and an SSM arch; and the port against
itself at 1 and 4 microbatches.

Tolerances. The losses are fp32 sums in another order: 1e-5 relative.
The moments carry the grads (μ = Σ(1−b1)·b1^i·g, ν likewise with g²),
held per leaf at 1e-4 of the leaf's largest value (the grads' own
tolerance in ``test_torch_lm.py``). The parameters move by AdamW's step,
lr·m̂/(√v̂ + eps): where a grad is near zero that step is near ±lr
whatever the grad's size (the first step is lr·sign(g)), so an element's
sign flip under fp32 rounding moves it by up to 2·lr a step, and a
later step carries that on whatever its own grad. Parameters are held to
2·lr·steps max abs per element, and to 1e-6 in the mean over each leaf
(the worst measured: 2.2e-5 max, 1.4e-7 mean, starcoder2's leaves)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model_zoo import get_bundle as j_bundle
from repro.training import trainer as JT
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 lm_tree_of)
from repro_torch.models.model_zoo import get_bundle
from repro_torch.training import lm_train_state, make_lm_train_step
from test_torch_lm import cfgs, leaves, lm_batch, to_port
from torch_parity import CPU, tree_numpy

LR = 3e-4
STEPS = 2


def _close_params(got, want, steps):
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2 * LR * steps, (k, d.max())
        assert d.mean() <= 1e-6, (k, d.mean())


def _close_moments(got, want):
    for k, w in want.items():
        err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err < 1e-4, (k, err)


@pytest.mark.parametrize("name", ["starcoder2-3b", "olmoe-1b-7b",
                                  "mamba2-2.7b"])
def test_train_step_matches_reference(name):
    cj, cp = cfgs(name, "float32")
    jb, pb = j_bundle(cj), get_bundle(cp)
    params = jb.init(jax.random.PRNGKey(2))
    model = lm_params_from_numpy(tree_numpy(params), cp, device=CPU)
    batches = [lm_batch(cj, seed=10 + i, B=4, S=32) for i in range(STEPS)]
    jstep = jax.jit(JT.make_lm_train_step(
        lambda p, b: jb.loss(p, b, q_block=16), num_microbatches=2))
    pstep = make_lm_train_step(lambda m, b: pb.loss(m, b, q_block=16),
                               num_microbatches=2)
    jst, pst = JT.lm_train_state(params), lm_train_state(model)
    for b in batches:
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        pst, pm = pstep(pst, to_port(b))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert pst.step == STEPS and pst.opt.count == STEPS
    _close_params(leaves(lm_params_to_numpy(pst.params)),
                  leaves(tree_numpy(jst.params)), STEPS)
    _close_moments(leaves(lm_tree_of(pst.opt.mu, cp)),
                   leaves(tree_numpy(jst.opt.mu)))
    _close_moments(leaves(lm_tree_of(pst.opt.nu, cp)),
                   leaves(tree_numpy(jst.opt.nu)))


@pytest.mark.parametrize("name", ["glm4-9b", "deepseek-moe-16b"])
def test_microbatches_agree(name):
    """One microbatch of 4 rows and 4 of 1: the same loss (a mean of equal
    microbatch means) and, after a step, the same moments and params."""
    cj, cp = cfgs(name, "float32")
    if cp.moe is not None:      # per-sample capacity, with no drops either
        cp = cp.replace(moe=dataclasses.replace(cp.moe,
                                                capacity_factor=8.0))
    pb = get_bundle(cp)
    tree = tree_numpy(j_bundle(cj).init(jax.random.PRNGKey(3)))
    batch = to_port(lm_batch(cp, seed=4, B=4, S=32))
    out = []
    for n in (1, 4):
        st = lm_train_state(lm_params_from_numpy(tree, cp, device=CPU))
        step = make_lm_train_step(lambda m, b: pb.loss(m, b, q_block=16),
                                  num_microbatches=n)
        st, m = step(st, batch)
        out.append((float(m["loss"]), st))
    (l1, s1), (l4, s4) = out
    np.testing.assert_allclose(l4, l1, rtol=1e-5)
    _close_moments(leaves(lm_tree_of(s4.opt.mu, cp)),
                   leaves(lm_tree_of(s1.opt.mu, cp)))
    _close_moments(leaves(lm_tree_of(s4.opt.nu, cp)),
                   leaves(lm_tree_of(s1.opt.nu, cp)))
    _close_params(leaves(lm_params_to_numpy(s4.params)),
                  leaves(lm_params_to_numpy(s1.params)), 1)
    assert torch.isfinite(torch.tensor(l1))


@pytest.mark.parametrize("n", [1, 2])
def test_lm_loss_microbatched_matches_reference(n):
    """``lm_loss_microbatched``: the mean of the microbatches' losses, the
    reference's (1e-5 relative: fp32 sums in another order)."""
    from repro.models import transformer as JTF
    from repro_torch.models import transformer as PTF
    cj, cp = cfgs("olmoe-1b-7b", "float32")
    params = j_bundle(cj).init(jax.random.PRNGKey(5))
    model = lm_params_from_numpy(tree_numpy(params), cp, device=CPU)
    b = lm_batch(cj, seed=6, B=4, S=32)
    want = JTF.lm_loss_microbatched(params, cj,
                                    {k: jnp.asarray(v) for k, v in b.items()},
                                    n, q_block=16)
    got = PTF.lm_loss_microbatched(model, cp, to_port(b), n, q_block=16)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
