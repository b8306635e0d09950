"""The port's LM stack (``models/transformer.py`` through ``LMBundle``)
against the JAX package's, for all ten assigned archs at ``reduced()``:
``lm_loss`` and every gradient, on the reference's ``init_lm`` weights
carried across by ``convert.lm_params_from_numpy``, in fp32 and in bf16.

Tolerances.
- fp32: the same fp32 arithmetic with sums in other orders; the loss to
  1e-5 relative, each gradient leaf to 1e-4 of its largest value (the
  worst measured is 9.3e-6, jamba's dt_bias, through the SSD's exp of
  cumulative sums).
- bf16: XLA on the CPU rounds to bf16 where it chooses (inside a fusion
  it keeps fp32) and PyTorch after every op, so the two bf16 runs differ
  by bf16 rounding (2^-8 relative) at different places, and a router
  decision flipped by it moves a MoE layer's grads much more. Each is held
  to the reference's own fp32 run instead: the port's bf16 loss lies
  within 2 × the reference bf16 loss's distance from the fp32 loss plus
  2e-3 of it, and each gradient leaf's relative L2 distance from the
  fp32 gradient within 2 × the reference bf16 gradient's plus 0.02.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as PC
from repro.models.model_zoo import get_bundle as j_bundle
from repro_torch.convert import lm_params_from_numpy, lm_tree_of
from repro_torch.models.model_zoo import get_bundle
from torch_parity import CPU, tree_numpy

ASSIGNED = sorted(JC.ASSIGNED)
B, S, Q_BLOCK = 2, 64, 32


def cfgs(name, dtype="float32", **kw):
    return (JC.reduced(JC.get_arch(name)).replace(dtype=dtype, **kw),
            PC.reduced(PC.get_arch(name)).replace(dtype=dtype, **kw))


def lm_batch(cfg, seed=0, B=B, S=S):
    """A numpy batch: labels, and tokens or (stub frontends) embeds."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.frontend == "stub_embed":
        batch["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    return batch


def to_port(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference(name, dtype):
    """(params as numpy, loss, grads as a numpy tree in fp32)."""
    cj, _ = cfgs(name, dtype)
    b = j_bundle(cj)
    params = b.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in lm_batch(cj).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: b.loss(p, batch, q_block=Q_BLOCK)))(params)
    return (tree_numpy(params), float(loss),
            jax.tree.map(lambda g: np.asarray(g.astype(jnp.float32)), grads))


def port_loss_and_grads(name, dtype, params):
    _, cp = cfgs(name, dtype)
    model = lm_params_from_numpy(params, cp, device=CPU)
    loss = get_bundle(cp).loss(model, to_port(lm_batch(cp)),
                               q_block=Q_BLOCK)
    plist = list(model.parameters())
    gs = torch.autograd.grad(loss, plist, allow_unused=True)
    named = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(model.named_parameters(), gs)}
    return float(loss.detach()), lm_tree_of(named, cp)


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ASSIGNED)
def test_loss_and_grads_match_reference(name, dtype):
    params, jloss, jgrads = reference(name, dtype)
    loss, grads = port_loss_and_grads(name, dtype, params)
    got, want = leaves(grads), leaves(jgrads)
    assert sorted(got) == sorted(want)
    assert np.isfinite(loss) and all(np.isfinite(g).all()
                                     for g in got.values())
    if dtype == "float32":
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        for k, w in want.items():
            err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
            assert err < 1e-4, (k, err)
        return
    _, floss, fgrads = reference(name, "float32")
    exact = leaves(fgrads)
    assert abs(loss - floss) <= 2 * abs(jloss - floss) + 2e-3 * abs(floss)
    for k, f in exact.items():
        if not np.any(f):                   # unused (the stub's embed)
            assert not np.any(got[k]), k
            continue
        e_port, e_ref = rel_l2(got[k], f), rel_l2(want[k], f)
        assert e_port <= 2 * e_ref + 0.02, (k, e_port, e_ref)
