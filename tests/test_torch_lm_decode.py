"""The port's LM prefill and decode (``lm_prefill``, ``lm_decode_step``)
against the JAX package's for all ten archs at ``reduced()``, in fp32 on
the reference's weights: the last position's logits, the filled cache
(stacked per period slot, as the reference's), then two decode steps. And
the port's own consistency on the reference test's four archs:
decode(prefill(x)) equals prefill(x + token)
(``tests/test_models.py::test_prefill_decode_consistency``).

Tolerances: fp32 arithmetic with sums in other orders, logits of size
~1-10 accumulated over the stack: 1e-4 max abs (the reference test's own
limit for its decode-vs-prefill check); the caches 5e-5 (layer l's K, V
and Mamba state carry the rounding of the l layers below it, O(1)
values; the worst measured is 1.02e-5, jamba's 16 layers)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models.model_zoo import get_bundle as j_bundle
from repro_torch.convert import lm_cache_to_numpy, lm_params_from_numpy
from repro_torch.models.model_zoo import get_bundle
from test_torch_lm import cfgs
from torch_parity import CPU, to_f32, tree_numpy

ASSIGNED = sorted(JC.ASSIGNED)
B, S = 2, 32
TOL = 1e-4
CACHE_TOL = 5e-5


def _no_drops(cj, cp):
    """Capacity factor 8 (no drops), as the reference test: a T = 33
    dispatch and a T = 1 dispatch would route differently otherwise."""
    if cj.moe is None:
        return cj, cp
    return (cj.replace(moe=dataclasses.replace(cj.moe, capacity_factor=8.0)),
            cp.replace(moe=dataclasses.replace(cp.moe, capacity_factor=8.0)))


def _inputs(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    emb = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return toks, emb


def _both(name):
    cj, cp = _no_drops(*cfgs(name, "float32"))
    jb = j_bundle(cj)
    params = jb.init(jax.random.PRNGKey(1))
    model = lm_params_from_numpy(tree_numpy(params), cp, device=CPU)
    return cj, cp, jb, params, get_bundle(cp), model


def _batch(cfg, toks, emb, lo, hi, jnp_=False):
    conv = jnp.asarray if jnp_ else (lambda a: torch.from_numpy(np.array(a)))
    if cfg.frontend == "stub_embed":
        return {"embeds": conv(emb[:, lo:hi])}
    return {"tokens": conv(toks[:, lo:hi])}


@pytest.mark.parametrize("name", ASSIGNED)
def test_prefill_and_decode_match_reference(name):
    cj, cp, jb, params, pb, model = _both(name)
    toks, emb = _inputs(cj, S + 2)
    stub = cj.frontend == "stub_embed"
    jl, jc = jb.prefill(params, _batch(cj, toks, emb, 0, S, True),
                        q_block=16, max_len=S + 2)
    pl, pc = pb.prefill(model, _batch(cp, toks, emb, 0, S), q_block=16,
                        max_len=S + 2)
    np.testing.assert_allclose(to_f32(pl), np.asarray(jl), atol=TOL)
    got = lm_cache_to_numpy(pc, cp)
    for s, (k, v) in jc.kv.items():
        np.testing.assert_allclose(got["kv"][s][0], np.asarray(k),
                                   atol=CACHE_TOL)
        np.testing.assert_allclose(got["kv"][s][1], np.asarray(v),
                                   atol=CACHE_TOL)
    for s, st in jc.ssm.items():
        for key in st:
            np.testing.assert_allclose(got["ssm"][s][key],
                                       np.asarray(st[key]), atol=CACHE_TOL)
    for i in (S, S + 1):
        kw = ({"embeds": jnp.asarray(emb[:, i:i + 1])} if stub else {})
        jl, jc = jb.decode(params, jnp.asarray(toks[:, i:i + 1]), jc,
                           jnp.int32(i), **kw)
        kw = ({"embeds": torch.from_numpy(emb[:, i:i + 1].copy())} if stub
              else {})
        pl, pc = pb.decode(model, torch.from_numpy(toks[:, i:i + 1].copy()),
                           pc, i, **kw)
        np.testing.assert_allclose(to_f32(pl), np.asarray(jl), atol=TOL)


@pytest.mark.parametrize("name", ["glm4-9b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b", "musicgen-large"])
def test_decode_after_prefill_equals_longer_prefill(name):
    """The port against itself: decode(prefill(x), token) logits ==
    prefill(x + token) last logits, and the same argmax."""
    _, cp, _, _, pb, model = _both(name)
    toks, emb = _inputs(cp, S + 1)
    full, _ = pb.prefill(model, _batch(cp, toks, emb, 0, S + 1), q_block=16)
    _, cache = pb.prefill(model, _batch(cp, toks, emb, 0, S), q_block=16,
                          max_len=S + 1)
    kw = ({"embeds": torch.from_numpy(emb[:, S:S + 1].copy())}
          if cp.frontend == "stub_embed" else {})
    step, _ = pb.decode(model, torch.from_numpy(toks[:, S:S + 1].copy()),
                        cache, S, **kw)
    lf, ls = to_f32(full[:, -1]), to_f32(step[:, -1])
    np.testing.assert_allclose(ls, lf, rtol=1e-4, atol=1e-4)
    assert (np.argmax(ls, -1) == np.argmax(lf, -1)).all()
