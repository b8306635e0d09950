"""The port's Mamba-2 block (``models/mamba.py``) against the JAX
package's on the same numpy inputs, in fp32: the chunked SSD with segment
resets, an initial state and padding, the decode step, the causal conv in
both modes, and the block at prefill, at decode and through its grads.

Tolerances: fp32 products and sums in another order (the pairwise SSD
products against XLA's einsums; the chunk recurrence), on outputs of size
~1 accumulated over up to 96 positions: 5e-5 max abs; grads 2e-4 of the
largest value."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as PC
from repro.models import mamba as JM
from repro_torch.models import mamba as PM
from test_torch_lm_layers import _t, load
from torch_parity import CPU, to_f32

ATOL = 5e-5
GRAD_TOL = 2e-4


def _cfg():
    return (JC.reduced(JC.get_arch("mamba2-2.7b")).replace(dtype="float32"),
            PC.reduced(PC.get_arch("mamba2-2.7b")).replace(dtype="float32"))


def _ssd_inputs(rng, b=2, S=96, H=4, P=8, G=1, N=16):
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(
        np.float32) * 0.3
    A = -np.exp(rng.uniform(0, 1.5, H)).astype(np.float32)
    Bm = rng.standard_normal((b, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((b, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("case", ["plain", "seg", "init_state", "groups"])
def test_ssd_chunked(case):
    rng = np.random.default_rng(0)
    G = 2 if case == "groups" else 1
    x, dt, A, Bm, Cm = _ssd_inputs(rng, G=G)
    seg = init = None
    if case == "seg":
        # three packed sequences per row, boundaries off the chunk grid
        seg = np.zeros((2, 96), np.int32)
        seg[0, 30:] = 1
        seg[0, 71:] = 2
        seg[1, 50:] = 1
    if case == "init_state":
        init = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    y, h = PM.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), 32,
                          seg=None if seg is None else _t(seg),
                          init_state=None if init is None else _t(init))
    jy, jh = JM.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 32,
                            seg=None if seg is None else jnp.asarray(seg),
                            init_state=None if init is None
                            else jnp.asarray(init))
    np.testing.assert_allclose(to_f32(y), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(to_f32(h), np.asarray(jh), atol=ATOL)
    if case == "seg":
        # the first sequence of each row, before any boundary, is the
        # sequence alone; after a boundary the reference's -1e9 in an fp32
        # cumulative sum leaves the decays within that chunk off (ulp 64
        # near 1e9), and the port keeps that arithmetic (ROADMAP.md,
        # queue 3): held to the reference above, not to a reset
        y2, _ = PM.ssd_chunked(*(_t(a[:1, :32]) for a in (x, dt)), _t(A),
                               *(_t(a[:1, :32]) for a in (Bm, Cm)), 32)
        np.testing.assert_allclose(to_f32(y)[0, :30], to_f32(y2)[0, :30],
                                   atol=ATOL)


def test_ssd_decode_step_continues_the_scan():
    rng = np.random.default_rng(1)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, S=33)
    st = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    args = (x[:, :1], dt[:, :1], A, Bm[:, :1], Cm[:, :1], st)
    y, s = PM.ssd_decode_step(*map(_t, args))
    jy, js = JM.ssd_decode_step(*map(jnp.asarray, args))
    np.testing.assert_allclose(to_f32(y), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(to_f32(s), np.asarray(js), atol=ATOL)
    # 32 chunked positions then one decode step == the last of 33 chunked
    _, h32 = PM.ssd_chunked(*(_t(a[:, :32]) for a in (x, dt)), _t(A),
                            *(_t(a[:, :32]) for a in (Bm, Cm)), 32)
    y33, _ = PM.ssd_decode_step(*(_t(a[:, 32:]) for a in (x, dt)), _t(A),
                                *(_t(a[:, 32:]) for a in (Bm, Cm)), h32)
    jy_all, _ = JM.ssd_chunked(*map(jnp.asarray, (x[:, :32], dt[:, :32], A,
                                                  Bm[:, :32], Cm[:, :32])),
                               32)
    assert np.isfinite(np.asarray(jy_all)).all()
    yfull, _ = PM.ssd_chunked(
        *map(_t, (np.pad(x, ((0, 0), (0, 31), (0, 0), (0, 0))),
                  np.pad(dt, ((0, 0), (0, 31), (0, 0))), A,
                  np.pad(Bm, ((0, 0), (0, 31), (0, 0), (0, 0))),
                  np.pad(Cm, ((0, 0), (0, 31), (0, 0), (0, 0))))), 32)
    np.testing.assert_allclose(to_f32(y33)[:, 0], to_f32(yfull)[:, 32],
                               atol=ATOL)


def test_causal_conv_both_modes():
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    out, st = PM._causal_conv(_t(h), _t(w), _t(b))
    jout, jst = JM._causal_conv(*map(jnp.asarray, (h, w, b)))
    np.testing.assert_allclose(to_f32(out), np.asarray(jout), atol=1e-6)
    np.testing.assert_allclose(to_f32(st), np.asarray(jst), atol=0)
    nxt = rng.standard_normal((2, 1, 12)).astype(np.float32)
    out1, st1 = PM._causal_conv(_t(nxt), _t(w), _t(b), st)
    jout1, jst1 = JM._causal_conv(*map(jnp.asarray, (nxt, w, b)),
                                  conv_state=jst)
    np.testing.assert_allclose(to_f32(out1), np.asarray(jout1), atol=1e-5)
    np.testing.assert_allclose(to_f32(st1), np.asarray(jst1), atol=0)


@pytest.mark.parametrize("S", [64, 45])     # 45: padded to a whole chunk
def test_mamba_block_prefill_decode_and_grads(S):
    cj, cp = _cfg()
    p = JM.init_mamba(jax.random.PRNGKey(0), cj, jnp.float32)
    mod = load(PM.Mamba(cp, dtype=torch.float32, device=CPU), p)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, cj.d_model)).astype(np.float32)

    def jloss(pp, xx):
        o, st = JM.mamba_block(pp, cj, xx)
        return jnp.sum(jnp.sin(o)), (o, st)

    (_, (jout, jst)), jg = jax.value_and_grad(jloss, has_aux=True)(
        p, jnp.asarray(x))
    out, st = PM.mamba_block(mod, cp, _t(x))
    torch.sum(torch.sin(out)).backward()
    np.testing.assert_allclose(to_f32(out), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(to_f32(st["ssm"]), np.asarray(jst["ssm"]),
                               atol=ATOL)
    for n, prm in mod.named_parameters():
        want = np.asarray(jg[n])
        err = np.abs(to_f32(prm.grad) - want).max() / np.abs(want).max()
        assert err < GRAD_TOL, (n, err)
    # prefill with a state, then a decode step, against the reference
    state = {k: np.asarray(v) for k, v in
             JM.init_mamba_state(cj, 2).items()}
    with torch.no_grad():
        _, pst = PM.mamba_block(mod, cp, _t(x),
                                state={k: _t(v) for k, v in state.items()})
        y1, dst = PM.mamba_block(mod, cp, _t(x[:, :1] * 0.5), state=pst)
    _, jpst = JM.mamba_block(p, cj, jnp.asarray(x),
                             state={k: jnp.asarray(v)
                                    for k, v in state.items()})
    jy1, jdst = JM.mamba_block(p, cj, jnp.asarray(x[:, :1] * 0.5),
                               state=jpst)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(to_f32(pst[k]), np.asarray(jpst[k]),
                                   atol=ATOL)
        np.testing.assert_allclose(to_f32(dst[k]), np.asarray(jdst[k]),
                                   atol=ATOL)
    np.testing.assert_allclose(to_f32(y1), np.asarray(jy1), atol=ATOL)


def test_init_mamba_state_matches():
    cj, cp = _cfg()
    got = PM.init_mamba_state(cp, 3, torch.bfloat16, device=CPU)
    want = JM.init_mamba_state(cj, 3, jnp.bfloat16)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
