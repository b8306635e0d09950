"""The port's HSTU block and GR forward against the JAX package, on the
same weights carried across by ``repro_torch.convert``."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import RABConfig as JRAB
from repro.models import gr as JG
from repro.models import hstu as JH
from repro_torch.configs.base import RABConfig as PRAB
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import gr as PG
from repro_torch.models import hstu as PH
from torch_parity import CPU, models, to_f32, to_t, tree_numpy

# fp32: two frameworks' matmul summation orders through 2 HSTU layers and
# 3 layernorms (each renormalising O(1) activations) leave a few 1e-6;
# 1e-4 bounds it with room. bf16: every matmul output and the attention
# weights round to bf16 (2^-8 relative) at slightly different points in
# the two frameworks, and the final layernorm scales O(1) outputs.
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(rng, G, cap, d, S, max_len, dtype):
    offs, ts, lp = [], [], []
    for g in range(G):
        lens = rng.integers(0, max_len + 1, S)
        lens[0] = max(lens[0], 1)
        while lens.sum() > cap:
            lens[np.argmax(lens)] //= 2
        o = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        offs.append(o)
        lp.append(np.maximum(o[1:] - 1, 0).astype(np.int32))
        ts.append(np.cumsum(rng.integers(0, 3000, cap)).astype(np.int32))
    x = (rng.standard_normal((G, cap, d)) * 0.5).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    return x, xj, np.stack(offs), np.stack(ts), np.stack(lp)


def _port_x(xj):
    return tensor_from_numpy(np.asarray(xj), CPU)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hstu_block_matches_jax(dtype):
    (cj, dense, _), (cp, model, _) = models(seed=2, dtype=dtype)
    rng = np.random.default_rng(0)
    _, xj, offs, ts, _ = _inputs(rng, 1, 256, cj.d_model, 6, 64,
                                 jnp.dtype(dtype))
    bp = {k: v[0] for k, v in dense["blocks"].items() if k != "rab"}
    bp["rab"] = {k: v[0] for k, v in dense["blocks"]["rab"].items()}
    ref = JH.hstu_block(bp, cj, xj[0], jnp.asarray(offs[0]),
                        jnp.asarray(ts[0]))
    out = PH.hstu_block(model.blocks[0], cp, _port_x(xj[0]),
                        *to_t(offs[0], ts[0]))
    assert out.dtype == {"float32": torch.float32,
                         "bfloat16": torch.bfloat16}[dtype]
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("jax_attn", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gr_user_embeddings_sharded_matches_jax(dtype, jax_attn):
    """G=2 packs through the whole stack: the port's default attention
    (plan-aware wrapper, plain version on the CPU) against the JAX
    package's XLA default and its Pallas kernel in interpret mode."""
    (cj, dense, _), (cp, model, _) = models(seed=3, dtype=dtype)
    rng = np.random.default_rng(1)
    _, xj, offs, ts, lp = _inputs(rng, 2, 256, cj.d_model, 5, 64,
                                  jnp.dtype(dtype))
    attn = (None if jax_attn == "xla" else
            JG.attn_ops.make_attn_fn(block=32, max_row_len=64,
                                     pairs_per_step=1, interpret=True))
    ref = JG.gr_user_embeddings_sharded(
        dense, cj, xj, jnp.asarray(offs), jnp.asarray(ts), jnp.asarray(lp),
        attn_fn=attn)
    out = PG.gr_user_embeddings_sharded(model, cp, _port_x(xj),
                                        *to_t(offs, ts, lp))
    assert out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=TOL[dtype],
                               rtol=0)


def test_gr_user_embeddings_single_pack_equals_sharded():
    _, (cp, model, _) = models(seed=4)
    rng = np.random.default_rng(2)
    x, _, offs, ts, lp = _inputs(rng, 2, 256, cp.d_model, 4, 64,
                                 jnp.float32)
    both = PG.gr_user_embeddings_sharded(model, cp, *to_t(x, offs, ts, lp))
    for g in range(2):
        one = PG.gr_user_embeddings(model, cp, *to_t(x[g], offs[g], ts[g],
                                                     lp[g]))
        torch.testing.assert_close(both[g], one, atol=1e-6, rtol=0)


def test_rab_helpers_match_jax():
    rng = np.random.default_rng(4)
    jr = JRAB(num_pos_buckets=16, num_time_buckets=8)
    pr = PRAB(num_pos_buckets=16, num_time_buckets=8)
    pos = rng.integers(0, 40, 30).astype(np.int32)
    ts = np.cumsum(rng.integers(0, 5000, 30)).astype(np.int32)
    p = {"pos_table": rng.standard_normal((16, 3)).astype(np.float32),
         "time_table": rng.standard_normal((8, 3)).astype(np.float32)}
    np.testing.assert_array_equal(
        np.asarray(JH.pos_bucket(pos, pos, 16)),
        PH.pos_bucket(*to_t(pos, pos), 16).numpy())
    np.testing.assert_array_equal(
        np.asarray(JH.time_bucket(jnp.asarray(ts), jnp.asarray(ts), jr)),
        PH.time_bucket(*to_t(ts, ts), pr).numpy())
    a = JH.rab_bias({k: jnp.asarray(v) for k, v in p.items()}, jr,
                    pos, pos, jnp.asarray(ts), jnp.asarray(ts))
    b = PH.rab_bias({k: torch.from_numpy(v) for k, v in p.items()}, pr,
                    *to_t(pos, pos, ts, ts))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bf16_roundtrip_is_bit_exact():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((7, 33)).astype(ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, CPU)
    assert t.dtype == torch.bfloat16
    back = t.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(back, a.view(np.uint16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_carried_per_layer(dtype):
    """The stacked layer axis splits per block, the u,v,q,k layout of
    w_uvqk is kept, and the RAB tables stay fp32."""
    (_, dense, _), (cp, model, _) = models(seed=6, dtype=dtype)
    tree = tree_numpy(dense)
    assert len(model.blocks) == cp.num_layers
    for i, bp in enumerate(model.blocks):
        for name in ("ln_w", "ln_b", "w_uvqk", "w_o"):
            src = tree["blocks"][name][i]
            got = getattr(bp, name).detach()
            np.testing.assert_array_equal(to_f32(got),
                                          src.astype(np.float32))
        for name, p in bp.rab.items():
            assert p.dtype == torch.float32
            np.testing.assert_array_equal(p.detach().numpy(),
                                          tree["blocks"]["rab"][name][i])
    H = cp.num_heads
    assert model.blocks[0].w_uvqk.shape == (cp.d_model, H * 4 * cp.qkv_dim)


def test_model_init_uses_init_gr_distributions():
    """A GRModel from a seeded generator: ln ones/zeros, weight scales as
    init_gr's (w_uvqk ~ N(0, 1/d), w_o ~ N(0, 1/(H·dv·2L)), RAB 0.02)."""
    _, cp = __import__("torch_parity").configs()
    cp = cp.replace(d_model=256)
    m = PG.GRModel(cp, device=CPU,
                   generator=torch.Generator().manual_seed(0))
    bp = m.blocks[0]
    assert torch.equal(bp.ln_w, torch.ones_like(bp.ln_w))
    d, H, dv, L = cp.d_model, cp.num_heads, cp.qkv_dim, cp.num_layers
    assert abs(bp.w_uvqk.std().item() - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(bp.w_o.std().item() - (H * dv * 2 * L) ** -0.5) < 0.15 * (
        H * dv * 2 * L) ** -0.5
    assert abs(bp.rab["pos_table"].std().item() - 0.02) < 0.005
