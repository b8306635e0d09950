"""The port's dense LM layers (``models/layers.py``) and the sharding
context (``core/sharding.py``) against the JAX package's, on the same
numpy inputs from a seed, in fp32.

Tolerances. fp32 results of the same fp32 arithmetic with sums in another
order (XLA's and PyTorch's matmuls, reductions): a few ulps of O(1)
values, held at 2e-5 max abs (norms, RoPE: elementwise, 1e-6); the
attention's fp32 scores feed a softmax whose weights sum keys in another
order, held at 2e-5 max abs of outputs of size ~1."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as PC
from repro.core import sharding as JS
from repro.models import layers as JL
from repro_torch.core import sharding as PS
from repro_torch.models import layers as PL
from torch_parity import CPU, to_f32

ATOL = 2e-5
ELEM_ATOL = 1e-6


def _cfg(name="glm4-9b", **kw):
    return (JC.reduced(JC.get_arch(name)).replace(dtype="float32", **kw),
            PC.reduced(PC.get_arch(name)).replace(dtype="float32", **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def load(module, tree):
    """Copy a reference params dict into a port module, leaf for leaf (the
    module's None leaves must be absent from the tree)."""
    own = dict(module.named_parameters(recurse=False))
    assert set(own) == set(tree), (sorted(own), sorted(tree))
    with torch.no_grad():
        for n, p in own.items():
            p.copy_(_t(np.asarray(tree[n])))
    return module


def test_norms_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32) * 3
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        to_f32(PL.rmsnorm(_t(x), _t(w), 1e-5)),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=ELEM_ATOL, rtol=1e-6)
    np.testing.assert_allclose(
        to_f32(PL.layernorm(_t(x), _t(w), _t(b))),
        np.asarray(JL.layernorm(*map(jnp.asarray, (x, w, b)))),
        atol=ELEM_ATOL, rtol=1e-6)
    pos = np.arange(7, dtype=np.int32)[None].repeat(2, 0) + 100
    for theta in (10_000.0, 1e6):
        np.testing.assert_allclose(
            to_f32(PL.apply_rope(_t(x), _t(pos), theta)),
            np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     theta)), atol=1e-5, rtol=1e-5)
    # halves, not interleaved pairs: position 0 is the identity, and the
    # first half's element 0 pairs with element hd/2
    y = to_f32(PL.apply_rope(_t(x), _t(np.zeros_like(pos)), 1e4))
    np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("case", ["causal", "lengths", "q_offset",
                                  "odd_block", "gqa1"])
def test_gqa_scores_blocked(case):
    rng = np.random.default_rng(1)
    B, Sq, Hq, Hkv, hd = 2, 48, 4, 2, 16
    Sk, q_off, block, lengths = Sq, 0, 16, None
    if case == "lengths":
        lengths = np.asarray([48, 0 + 5], np.int32)
    if case == "q_offset":
        Sq, Sk, q_off = 8, 40, 32
        lengths = np.asarray([40, 37], np.int32)
    if case == "odd_block":
        Sq = Sk = 45           # 16 does not divide 45: one block
    if case == "gqa1":
        Hkv = 4
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    want = JL.gqa_scores_blocked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(q_off),
        block, lengths=None if lengths is None else jnp.asarray(lengths))
    got = PL.gqa_scores_blocked(_t(q), _t(k), _t(v), q_off, block,
                                lengths=None if lengths is None
                                else _t(lengths))
    np.testing.assert_allclose(to_f32(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["glm4-9b", "starcoder2-3b",
                                  "pixtral-12b"])
@pytest.mark.parametrize("cached", [False, True])
def test_attention_layer(name, cached):
    """The layer (qkv with its biases, RoPE, GQA, output projection), alone
    or against a KV cache written at cache_index: the port writes K and V
    in place, the reference returns a new cache; both hold the same."""
    cj, cp = _cfg(name)
    p = JL.init_attention(jax.random.PRNGKey(3), cj, jnp.float32)
    if "bq" in p:   # non-zero biases, so that they count
        p = {k: (v + 0.1 * jax.random.normal(jax.random.PRNGKey(4), v.shape)
                 if k.startswith("b") else v) for k, v in p.items()}
    mod = load(PL.Attention(cp, dtype=torch.float32, device=CPU), p)
    rng = np.random.default_rng(2)
    B, S, Smax = 2, 8, 32
    x = rng.standard_normal((B, S, cj.d_model)).astype(np.float32)
    if not cached:
        pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
        want, _ = JL.attention(p, cj, jnp.asarray(x), jnp.asarray(pos),
                               q_block=4)
        got, _ = PL.attention(mod, cp, _t(x), _t(pos), q_block=4)
        np.testing.assert_allclose(to_f32(got), np.asarray(want), atol=ATOL)
        return
    hd, Hkv = cj.resolved_head_dim, cj.num_kv_heads
    K = rng.standard_normal((B, Smax, Hkv, hd)).astype(np.float32)
    V = rng.standard_normal((B, Smax, Hkv, hd)).astype(np.float32)
    idx = 20
    pos = np.full((B, S), 0, np.int32) + np.arange(idx, idx + S)[None]
    want, (wk, wv) = JL.attention(p, cj, jnp.asarray(x), jnp.asarray(pos),
                                  q_block=4, kv_cache=(jnp.asarray(K),
                                                       jnp.asarray(V)),
                                  cache_index=jnp.int32(idx))
    ck, cv = _t(K.copy()), _t(V.copy())
    got, (gk, gv) = PL.attention(mod, cp, _t(x), _t(pos), q_block=4,
                                 kv_cache=(ck, cv), cache_index=idx)
    assert gk is ck and gv is cv            # written in place
    np.testing.assert_allclose(to_f32(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(to_f32(gk), np.asarray(wk), atol=ELEM_ATOL)
    np.testing.assert_allclose(to_f32(gv), np.asarray(wv), atol=ELEM_ATOL)


@pytest.mark.parametrize("name", ["glm4-9b",          # GLU, SiLU, no bias
                                  "musicgen-large",   # plain GELU
                                  "starcoder2-3b"])   # GELU with biases
def test_mlp(name):
    cj, cp = _cfg(name)
    p = JL.init_mlp(jax.random.PRNGKey(5), cj, cj.d_ff, jnp.float32)
    if "b_in" in p:
        p = dict(p, b_in=p["b_in"] + 0.3, b_out=p["b_out"] - 0.2)
    mod = load(PL.MLP(cp, cp.d_ff, dtype=torch.float32, device=CPU), p)
    x = np.random.default_rng(6).standard_normal(
        (2, 5, cj.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        to_f32(PL.mlp(mod, cp, _t(x))),
        np.asarray(JL.mlp(p, cj, jnp.asarray(x))), atol=ATOL)


def test_fp32_products_refuse_tf32(monkeypatch):
    """matmul_f32 widens bf16 operands (exact products) and refuses to run
    on the card with TF32 allowed."""
    a = torch.randn(4, 8, dtype=torch.bfloat16)
    b = torch.randn(8, 3, dtype=torch.bfloat16)
    out = PL.matmul_f32(a, b)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, a.double().matmul(b.double()).float(),
                               rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    with pytest.raises(RuntimeError, match="allow_tf32"):
        PL.matmul_f32(a, b)


class _Mesh:
    """A mesh's shape and axis names, as DeviceMesh gives them."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


def test_sharding_rules_match_reference():
    """Outside a context: constrain is the identity, every logical axis has
    size 1. Inside: a logical axis resolves to its mesh axes, and one whose
    mesh size does not divide the dim is dropped, as the reference's."""
    x = torch.randn(4, 6)
    assert PS.constrain(x, "batch", "tp") is x
    assert PS.logical_axis_size("tp") == 1 == JS.logical_axis_size("tp")
    mesh = _Mesh(data=2, model=4)
    rules = {"batch": "data", "tp": "model", "both": ("data", "model")}
    with PS.shard_ctx(mesh, rules):
        assert PS.current_ctx().rules == rules
        assert PS.logical_axis_size("tp") == 4
        assert PS.logical_axis_size("both") == 8
        assert PS.logical_axis_size("none") == 1
        assert PS.constrain(x, "batch", "tp") is x     # a plain tensor
        ctx = PS.current_ctx()
        assert ctx.resolve(["batch", None, "tp"]) == ("data", None, "model")
        # 6 % 4 != 0: dropped; 2 KV heads on a 4-way axis: dropped
        assert ctx.resolve_for((4, 6), ["batch", "tp"]) == ("data", None)
        assert ctx.resolve_for((8, 2, 16), ["both", "tp", "tp"]) == \
            (("data", "model"), None, "model")
    assert PS.current_ctx() is None


def test_constrain_redistributes_a_dtensor(tmp_path):
    """Inside a context a DTensor is redistributed to the resolved
    placements (a one-rank gloo world: the values stay)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    store = dist.FileStore(os.path.join(tmp_path, "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
        x = torch.randn(4, 6)
        dt = DTensor.from_local(x, mesh, [Replicate(), Replicate()])
        with PS.shard_ctx(mesh, {"batch": "data", "tp": "model"}):
            y = PS.constrain(dt, "batch", "tp")
        assert list(y.placements) == [Shard(0), Shard(1)]
        torch.testing.assert_close(y.full_tensor(), x, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()
