"""The port on the card: the CUDA kernels against their plain versions and
the serving slice on CUDA against the same slice on the CPU.

Every test here carries the ``gpu`` marker and skips without a card (the
kernels are CUDA C++ and have no interpret mode). This file imports no jax,
so it also runs on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import RABConfig, get_arch, reduced
from repro_torch.kernels.jagged_attention import (attention_fwd_plain,
                                                  build_attn_plan,
                                                  jagged_attention,
                                                  jagged_attention_ref, ops)
from repro_torch.kernels.jagged_attention.ref import (max_row_rel_err,
                                                      time_buckets)
from repro_torch.models.gr import GRModel
from repro_torch.serving import RecallEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pack(dev, dtype, H, D, lens_per_pack, cap, seed=7):
    rng = np.random.default_rng(seed)
    S = max(len(lens) for lens in lens_per_pack)
    offs = np.zeros((len(lens_per_pack), S + 1), np.int32)
    for g, lens in enumerate(lens_per_pack):
        o = np.concatenate([[0], np.cumsum(lens)])
        offs[g, :len(o)], offs[g, len(o):] = o, o[-1]
    G = len(lens_per_pack)
    ts = np.cumsum(rng.integers(0, 4000, (G, cap)), axis=1).astype(np.int32)
    q, k, v = (torch.from_numpy(rng.standard_normal((G, cap, H, D))
                                .astype(np.float32)).to(dev, dtype)
               for _ in range(3))
    return q, k, v, torch.from_numpy(offs).to(dev), torch.from_numpy(ts).to(
        dev)


# fp32: same fp32 arithmetic, keys summed in another order (1e-4 max abs
# bounds a few ulps of O(1) outputs). bf16: the weights round to bf16
# before a·v and the output rounds to bf16; a one-ulp flip moves a value by
# at most 2^-7 of itself, and long rows' outputs are small, so bf16 is held
# per (token, head) by the relative L2 error along the head dim.
@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, dtype, D):
    H, cap = 8, 1024
    q, k, v, offs, ts = _pack(cuda, dtype, H, D,
                              [[500, 3, 0, 300, 129], [0, 0, 0]], cap)
    rab = {"pos_table": torch.randn(256, H, device=cuda) * 0.5,
           "time_table": torch.randn(32, H, device=cuda) * 0.5}
    cfg = RABConfig()
    plan = build_attn_plan(offs, ts, cap, block=128, max_row_len=1024)
    before = ops.KERNEL_LAUNCHES["attn_fwd"]
    out = jagged_attention(q, k, v, offs, ts, rab, cfg, plan=plan)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES["attn_fwd"] == before + 1
    plain = jagged_attention_ref(q, k, v, offs, ts, rab, cfg, plan=plan)
    if dtype == torch.float32:
        assert (out.float() - plain.float()).abs().max().item() <= 1e-4
    else:
        assert max_row_rel_err(out, plain) <= 1e-2
    assert torch.count_nonzero(out[1]) == 0              # all-padding pack
    p = ops._as_batched(plan)
    direct = attention_fwd_plain(
        q, k, v, rab["pos_table"], rab["time_table"], p, scale=D ** -0.5,
        tb_denom=ops.time_bucket_denom(cfg.time_bucket_scale), use_pos=True,
        use_time=True)
    torch.testing.assert_close(ops._masked(p.meta_i32, direct), plain)


def test_kernel_time_buckets_match_plain_version(cuda):
    rng = np.random.default_rng(3)
    ts = torch.from_numpy(np.cumsum(rng.integers(0, 5000, 3000))
                          .astype(np.int32)).to(cuda)
    denom = ops.time_bucket_denom(0.301)
    kb = ops.kernel_time_buckets(ts, ts, 0.301, 32)
    pb = time_buckets((ts[:, None] - ts[None, :]).abs(), denom, 32)
    assert torch.equal(kb.long(), pb)


def test_kernel_wrapper_raises_on_what_it_does_not_take(cuda):
    H, D, cap = 4, 128, 256
    q, k, v, offs, ts = _pack(cuda, torch.bfloat16, H, D, [[100, 20]], cap)
    rab = {"pos_table": torch.zeros(256, H, device=cuda),
           "time_table": torch.zeros(32, H, device=cuda)}
    with pytest.raises(ValueError, match="does not match q"):
        jagged_attention(q, k.float(), v, offs, ts, rab, RABConfig())
    with pytest.raises(ValueError, match="block"):
        jagged_attention(q, k, v, offs, ts, rab, RABConfig(), block=64)
    with pytest.raises(ValueError, match="head dim"):
        jagged_attention(q[..., :48], k[..., :48], v[..., :48], offs, ts,
                         rab, RABConfig())


def test_recall_engine_on_card_matches_cpu(cuda):
    """The slice at a reduced size, fp32: the engine on the card (kernel)
    against the same engine on the CPU (plain version); the hit round is
    bit-identical to the cold round and encodes nothing."""
    cfg = reduced(get_arch("hstu-tiny")).replace(vocab_size=2000,
                                                 max_seq_len=300,
                                                 dtype="float32")
    g = torch.Generator().manual_seed(0)
    model_cpu = GRModel(cfg, device="cpu", generator=g)
    master = torch.randn(cfg.vocab_size, cfg.d_model, generator=g) * 0.02
    model_gpu = GRModel(cfg, device=cuda)
    model_gpu.load_state_dict(model_cpu.state_dict())
    kw = dict(num_shards=2, users_per_shard=4, tokens_per_shard=600, k=20,
              retrieval_block=512, max_delay_ms=0.0)
    on_card = RecallEngine(cfg, model_gpu, master.to(cuda), **kw)
    on_cpu = RecallEngine(cfg, model_cpu, master, device="cpu", **kw)
    rng = np.random.default_rng(1)
    reqs = []
    for u in range(12):
        n = int(rng.integers(1, cfg.max_seq_len))
        reqs.append((u, rng.integers(0, cfg.vocab_size, n),
                     np.cumsum(rng.integers(1, 3600, n))))
    before = ops.KERNEL_LAUNCHES["attn_fwd"]
    a, b = on_card.serve(reqs), on_cpu.serve(reqs)
    assert (ops.KERNEL_LAUNCHES["attn_fwd"] - before
            == cfg.num_layers * on_card.encoded_batches)
    for x, y in zip(a, b):
        assert x.rid == y.rid and x.user == y.user
        np.testing.assert_allclose(x.user_emb, y.user_emb, atol=1e-4, rtol=0)
        np.testing.assert_allclose(x.scores, y.scores, atol=1e-4, rtol=0)
    n_enc = on_card.encoded_batches
    hits = on_card.serve([(u, [], []) for u, _, _ in reqs])
    assert on_card.encoded_batches == n_enc
    for x, h in zip(a, hits):
        assert h.cache_hit
        np.testing.assert_array_equal(x.item_ids, h.item_ids)
        np.testing.assert_array_equal(x.user_emb, h.user_emb)
