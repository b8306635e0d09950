"""The work arithmetic against brute-force counts at tiny sizes."""
import itertools

import numpy as np

from perfbench.work import flops


def brute_pairs(lengths):
    return sum(1 for n in lengths for q, k in itertools.product(range(n),
                                                                 repeat=2)
               if k <= q)


def test_causal_pairs():
    for lens in ([1], [3, 5], [7, 1, 12], []):
        assert flops.causal_pairs(lens) == brute_pairs(lens)


def test_append_pairs():
    pref, total = [3, 0, 5], [5, 2, 6]
    brute = sum(1 for p, T in zip(pref, total) for q in range(p, T)
                for k in range(T) if k <= q)
    assert flops.append_pairs(pref, total) == brute


def test_attention_work_counts_real_tokens():
    lens, H, D = [3, 4], 2, 8
    ops, byts, mufu = flops.attn_fwd_work(lens, H, D, 2, "bucket")
    pairs = brute_pairs(lens)
    assert ops == 4 * D * H * pairs
    assert byts == 4 * 7 * H * D * 2 + (256 + 32) * H * 4
    assert mufu == pairs * (2 * H + 1)
    ops_b, byts_b, _ = flops.attn_bwd_work(lens, H, D, 2, "functional")
    assert ops_b == 10 * D * H * pairs
    assert byts_b == 7 * 7 * H * D * 2 + 2 * (256 + 3) * H * 4


def test_negative_bytes_count_each_row_once():
    T, R, d = 5, 4, 16
    ids = np.array([[0, 1, 1, 2]] * T)
    uniq = len(np.unique(ids))
    ops, byts = flops.neg_work(T, R, d, uniq)
    assert ops == 6 * T * R * d
    rows = 2 * uniq * d * 2
    assert byts - rows == (2 * (T * d * 2 + T * R * 4) + 7 * T * 4
                           + T * R * 4 + T * d * 4 + T * 4)


def test_train_flops_terms():
    cfg = {"d_model": 16, "num_heads": 2, "head_dim": 8, "qkv_dim": 8,
           "num_layers": 3, "gr_block": "hstu", "num_negatives": 4}
    lens = [2, 3]
    dense = 3 * (16 * 2 * 4 * 8 + 2 * 8 * 16)
    assert flops.dense_params(cfg) == dense
    want = (6 * dense * 5 + 12 * 8 * 2 * 3 * brute_pairs(lens)
            + 6 * 5 * 5 * 16)
    assert flops.train_step_flops(cfg, lens) == want


def test_bound_names_its_term():
    t, by = flops.bound(1e12, 1e6, "bfloat16")
    assert by == "operations" and np.isclose(t, 1e12 / 989.4e12)
    t, by = flops.bound(1.0, 3.35e12, "float16")
    assert by == "bytes" and np.isclose(t, 1.0)
