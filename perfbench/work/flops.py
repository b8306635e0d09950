"""The work a batch needs, as operations and bytes, and the card's least
time for it: the yardstick of every roofline share and of the MFU.

A frozen copy of the per-pair and per-row arithmetic of the program's
cost model (``repro_torch/kernels/cost.py``), changed to count what the
inputs need rather than how a kernel tiles them: attention counts the
causal (query, key) pairs the lengths give, not live blocks × 128²; its
bytes count q, k, v, dy and the outputs over the real tokens and the
relative-bias tables, not a plan; the negative loss counts each distinct
row it reads once. The bound is the largest of the operations at the
dtype's peak, the bytes at the memory rate, and the special functions at
the SFU rate; ``bound`` says which binds.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

#: NVIDIA H100 SXM5 data sheet, dense (no sparsity): 989.4 TFLOP/s in
#: bf16 and fp16 on the tensor cores, 67 TFLOP/s in fp32 on the CUDA cores;
#: HBM3 at 3.35 TB/s. Figures at the full 700 W power limit.
PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
#: Special-function instructions per clock: 16 per SM on 132 SMs.
SFU_PER_CLOCK = 16 * 132
#: The H100 SXM5's largest SM clock, used when the card does not say.
SM_CLOCK_HZ = 1.98e9
#: Special functions per score entry and head, and per (query, key) pair
#: once for all heads (cost.py's MUFU_PER_ENTRY_HEAD / MUFU_PER_PAIR).
MUFU_PER_ENTRY_HEAD = {"bucket": 2, "functional": 4}
MUFU_PER_PAIR = {"bucket": 1, "functional": 0}


def causal_pairs(lengths: Sequence[int]) -> int:
    """(query, key) pairs of causal attention over rows of these lengths."""
    return sum(n * (n + 1) // 2 for n in lengths)


def append_pairs(prefix: Sequence[int], total: Sequence[int]) -> int:
    """Pairs of the window's queries [p, T) of each row against its keys."""
    return sum((T * (T + 1) - p * (p + 1)) // 2 for p, T in zip(prefix, total))


def dense_params(cfg: Dict) -> int:
    """Dense parameters of an HSTU or FuXi stack: f1 (d → 4·H·dqk), f2
    (H·dqk → d) and, in FuXi, the gated FFN (3·d·d_ff), per layer."""
    d, H, L = cfg["d_model"], cfg["num_heads"], cfg["num_layers"]
    dqk = cfg.get("qkv_dim") or cfg["head_dim"]
    per = d * H * 4 * dqk + H * dqk * d
    if cfg["gr_block"] == "fuxi":
        per += 3 * d * cfg["d_ff"]
    return L * per


def train_step_flops(cfg: Dict, lengths: Sequence[int]) -> float:
    """Model FLOPs of one training step over rows of these lengths (real
    tokens only, recompute not counted): 6 × dense params × tokens;
    attention's QKᵀ and AV forward (4·D per pair and head) and their four
    backward products (8·D); the positive and R negative logits of each
    token forward (2·d each) and backward (4·d each)."""
    T = sum(lengths)
    H, L = cfg["num_heads"], cfg["num_layers"]
    D = cfg.get("qkv_dim") or cfg["head_dim"]
    R = cfg["num_negatives"]
    attn = 12 * D * H * L * causal_pairs(lengths)
    neg = 6 * T * (1 + R) * cfg["d_model"]
    return 6.0 * dense_params(cfg) * T + attn + neg


def bound(ops: float, byts: float, dtype: str, special: float = 0.0,
          sm_clock_hz: float = SM_CLOCK_HZ) -> Tuple[float, str]:
    """(the least seconds, the term that binds)."""
    t = {"operations": ops / PEAK_FLOPS[dtype], "bytes": byts / PEAK_BYTES}
    if special:
        t["special functions"] = special / (SFU_PER_CLOCK * sm_clock_hz)
    by = max(t, key=t.get)
    return t[by], by


def _mufu(pairs: int, H: int, mode: str) -> int:
    return pairs * (H * MUFU_PER_ENTRY_HEAD[mode] + MUFU_PER_PAIR[mode])


def attn_fwd_work(lengths: Sequence[int], H: int, D: int, itemsize: int,
                  mode: str, npb: int = 256, ntb: int = 32
                  ) -> Tuple[float, float, float]:
    """(operations, bytes, special functions) of the attention forward:
    4·D per pair and head; q, k, v read and out written over the real
    tokens, the two bias tables read."""
    pairs = causal_pairs(lengths)
    T = sum(lengths)
    ntb = 3 if mode == "functional" else ntb
    return (4 * D * H * pairs, 4 * T * H * D * itemsize + (npb + ntb) * H * 4,
            _mufu(pairs, H, mode))


def attn_bwd_work(lengths: Sequence[int], H: int, D: int, itemsize: int,
                  mode: str, npb: int = 256, ntb: int = 32
                  ) -> Tuple[float, float, float]:
    """The backward: S (a backward that keeps no (n, n) matrix needs it),
    dP, dV, dK, dQ, 2·D each per pair and head; q, k, v, dy read and dq,
    dk, dv written; the tables read and their grads written."""
    pairs = causal_pairs(lengths)
    T = sum(lengths)
    ntb = 3 if mode == "functional" else ntb
    return (10 * D * H * pairs,
            7 * T * H * D * itemsize + 2 * (npb + ntb) * H * 4,
            _mufu(pairs, H, mode))


def append_work(prefix: Sequence[int], total: Sequence[int], H: int, D: int,
                itemsize: int, mode: str = "bucket"
                ) -> Tuple[float, float, float]:
    """The serving append: the window's queries against each row's keys;
    the window's q read and out written, each row's K and V read over its
    live keys, the tables."""
    pairs = append_pairs(prefix, total)
    q = sum(T - p for p, T in zip(prefix, total))
    return (4 * D * H * pairs,
            2 * q * H * D * itemsize + 2 * sum(total) * H * D * itemsize
            + (256 + 32) * H * 4, _mufu(pairs, H, mode))


def neg_work(T: int, R: int, d: int, unique_rows: int
             ) -> Tuple[float, float]:
    """The fused negative loss forward + backward over T real tokens
    (operations, bytes): the logits' dot (2·d a row) forward, the dot
    again and dout's product (4·d) backward; each distinct row read once
    each way at fp16, o (bf16) and the ids each way, pos, valid, lse and
    g, the weights w (T, R) fp32 and dout (T, d) fp32 written."""
    ops = 6 * T * R * d
    small = T * d * 2 + T * R * 4
    byts = (2 * (unique_rows * d * 2 + small) + 3 * T * 4 + 4 * T * 4
            + T * R * 4 + T * d * 4 + T * 4)
    return ops, byts


def retrieval_work(B: int, V: int, d: int, k: int) -> Tuple[float, float]:
    """One rank batch: B queries against V fp16 rows, the top k of each:
    2·d per (query, row); the table read once, the queries, the results."""
    return 2 * B * V * d, V * d * 2 + B * d * 2 + B * k * 8
