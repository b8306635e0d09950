"""Weights and tables made by the benchmark from the seed, on the device.

The program and the plain reference get the same numbers from here: the
program as a state dict loaded into its model and an fp32 master it trains
in place, the reference as its own fp32 copies. The distributions are the
GR models' usual ones (unit norms, fan-in-scaled projections, 0.02-scaled
tables); the draws are the benchmark's, in a few large calls.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

#: Rows of the table drawn per call; block k of the table is drawn from a
#: generator seeded by the run's seed and k, so any block can be drawn
#: again alone (the check of a table's change after training).
TABLE_BLOCK_ROWS = 1 << 18

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def _seed(seed: int, *key: int) -> int:
    h = int(seed) % (1 << 61)
    for k in key:
        h = (h * 1_000_003 + int(k) + 1) % (1 << 61)
    return h


def dense_spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, object]]:
    """(name, shape, kind, arg) of every dense leaf, named as the model's
    state dict names them. kind: "normal" (arg: the std), "ones", "zeros",
    "fill" (arg: the value), "linspace" (arg: (lo, hi)); weights in the
    model's dtype, the relative-bias leaves in fp32."""
    d, H, L = cfg["d_model"], cfg["num_heads"], cfg["num_layers"]
    dqk = cfg.get("qkv_dim") or cfg["head_dim"]
    dv = dqk
    rab = cfg["rab"]
    out = []
    for l in range(L):
        p = f"blocks.{l}."
        out += [(p + "ln_w", (d,), "ones", None),
                (p + "ln_b", (d,), "zeros", None),
                (p + "w_uvqk", (d, H * (2 * dv + 2 * dqk)), "normal",
                 1 / math.sqrt(d)),
                (p + "w_o", (H * dv, d), "normal",
                 1 / math.sqrt(H * dv * 2 * L)),
                (p + "rab.pos_table", (rab["num_pos_buckets"], H), "normal",
                 0.02)]
        if cfg["gr_block"] == "fuxi":
            dff = cfg["d_ff"]
            out += [(p + "rab.time_amp", (H,), "fill", 0.02),
                    (p + "rab.time_log_sigma", (H,), "linspace", (2.0, 12.0)),
                    (p + "rab.time_rho", (H,), "fill", 0.0),
                    (p + "ffn_ln_w", (d,), "ones", None),
                    (p + "ffn_ln_b", (d,), "zeros", None),
                    (p + "ffn_w_in", (d, dff), "normal", 1 / math.sqrt(d)),
                    (p + "ffn_w_gate", (d, dff), "normal", 1 / math.sqrt(d)),
                    (p + "ffn_w_out", (dff, d), "normal",
                     1 / math.sqrt(dff * 2 * L))]
        else:
            out.append((p + "rab.time_table", (rab["num_time_buckets"], H),
                        "normal", 0.02))
    out += [("out_ln_w", (d,), "ones", None), ("out_ln_b", (d,), "zeros",
                                               None)]
    return out


def leaf_dtype(name: str, cfg: Dict) -> torch.dtype:
    return torch.float32 if ".rab." in name else DTYPES[cfg["dtype"]]


def make_dense(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every dense leaf from one draw of N(0, 1) on ``device``."""
    spec = dense_spec(cfg)
    n = sum(math.prod(s) for _, s, k, _ in spec if k == "normal")
    g = torch.Generator(device=device).manual_seed(_seed(seed, 1))
    flat = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind, arg in spec:
        dt = leaf_dtype(name, cfg)
        if kind == "normal":
            m = math.prod(shape)
            t = (flat[at:at + m].view(shape) * arg).to(dt)
            at += m
        elif kind == "ones":
            t = torch.ones(shape, dtype=dt, device=device)
        elif kind == "zeros":
            t = torch.zeros(shape, dtype=dt, device=device)
        elif kind == "fill":
            t = torch.full(shape, float(arg), dtype=dt, device=device)
        else:
            t = torch.linspace(arg[0], arg[1], shape[0], dtype=dt,
                               device=device)
        out[name] = t
    return out


def table_block(cfg: Dict, seed: int, k: int, device) -> torch.Tensor:
    """Rows [k·B, (k+1)·B) of the fp32 master (B = TABLE_BLOCK_ROWS)."""
    V, d = cfg["vocab_size"], cfg["d_model"]
    lo, hi = k * TABLE_BLOCK_ROWS, min((k + 1) * TABLE_BLOCK_ROWS, V)
    g = torch.Generator(device=device).manual_seed(_seed(seed, 2, k))
    blk = torch.randn(hi - lo, d, generator=g, device=device,
                      dtype=torch.float32)
    return blk.mul_(cfg["table"]["init_std"])


def num_blocks(cfg: Dict) -> int:
    return -(-cfg["vocab_size"] // TABLE_BLOCK_ROWS)


def make_table(cfg: Dict, seed: int, device) -> torch.Tensor:
    """The (V, d) fp32 master, block by block."""
    V, d = cfg["vocab_size"], cfg["d_model"]
    out = torch.empty((V, d), dtype=torch.float32, device=device)
    for k in range(num_blocks(cfg)):
        lo = k * TABLE_BLOCK_ROWS
        blk = table_block(cfg, seed, k, device)
        out[lo:lo + blk.shape[0]] = blk
        del blk
    return out


def table_change_norm(cfg: Dict, seed: int, master: torch.Tensor) -> float:
    """||master − the initial master||, the initial blocks drawn again."""
    total = torch.zeros((), dtype=torch.float64, device=master.device)
    for k in range(num_blocks(cfg)):
        lo = k * TABLE_BLOCK_ROWS
        blk = table_block(cfg, seed, k, master.device)
        blk.sub_(master[lo:lo + blk.shape[0]])
        total += torch.linalg.vector_norm(blk).double() ** 2
        del blk
    return float(total.sqrt())
