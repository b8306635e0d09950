"""Tiny configurations and mixes of the cells' kinds, for the CPU tests:
the widths cut so that the program's plain versions and the reference run
in seconds; the structure of each cell kept."""
from __future__ import annotations

import copy
from typing import Dict

from perfbench import common
from perfbench.traffic import gen


def config(name: str) -> Dict:
    c = copy.deepcopy(common.config(name))
    c.update(num_layers=2, d_model=64, num_heads=2, head_dim=32, qkv_dim=32,
             vocab_size=4096, max_seq_len=64, num_negatives=8)
    if c["gr_block"] == "fuxi":
        c["d_ff"] = 128
    return c


def mix(name: str) -> Dict:
    m = copy.deepcopy(gen.load_mix(name))
    if m["kind"] == "train":
        m.update(users_per_pack=4, max_seq_len=64)
    else:
        m.update(slots=8, rows_per_tick=4, k=10, max_seq_len=64,
                 resident_users=4, warm_q_caps=[1, 2, 4], rate_per_s=20.0,
                 checked_requests=6)
    return m
