"""The port's roofline and per-device counts (``launch/roofline.py``,
``launch/op_analysis.py``): the analytic model FLOPs equal the
reference's for every runnable cell (exact: the same integer arithmetic);
the dispatch-mode counts against hand-worked numbers: an MLP's forward and
backward FLOPs at world 1, and one device's FLOPs of a sharded MLP on a
2 × 4 fake mesh (the local shards' products, not the global one), a
gather's bytes (its rows and indices, not the table), and the collective
bytes of a redistribution (its operand, as the reference counts)."""
import os
import subprocess
import sys

import pytest
import torch

import repro.configs as JC
import repro_torch.configs as PC
from repro.configs.shapes import SHAPES_BY_NAME as JS
from repro.launch import roofline as JRL
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import roofline as RL
from repro_torch.launch.dryrun_all import list_cells
from torch_limits import time_limit

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("arch,shape", list_cells()[0])
@time_limit(10)
def test_model_flops_per_step_matches_reference(arch, shape):
    assert RL.model_flops_per_step(PC.get_arch(arch),
                                   PC.SHAPES_BY_NAME[shape]) == \
        JRL.model_flops_per_step(JC.get_arch(arch), JS[shape])


@time_limit(10)
def test_roofline_terms_and_h100_constants():
    assert RL.PEAK_FLOPS == 989.4e12 and RL.HBM_BW == 3.35e12
    assert RL.LINK_BW == 50e9
    cfg, shape = PC.get_arch("glm4-9b"), PC.SHAPES_BY_NAME["train_4k"]
    t = {"flops": 2e15, "bytes": 1e12,
         "coll_bytes": {"all-gather": 3e10, "all-reduce": 2e10}}
    r = RL.analyze(cfg, shape, "pod16x16", 256, t)
    assert r.compute_s == 2e15 / 989.4e12 and r.memory_s == 1e12 / 3.35e12
    assert r.collective_s == 5e10 / 50e9 and r.dominant == "compute"
    mf, tok = RL.model_flops_per_step(cfg, shape)
    assert r.model_flops == mf / 256 and r.step_tokens == tok
    assert r.useful_ratio == (mf / 256) / 2e15
    assert r.roofline_frac == (mf / 256 / 989.4e12) / r.compute_s


@time_limit(20)
def test_mlp_flops_at_world_1():
    """x (64, 32) @ w1 (32, 128) → relu → @ w2 (128, 16), sum, backward:
    forward 2·64·(32·128 + 128·16); backward dW1, dW2 and dh (x needs no
    grad): 2·64·(32·128 + 128·16) + 2·64·128·16."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 32, generator=g)
    w1 = torch.randn(32, 128, generator=g, requires_grad=True)
    w2 = torch.randn(128, 16, generator=g, requires_grad=True)
    with OA.OpAnalysis() as a:
        (torch.relu(x @ w1) @ w2).sum().backward()
    fwd = 2 * 64 * (32 * 128 + 128 * 16)
    assert a.totals.flops == fwd + fwd + 2 * 64 * 128 * 16
    assert sum(a.totals.coll_bytes.values()) == 0


@time_limit(20)
def test_gather_counts_its_rows_not_its_table():
    table = torch.randn(100_000, 64)
    ids = torch.randint(0, 100_000, (10,))
    with OA.OpAnalysis() as a:
        table[ids]
        torch.index_select(table, 0, ids)
    # each: 10 rows of 256 bytes read and written, 80 bytes of int64 ids
    assert a.totals.bytes == 2 * (2 * 10 * 64 * 4 + 10 * 8)
    rows = torch.randn(10, 64)
    with OA.OpAnalysis() as a:
        table.index_add_(0, ids, rows)
    # 10 rows read and written, the values and the ids read
    assert a.totals.bytes == 2 * 10 * 64 * 4 + 10 * 64 * 4 + 10 * 8


MESH_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.launch import mesh as M
from repro_torch.launch.op_analysis import OpAnalysis
from torch.distributed.tensor import distribute_tensor, Shard, Replicate
M.init_fake_world(8)
mesh = M.device_mesh((2, 4), ("data", "model"), device="cpu")
out = {}
x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                      [Shard(0), Replicate()])
w1 = distribute_tensor(torch.empty(32, 128, device="meta"), mesh,
                       [Replicate(), Shard(1)])
w2 = distribute_tensor(torch.empty(128, 16, device="meta"), mesh,
                       [Replicate(), Shard(0)])
with OpAnalysis() as a:
    y = torch.relu(x @ w1) @ w2
out["mlp_flops"] = a.totals.flops
with OpAnalysis() as a:
    x.redistribute(mesh, [Replicate(), Replicate()])
out["gather"] = a.totals.coll_bytes
with OpAnalysis() as a:
    y.redistribute(mesh, [Shard(0), Replicate()])
out["reduce"] = a.totals.coll_bytes
print(json.dumps(out))
"""


@time_limit(90)
def test_per_device_counts_on_a_fake_mesh():
    """On a (data 2, model 4) mesh: x rows over data, w1's columns and w2's
    rows over model. One device multiplies its (32, 32) block of x by its
    (32, 32) block of w1 and the (32, 32) result by its (32, 16) block of
    w2: 2·32·32·32 + 2·32·32·16 FLOPs, not the global product's
    2·64·(32·128 + 128·16). Gathering x whole sends this device's (32, 32)
    fp32 shard, 4096 bytes; the partial y (32, 16) reduced over model
    sends 2048."""
    import json
    r = subprocess.run([sys.executable, "-c", MESH_SCRIPT, SRC],
                       capture_output=True, text=True, timeout=80)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["mlp_flops"] == 2 * 32 * 32 * 32 + 2 * 32 * 32 * 16
    assert out["gather"]["all-gather"] == 32 * 32 * 4
    assert sum(out["gather"].values()) == 32 * 32 * 4
    assert out["reduce"]["all-reduce"] + out["reduce"][
        "reduce-scatter"] == 32 * 16 * 4
