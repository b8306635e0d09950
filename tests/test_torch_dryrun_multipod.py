"""The port's dry-run on a three-axis (pod, data, model) mesh: the LM
cells of the multi-pod production mesh, cut to a (pod 2, data 2, model 2)
fake world of eight ranks.

For a ``reduced`` config of each LM family (dense GQA, MoE, Mamba-2, the
hybrid) and each step kind, ``run_cell`` on (2, 2, 2) must finish, and its
record must count what the plan puts on one device:

- ``state_bytes_per_device`` equals the bytes of DTensor's own local
  shards of the same specs;
- ``totals.flops`` equals the same cell's on (data 4, model 2): the same
  four-way data parallelism, the same tensor parallelism, so every device
  runs the same local ops;
- in the train cases, ``state_bytes_per_device`` equals the same cell's on
  (data 2, model 2): the plans shard parameters and moments over ``data``
  and ``model`` and replicate them over ``pod`` (FSDP over ``data`` alone),
  so a layout that split them over ``pod`` as well fails here.

Each case runs in a subprocess of its own (the fake process group would
outlive the test in the worker)."""
import json
import os
import subprocess
import sys

import pytest

from torch_limits import time_limit

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import dryrun as DR, mesh as M
arch, kind = sys.argv[2], sys.argv[3]
M.init_fake_world(8)
cfg = reduced(get_arch(arch))
shape = ShapeConfig("t", 128, 8, kind)
kw = dict(cfg=cfg, shape=shape)


def mesh(dims, axes):
    return M.device_mesh(dims, axes, device="cpu")


pod = mesh((2, 2, 2), ("pod", "data", "model"))
rec = DR.run_cell(arch, "t", mesh=pod, mesh_name="fake2x2x2", **kw)
local = DR.local_state_bytes(DR.build_cell(arch, "t", mesh=pod, **kw))
flat = DR.run_cell(arch, "t", mesh=mesh((4, 2), ("data", "model")),
                   mesh_name="fake4x2", **kw)
m22 = mesh((2, 2), ("data", "model"))
state22 = DR._sharded_bytes(DR.build_cell(arch, "t", mesh=m22, **kw).state,
                            m22)
print(json.dumps({"rec": rec, "local": local,
                  "flops_4x2": flat["totals"]["flops"],
                  "state_2x2": state22}, default=str))
"""

FAMILIES = ["glm4-9b", "olmoe-1b-7b", "mamba2-2.7b", "jamba-1.5-large-398b"]
KINDS = ["train", "prefill", "decode"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
@time_limit(150)
def test_lm_cell_on_a_three_axis_mesh(arch, kind):
    r = subprocess.run([sys.executable, "-c", SCRIPT, SRC, arch, kind],
                       capture_output=True, text=True, timeout=140)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    out = json.loads(r.stdout.strip().splitlines()[-1])
    rec = out["rec"]
    assert rec["ok"] and rec["chips"] == 8
    assert rec["state_bytes_per_device"] == out["local"] > 0
    assert rec["totals"]["flops"] == out["flops_4x2"] > 0
    if kind == "train":
        assert rec["state_bytes_per_device"] == out["state_2x2"]
        assert rec["totals"]["coll_bytes"]["all-gather"] > 0
