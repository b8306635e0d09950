"""The port's dry-run (``launch/dryrun.py``) and the kernels' shape-only
path it stands on.

- Each kernel wrapper on ``meta`` tensors (K1-fwd, K2, K3, K4, K5, K6, K9
  and K1-fwd's append launch) gives its outputs' shapes and dtypes and
  records its cost, with its plain version and its launch patched to
  raise: no path gives way to another.
- ``run_cell`` on a 2 × 2 fake mesh for a ``reduced`` LM train cell and a
  ``hstu-tiny`` GR cell: the record's ``state_bytes_per_device`` equals the
  bytes of DTensor's own local shards of the same specs, its counts come
  with their worst-case notes, the τ=1 carry's spec is sharded.
- ``build_serve_cell`` on a 2 × 4 fake mesh, as the reference's
  ``test_serving_stream.py`` holds its own: the layout is real.
- ``reanalyze`` re-derives a record's totals and roofline from its saved
  per-op records, to the bit.
- ``kernels/cost.py`` at the shapes ``chip_smoke.py`` printed (PERF.md §6):
  K3 2.17 GB, K4 2.21 GB, K9 2.17 / 4.35 GB and 33.9 MB a segment.
- ``gr_capacity`` and ``max_token_diff`` against the reference's.

The fake process group lives in a subprocess per test (it would outlive
the test in the worker)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import cost as KC
from torch_limits import time_limit

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
META = torch.device("meta")


def _run(script, *args, timeout=200):
    r = subprocess.run([sys.executable, "-c", script, SRC, *map(str, args)],
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


# --------------------------------------------------------------------------
# the kernels on meta: no fallback
# --------------------------------------------------------------------------

def _refuse(*a, **k):
    raise AssertionError("a meta call reached a plain version or a launch")


@pytest.fixture
def no_fallback(monkeypatch):
    from repro_torch.kernels.jagged_attention import ops as AO
    from repro_torch.kernels.jagged_attention import ref as AR
    from repro_torch.kernels.jagged_lookup import ops as LO
    from repro_torch.kernels.jagged_lookup import ref as LR
    from repro_torch.kernels.neg_logits import ops as NO
    from repro_torch.kernels.neg_logits import ref as NR
    for mod, names in ((AR, ("attention_fwd_plain", "attention_bwd_plain",
                             "attention_append_plain")),
                       (AO, ("_launch_fwd", "_launch_bwd",
                             "_launch_append")),
                       (NR, ("neg_fwd_plain", "neg_bwd_plain",
                             "neg_logits_fwd_plain",
                             "neg_logits_bwd_plain")),
                       (NO, ("_lib", "_nl_lib", "_check", "_check_nl")),
                       (LR, ("run_totals_plain",
                             "weighted_run_totals_plain")),
                       (LO, ("_launch_runsum", "_launch_wscatter"))):
        for n in names:
            monkeypatch.setattr(mod, n, _refuse)


def _collect():
    recs = []
    return recs, KC.collecting(lambda k, c, **kw: recs.append((k, c, kw)))


@time_limit(60)
def test_attention_meta_path_k1_k2(no_fallback):
    from repro_torch.configs import RABConfig
    from repro_torch.kernels.jagged_attention import make_attn_fn
    G, cap, H, D = 2, 256, 4, 32
    rab = RABConfig(num_pos_buckets=256, num_time_buckets=32)
    q, k, v = (torch.empty(G, cap, H, D, device=META, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    params = {"pos_table": torch.empty(257, H, device=META,
                                       requires_grad=True),
              "time_table": torch.empty(33, H, device=META,
                                        requires_grad=True)}
    offs = torch.empty(G, 5, dtype=torch.int32, device=META)
    ts = torch.empty(G, cap, dtype=torch.int32, device=META)
    fn = make_attn_fn(max_row_len=128)
    recs, ctx = _collect()
    with ctx:
        out = fn(q, k, v, offs, ts, params, rab)
        out.float().sum().backward()
    assert out.shape == (G, cap, H, D) and out.dtype == torch.bfloat16
    assert q.grad.shape == q.shape and params["time_table"].grad.shape == (
        33, H)
    assert [r[0] for r in recs] == ["attn_fwd", "attn_bwd"]
    plan = fn.make_plan(offs, ts, cap)
    padded = int(plan.q_wl.shape[:-1].numel())
    for kernel, c, kw in recs:
        assert kw["worst_case"] and kw["live_pairs"] == padded == G * \
            plan.num_pairs
    assert recs[0][1] == KC.attn_fwd_cost(plan, G, cap, H, D, 2, "bucket",
                                          padded, ntb=33, npb=257)
    assert recs[1][1] == KC.attn_bwd_cost(plan, G, cap, H, D, 2, "bucket",
                                          padded, ntb=33, npb=257)


@time_limit(60)
def test_negative_meta_paths_k3_k4_k9(no_fallback):
    from repro_torch.kernels.neg_logits import (TableGradSink,
                                                fused_recall_lse, neg_logits)
    T, R, D, V = 256, 8, 64, 1000
    o = torch.empty(T, D, device=META, dtype=torch.bfloat16,
                    requires_grad=True)
    pos = torch.empty(T, device=META, requires_grad=True)
    table = torch.empty(V, D, device=META)
    sink = TableGradSink()
    shadow = torch.empty(V, D, device=META, dtype=torch.float16)
    ids = torch.empty(T, R, dtype=torch.int64, device=META)
    recs, ctx = _collect()
    with ctx:
        lse = fused_recall_lse(o, pos, table, ids, gather_table=shadow,
                               scatter_impl="two_pass",
                               table_grad_pairs=sink)
        lse.sum().backward()
        n = torch.empty(T, R, D, device=META, dtype=torch.float16,
                        requires_grad=True)
        lg = neg_logits(o.detach().requires_grad_(), n)
        lg.sum().backward()
    assert lse.shape == (T,) and lg.shape == (T, R)
    assert sink.rows.shape == (T * R, D) and sink.ids.shape == (T * R,)
    assert o.grad.shape == (T, D) and n.grad.dtype == torch.float16
    assert [r[0] for r in recs] == ["neg_fwd", "neg_bwd", "neg_logits_fwd",
                                    "neg_logits_bwd"]
    assert all(kw["worst_case"] for _, _, kw in recs)
    assert recs[0][1] == KC.neg_fwd_cost(T, R, D, (T // 128) * 1 * 128)
    assert recs[2][1] == KC.neg_logits_cost(T, R, D, 2, False)
    assert recs[3][1] == KC.neg_logits_cost(T, R, D, 2, True)


@time_limit(60)
def test_run_sum_meta_paths_k5_k6_worst_case(no_fallback):
    from repro_torch.kernels.jagged_lookup.ops import (run_totals,
                                                       sort_pairs,
                                                       weighted_run_totals)
    n, D, T, R = 600, 64, 32, 16
    ids = torch.empty(n, dtype=torch.int32, device=META)
    order, sids = sort_pairs(ids)
    recs, ctx = _collect()
    with ctx:
        u, rows = run_totals(torch.empty(n, D, device=META), order, sids)
        u2, rows2 = weighted_run_totals(
            torch.empty(T, D, device=META, dtype=torch.bfloat16),
            torch.empty(T, R, device=META), torch.empty(n - T * R, D,
                                                        device=META),
            order, sids, scale=1.0)
    # every id distinct: one run, one pair, per slot
    assert u.shape == (n,) and rows.shape == (n, D)
    assert u2.shape == (n,) and rows2.shape == (n, D)
    assert recs[0][1] == KC.runsum_cost(n, n, D)
    assert recs[1][1] == KC.wscatter_cost(T, T * R, n, n, D)
    assert all(kw["worst_case"] for _, _, kw in recs)


@time_limit(60)
def test_meta_gr_step_records_every_kernel(no_fallback):
    """A whole GR train step on meta, the fused and segmented paths: every
    kernel of the path records, nothing runs."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.jagged_attention import make_attn_fn
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import gr_train_state, make_gr_step_fn
    cfg = reduced(get_arch("hstu-tiny"))
    b = GRBundle(cfg)
    st = gr_train_state(b.init_dense(device="meta"),
                        torch.empty(cfg.vocab_size, cfg.d_model,
                                    device=META))
    batch = {k: torch.empty(s, dtype=torch.int32, device=META) for k, s in
             (("ids", (2, 256)), ("labels", (2, 256)),
              ("timestamps", (2, 256)), ("offsets", (2, 5)),
              ("neg_ids", (2, 256, 8)))}
    batch["rng"] = torch.empty(2, dtype=torch.int64, device=META)
    want = {"fused": {"attn_fwd", "attn_bwd", "neg_fwd", "neg_bwd",
                      "wscatter"},
            "segmented": {"attn_fwd", "attn_bwd", "neg_logits_fwd",
                          "neg_logits_bwd", "runsum"}}
    for mode, kernels in want.items():
        step = make_gr_step_fn(b, loss_kwargs=dict(
            neg_mode=mode, attn_fn=make_attn_fn(max_row_len=128)))
        recs, ctx = _collect()
        with ctx:
            step(st, batch)
        assert {r[0] for r in recs} == kernels, mode


# --------------------------------------------------------------------------
# cells on a fake mesh
# --------------------------------------------------------------------------

CELL_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import dryrun as DR, mesh as M, partition as PT
from repro_torch.launch import reanalyze as RA
from torch.distributed.tensor import distribute_tensor
M.init_fake_world(4)
mesh = M.device_mesh((2, 2), ("data", "model"), device="cpu")
arch, ops_dir = sys.argv[2], sys.argv[3]
cfg = reduced(get_arch(arch))
gr = cfg.gr
shape = (ShapeConfig("gr_t", 256, 8, "train") if gr
         else ShapeConfig("t", 128, 8, "train"))
kw = dict(mesh=mesh, cfg=cfg, shape=shape)
rec = DR.run_cell(arch, shape.name, ops_dir=ops_dir, mesh_name="fake2x2",
                  **kw)
cell = DR.build_cell(arch, shape.name, **kw)
local = sum(distribute_tensor(torch.empty(s, dtype=dt, device="meta"), mesh,
                              PT.to_placements(mesh, sp)).to_local().numel()
            * torch.empty((), dtype=dt).element_size()
            for _, s, dt, sp in cell.state)
again = RA.reanalyze_record(rec, ops_dir, cfg=cfg, shape=shape)
print(json.dumps({"rec": rec, "local": local,
                  "again": {k: again[k] for k in ("totals", "roofline")}},
                 default=str))
"""


@pytest.mark.parametrize("arch", ["starcoder2-3b", "olmoe-1b-7b",
                                  "hstu-tiny"])
@time_limit(240)
def test_run_cell_on_a_fake_mesh(arch, tmp_path):
    out = _run(CELL_SCRIPT, arch, str(tmp_path), timeout=230)
    rec = out["rec"]
    assert rec["ok"] and rec["chips"] == 4
    assert rec["state_bytes_per_device"] == out["local"] > 0
    assert rec["roofline"]["hlo_flops"] == rec["totals"]["flops"] > 0
    assert rec["roofline"]["model_flops"] > 0
    # reanalyze reproduces the record from its saved op records
    assert out["again"]["totals"] == rec["totals"]
    assert out["again"]["roofline"] == rec["roofline"]
    if arch == "hstu-tiny":
        assert "data" in rec["pend_spec"]
        assert set(rec["kernels"]) == {"attn_fwd", "attn_bwd",
                                       "neg_logits_fwd", "neg_logits_bwd",
                                       "runsum"}
        assert all(k["worst_case"] for k in rec["kernels"].values())
        assert len(rec["worst_case"]) == 4
        kinds = {c[1] for c in rec["collectives_from_shapes"]}
        assert kinds == {"all-to-all", "all-gather", "all-reduce"}
    else:
        assert rec["num_microbatches"] >= 1 and not rec["kernels"]
        # the plan's sharding shows as collectives
        assert rec["totals"]["coll_bytes"]["all-gather"] > 0


SERVE_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import mesh as M
from repro_torch.launch.dryrun import build_serve_cell
M.init_fake_world(8)
mesh = M.device_mesh((2, 4), ("data", "model"), device="cpu")
rec = build_serve_cell("hstu-tiny", max_users=15, rows_per_tick=4,
                       append_window=4, mesh=mesh)
print(json.dumps(rec))
"""


@time_limit(120)
def test_gr_serve_specs_on_8_device_mesh():
    out = _run(SERVE_SCRIPT, timeout=110)
    assert out["ok"]
    # the layout is real, not a replicated fallback
    assert "data" in out["specs"]["tokens"]
    assert "model" in out["specs"]["kv_k"]
    assert "model" in out["specs"]["scan_table"]
    assert out["local_slot_rows"] == 8                 # 16 slots over data
    assert out["cold"]["kernels"] == ["attn_fwd"]
    assert out["warm"]["kernels"] == ["attn_fwd_append"]
    assert all(out[p]["argument_bytes"] > 0 for p in ("cold", "warm",
                                                      "rank"))


# --------------------------------------------------------------------------
# the cost model at chip_smoke.py's shapes; the two helpers
# --------------------------------------------------------------------------

@time_limit(30)
def test_cost_model_pinned_to_the_card_runs_shapes():
    """T 8192, R 128, D 1024, bf16 o, fp16 rows, 64 segments' perms at
    expansion 1 (64 × 1 × 128): PERF.md §6's 2.17 GB (K3, bound 0.647 ms),
    2.21 GB (K4, 0.659 ms); K9 2.17 / 4.35 GB (bound 1.298 ms backward),
    33.9 MB a 128-token segment (0.0101 ms)."""
    peak = 989.4e12
    k3 = KC.neg_fwd_cost(8192, 128, 1024, 64 * 128)
    k4 = KC.neg_bwd_cost(8192, 128, 1024, 64 * 128)
    assert (k3.bytes, k4.bytes) == (2168586240, 2206400512)
    assert round(KC.bound_ms(k3, peak)[0], 3) == 0.647
    assert round(KC.bound_ms(k4, peak)[0], 3) == 0.659
    assert KC.bound_ms(k3, peak)[1] == "bytes"
    f, b = (KC.neg_logits_cost(8192, 128, 1024, 2, bwd) for bwd in (0, 1))
    assert (f.bytes, b.bytes) == (2168455168, 4349493248)
    assert round(KC.bound_ms(b, peak)[0], 3) == 1.298
    seg = KC.neg_logits_cost(128, 128, 1024, 2, False)
    assert seg.bytes == 33882112 and round(KC.bound_ms(seg, peak)[0],
                                           4) == 0.0101
    # the runsums and the gather by their formulas, worked by hand
    assert KC.runsum_cost(10, 4, 8) == (80, 10 * 32 + 4 * 32 + 80 + 40 + 20,
                                        0)
    assert KC.wscatter_cost(2, 6, 10, 4, 8) == (
        3 * 6 * 8 + 4 * 8, 2 * 8 * 2 + 24 + 4 * 32 + 80 + 40 + 20 + 4 * 32,
        0)
    assert KC.gather_cost(10, 7, 8) == (0, 7 * 32 + 10 * 16 + 40, 0)
    # the special functions bind when the clock is slow enough
    t, by, parts = KC.bound_ms((1, 1, 10 ** 9), peak, 1e6)
    assert by == "special functions" and set(parts) == {
        "operations", "bytes", "special functions"}


@time_limit(30)
def test_append_and_attention_costs_by_hand():
    pairs, live = KC.append_live_pairs([0, 2], [3, 4])
    assert (pairs, live) == (6 + 7, 5)
    c = KC.attn_append_cost(8, [0, 2], [3, 4], 2, 16, 2)
    assert c.operations == 4 * 16 * 2 * 13
    assert c.special == 13 * (2 * 2 + 1)


@pytest.mark.parametrize("shape", ["gr_train_2k", "gr_train_4k", "train_4k"])
@pytest.mark.parametrize("shards", [1, 8, 256, 512, 4096])
@time_limit(30)
def test_gr_capacity_matches_reference(shape, shards):
    from repro.configs.shapes import SHAPES_BY_NAME as JS
    from repro.models.model_zoo import gr_capacity as j_cap
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.models.model_zoo import gr_capacity
    assert gr_capacity(SHAPES_BY_NAME[shape], shards) == j_cap(JS[shape],
                                                               shards)


@pytest.mark.parametrize("seed", range(4))
@time_limit(30)
def test_max_token_diff_matches_reference(seed):
    from repro.core import load_balance as J
    from repro_torch.core import load_balance as P
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 2048, 200)
    for a in (P.global_token_reallocation(lengths, 8),
              P.token_aware_batches(lengths, 8, int(lengths.sum()) // 8),
              P.fixed_batches(lengths, 8, 25)):
        want = J.max_token_diff(a, lengths)
        assert P.max_token_diff(a, lengths) == want
        loads = P.assignment_token_loads(a, lengths)
        assert P.max_token_diff(a, lengths, loads=loads) == want


@time_limit(30)
def test_report_prints_every_table(tmp_path, capsys):
    from repro_torch.launch import report
    ok = {"arch": "glm4-9b", "shape": "train_4k", "mesh": "pod16x16",
          "chips": 256, "ok": True, "t_build_s": 0.5, "t_step_s": 1.0,
          "state_bytes_per_device": 2.5e9,
          "roofline": {"hlo_flops": 1e12, "coll_bytes": 1e9,
                       "compute_s": 0.1, "memory_s": 0.3,
                       "collective_s": 0.2, "dominant": "memory",
                       "useful_ratio": 0.5, "roofline_frac": 0.3}}
    bad = {"arch": "glm4-9b", "shape": "train_4k", "mesh": "pod2x16x16",
           "ok": False, "error": "dry-run timeout (1500 s)"}
    for i, r in enumerate((ok, bad)):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    for head in ("Single-pod mesh", "Multi-pod mesh", "Skipped cells",
                 "Roofline", "State GB per device", "Build + step"):
        assert head in out, head
    assert "| glm4-9b | 2.50 m / FAIL |" in out
    assert "| glm4-9b | 1.5 / FAIL |" in out
    assert "FAIL: dry-run timeout" in out


@time_limit(90)
def test_sweep_timeout_record_keeps_the_stack(tmp_path):
    """A cell past the sweep's timeout leaves a failure record whose
    traceback is the stack it printed just before (``--stack-at``)."""
    from repro_torch.launch import dryrun_all as DA
    os.makedirs(tmp_path / "logs")
    # jamba's train cell runs ~15 min of meta step: it is mid-step at 38 s
    # whatever the machine
    tag = "jamba-1.5-large-398b__train_4k__pod16x16"
    env = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(filter(None, [SRC, env]))
    try:
        DA._run_one("jamba-1.5-large-398b", "train_4k", "single",
                    str(tmp_path), "cpu", 40, tag)
    finally:
        if env is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = env
    rec = json.loads((tmp_path / f"{tag}.json").read_text())
    assert not rec["ok"], rec
    assert rec["traceback"].startswith("Thread 0x"), rec
