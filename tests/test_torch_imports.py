"""The port stands alone: it imports no jax, nothing of the JAX package and
no msgpack (every module, serving and training alike, HSTU, FuXi and
SASRec, the streaming engine, the fused, baseline and segmented negative
paths, the kernel lookup and the dense attention schedule, telemetry,
checkpoints and the resilient engine, the embedding cache and its
histograms, the sparse parallelism over a process-group mesh, its
sharded checkpoints, the semi-async analysis and the elastic runner, the
LM zoo's configs, layers, MoE, Mamba, stack, bundle and train step, the
autotune harness and its store, the launch tooling (partition plans, the
kernels' cost model, the per-device analysis, the roofline, the
dry-run, its sweep, report and reanalysis), runs with all three
blocked), and
its entry points run on the card unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as PC
from repro_torch.convert import (gr_params_from_numpy, pending_from_numpy,
                                 shadowed_table_from_numpy, table_from_numpy)
from repro_torch.data import synth_jagged_batch
from repro_torch.embedding import CachedShadowedTable
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.gr import GRModel
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.model_zoo import GRBundle, LMBundle
from repro_torch.models.transformer import LM
from repro_torch.serving import RecallEngine, StreamingRecallEngine
from repro_torch.training import GREngine

ROOT = Path(__file__).resolve().parents[1]
IMPORT_RE = re.compile(
    r"^\s*(import|from)\s+(jax|repro|msgpack)(\.|\s|$)")

_GUARDED = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["msgpack"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import repro_torch
from repro_torch.configs import get_arch, reduced
from repro_torch.models.gr import GRModel
from repro_torch.serving import RecallEngine
cfg = reduced(get_arch("hstu-tiny")).replace(vocab_size=300, max_seq_len=40)
g = torch.Generator().manual_seed(0)
model = GRModel(cfg, device="cpu", generator=g)
master = torch.randn(cfg.vocab_size, cfg.d_model, generator=g) * 0.02
eng = RecallEngine(cfg, model, master, num_shards=2, users_per_shard=2,
                   k=5, retrieval_block=128, device="cpu")
rng = np.random.default_rng(0)
reqs = [(u, rng.integers(0, 300, 9 + u), np.arange(9 + u) * 7)
        for u in range(5)]
res = eng.serve(reqs)
assert len(res) == 5 and all(np.isfinite(r.user_emb).all() for r in res)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
import repro_torch.core.negative_sampling, repro_torch.data
import repro_torch.kernels.jagged_lookup, repro_torch.kernels.neg_logits
import repro_torch.models.model_zoo, repro_torch.training
import repro_torch.convert
from repro_torch.data import GRLoader, SyntheticKuaiRand
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.model_zoo import GRBundle, LMBundle
from repro_torch.models.transformer import LM
from repro_torch.training import gr_train_state, make_gr_train_step, to_device
cfg = cfg.replace(num_negatives=4)
b = GRBundle(cfg)
gen = SyntheticKuaiRand(num_users=12, num_items=300, mean_len=20, max_len=40)
seqs = {u: (d["item"], d["ts"]) for u, d in
        ((u, gen.interactions(u)) for u in range(12))}
loader = GRLoader(seqs, 2, 2, 40, 4, 300)
st = gr_train_state(b.init_dense(g, device="cpu"),
                    b.init_table(g, device="cpu"))
for semi in (False, True):
    step = make_gr_train_step(
        lambda d, t, bt, **kw: b.loss(d, t, bt, neg_segment=32, **kw),
        input_gather=b.input_gather, semi_async=semi)
    for batch in loader.batches(2):
        st, m = step(st, to_device(batch, "cpu"))
        assert np.isfinite(float(m["loss"]))
assert st.pending_ids.numel() > 0
from functools import partial
from repro_torch.core.jagged import JaggedBatch, from_dense, to_dense
from repro_torch.data import synth_jagged_batch
from repro_torch.embedding import (TableSpec, init_table, lookup_quantized,
                                   multi_table_lookup)
from repro_torch.kernels.jagged_attention import make_attn_fn
from repro_torch.kernels.jagged_lookup import jagged_lookup
from repro_torch.training import adagrad_init, adagrad_update
from repro_torch.training.engine import make_gr_step_fn
for mode in ("baseline", "segmented"):
    step = make_gr_step_fn(b, loss_kwargs=dict(
        neg_mode=mode, neg_segment=16, expansion=2,
        attn_fn=make_attn_fn(schedule="dense", max_row_len=40),
        lookup_fn=partial(jagged_lookup,
                          compute_dtype=getattr(torch, cfg.dtype))))
    for batch in loader.batches(2):
        st, m = step(st, to_device(batch, "cpu"))
        assert np.isfinite(float(m["loss"]))
sb = synth_jagged_batch(g, 2, 32, 300, 4, device="cpu")
assert np.isfinite(float(b.loss(st.dense, st.table.master, sb,
                                neg_mode="baseline", neg_segment=16)))
import repro_torch.core.pipeline, repro_torch.data.kuairand
import repro_torch.launch.train, repro_torch.training.engine
from repro_torch.training import GREngine
ge = GREngine(b, loader, state=st, loss_kwargs=dict(neg_segment=32))
assert all(np.isfinite(r["loss"]) for r in ge.run(3))
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()) as cli_out:
    recs = repro_torch.launch.train.main([
        "--device", "cpu", "--arch", "hstu-tiny", "--steps", "2",
        "--synthetic-users", "120", "--num-items", "900", "--max-seq-len",
        "32", "--num-negatives", "4", "--log-every", "1"])
assert len(recs) == 2 and "[done] 2 steps" in cli_out.getvalue()
import repro_torch.configs.fuxi, repro_torch.models.fuxi
fcfg = reduced(get_arch("fuxi-tiny")).replace(vocab_size=300, max_seq_len=40,
                                              num_negatives=4)
fb = GRBundle(fcfg)
fst = gr_train_state(fb.init_dense(g, device="cpu"),
                     fb.init_table(g, device="cpu"))
fstep = make_gr_train_step(
    lambda d, t, bt, **kw: fb.loss(d, t, bt, neg_segment=32, **kw),
    input_gather=fb.input_gather)
for batch in loader.batches(2):
    fst, m = fstep(fst, to_device(batch, "cpu"))
    assert np.isfinite(float(m["loss"]))
feng = RecallEngine(fcfg, fst.dense, fst.table.master, num_shards=2,
                    users_per_shard=2, k=5, retrieval_block=128,
                    device="cpu")
assert len(feng.serve(reqs)) == 5
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
from repro_torch.serving import StreamingRecallEngine
import repro_torch.configs.sasrec, repro_torch.models.sasrec
for arch in ("hstu-tiny", "sasrec-tiny"):
    scfg = reduced(get_arch(arch)).replace(vocab_size=300, max_seq_len=40)
    smodel = GRModel(scfg, device="cpu", generator=g)
    seng = StreamingRecallEngine(scfg, smodel, master, max_users=4, k=5,
                                 retrieval_block=128, max_rows_per_tick=2,
                                 device="cpu")
    sres = seng.serve(reqs[:3]) + seng.serve([(0, [1, 2], [400, 401])])
    assert len(sres) == 4 and all(np.isfinite(r.user_emb).all()
                                  for r in sres)
    assert seng.prefix_reuse == (arch == "hstu-tiny")
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
import tempfile
import repro_torch.obs, repro_torch.obs.derived, repro_torch.obs.metrics
import repro_torch.obs.trace
from repro_torch.obs import Obs
from repro_torch.training import checkpoint as CKPT, clone_state, state_tensors
from repro_torch.training import resilience as R
with tempfile.TemporaryDirectory() as d:
    CKPT.save(d, 3, st)
    fresh = gr_train_state(b.init_dense(torch.Generator().manual_seed(9),
                                        device="cpu"),
                           b.init_table(torch.Generator().manual_seed(9),
                                        device="cpu"))
    got, used = CKPT.restore_with_step(d, fresh)
    assert used == 3 and got.step == st.step
    assert all(torch.equal(x, y) for x, y in
               zip(state_tensors(got), state_tensors(st)))
    obs = Obs()
    ge = GREngine(b, loader, state=clone_state(st),
                  loss_kwargs=dict(neg_segment=32), obs=obs, peak_flops=1e12)
    recs = ge.run_resilient(
        st.step + 3, ckpt_dir=d + "/run", ckpt_every=2,
        injector=R.FaultInjector([R.FaultSpec("emb_bwd", st.step + 1)]),
        policy=R.FaultPolicy(retries={}))
    assert len(recs) == 3 and len(ge.recoveries) == 1
    assert obs.snapshot()["ckpt_saves_total"]["values"][""] >= 1
import repro_torch.data.freq, repro_torch.embedding.cache
from repro_torch.data import stream_id_histogram
from repro_torch.embedding import CachedShadowedTable
first = list(loader.batches(2))
cache = CachedShadowedTable(b.init_table(g, device="cpu"),
                            capacity_chunks=3, chunk_rows=100, device="cpu")
cache.warm_up(stream_id_histogram(first, cfg.vocab_size))
ce = GREngine(b, lambda i: first[i % 2], cache=cache,
              loss_kwargs=dict(neg_segment=32))
assert all(np.isfinite(r["loss"]) and "cache" in r for r in ce.run(3))
assert ce.full_snapshot().shapes[ce.full_snapshot().paths.index(
    "table.master")] == (cfg.vocab_size, cfg.d_model)
assert not any(m == "jax" or m.startswith(("jax.", "repro.", "msgpack"))
               for m in sys.modules if sys.modules[m] is not None)
import repro_torch.core.hsp, repro_torch.core.semi_async
import repro_torch.launch.mesh, repro_torch.training.elastic
from repro_torch.core.semi_async import collision_alpha
from repro_torch.training.elastic import (build_gr_engine, rebuild_mesh,
                                          viable_mesh_shape)
assert viable_mesh_shape(12, 4) == (3, 4)
assert 0.0 <= collision_alpha(np.stack([b["neg_ids"].reshape(-1)
                                        for b in first])) <= 1.0
with tempfile.TemporaryDirectory() as d:
    mesh = rebuild_mesh(1, 2, rank=0, store_dir=d, timeout_s=30,
                        device="cpu")
    assert mesh.shape == (1, 1)
    he = build_gr_engine(mesh, arch="hstu-tiny", reduce=True,
                         overrides=dict(vocab_size=300, max_seq_len=40,
                                        num_negatives=4),
                         data=dict(users=12, mean_len=20, max_len=40,
                                   users_per_device=2, max_seq_len=40,
                                   seed=0),
                         loss_kwargs=dict(neg_segment=32))
    hr = he.run_resilient(2, ckpt_dir=d + "/hsp", ckpt_every=1)
    assert len(hr) == 2 and all(np.isfinite(r["loss"]) for r in hr)
    assert he.restore_latest(d + "/hsp") == 2
    mesh.close()
assert not any(m == "jax" or m.startswith(("jax.", "repro.", "msgpack"))
               for m in sys.modules if sys.modules[m] is not None)
import repro_torch.configs.shapes, repro_torch.core.sharding
import repro_torch.models.layers, repro_torch.models.mamba
import repro_torch.models.moe, repro_torch.models.transformer
from repro_torch.configs import ASSIGNED, cells_for, count_params
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models.model_zoo import LMBundle, get_bundle
from repro_torch.training import lm_train_state, make_lm_train_step
assert len(ASSIGNED) == 10
for name in ("starcoder2-3b", "olmoe-1b-7b", "jamba-1.5-large-398b",
             "musicgen-large"):
    lcfg = reduced(get_arch(name))
    lb = get_bundle(lcfg)
    assert isinstance(lb, LMBundle) and count_params(lcfg) > 0
    assert lb.input_specs(cells_for(get_arch(name))[0][0])
    lm = lb.init(torch.Generator().manual_seed(0), device="cpu")
    lm = lm_params_from_numpy(lm_params_to_numpy(lm), lcfg, device="cpu")
    toks = torch.randint(0, lcfg.vocab_size, (2, 17), generator=g)
    inp = ({"embeds": torch.randn(2, 17, lcfg.d_model, generator=g)}
           if lcfg.frontend == "stub_embed" else {"tokens": toks})
    lst = lm_train_state(lm)
    lstep = make_lm_train_step(lambda m, bt: lb.loss(m, bt, q_block=8),
                               num_microbatches=2)
    lst, mm = lstep(lst, dict({k: v[:, :16] for k, v in inp.items()},
                              labels=toks[:, 1:]))
    assert np.isfinite(float(mm["loss"]))
    _, cache = lb.prefill(lm, {k: v[:, :16] for k, v in inp.items()},
                          max_len=17)
    logits, _ = lb.decode(lm, toks[:, 16:], cache, 16,
                          embeds=inp.get("embeds", toks)[:, 16:])
    assert logits.shape == (2, 1, lcfg.vocab_size)
assert not any(m == "jax" or m.startswith(("jax.", "repro.", "msgpack"))
               for m in sys.modules if sys.modules[m] is not None)
import json, os
import repro_torch.kernels.autotune as AT
from repro_torch.obs import MetricsRegistry, Tracer
with tempfile.TemporaryDirectory() as d:
    os.environ["REPRO_TORCH_TUNED_JSON"] = d + "/tuned.json"
    dims = dict(T=64, R=64, D=16)
    assert AT.resolve("neg_logits_fwd", dims, "row_split", default=2) == 2
    tr = Tracer()
    res = AT.sweep("neg_logits_fwd", dims, lambda c: (lambda: torch.ones(
        8) * c["row_split"]), iters=2, warmup=0, tracer=tr,
        metrics=MetricsRegistry(), device="cpu")
    assert sorted(t["config"]["row_split"] for t in res["trials"]) == [1, 2]
    assert AT.resolve("neg_logits_fwd", dims, "row_split", default=2,
                      backend=AT.default_backend()) == \
        res["best"]["config"]["row_split"]
    assert json.load(open(d + "/tuned.json"))["version"] == 1
    del os.environ["REPRO_TORCH_TUNED_JSON"]
assert not any(m == "jax" or m.startswith(("jax.", "repro.", "msgpack"))
               for m in sys.modules if sys.modules[m] is not None)
import repro_torch.kernels.cost as KC
import repro_torch.launch.dryrun, repro_torch.launch.dryrun_all
import repro_torch.launch.op_analysis, repro_torch.launch.partition
import repro_torch.launch.reanalyze, repro_torch.launch.report
import repro_torch.launch.roofline
from repro_torch.configs.shapes import SHAPES_BY_NAME as PC_SHAPES, ShapeConfig
from repro_torch.core.load_balance import max_token_diff
from repro_torch.launch import dryrun as DR, mesh as LM_, partition as PT
from repro_torch.models.model_zoo import gr_capacity
assert gr_capacity(ShapeConfig("t", 64, 8, "train"), 4) == (128, 4)
assert max_token_diff([[0], [1, 2]], [5, 1, 1]) == 3
am = PT.AbstractMesh((16, 16), ("data", "model"))
assert PT.make_plan(get_arch("glm4-9b"), PC_SHAPES["train_4k"],
                    am).num_microbatches == 8
LM_.init_fake_world(4)
dm = LM_.device_mesh((2, 2), ("data", "model"), device="cpu")
rec = DR.run_cell("hstu-tiny", "gr_t", mesh=dm, mesh_name="fake2x2",
                  cfg=reduced(get_arch("hstu-tiny")),
                  shape=ShapeConfig("gr_t", 128, 4, "train"))
assert rec["ok"] and rec["kernels"]["attn_fwd"]["worst_case"]
assert not any(m == "jax" or m.startswith(("jax.", "repro.", "msgpack"))
               for m in sys.modules if sys.modules[m] is not None)
print("OK", eng.encoded_batches)
"""


def test_port_runs_with_jax_and_reference_blocked():
    out = subprocess.run([sys.executable, "-c", _GUARDED, str(ROOT / "src")],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def test_source_has_no_jax_or_reference_imports():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if IMPORT_RE.match(line)]
    assert not bad, bad


def _cfg():
    return PC.reduced(PC.get_arch("hstu-tiny")).replace(vocab_size=64)


def _lm_cfg():
    return PC.reduced(PC.get_arch("starcoder2-3b"))


def _cpu_model():
    return GRModel(_cfg(), device="cpu",
                   generator=torch.Generator().manual_seed(0))


ENTRY_POINTS = {
    "GRModel": lambda: GRModel(_cfg()),
    "GRBundle.init_dense": lambda: GRBundle(_cfg()).init_dense(),
    "GRBundle.init_table": lambda: GRBundle(_cfg()).init_table(),
    "shadowed_table_from_numpy": lambda: shadowed_table_from_numpy(
        np.zeros((4, 2), np.float32), None, np.zeros((4, 2), np.float32)),
    "pending_from_numpy": lambda: pending_from_numpy(
        np.zeros(3, np.int32), np.zeros((3, 2), np.float32)),
    "RecallEngine": lambda: RecallEngine(_cfg(), _cpu_model(),
                                         torch.zeros(64, 128)),
    "StreamingRecallEngine": lambda: StreamingRecallEngine(
        _cfg(), _cpu_model(), torch.zeros(64, 128)),
    "gr_params_from_numpy": lambda: gr_params_from_numpy({}, _cfg()),
    "table_from_numpy": lambda: table_from_numpy(np.zeros((4, 2),
                                                          np.float32)),
    "GREngine": lambda: GREngine(GRBundle(_cfg()), lambda i: None),
    "CachedShadowedTable": lambda: CachedShadowedTable(
        np.zeros((64, 2), np.float32), capacity_chunks=2, chunk_rows=16),
    "synth_jagged_batch": lambda: synth_jagged_batch(None, 1, 8, 10, 2),
    "launch.train.main": lambda: train_cli.main(["--arch", "hstu-tiny"]),
    "LM": lambda: LM(_lm_cfg()),
    "LMBundle.init": lambda: LMBundle(_lm_cfg()).init(),
    "LMBundle.init_cache": lambda: LMBundle(_lm_cfg()).init_cache(1, 8),
    "lm_params_from_numpy": lambda: lm_params_from_numpy({}, _lm_cfg()),
    "make_production_mesh": lambda: make_production_mesh(),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """device=None means CUDA; with no card the entry point raises rather
    than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()
