"""The port's telemetry (``obs/``) against the reference's (``repro.obs``),
and its hooks in the training and serving engines, on the CPU.

The tracer, the registry, the derived gauges and both exports are driven
with the same inputs in both packages (spans with explicit timestamps, so
even the Chrome trace is compared exactly); the port's own contracts: an
engine with obs, or with a disabled obs, gives the losses of an engine
without it bit for bit, the exported trace's per-track busy time is
``timeline_report``'s, a run publishes the reference's metric names for
the same run, and obs changes no serving result or stat."""
import json
import os
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

from repro import obs as JO
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as j_reduced
from repro.core import load_balance as JLB
from repro.core.pipeline import StageEvent as JEvent
from repro.data.synthetic import synth_jagged_batch as j_synth
from repro.launch.roofline import gr_dense_params as j_gr_dense_params
from repro.models.model_zoo import get_bundle as j_get_bundle
from repro.training.engine import GREngine as JEngine
from repro_torch import obs as PO
from repro_torch.configs import ARCHS as PARCHS
from repro_torch.configs import reduced
from repro_torch.core import load_balance as PLB
from repro_torch.core.pipeline import StageEvent as PEvent
from repro_torch.models.gr import GRModel
from repro_torch.serving import RecallEngine, StreamingRecallEngine
from repro_torch.training import GREngine
from test_torch_engine import LK, _setup

PEAK = 197e12          # any positive peak; both packages get the same one


# ---------------------------------------------------------------------------
# tracer, registry, derived gauges: the port against the reference
# ---------------------------------------------------------------------------

def _spans(rng, n=60):
    return [(f"op{int(k)}", f"t{int(t)}", float(s), float(s + d),
             {"step": int(k)})
            for k, t, s, d in zip(rng.integers(0, 9, n), rng.integers(0, 4, n),
                                  rng.random(n) * 10, rng.random(n))]


@pytest.mark.parametrize("seed", [0, 1])
def test_tracer_and_chrome_export_match_reference(seed):
    """The same spans (overlapping, nested, on several tracks), instants and
    stage events with records into both tracers: equal busy time per track,
    wall span, Chrome trace (exactly: the timestamps are the inputs) and
    busy time re-read from the exported JSON."""
    rng = np.random.default_rng(seed)
    spans = _spans(rng)
    stages = ["dataload", "a2a", "unique", "emb_fwd", "dense_fwd",
              "dense_bwd", "emb_bwd"]
    evs = [(stages[int(k)], int(b), float(s), float(s + d))
           for k, b, s, d in zip(rng.integers(0, 7, 30), rng.integers(0, 5, 30),
                                 rng.random(30) * 5, rng.random(30))]
    recs = {b: {"loss": 1.0 + b, "tokens": 64 * b, "mfu": 0.1,
                "cache": {"hit_rate": 0.5}} for b in range(5)}
    out = {}
    for name, mod, ev_cls in (("ref", JO, JEvent), ("port", PO, PEvent)):
        t = mod.Tracer()
        for s in spans:
            t.record(*s)
        t.instant("mark", "t1", now=0.25, args={"k": 1})
        n = t.ingest_stage_events([ev_cls(*e) for e in evs], records=recs)
        assert n == len(evs)
        trace = json.loads(json.dumps(t.to_chrome_trace("proc")))
        out[name] = (t.busy_by_track(), t.wall_span(), trace,
                     mod.trace_busy_by_track(trace), len(t))
    assert out["port"] == out["ref"]


def test_tracer_context_manager_disabled_and_threads():
    """The span context manager on an injected clock, the disabled tracer
    (one shared null context, nothing recorded) and spans recorded from
    four threads, each against the reference's."""
    for mod in (JO, PO):
        clock = iter([1.0, 2.5, 3.0, 3.25])
        t = mod.Tracer(clock=lambda: next(clock))
        with t.span("work", "main", step=7):
            pass
        with t.span("more"):
            pass
        s = t.spans()
        assert [(x.name, x.track, x.start, x.end, dict(x.args)) for x in s] \
            == [("work", "main", 1.0, 2.5, {"step": 7}),
                ("more", "more", 3.0, 3.25, {})]
    off = PO.Tracer(enabled=False)
    with off.span("x", "y"):
        pass
    off.record("a", "b", 0.0, 1.0)
    off.instant("i")
    assert len(off) == 0 and off.span("p") is off.span("q") is PO.NULL_SPAN
    t = PO.Tracer()
    barrier = threading.Barrier(4)

    def worker(k):
        barrier.wait()
        for i in range(50):
            t.record(f"op{i}", f"thread{k}", float(i), float(i) + 0.5)
    ths = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    assert len(t) == 200
    assert all(abs(v - 25.0) < 1e-9 for v in t.busy_by_track().values())

    class Ev:
        failed_step, restored_step, steps_lost = 7, 5, 2
        error, wall_s = "boom", 0.5
    views = []
    for mod in (JO, PO):
        t = mod.Tracer()
        assert t.ingest_recovery_events([Ev(), Ev()], t0=1.0) == 2
        views.append(t.to_chrome_trace())
    assert views[0] == views[1]


def test_registry_snapshot_prometheus_and_publish_match_reference():
    """The same counters, labelled gauges, histograms (custom and default
    buckets) and a published nested stats dict in both registries: equal
    snapshots and equal Prometheus text; the registry's own errors."""
    out = []
    for mod in (JO, PO):
        r = mod.MetricsRegistry()
        r.counter("train_steps_total", "steps done").inc(4)
        r.counter("train_steps_total").inc()
        r.gauge("busy_s", labels={"stage": "a2a"}).set(1.0)
        r.gauge("busy_s", labels={"stage": "dataload"}).set(2.5)
        h = r.histogram("ckpt_save_s", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        for v in (1e-5, 0.02, 40.0):
            r.histogram("train_step_s", "step wall").observe(v)
        n = r.publish("serve", {"latency": {"p50_s": 0.001, "count": 3},
                                "mode": "warm", "hit": True,
                                "occupancy": {"rows": 4}})
        assert n == 4
        out.append((r.snapshot(), r.to_prometheus()))
        with pytest.raises(ValueError):
            r.counter("train_steps_total").inc(-1)
        with pytest.raises(ValueError):
            r.gauge("train_steps_total")
    assert out[0] == out[1]
    assert list(out[1][0]) == sorted(out[1][0])
    assert PO.MetricsRegistry().snapshot() == {}


def test_derived_gauges_match_reference():
    """measured MFU, token imbalance, pipeline goodput and the GR dense
    parameter count against the reference's on the same inputs; the peak
    table (the H100's cited dense bf16/fp16 rate) and its refusal of a card
    or dtype it has no figure for."""
    rng = np.random.default_rng(3)
    for flops, wall in ((1e12, 0.01), (3.3e15, 0.18), (0.0, 1.0), (1.0, 0.0)):
        assert PO.measured_mfu(flops, wall, PEAK) == JO.measured_mfu(
            flops, wall, peak_flops=PEAK)
    for loads in ([100, 50, 50], [64] * 4, [5], [0, 0], [],
                  list(rng.integers(0, 9000, 8))):
        assert PO.token_imbalance(loads) == JO.token_imbalance(loads)
    lens = rng.integers(1, 500, 40)
    assign = [list(range(k, 40, 5)) for k in range(5)]
    for kw in ({}, dict(step_cost_per_token=2.0, fixed_overhead=30.0)):
        assert PLB.imbalance_ratio(assign, lens, **kw) == \
            JLB.imbalance_ratio(assign, lens, **kw)
    np.testing.assert_array_equal(PLB.assignment_token_loads(assign, lens),
                                  JLB.assignment_token_loads(assign, lens))
    for n in (0, 1, 40):
        evs = [(str(k), 0, float(s), float(s + d)) for k, s, d in
               zip(range(n), rng.random(n) * 4, rng.random(n))]
        assert PO.pipeline_goodput([PEvent(*e) for e in evs]) == \
            JO.pipeline_goodput([JEvent(*e) for e in evs])
    for arch in ("hstu-large", "fuxi-large", "hstu-tiny", "fuxi-tiny"):
        assert PO.gr_dense_params(PARCHS[arch]) == \
            j_gr_dense_params(JARCHS[arch])
    assert PO.peak_flops_of("NVIDIA H100 80GB HBM3") == 989.4e12
    assert PO.peak_flops_of("NVIDIA H100 80GB HBM3", "float16") == 989.4e12
    assert PO.peak_flops_of("NVIDIA H100 80GB HBM3", "float32") == 67e12
    assert PO.peak_flops_of("cpu", peak_flops=5.0) == 5.0
    for name, dt in (("cpu", "bfloat16"), ("NVIDIA A100-SXM4-80GB",
                                           "bfloat16"),
                     ("NVIDIA H100 80GB HBM3", "float64")):
        with pytest.raises(ValueError, match="pass peak_flops"):
            PO.peak_flops_of(name, dt)


# ---------------------------------------------------------------------------
# the training engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gr():
    return _setup()


def _engine(gr, obs, **kw):
    b, batch, mk_state = gr
    return GREngine(b, batch, state=mk_state(), loss_kwargs=LK, obs=obs,
                    workers=2, peak_flops=PEAK, **kw)


@pytest.mark.parametrize("schedule", ["algorithm1", "flat"])
def test_engine_obs_losses_bit_identical(gr, schedule):
    """With obs, with a disabled obs and without: the same losses bit for
    bit; records gain step_wall_s, mfu and imbalance only with a live obs,
    and a disabled obs records nothing. The exported trace's busy time per
    merged stage is timeline_report's."""
    obs, noop = PO.Obs(), PO.Obs.noop()
    runs = {k: _engine(gr, o, schedule=schedule)
            for k, o in (("obs", obs), ("noop", noop), ("none", None))}
    res = {k: e.run(4) for k, e in runs.items()}
    losses = {k: [r["loss"] for r in v] for k, v in res.items()}
    assert losses["obs"] == losses["noop"] == losses["none"]
    assert sorted(res["none"][0]) == sorted(res["noop"][0]) == \
        ["loss", "step", "tokens"]
    assert {"mfu", "imbalance", "step_wall_s"} <= set(res["obs"][0])
    assert all(0 < r["mfu"] < 1 for r in res["obs"])
    assert len(noop.tracer) == 0 and noop.snapshot() == {}
    stage_s = runs["obs"].timeline_report()["stage_s"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        obs.export_trace(path)
        busy = PO.trace_busy_by_track(json.load(open(path)))
    assert set(busy) == set(stage_s)
    for stage, want in stage_s.items():
        assert busy[stage] == pytest.approx(want, rel=1e-9, abs=1e-9), stage


def _ref_tiny_engine(obs):
    cfg = j_reduced(JARCHS["hstu-tiny"]).replace(num_negatives=8,
                                                 vocab_size=512)
    b = j_get_bundle(cfg)
    return JEngine(b, lambda i: j_synth(jax.random.PRNGKey(i), 2, 96, 512, 8),
                   obs=obs, workers=2)


def test_engine_metric_names_equal_reference(gr):
    """A plain run, then a resilient run with checkpoints and one recovery,
    in each package: the same metric families, of the same types, and the
    same counts of steps, saves, restores and recoveries."""
    snaps = []
    for mk in (lambda o: _ref_tiny_engine(o), lambda o: _engine(gr, o)):
        obs = (JO if not snaps else PO).Obs()
        eng = mk(obs)
        eng.run(3)
        with tempfile.TemporaryDirectory() as d:
            if not snaps:
                from repro.training import resilience as JR
                inj_mod = JR
            else:
                from repro_torch.training import resilience as inj_mod
            eng.run_resilient(
                6, ckpt_dir=d, ckpt_every=2, async_save=False,
                start_step=0,
                injector=inj_mod.FaultInjector(
                    [inj_mod.FaultSpec("dense_fwd", 3)]),
                policy=inj_mod.FaultPolicy(retries={}))
        snaps.append(obs.snapshot())
    ref, port = snaps
    assert sorted(port) == sorted(ref)
    assert {k: v["type"] for k, v in port.items()} == \
        {k: v["type"] for k, v in ref.items()}
    for fam in ("train_steps_total", "ckpt_saves_total",
                "ckpt_restores_total", "train_recoveries_total",
                "train_steps_replayed_total"):
        assert port[fam]["values"] == ref[fam]["values"], fam
    assert port["train_recovery_s"]["values"][""]["count"] == 1


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _tiny_serving():
    cfg = reduced(PARCHS["hstu-tiny"]).replace(vocab_size=300,
                                               max_seq_len=24)
    g = torch.Generator().manual_seed(0)
    model = GRModel(cfg, device="cpu", generator=g)
    table = torch.randn(cfg.vocab_size, cfg.d_model, generator=g) * 0.02
    return cfg, model, table


def test_streaming_stats_unchanged_by_obs():
    """Two rounds (cold, then appends and hits) through the streaming engine
    with a live obs and without: the same results and the same stats;
    the stats mirrored under serve_ and the reference's span tracks."""
    cfg, model, table = _tiny_serving()
    reqs = [(u, list(range(1, 6 + u)), list(range(10, 15 + u)))
            for u in range(4)]
    more = [(u, [7, 8][:1 + u % 2], [40, 41][:1 + u % 2]) for u in range(2)]
    more += [(3, [], [])]

    def run(obs):
        eng = StreamingRecallEngine(cfg, model, table, max_users=8, k=15,
                                    retrieval_block=128,
                                    max_rows_per_tick=4, obs=obs,
                                    device="cpu")
        return eng.serve(reqs, now=5.0) + eng.serve(more, now=6.0), \
            eng.stats()

    obs = PO.Obs()
    r1, s1 = run(obs)
    r2, s2 = run(None)
    r3, s3 = run(PO.Obs.noop())
    assert s1 == s2 == s3
    assert s1["encode"]["warm_rows"] > 0
    for a, b, c in zip(r1, r2, r3):
        assert np.array_equal(a.item_ids, b.item_ids)
        assert np.array_equal(a.scores, b.scores)
        assert np.array_equal(a.item_ids, c.item_ids)
    snap = obs.snapshot()
    assert snap["serve_latency_count"]["values"][""] == s1["latency"]["count"]
    assert "serve_occupancy_row_utilization" in snap
    assert "serve_compile_compiles" in snap
    names = {(s.name, s.track) for s in obs.tracer.spans()}
    assert names == {("tick", "serve"), ("encode_cold", "serve_encode"),
                     ("encode_warm", "serve_encode"), ("rank", "serve_rank")}


def test_recall_engine_stats_unchanged_by_obs():
    cfg, model, table = _tiny_serving()
    reqs = [(u, list(range(1, 8)), list(range(10, 17))) for u in range(3)]

    def run(obs):
        eng = RecallEngine(cfg, model, table, num_shards=1,
                           users_per_shard=4, k=15, retrieval_block=128,
                           obs=obs, device="cpu")
        return eng.serve(reqs, now=2.0), eng.stats()

    obs = PO.Obs()
    r1, s1 = run(obs)
    r2, s2 = run(None)
    assert s1 == s2
    for a, b in zip(r1, r2):
        assert np.array_equal(a.item_ids, b.item_ids)
        assert np.array_equal(a.scores, b.scores)
    snap = obs.snapshot()
    assert snap["serve_encoded_batches"]["values"][""] == \
        s1["encoded_batches"]
    assert {(s.name, s.track) for s in obs.tracer.spans()} == \
        {("encode", "serve_encode"), ("retrieval", "serve_rank")}
