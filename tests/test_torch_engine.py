"""The port's staged engine (``training/engine.py``), its copy of the
six-stage pipeline (``core/pipeline.py``), its KuaiRand preprocessing
(``data/kuairand.py``) and its training CLI (``launch/train.py``).

Inside the port: ``GREngine`` in both schedules equals the flat
``make_gr_train_step`` bit for bit (losses, every state tensor and the τ=1
carry), a τ=1 run split in two equals the unbroken run, and a mid-run
``step_callback`` state resumes to the same trajectory — the reference's
``tests/test_trainer.py`` contract. Across frameworks: the port's engine
against the reference's on the same converted weights and loader batches,
to the training slice's tolerances; the pipeline's stage order and
``timeline_report``, and ``preprocess_log``, exactly."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.data import kuairand as JK
from repro.data.loader import GRLoader as JLoader
from repro.data.synthetic import SyntheticKuaiRand as JSynth
from repro.models.model_zoo import get_bundle as j_bundle
from repro.training import trainer as JT
from repro.training.engine import GREngine as JEngine
from repro_torch.convert import (adamw_to_numpy, gr_params_from_numpy,
                                 gr_params_to_numpy, pending_to_numpy,
                                 shadowed_table_from_numpy, table_to_numpy)
from repro_torch.core import pipeline as PP
from repro_torch.data import GRLoader as PLoader
from repro_torch.data import SyntheticKuaiRand as PSynth
from repro_torch.data import kuairand as PK
from repro_torch.launch import train as cli
from repro_torch.models.model_zoo import GRBundle
from repro_torch.training import (GREngine, GRTrainState, clone_state,
                                  gr_train_state, make_gr_step_fn,
                                  state_tensors, to_device)
from test_torch_training import TOLS, _assert_close, _assert_trees
from torch_parity import configs, tree_numpy

CPU = torch.device("cpu")
SEG = 32
R = 8


def _loader(cls_loader, cls_synth, vocab, seed=4):
    gen = cls_synth(num_users=60, num_items=vocab, mean_len=30, max_len=80,
                    seed=3)
    seqs = {u: (d["item"], d["ts"]) for u, d in
            ((u, gen.interactions(u)) for u in range(60))}
    return cls_loader(seqs, num_devices=2, users_per_device=3,
                      max_seq_len=32, num_negatives=R, num_items=vocab,
                      seed=seed)


def _setup(dtype="bfloat16"):
    """Bundle, fixed numpy batches (batch(i) repeats with period 6) and a
    factory of fresh states from one init."""
    _, cp = configs(dtype, n_items=500, max_seq_len=32)
    cp = cp.replace(num_negatives=R)
    b = GRBundle(cp)
    batches = list(_loader(PLoader, PSynth, 500).batches(6))

    def mk_state():
        g = torch.Generator().manual_seed(0)
        return gr_train_state(b.init_dense(g, device=CPU),
                              b.init_table(g, device=CPU))
    return b, lambda i: batches[i % 6], mk_state


LK = dict(neg_segment=SEG)


def _assert_states_equal(a: GRTrainState, b: GRTrainState, what=""):
    assert a.step == b.step and a.dense_opt.count == b.dense_opt.count
    ta, tb = state_tensors(a), state_tensors(b)
    assert len(ta) == len(tb)
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert torch.equal(x, y), f"{what} tensor {i}"


def _flat(b, batch, state, steps, semi_async=True, start=0):
    step = make_gr_step_fn(b, loss_kwargs=LK, semi_async=semi_async)
    losses = []
    for i in range(start, start + steps):
        state, m = step(state, to_device(batch(i), CPU))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("semi_async", [False, True])
def test_engine_schedules_match_flat_step(semi_async):
    """Pipelined (Algorithm 1) and serial (flat) engine runs against the
    flat step from one init, 5 steps: the same losses and the same bits in
    every state tensor, the τ=1 carry included."""
    b, batch, mk_state = _setup()
    N = 5
    st, losses = _flat(b, batch, mk_state(), N, semi_async)
    assert st.step == N
    if semi_async:
        assert st.pending_ids.numel() > 0
    for sched in ("algorithm1", "flat"):
        eng = GREngine(b, batch, state=mk_state(), loss_kwargs=LK,
                       semi_async=semi_async, schedule=sched)
        recs = eng.run(N)
        assert [r["loss"] for r in recs] == losses, sched
        assert [r["step"] for r in recs] == list(range(N))
        _assert_states_equal(st, eng.state, sched)
        tl = eng.timeline_report()
        assert set(tl["stage_s"]) == {"dataload", "a2a", "unique", "emb_fwd",
                                      "dense_fwd_bwd", "emb_bwd"}


def test_engine_resume_carries_pending_pairs():
    """A τ=1 run split into two engine runs (3 + 3 steps) equals the
    unbroken flat run: the first run's last pairs stay pending and land
    mid-prologue of the second."""
    b, batch, mk_state = _setup()
    st, losses = _flat(b, batch, mk_state(), 6)
    eng = GREngine(b, batch, state=mk_state(), loss_kwargs=LK,
                   schedule="algorithm1")
    r1 = eng.run(3)
    assert eng.state.pending_ids.numel() > 0
    eng2 = GREngine(b, lambda i: batch(i + 3), state=eng.state,
                    loss_kwargs=LK, schedule="algorithm1")
    r2 = eng2.run(3)
    assert [r["loss"] for r in r1 + r2] == losses
    _assert_states_equal(st, eng2.state)


def test_engine_midrun_snapshot_is_resume_equivalent():
    """The state ``step_callback`` sees mid-run under the pipelined τ=1
    schedule is the carry-convention state (pairs pending, not landed):
    the flat step resumed from a copy of it reproduces the uninterrupted
    trajectory."""
    b, batch, mk_state = _setup()
    st, losses = _flat(b, batch, mk_state(), 5)
    snaps, seen = {}, []

    def cb(i, rec, state):
        seen.append((i, threading.current_thread() is threading.main_thread()))
        snaps[i] = clone_state(state)
    eng = GREngine(b, batch, state=mk_state(), loss_kwargs=LK,
                   schedule="algorithm1", step_callback=cb)
    eng.run(5)
    assert seen == [(i, True) for i in range(5)]
    assert snaps[1].pending_ids.numel() > 0
    st2, resumed = _flat(b, batch, snaps[1], 3, start=2)
    assert resumed == losses[2:]
    _assert_states_equal(st, st2)


@pytest.mark.parametrize("rows", ["fp32", "fp16_shadow"])
def test_engine_matches_reference_engine(rows):
    """The port's ``GREngine`` against the reference's (``neg_mode="fused"``
    and the reference's default ``"fused"`` scatter), algorithm1, τ=1, 4
    steps, on the same converted weights and the two packages' GRLoaders
    over the same synthetic users (equal batches): losses and state held
    to the training slice's tolerances (``test_torch_training.TOLS``, the
    reasons there), the τ=1 carry as a set of (id, row) pairs."""
    engine_vs_reference(rows)


def engine_vs_reference(rows, arch="hstu-tiny", tweak=None, tols=None):
    """The body of :func:`test_engine_matches_reference_engine` for reduced
    ``arch``; ``tweak(dense) -> dense`` edits the JAX init first; ``tols``
    replaces ``TOLS``."""
    tol = (tols or TOLS)[rows]
    jq, pq = (None, None) if rows == "fp32" else (jnp.float16, torch.float16)
    cj, cp = configs("float32", n_items=600, max_seq_len=32, arch=arch)
    cj, cp = cj.replace(num_negatives=R), cp.replace(num_negatives=R)
    key = jax.random.PRNGKey(0)
    jb = j_bundle(cj)
    dense, table = jb.init_dense(key), jb.init_table(key)
    if tweak is not None:
        dense = tweak(dense)
    first = next(iter(_loader(JLoader, JSynth, 600).batches(1)))
    jstate = JT.gr_train_state(dense, table, qdtype=jq,
                               pending_slots=JT.gr_pending_slots(first))
    jeng = JEngine(jb, _loader(JLoader, JSynth, 600), state=jstate,
                   loss_kwargs=dict(neg_mode="fused", neg_segment=SEG,
                                    fetch_dtype=jq), schedule="algorithm1")
    jl = [r["loss"] for r in jeng.run(4)]

    master = np.asarray(table)
    pstate = gr_train_state(
        gr_params_from_numpy(tree_numpy(dense), cp, device=CPU),
        shadowed_table_from_numpy(
            master, None if pq is None else master.astype(np.float16),
            np.zeros_like(master), device=CPU))
    peng = GREngine(GRBundle(cp), _loader(PLoader, PSynth, 600),
                    state=pstate, loss_kwargs=dict(neg_segment=SEG,
                                                   fetch_dtype=pq),
                    schedule="algorithm1")
    pl = [r["loss"] for r in peng.run(4)]

    js, ps = jeng.state, peng.state
    np.testing.assert_allclose(pl, jl, rtol=0, atol=tol["loss"])
    _assert_trees(gr_params_to_numpy(ps.dense), tree_numpy(js.dense),
                  tol["dense"], 0, "dense")
    opt = adamw_to_numpy(ps.dense_opt)
    assert opt["count"] == int(js.dense_opt.count) == 4 == ps.step
    _assert_trees(opt["mu"], tree_numpy(js.dense_opt.mu), tol["mu"], 0,
                  "adamw mu")
    _assert_trees(opt["nu"], tree_numpy(js.dense_opt.nu), tol["nu"], 0,
                  "adamw nu")
    t = table_to_numpy(ps.table)
    _assert_close(t["master"], js.table.master, tol["master"], 0, "master")
    _assert_close(t["accum"], js.table.accum, tol["accum"], 0, "accum")
    if pq is not None:
        np.testing.assert_array_equal(t["shadow"],
                                      t["master"].astype(np.float16))
    pi, pr = pending_to_numpy(ps.pending_ids, ps.pending_rows)
    ji, jr = pending_to_numpy(torch.from_numpy(np.array(js.pending_ids)),
                              torch.from_numpy(np.array(js.pending_rows)))
    np.testing.assert_array_equal(pi, ji)
    _assert_close(pr, jr, tol["rows"], 0, "pending rows")


def _recording_hooks(cls_hooks, log, lock):
    def mk(name):
        def fn(i, *a):
            if name in ("dataload", "a2a", "unique"):
                time.sleep(0.001 * ((i * 7) % 3))   # workers finish unordered
            with lock:
                log.append((name, i))
            return (name, i)
        return fn
    return cls_hooks(**{s: mk(s) for s in PP.STAGES})


@pytest.mark.parametrize("steps", [1, 3, 7])
def test_pipeline_copy_matches_reference(steps):
    """The port's ``SixStagePipeline`` calls the device hooks (the main
    thread) in the reference's order and each host hook once per batch, and
    returns the same results; ``timeline_report`` gives the reference's
    numbers on the same synthetic events."""
    logs = {}
    for name, mod in (("ref", JP), ("port", PP)):
        log, lock = [], threading.Lock()
        pipe = mod.SixStagePipeline(_recording_hooks(mod.PipelineHooks, log,
                                                     lock), workers=3)
        res = pipe.run(steps)
        assert res == [("dense_bwd", i) for i in range(steps)]
        logs[name] = log
    dev = ("emb_fwd", "dense_fwd", "dense_bwd", "emb_bwd")
    main = {k: [e for e in v if e[0] in dev] for k, v in logs.items()}
    assert main["port"] == main["ref"]
    assert sorted(logs["port"]) == sorted(logs["ref"])
    assert sorted(logs["port"]) == sorted((s, i) for s in PP.STAGES
                                          for i in range(steps))
    assert PP.STAGES == JP.STAGES and PP.REPORT_MERGED == JP.REPORT_MERGED
    rng = np.random.default_rng(steps)
    starts = rng.random(40) * 5
    spec = [(PP.STAGES[int(k)], int(b), float(s), float(s + d))
            for k, b, s, d in zip(rng.integers(0, 7, 40),
                                  rng.integers(0, 9, 40), starts,
                                  rng.random(40))]
    assert (PP.timeline_report([PP.StageEvent(*e) for e in spec])
            == JP.timeline_report([JP.StageEvent(*e) for e in spec]))
    assert PP.timeline_report([]) == JP.timeline_report([]) == {}


def test_preprocess_log_matches_reference():
    """Appendix-A preprocessing: the port's numpy copy gives the
    reference's train sequences, test items and item remap exactly, and so
    does each step on its own."""
    log = PSynth(num_users=120, num_items=2000, mean_len=40, max_len=200,
                 seed=5).log()
    j_train, j_test, j_remap = JK.preprocess_log(dict(log))
    p_train, p_test, p_remap = PK.preprocess_log(dict(log))
    assert p_remap == j_remap and p_test == j_test
    assert list(p_train) == list(j_train) and len(p_train) > 50
    for u, (it, ts) in j_train.items():
        np.testing.assert_array_equal(p_train[u][0], it)
        np.testing.assert_array_equal(p_train[u][1], ts)
        assert p_train[u][0].dtype == it.dtype
    a, b = JK.drop_negative(dict(log)), PK.drop_negative(dict(log))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    a, b = JK.five_core_filter(a, 5), PK.five_core_filter(b, 5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    ga, gb = JK.group_sequences(a), PK.group_sequences(b)
    assert list(ga) == list(gb)
    assert JK.leave_one_out(ga)[1] == PK.leave_one_out(gb)[1]


@pytest.mark.parametrize("arg", ["cache"])
def test_engine_rejects_what_is_not_ported(arg):
    """An embedding cache together with a custom ``lookup_fn`` raises (the
    cache hands the loss window rows, a lookup_fn expects global ids), as
    the reference's engine does; so do a bad schedule and a state with a
    device."""
    from functools import partial
    from repro_torch.embedding import CachedShadowedTable
    from repro_torch.kernels.jagged_lookup import jagged_lookup
    b, batch, mk_state = _setup()
    kw = {"cache": CachedShadowedTable(
        mk_state().table.master, capacity_chunks=4, chunk_rows=128,
        device="cpu")}
    with pytest.raises(ValueError, match="lookup_fn"):
        GREngine(b, batch, loss_kwargs=dict(lookup_fn=partial(
            jagged_lookup, compute_dtype=torch.bfloat16)), **{arg: kw[arg]})
    with pytest.raises(ValueError, match="schedule"):
        GREngine(b, batch, state=mk_state(), schedule="dense")
    with pytest.raises(ValueError, match="not both"):
        GREngine(b, batch, state=mk_state(), device="cpu")


def test_cli_trains_on_cpu_and_needs_the_card(capsys, monkeypatch):
    """``python -m repro_torch.launch.train --device cpu`` at hstu-tiny:
    the loss falls over 10 steps and the run ends with ``[done]``. Without
    ``--device cpu`` it needs the card and raises without one; flags of
    layers not ported are refused by argparse."""
    args = ["--device", "cpu", "--arch", "hstu-tiny", "--steps", "10",
            "--synthetic-users", "300", "--num-items", "3000",
            "--max-seq-len", "64", "--num-negatives", "8", "--log-every",
            "5"]
    recs = cli.main(args)
    losses = [r["loss"] for r in recs]
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    out = capsys.readouterr().out
    assert "[done] 10 steps" in out and "step    10  loss" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args[2:])
    with pytest.raises(SystemExit):
        cli.main(args + ["--use-kernel"])
