"""The port's crash-consistent checkpoints and supervised recovery
(``training/checkpoint.py``, ``training/resilience.py``,
``GREngine.run_resilient``), on the CPU.

Inside the port, the reference's contract: for every fault site (each of
the seven stages, and a crash mid-save) a run that fails and recovers ends
with the losses and every state tensor (dense params, both moments,
master, accumulator, shadow, the τ=1 pairs) of an uninterrupted run, bit
for bit, in both schedules, sync and τ=1. The checkpoint layer's
fallbacks are the reference's, case for case. Across packages: the
manifest bytes are MessagePack that ``msgpack`` reads and writes alike, a
port checkpoint has the reference's leaves in jax's order, and a checkpoint
of either package restores into the other, which then trains within the
training slice's tolerances (``test_torch_training.TOLS``) of the package
that wrote it trained on."""
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.core.pipeline import STAGES
from repro.models.model_zoo import get_bundle as j_bundle
from repro.training import checkpoint as JCKPT
from repro.training import trainer as JT
from repro.training.engine import GREngine as JEngine
from repro_torch.convert import (adamw_to_numpy, gr_params_from_numpy,
                                 gr_params_to_numpy, pending_to_numpy,
                                 shadowed_table_from_numpy, table_to_numpy)
from repro_torch.data import GRLoader as PLoader
from repro_torch.data import SyntheticKuaiRand as PSynth
from repro_torch.launch import train as cli
from repro_torch.models.model_zoo import GRBundle
from repro_torch.training import GREngine, clone_state, gr_train_state
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import resilience as R
from repro_torch.training.engine import RETRY_SAFE_STAGES
from test_torch_engine import LK, SEG, _assert_states_equal, _flat, _loader
from test_torch_engine import R as N_NEG
from test_torch_engine import _setup
from test_torch_training import TOLS, _assert_close, _assert_trees
from torch_parity import CPU, configs, tree_numpy

N_STEPS = 8


@pytest.fixture(scope="module")
def gr():
    return _setup()


@pytest.fixture(scope="module")
def baselines(gr):
    """The uninterrupted flat step, per semi_async mode."""
    b, batch, mk_state = gr
    return {semi: _flat(b, batch, mk_state(), N_STEPS, semi)
            for semi in (False, True)}


def _engine(gr, **kw):
    b, batch, mk_state = gr
    return GREngine(b, batch, state=mk_state(), loss_kwargs=LK, **kw)


def _assert_run(eng, recs, baseline, what=""):
    st, losses = baseline
    assert [r["loss"] for r in recs] == losses, what
    assert [r["step"] for r in recs] == list(range(N_STEPS)), what
    _assert_states_equal(st, eng.state, what)


# --------------------------------------------------------------------------
# fault sites: all 7 stages + a mid-save crash, bit-identical recovery
# --------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["algorithm1", "flat"])
@pytest.mark.parametrize("semi_async", [True, False])
def test_every_fault_site_recovers_bit_identical(gr, baselines, schedule,
                                                 semi_async):
    """One resilient run per (schedule, sync mode) with a host exception
    injected at every stage (each at another step) and a torn checkpoint
    write: eight recovery cycles, and the losses and every state tensor
    still equal the uninterrupted run's."""
    faults = [R.FaultSpec(stage, 1 + k, "exception")
              for k, stage in enumerate(STAGES)]
    faults.append(R.FaultSpec(R.SAVE_SITE, 4, "torn_save",
                              tear="partial_dir"))
    with tempfile.TemporaryDirectory() as d:
        inj = R.FaultInjector(faults)
        eng = _engine(gr, semi_async=semi_async, schedule=schedule)
        recs = eng.run_resilient(
            N_STEPS, ckpt_dir=d, ckpt_every=2,
            policy=R.FaultPolicy(retries={}, max_recoveries=16),
            injector=inj)
        assert inj.exhausted, inj._pending
        assert len(eng.recoveries) == len(faults), eng.recoveries
        _assert_run(eng, recs, baselines[semi_async],
                    f"{schedule} semi_async={semi_async}")
        assert ("torn_save", R.SAVE_SITE, 4) in eng.fault_events
        for ev in eng.recoveries:
            assert ev.restored_step <= ev.failed_step
            assert ev.steps_lost <= 2 + 5        # ckpt_every + lookahead
        assert eng.snapshots and all(n > 0 for _, _, n in eng.snapshots)


@pytest.mark.parametrize("tear", ["partial_dir", "truncated", "torn_latest",
                                  "bitflip"])
def test_mid_save_crash_each_tear_flavour(gr, baselines, tear):
    """A crash mid-save — partial directory, truncated published leaf, torn
    LATEST pointer, a flipped byte that only the CRC sees — falls back to
    the previous intact step (or, for a torn pointer, finds the intact save
    by its scan) and recovers bit for bit."""
    with tempfile.TemporaryDirectory() as d:
        inj = R.FaultInjector(
            [R.FaultSpec(R.SAVE_SITE, 6, "torn_save", tear=tear)])
        eng = _engine(gr, semi_async=True, schedule="algorithm1")
        recs = eng.run_resilient(
            N_STEPS, ckpt_dir=d, ckpt_every=2,
            policy=R.FaultPolicy(retries={}), injector=inj)
        _assert_run(eng, recs, baselines[True], tear)
        assert len(eng.recoveries) == 1
        want = 6 if tear == "torn_latest" else 4
        assert eng.recoveries[0].restored_step == want, tear


def test_retry_recovers_transient_fault_without_restore(gr, baselines):
    """Transient faults under the retry budget are absorbed in place: a
    host stage, and an in-place device stage whose injected fault raised
    before its body ran. No recovery cycle; the trajectory is untouched."""
    with tempfile.TemporaryDirectory() as d:
        inj = R.FaultInjector([R.FaultSpec("dataload", 2, "exception"),
                               R.FaultSpec("unique", 5, "exception"),
                               R.FaultSpec("emb_bwd", 3, "exception")])
        eng = _engine(gr, semi_async=True, schedule="algorithm1")
        recs = eng.run_resilient(
            N_STEPS, ckpt_dir=d, ckpt_every=3,
            policy=R.FaultPolicy(retries={"dataload": 2, "unique": 1,
                                          "emb_bwd": 1}),
            injector=inj)
        assert eng.recoveries == []
        kinds = [k for (k, _, _) in eng.fault_events]
        assert kinds.count("retry") == 3, eng.fault_events
        _assert_run(eng, recs, baselines[True])


def test_in_place_stage_failure_escalates_instead_of_retrying(gr,
                                                              baselines):
    """A failure raised inside the body of a stage that writes the state in
    place (here emb_bwd, after its AdamW and AdaGrad landed) is never
    retried, whatever the budget: it escalates to a restore, and the run
    still ends bit for bit. A pure stage's body failure is retried."""
    assert set(RETRY_SAFE_STAGES) == {"dataload", "a2a", "unique",
                                      "dense_bwd"}
    eng = _engine(gr, semi_async=True, schedule="algorithm1")
    inner = eng._hk_emb_bwd
    fired = []

    def emb_bwd(i, rec, **kw):
        out = inner(i, rec, **kw)
        if eng._resume_base + i == 4 and not fired:
            fired.append(i)
            raise RuntimeError("failure after the in-place landing")
        return out
    eng._hk_emb_bwd = emb_bwd
    with tempfile.TemporaryDirectory() as d:
        recs = eng.run_resilient(
            N_STEPS, ckpt_dir=d, ckpt_every=2,
            policy=R.FaultPolicy(retries={"emb_bwd": 3}))
        assert [k for k, _, _ in eng.fault_events].count("retry") == 0
        assert len(eng.recoveries) == 1
        assert eng.recoveries[0].restored_step == 4
        _assert_run(eng, recs, baselines[True])
    # the same failure in a pure stage's body is retried in place
    eng = _engine(gr, semi_async=True, schedule="flat")
    inner_bwd = eng._hk_dense_bwd
    fired.clear()

    def dense_bwd(i, art):
        if eng._resume_base + i == 5 and not fired:
            fired.append(i)
            raise RuntimeError("transient failure")
        return inner_bwd(i, art)
    eng._hk_dense_bwd = dense_bwd
    with tempfile.TemporaryDirectory() as d:
        recs = eng.run_resilient(
            N_STEPS, ckpt_dir=d, ckpt_every=2,
            policy=R.FaultPolicy(retries={"dense_bwd": 1}))
        assert eng.recoveries == []
        assert ("retry", "dense_bwd", 5) in eng.fault_events
        _assert_run(eng, recs, baselines[True])


def test_watchdog_flags_and_fails_stragglers(gr, baselines):
    """The port's watchdog: an injected delay over a stage's budget is a
    typed straggler event (action "record": no recovery, math untouched);
    with action "fail" it escalates to a recovery cycle, still bit for
    bit. A stage under its budget is never flagged."""
    for action, want_recoveries in (("record", 0), ("fail", 1)):
        with tempfile.TemporaryDirectory() as d:
            inj = R.FaultInjector(
                [R.FaultSpec("unique", 3, "delay", delay_s=0.5)])
            eng = _engine(gr, semi_async=True, schedule="algorithm1")
            recs = eng.run_resilient(
                N_STEPS, ckpt_dir=d, ckpt_every=2,
                policy=R.FaultPolicy(
                    retries={}, stage_timeout_s={"unique": 0.25},
                    straggler_action=action),
                injector=inj)
            stragglers = [e for e in eng.fault_events
                          if e[0] == "straggler"]
            assert stragglers == [("straggler", "unique", 3)], action
            assert len(eng.recoveries) == want_recoveries, action
            _assert_run(eng, recs, baselines[True], action)


@pytest.mark.parametrize("schedule", ["algorithm1", "flat"])
def test_nan_poison_recovers_bit_identical(gr, baselines, schedule):
    """A NaN-poisoned batch under nonfinite_action="recover" escalates to a
    restore; the replay (the poison fires once) is clean and the run ends
    bit for bit."""
    with tempfile.TemporaryDirectory() as d:
        inj = R.FaultInjector([R.FaultSpec("dense_fwd", 4, "nan")])
        eng = _engine(gr, semi_async=True, schedule=schedule)
        recs = eng.run_resilient(
            N_STEPS, ckpt_dir=d, ckpt_every=2,
            policy=R.FaultPolicy(retries={}, nonfinite_action="recover"),
            injector=inj)
        assert len(eng.recoveries) == 1
        assert "non-finite" in eng.recoveries[0].error
        assert ("nan_poison", "dense_fwd", 4) in eng.fault_events
        _assert_run(eng, recs, baselines[True], schedule)


def test_nan_skip_budget(gr, baselines):
    """nonfinite_action="skip" drops the poisoned batch's update under the
    skip budget (the step counter and the moments' count stay one behind,
    and the steps before the skip are the uninterrupted run's); the budget
    exhausting escalates instead of skipping forever."""
    b, batch, mk_state = gr
    with tempfile.TemporaryDirectory() as d:
        inj = R.FaultInjector([R.FaultSpec("dense_fwd", 3, "nan")])
        eng = _engine(gr, semi_async=True, schedule="algorithm1")
        recs = eng.run_resilient(
            N_STEPS, ckpt_dir=d, ckpt_every=4,
            policy=R.FaultPolicy(retries={}, nonfinite_action="skip",
                                 max_skips=2),
            injector=inj)
        assert eng.recoveries == []
        assert len(recs) == N_STEPS
        skipped = [r for r in recs if r.get("skipped")]
        assert [r["step"] for r in skipped] == [3]
        assert not np.isfinite(skipped[0]["loss"])
        assert all(np.isfinite(r["loss"]) for r in recs
                   if not r.get("skipped"))
        assert [r["loss"] for r in recs[:3]] == baselines[True][1][:3]
        assert ("skip_nonfinite", "dense_bwd", 3) in eng.fault_events
        assert eng.state.step == N_STEPS - 1
        assert eng.state.dense_opt.count == N_STEPS - 1
    with tempfile.TemporaryDirectory() as d:
        inj = R.FaultInjector([R.FaultSpec("dense_fwd", 3, "nan")])
        eng = _engine(gr, semi_async=True, schedule="algorithm1")
        with pytest.raises(R.NonFiniteLossError):
            eng.run_resilient(
                N_STEPS, ckpt_dir=d, ckpt_every=4,
                policy=R.FaultPolicy(retries={}, nonfinite_action="skip",
                                     max_skips=0, max_recoveries=0),
                injector=inj)


def test_persistent_fault_exhausts_recovery_budget(gr):
    """A fault that fires again on every replay stops after max_recoveries
    restore cycles, raising the original error."""
    faults = [R.FaultSpec("dense_fwd", 3, "exception") for _ in range(10)]
    with tempfile.TemporaryDirectory() as d:
        inj = R.FaultInjector(faults)
        eng = _engine(gr, semi_async=True, schedule="algorithm1")
        with pytest.raises(R.InjectedFault):
            eng.run_resilient(N_STEPS, ckpt_dir=d, ckpt_every=2,
                              policy=R.FaultPolicy(retries={},
                                                   max_recoveries=3),
                              injector=inj)
        assert len(eng.recoveries) == 3


def test_failed_restore_is_raised_not_masked(gr, monkeypatch):
    """A restore that fails itself (as one does after a sticky CUDA error,
    which poisons every later call on the card) ends the run with that
    error, chained to the stage failure that began the recovery; nothing
    retries it."""
    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    monkeypatch.setattr(CKPT, "restore_with_step", broken)
    with tempfile.TemporaryDirectory() as d:
        inj = R.FaultInjector([R.FaultSpec("dense_fwd", 5, "exception")])
        eng = _engine(gr, semi_async=True, schedule="algorithm1")
        with pytest.raises(RuntimeError, match="illegal memory") as e:
            eng.run_resilient(N_STEPS, ckpt_dir=d, ckpt_every=2,
                              policy=R.FaultPolicy(retries={}),
                              injector=inj)
        assert isinstance(e.value.__context__, R.InjectedFault)
        assert eng.recoveries == []


@pytest.mark.parametrize("schedule", ["algorithm1", "flat"])
def test_failure_before_first_checkpoint_replays_from_scratch(
        gr, baselines, schedule):
    """A fault before any checkpoint exists restores the run's initial
    state from its host copy (the state object was trained in place) and
    replays from step 0, bit for bit; no extra file is written for it."""
    with tempfile.TemporaryDirectory() as d:
        inj = R.FaultInjector([R.FaultSpec("dense_bwd", 2, "exception")])
        eng = _engine(gr, semi_async=True, schedule=schedule)
        recs = eng.run_resilient(N_STEPS, ckpt_dir=d, ckpt_every=100,
                                 policy=R.FaultPolicy(retries={}),
                                 injector=inj)
        assert len(eng.recoveries) == 1
        assert eng.recoveries[0].restored_step == 0
        _assert_run(eng, recs, baselines[True], schedule)
        assert sorted(os.listdir(d)) == ["LATEST", f"step_{N_STEPS}"]


def test_restored_engine_continues_bit_for_bit(gr):
    """A fresh engine restored from a resilient run's last checkpoint trains
    on to the same losses and state as the uninterrupted run continued."""
    b, batch, mk_state = gr
    st, losses = _flat(b, batch, mk_state(), N_STEPS + 2)
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(gr, semi_async=True, schedule="algorithm1")
        eng.run_resilient(N_STEPS, ckpt_dir=d, ckpt_every=4, keep_last_n=1)
        assert CKPT.intact_steps(d) == [N_STEPS]
        g = torch.Generator().manual_seed(5)
        fresh = gr_train_state(b.init_dense(g, device=CPU),
                               b.init_table(g, device=CPU))
        state, used = CKPT.restore_with_step(d, fresh)
        assert used == N_STEPS and state.step == N_STEPS
        eng2 = GREngine(b, lambda i: batch(i + N_STEPS), state=state,
                        loss_kwargs=LK, schedule="algorithm1")
        recs = eng2.run(2)
    assert [r["loss"] for r in recs] == losses[N_STEPS:]
    _assert_states_equal(st, eng2.state)


# --------------------------------------------------------------------------
# checkpoint crash consistency (the reference's cases, on the port's files)
# --------------------------------------------------------------------------

def _tree(v=1.0):
    return {"a": torch.arange(6.0).reshape(2, 3) * v,
            "b": {"c": torch.ones(4) * v}, "n": np.int32(7)}


def test_restore_falls_back_past_corrupt_saves():
    """A truncated leaf and a bit-flipped leaf (which still loads) are
    caught by the CRC; a missing manifest leaves the pointer dangling;
    an explicit step restores exactly or raises."""
    for damage in ("truncate", "flip", "manifest"):
        with tempfile.TemporaryDirectory() as d:
            CKPT.save(d, 1, _tree(1.0))
            CKPT.save(d, 2, _tree(2.0))
            victim = os.path.join(d, "step_2", "arr_0.npy")
            if damage == "truncate":
                with open(victim, "r+b") as f:
                    f.truncate(os.path.getsize(victim) // 2)
            elif damage == "flip":
                data = bytearray(open(victim, "rb").read())
                data[-1] ^= 0xFF
                open(victim, "wb").write(bytes(data))
            else:
                os.remove(os.path.join(d, "step_2", "manifest.msgpack"))
                assert CKPT.latest_step(d) == 1
            got, used = CKPT.restore_with_step(d, _tree())
            assert used == 1, damage
            torch.testing.assert_close(got["a"], _tree(1.0)["a"])
            assert int(got["n"]) == 7
            if damage != "manifest":
                with pytest.raises(CKPT.CheckpointCorrupt):
                    CKPT.restore(d, _tree(), step=2)


def test_latest_step_torn_pointer_falls_back():
    with tempfile.TemporaryDirectory() as d:
        assert CKPT.latest_step(d) is None
        assert CKPT.latest_step(os.path.join(d, "nope")) is None
        CKPT.save(d, 4, _tree())
        CKPT.save(d, 9, _tree())
        with open(os.path.join(d, "LATEST"), "w") as f:
            f.write("step_")                    # torn mid-write
        assert CKPT.latest_step(d) == 9
        with open(os.path.join(d, "LATEST"), "w") as f:
            f.write("step_12")                  # dangling pointer
        assert CKPT.latest_step(d) == 9
        os.remove(os.path.join(d, "LATEST"))    # pointer lost entirely
        assert CKPT.latest_step(d) == 9
        assert CKPT.intact_steps(d) == [9, 4]


def test_no_intact_checkpoint_raises():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            CKPT.restore(d, _tree())
        CKPT.save(d, 1, _tree())
        os.remove(os.path.join(d, "step_1", "manifest.msgpack"))
        with pytest.raises(FileNotFoundError):
            CKPT.restore(d, _tree())


def test_keep_last_n_retention_sync_and_async():
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            CKPT.save(d, s, _tree(float(s)), keep_last_n=2)
        assert CKPT.intact_steps(d) == [5, 4]
        assert CKPT.latest_step(d) == 5
        os.makedirs(os.path.join(d, ".tmp_step_9_x"))
        CKPT.save(d, 6, _tree(6.0), keep_last_n=2)
        assert CKPT.intact_steps(d) == [6, 5]
        assert not [n for n in os.listdir(d) if n.startswith(".tmp")]
    with tempfile.TemporaryDirectory() as d:
        ck = CKPT.AsyncCheckpointer(d, keep_last_n=1)
        ck.save_async(1, _tree(1.0))
        ck.wait()
        ck.save_async(2, _tree(2.0))
        ck.wait()
        assert CKPT.intact_steps(d) == [2]
        assert [s for s, _, _ in ck.snapshots] == [1, 2]


def test_async_snapshot_is_complete_before_the_caller_goes_on(gr):
    """The host copy is taken on the caller's thread: writing into the
    state right after ``save_async`` returns leaves the checkpoint as it
    was."""
    b, batch, mk_state = gr
    st = mk_state()
    want = clone_state(st)
    with tempfile.TemporaryDirectory() as d:
        ck = CKPT.AsyncCheckpointer(d)
        ck.save_async(0, st)
        st.table.master.add_(1.0)
        for p in st.dense.parameters():
            p.data.mul_(2)
        ck.wait()
        got = CKPT.restore(d, st)
    _assert_states_equal(want, got)


def test_simulate_torn_save_flavours_are_skipped():
    for tear in ("partial_dir", "truncated", "torn_latest", "bitflip"):
        with tempfile.TemporaryDirectory() as d:
            CKPT.save(d, 1, _tree(1.0))
            R.simulate_torn_save(d, 2, _tree(2.0), tear=tear)
            _, used = CKPT.restore_with_step(d, _tree())
            if tear == "torn_latest":
                assert used == 2 and CKPT.latest_step(d) == 2
            elif tear in ("truncated", "bitflip"):
                assert used == 1 and CKPT.latest_step(d) == 2
            else:
                assert used == 1 and CKPT.latest_step(d) == 1
            if tear == "bitflip":          # it loads; only the CRC refuses
                with pytest.raises(CKPT.CheckpointCorrupt, match="CRC"):
                    CKPT.restore(d, _tree(), step=2)


def test_resumed_run_keeps_no_anchor_and_recovers_from_its_step(
        gr, baselines, monkeypatch):
    """A run that starts where its directory already holds an intact step
    (a resumed run) keeps no host copy of its start: a fault before its
    first save restores that step instead, bit for bit."""
    b, batch, mk_state = gr
    with tempfile.TemporaryDirectory() as d:
        _engine(gr, semi_async=True).run_resilient(4, ckpt_dir=d,
                                                   ckpt_every=4)
        state = CKPT.restore(d, mk_state())
        eng = GREngine(b, batch, state=state, loss_kwargs=LK,
                       semi_async=True)
        copies = []
        snap = CKPT.snapshot
        monkeypatch.setattr(CKPT, "snapshot",
                            lambda *a, **kw: copies.append(1) or
                            snap(*a, **kw))
        inj = R.FaultInjector([R.FaultSpec("dense_fwd", 6, "exception")])
        recs = eng.run_resilient(N_STEPS, ckpt_dir=d, ckpt_every=100,
                                 final_save=False,
                                 policy=R.FaultPolicy(retries={}),
                                 injector=inj)
        assert copies == []                  # no anchor, no save
        assert [ev.restored_step for ev in eng.recoveries] == [4]
        st, losses = baselines[True]
        assert [r["step"] for r in recs] == list(range(4, N_STEPS))
        assert [r["loss"] for r in recs] == losses[4:]
        _assert_states_equal(st, eng.state)


def _host_need(eng, batch, keep_anchor=True):
    """What ``run_resilient`` counts before its first step: the saver's
    copy (the whole state, the carry at a row per id feature entry of the
    first batch), the checkpoint I/O buffers and the anchor (the state as
    it is)."""
    V = eng.state.table.master.shape[0]
    ids = sum(batch[k].size for k in ("ids", "labels", "neg_ids"))
    return (CKPT.host_nbytes(eng._full_layout(carry_rows=min(ids, V)))
            + CKPT.IO_BUFFER_BYTES
            + CKPT.host_nbytes(eng.state) * keep_anchor)


def test_run_resilient_refuses_a_host_too_small_for_its_copies(
        gr, monkeypatch):
    """Before its first step the run checks that the host holds what it
    will hold besides the state (the saver's copy, the checkpoint I/O
    buffers, the replay anchor until the first save is written) and raises
    a clear error naming them if it does not, rather than failing
    mid-run."""
    b, batch, _ = gr
    eng = _engine(gr, semi_async=True)
    nbytes = CKPT.host_nbytes(eng.state)
    assert nbytes == CKPT.snapshot(eng.state).nbytes
    need = _host_need(eng, batch(0))
    monkeypatch.setattr(CKPT, "host_available_bytes", lambda: need - 1)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(MemoryError, match="the saver's copy .* the "
                           "checkpoint I/O buffers .* the replay anchor "
                           "until the first save is written"):
            eng.run_resilient(N_STEPS, ckpt_dir=d)
        assert os.listdir(d) == [] and int(eng.state.step) == 0


@pytest.mark.parametrize("async_save", [True, False])
def test_fresh_run_recovers_within_the_counted_host_memory(
        gr, baselines, monkeypatch, async_save):
    """With the host's available memory exactly the run's count, a fresh
    run starts, and faults before its first save (the anchor) and after it
    (the step-4 checkpoint) recover bit for bit."""
    b, batch, _ = gr
    eng = _engine(gr, semi_async=True)
    monkeypatch.setattr(CKPT, "host_available_bytes",
                        lambda: _host_need(eng, batch(0)))
    inj = R.FaultInjector([R.FaultSpec("dense_fwd", 1, "exception"),
                           R.FaultSpec("dense_fwd", 6, "exception")])
    with tempfile.TemporaryDirectory() as d:
        recs = eng.run_resilient(N_STEPS, ckpt_dir=d, ckpt_every=4,
                                 keep_last_n=1, async_save=async_save,
                                 policy=R.FaultPolicy(retries={}),
                                 injector=inj)
    assert [ev.restored_step for ev in eng.recoveries] == [0, 4]
    _assert_run(eng, recs, baselines[True], f"async_save={async_save}")


def test_anchor_is_dropped_once_the_first_save_is_written(gr):
    """Once a save has been written the run keeps no copy of its start: a
    fault after every step directory is gone raises instead of replaying
    from scratch."""
    b, batch, _ = gr
    eng = _engine(gr, semi_async=True)
    with tempfile.TemporaryDirectory() as d:
        def lose_the_checkpoints(g, rec, state):
            if g == 5:
                for name in os.listdir(d):
                    shutil.rmtree(os.path.join(d, name), ignore_errors=True)
        eng.step_callback = lose_the_checkpoints
        inj = R.FaultInjector([R.FaultSpec("dense_fwd", 6, "exception")])
        with pytest.raises(FileNotFoundError):
            eng.run_resilient(N_STEPS, ckpt_dir=d, ckpt_every=4,
                              async_save=False,
                              policy=R.FaultPolicy(retries={}),
                              injector=inj)
    assert eng.recoveries == []


@pytest.mark.parametrize("tear", ["partial_dir", "bitflip"])
def test_torn_first_save_recovers_from_the_anchor(gr, baselines, tear):
    """A crash during the run's first save, whose wreckage either never
    becomes a step or is a step only its CRC refuses, leaves no intact
    step: the run replays from its anchor, bit for bit."""
    with tempfile.TemporaryDirectory() as d:
        inj = R.FaultInjector(
            [R.FaultSpec(R.SAVE_SITE, 4, "torn_save", tear=tear)])
        eng = _engine(gr, semi_async=True, schedule="algorithm1")
        recs = eng.run_resilient(N_STEPS, ckpt_dir=d, ckpt_every=4,
                                 keep_last_n=1,
                                 policy=R.FaultPolicy(retries={}),
                                 injector=inj)
        assert CKPT.intact_steps(d) == [N_STEPS]
    assert [ev.restored_step for ev in eng.recoveries] == [0]
    _assert_run(eng, recs, baselines[True], tear)


def test_corrupt_last_leaf_writes_nothing_and_falls_back(gr, monkeypatch):
    """A step whose last leaf has a flipped byte is refused before any
    leaf is copied into the state: an explicit restore of it raises and
    leaves every tensor of the template bitwise as it was; a restore of
    the newest step falls back to the previous one."""
    b, batch, mk_state = gr
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(gr, semi_async=True)
        eng.run_resilient(4, ckpt_dir=d, ckpt_every=2, keep_last_n=2)
        n = CKPT.read_manifest(os.path.join(d, "step_4"))["num_leaves"]
        victim = os.path.join(d, "step_4", f"arr_{n - 1}.npy")
        data = bytearray(open(victim, "rb").read())
        data[-1] ^= 0xFF
        open(victim, "wb").write(bytes(data))
        template = mk_state()
        before = clone_state(template)
        copies = []
        copy_in = CKPT._copy_in
        monkeypatch.setattr(CKPT, "_copy_in",
                            lambda *a: copies.append(1) or copy_in(*a))
        with pytest.raises(CKPT.CheckpointCorrupt, match="CRC mismatch"):
            CKPT.restore(d, template, step=4)
        assert copies == []
        _assert_states_equal(before, template)
        got, used = CKPT.restore_with_step(d, template)
        assert used == 2 and got.step == 2 and copies
        _assert_states_equal(CKPT.restore(d, mk_state(), step=2), got)


def test_host_nbytes_counts_pinned_buffers_as_the_allocator_rounds_them():
    """A card state's pinned host copy is counted leaf by leaf as the
    pinned-memory allocator holds it: each buffer rounded up to a power of
    two."""
    tree = {"a": np.zeros((3, 5), np.float32), "b": np.zeros(16, np.int32),
            "c": torch.zeros(7, dtype=torch.bfloat16)}
    assert CKPT.host_nbytes(tree) == 60 + 64 + 28
    assert CKPT.host_nbytes(tree, pinned=True) == 64 + 64 + 32


def test_all_finite_over_tensors():
    assert R.all_finite({"a": torch.ones(3), "b": [torch.zeros(2, 2),
                                                   torch.arange(3)]})
    assert not R.all_finite({"a": torch.tensor([1.0, float("nan")])})
    assert not R.all_finite([torch.tensor([float("inf")], dtype=torch.bfloat16)])
    assert R.all_finite({}) and R.all_finite(torch.arange(4))


# --------------------------------------------------------------------------
# across packages: the manifest, the leaves, restores both ways
# --------------------------------------------------------------------------

@pytest.mark.parametrize("obj", [
    {"step": 12, "treedef": "x", "num_leaves": 3, "shapes": [[2, 3], [], [0]],
     "dtypes": ["bfloat16", "int32", "float16"],
     "crc32s": [0, 0x7f, 0x80, 0xff, 0x100, 0xffff, 0x10000, 0xffffffff],
     "meta": {}},
    {"neg": [-1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
             -2 ** 63], "big": 2 ** 64 - 1, "f": [0.5, -1e300, 3.0],
     "b": [True, False, None], "s": "é" * 40 + "x" * 300,
     "long": list(range(70000)), "m": {str(i): i for i in range(20)},
     "bin": b"\x00\x01" * 200},
])
def test_manifest_msgpack_both_ways(obj):
    """The port's encoder writes the bytes ``msgpack.packb`` writes, and
    each package's decoder reads the other's."""
    ours = CKPT.packb(obj)
    theirs = msgpack.packb(obj)
    assert ours == theirs
    assert msgpack.unpackb(ours) == obj
    assert CKPT.unpackb(theirs) == obj
    assert CKPT.unpackb(msgpack.packb(obj, use_single_float=True)) == \
        msgpack.unpackb(msgpack.packb(obj, use_single_float=True))
    with pytest.raises(ValueError):
        CKPT.unpackb(ours[:-1])
    with pytest.raises(ValueError):
        CKPT.unpackb(ours + b"\x00")


def _ref_pair(rows="fp16_shadow"):
    """A reference state and the port's state holding the same values
    (reduced hstu-tiny, fp32 weights, ``rows``' shadow), and the numpy
    batches both train on (period 6)."""
    jq, pq = (None, None) if rows == "fp32" else (jnp.float16,
                                                  torch.float16)
    cj, cp = configs("float32", n_items=600, max_seq_len=32)
    cj, cp = cj.replace(num_negatives=N_NEG), cp.replace(num_negatives=N_NEG)
    key = jax.random.PRNGKey(0)
    jb = j_bundle(cj)
    dense, table = jb.init_dense(key), jb.init_table(key)
    batches = list(_loader(PLoader, PSynth, 600).batches(6))
    jstate = JT.gr_train_state(dense, table, qdtype=jq,
                               pending_slots=JT.gr_pending_slots(batches[0]))
    master = np.asarray(table)
    pstate = gr_train_state(
        gr_params_from_numpy(tree_numpy(dense), cp, device=CPU),
        shadowed_table_from_numpy(
            master, None if pq is None else master.astype(np.float16),
            np.zeros_like(master), device=CPU))
    jlk = dict(neg_mode="fused", neg_segment=SEG, fetch_dtype=jq)
    plk = dict(neg_segment=SEG, fetch_dtype=pq)
    return jb, GRBundle(cp), jstate, pstate, batches, jlk, plk


def _assert_same_state(ps, js, tol, what):
    """The port's state against the reference's within ``tol`` (a TOLS
    entry; exact when None)."""
    t = tol or {k: 0.0 for k in TOLS["fp32"]}
    _assert_trees(gr_params_to_numpy(ps.dense), tree_numpy(js.dense),
                  t["dense"], 0, f"{what} dense")
    opt = adamw_to_numpy(ps.dense_opt)
    assert opt["count"] == int(js.dense_opt.count) == ps.step == int(js.step)
    _assert_trees(opt["mu"], tree_numpy(js.dense_opt.mu), t["mu"], 0,
                  f"{what} mu")
    _assert_trees(opt["nu"], tree_numpy(js.dense_opt.nu), t["nu"], 0,
                  f"{what} nu")
    tb = table_to_numpy(ps.table)
    _assert_close(tb["master"], js.table.master, t["master"], 0,
                  f"{what} master")
    _assert_close(tb["accum"], js.table.accum, t["accum"], 0,
                  f"{what} accum")
    np.testing.assert_array_equal(tb["shadow"],
                                  tb["master"].astype(np.float16))
    np.testing.assert_array_equal(np.asarray(js.table.shadow),
                                  np.asarray(js.table.master,
                                             np.float16))
    pi, pr = pending_to_numpy(ps.pending_ids, ps.pending_rows)
    ji, jr = pending_to_numpy(torch.from_numpy(np.array(js.pending_ids)),
                              torch.from_numpy(np.array(js.pending_rows)))
    np.testing.assert_array_equal(pi, ji)
    _assert_close(pr, jr, t["rows"], 0, f"{what} pending rows")


def test_port_checkpoint_has_the_reference_leaves():
    """The same state saved by each package: the same leaf count, and leaf
    by leaf the same shape and dtype name in the manifest (the τ=1 carry
    aside: the reference's N slots against the port's compact pairs), and
    the same bytes in every leaf file but the carry's."""
    jb, pb, jstate, pstate, batches, jlk, plk = _ref_pair()
    with tempfile.TemporaryDirectory() as d:
        JCKPT.save(os.path.join(d, "ref"), 0, jstate)
        CKPT.save(os.path.join(d, "port"), 0, pstate)
        mj = CKPT.read_manifest(os.path.join(d, "ref", "step_0"))
        mp = msgpack.unpackb(open(os.path.join(
            d, "port", "step_0", "manifest.msgpack"), "rb").read())
        assert mp["num_leaves"] == mj["num_leaves"]
        assert mp["dtypes"] == mj["dtypes"]
        paths = mp["treedef"].split(":", 1)[1].split(",")
        carry = {paths.index("pending_ids"), paths.index("pending_rows")}
        assert carry == {mj["num_leaves"] - 3, mj["num_leaves"] - 2}
        assert [s for i, s in enumerate(mp["shapes"]) if i not in carry] \
            == [s for i, s in enumerate(mj["shapes"]) if i not in carry]
        i = paths.index("pending_ids")
        assert mp["shapes"][i] == [0] and mj["shapes"][i][0] > 0
        for i in range(mj["num_leaves"]):
            if i in carry:
                continue
            a = np.load(os.path.join(d, "ref", "step_0", f"arr_{i}.npy"))
            c = np.load(os.path.join(d, "port", "step_0", f"arr_{i}.npy"))
            assert a.dtype == c.dtype and a.shape == c.shape, i
            np.testing.assert_array_equal(a, c, err_msg=str(i))
        assert [c for i, c in enumerate(mp["crc32s"]) if i not in carry] \
            == [c for i, c in enumerate(mj["crc32s"]) if i not in carry]


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoints_cross_between_the_packages(direction):
    """One package trains 4 steps (τ=1, algorithm1) and saves; the other
    restores that checkpoint (exactly: the same values, the carry as a set
    of pairs) and trains 4 more; the first package, restored from the same
    checkpoint, trains the same 4. The two continuations stay within the
    training slice's fp16-shadow tolerances (``TOLS``; the reasons there):
    losses and every state field."""
    jb, pb, jstate, pstate, batches, jlk, plk = _ref_pair()
    tol = TOLS["fp16_shadow"]
    data = lambda k: (lambda i: batches[(k + i) % 6])     # noqa: E731
    with tempfile.TemporaryDirectory() as d:
        if direction == "reference_to_port":
            jeng = JEngine(jb, data(0), state=jstate, loss_kwargs=jlk)
            jeng.run(4)
            JCKPT.save(d, 4, jeng.state)
        else:
            peng = GREngine(pb, data(0), state=pstate, loss_kwargs=plk)
            peng.run(4)
            CKPT.save(d, 4, peng.state)
        g = torch.Generator().manual_seed(3)
        ptmpl = gr_train_state(pb.init_dense(g, device=CPU),
                               pb.init_table(g, device=CPU))
        jtmpl = JT.gr_train_state(
            jb.init_dense(jax.random.PRNGKey(3)),
            jb.init_table(jax.random.PRNGKey(3)),
            pending_slots=JT.gr_pending_slots(batches[0]))
        p4, pused = CKPT.restore_with_step(d, ptmpl)
        j4, jused = JCKPT.restore_with_step(d, jtmpl)
    assert pused == jused == 4
    _assert_same_state(p4, j4, None, "restored")
    peng = GREngine(pb, data(4), state=p4, loss_kwargs=plk)
    pl = [r["loss"] for r in peng.run(4)]
    jeng = JEngine(jb, data(4), state=j4, loss_kwargs=jlk)
    jl = [r["loss"] for r in jeng.run(4)]
    np.testing.assert_allclose(pl, jl, rtol=0, atol=tol["loss"])
    _assert_same_state(peng.state, jeng.state, tol, "trained on")


def test_cli_checkpoints_then_resumes_on_cpu(capsys, tmp_path):
    """``--ckpt-dir`` with telemetry, then ``--resume`` to more steps: the
    resumed run prints ``[resume] restored intact checkpoint step N`` and
    its losses are the uninterrupted run's; the trace and both metrics
    formats parse."""
    import json
    base = ["--device", "cpu", "--arch", "hstu-tiny", "--synthetic-users",
            "200", "--num-items", "2000", "--max-seq-len", "32",
            "--num-negatives", "4", "--log-every", "2", "--peak-flops",
            "1e12"]
    ck = str(tmp_path / "ck")
    full = cli.main(base + ["--steps", "6"])
    first = cli.main(base + ["--steps", "4", "--ckpt-dir", ck,
                             "--ckpt-every", "2", "--keep-last-n", "1",
                             "--trace-out", str(tmp_path / "t.json"),
                             "--metrics-out", str(tmp_path / "m.json"),
                             "--metrics-every", "2"])
    out = capsys.readouterr().out
    assert "[obs] step     2  mfu" in out and "[obs] pipeline goodput" in out
    assert CKPT.intact_steps(ck) == [4]
    trace = json.load(open(tmp_path / "t.json"))
    assert {e["ph"] for e in trace["traceEvents"]} >= {"M", "X"}
    snap = json.load(open(tmp_path / "m.json"))
    assert snap["train_steps_total"]["values"][""] == 4.0
    rest = cli.main(base + ["--steps", "6", "--ckpt-dir", ck, "--resume",
                            "--metrics-out", str(tmp_path / "m.prom")])
    out = capsys.readouterr().out
    assert "[resume] restored intact checkpoint step 4" in out
    assert [r["loss"] for r in first + rest] == [r["loss"] for r in full]
    assert "# TYPE train_steps_total counter" in open(
        tmp_path / "m.prom").read()
