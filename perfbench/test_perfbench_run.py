"""A whole run of a cell on the CPU at a tiny size, the look for a chip
skipped: the result line's keys, the checks beside their limits, and
``correct`` false whenever the timed path underneath is broken."""
import io
import json
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from perfbench import common, run, tiny, train

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def _threads(monkeypatch):
    # A test worker also runs the JAX package's tests, which load JAX in
    # this process; the import check has tests of its own in fresh
    # interpreters (test_perfbench_imports.py).
    monkeypatch.setattr(common, "forbidden_loaded", lambda names=None: [])
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cell(name):
    w = common.cell(name)
    return w, tiny.config(w["config"]), tiny.mix(w["traffic"])


def execute(name, seed, trace=False, fault=None, seconds=1.0):
    w, cfg, mix = cell(name)
    return run.execute(w, cfg, mix, seed, seconds, trace,
                       time.perf_counter(), CPU, fault=fault)


def test_result_line_keys_untraced():
    res = execute("hstu_large.train_long", 2 ** 31 + 3)
    assert list(res) == KEYS + ["checks"]
    want = [m["name"] for m in common.metrics_of("hstu_large.train_long",
                                                 "end_to_end")]
    assert sorted(res["metrics"]) == sorted(want)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["checks"]) == set(common.limits("hstu_large.train_long"))
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        common.emit(dict(res))
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and list(line)[:5] == KEYS
    tail = err.getvalue().strip().splitlines()[-len(res["checks"]):]
    assert all(t.startswith("[check] ") for t in tail)


def test_result_line_keys_traced():
    res = execute("hstu_large.train_short", 11, trace=True)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    names = {m["name"] for m in common.metrics_of("hstu_large.train_short",
                                                  "per_layer")}
    assert set(res["metrics"]) <= names
    assert "engine.free_share.train" in res["metrics"]


@pytest.mark.parametrize("fault", train.FAULTS)
def test_train_fault_is_not_correct(fault):
    res = execute("hstu_large.train_long", 5, fault=fault)
    assert res["correct"] is False, res["checks"]


def test_serve_altered_answer_is_not_correct():
    res = execute("hstu_large.serve_open", 5, fault="altered_answer",
                  seconds=2.0)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["served_gap"]["value"] > \
        res["checks"]["served_gap"]["limit"]


def test_serve_result_line():
    res = execute("hstu_large.serve_open", 2 ** 31 + 9, seconds=2.0)
    assert list(res) == KEYS + ["checks"]
    assert res["attempted"] >= 40 and res["failed"] == 0
    assert res["metrics"]["serve_p95_ms"]["value"] > 0
