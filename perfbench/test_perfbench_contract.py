"""BENCHMARK.json keeps to the benchmark's rules, and the harness finds
every configuration, mix, limit and metric reader by name."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import common
from perfbench.traffic import gen

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][0] == "python3"
    assert all(not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_and_units():
    names = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[sec]:
            assert NAME.match(e["name"]), e["name"]
            names.append((sec, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for k in ("why", "layer", "source"):
                if k in e and k != "source" or (k == "source"
                                                and sec == "configs"):
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_metrics_keep_to_the_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            assert w in cells
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in common.metrics_of(w["name"], "end_to_end",
                                                    BENCH)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert common.metrics_of(w["name"], "per_layer", BENCH)


def test_everything_is_found_by_name():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        cfg = common.config(c["name"], BENCH)
        assert cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        mix = gen.load_mix(w["traffic"])
        assert mix["kind"] in ("train", "serve")
        assert common.limits(w["name"])
    for m in BENCH["per_layer"]:
        mod = common.metric_reader(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"],
                                                    m["moves"])
        assert callable(mod.read)


def test_layers_are_named_alike():
    by = {}
    for m in BENCH["per_layer"]:
        by.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by.values())


def test_a_new_metric_is_found_as_a_file(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "HERE", tmp_path)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x.new_metric.train.py").write_text(
        "LAYER = 'device'\nUNIT = 'ms'\nMOVES = 'setup_s'\n"
        "def read(ctx):\n    return ctx['v'] * 2\n")
    assert common.metric_reader("x.new_metric.train").read({"v": 2}) == 4


def test_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                        "--workload", BENCH["workloads"][0]["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
