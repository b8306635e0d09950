"""The port's autotune harness (``repro_torch.kernels.autotune``) against
the reference's (``repro.kernels.autotune``) on the same inputs, each
package pointed at a temporary store through its own environment variable
(``REPRO_TORCH_TUNED_JSON``, ``REPRO_TUNED_JSON``): shape buckets, the
store's layout, ``resolve`` on missing, corrupt, stale and valid entries,
the cache on a rewrite, a measured sweep through the obs layer; the port's
knobs (K9-fwd's row split, the fused path's ``scatter_impl``) and the
wrappers that consult the store."""
import json
import os

import numpy as np
import pytest
import torch

from repro.kernels import autotune as JA
from repro_torch.kernels import autotune as PA
from repro_torch.kernels.neg_logits import (TableGradSink, fused_recall_lse,
                                            fwd_row_split)
from repro_torch.obs import MetricsRegistry, Tracer

NEG_DIMS = {"segment": 16, "R": 8, "D": 16, "T": 64, "expansion": 2}
K9_DIMS = {"T": 8192, "R": 128, "D": 1024, "o": "bfloat16", "n": "bfloat16"}


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    """Each package's store in a temporary file of its own."""
    mine, ref = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    monkeypatch.setenv("REPRO_TORCH_TUNED_JSON", mine)
    monkeypatch.setenv("REPRO_TUNED_JSON", ref)
    return mine, ref


@pytest.mark.parametrize("dims", [
    {"T": 4096}, {"T": 4097}, {"R": 32}, {"causal": True},
    {"a": 1, "b": 2}, {"b": 2, "a": 1}, NEG_DIMS, K9_DIMS,
    {"T": 257, "R": 256, "segment": 128, "n": "float16"}])
def test_shape_bucket_matches_reference(dims):
    assert PA.shape_bucket(dims) == JA.shape_bucket(dims)


def test_store_layout_matches_reference(stores):
    """The same entry saved by both: the same JSON but for the backend in
    the key; the port's backend key is ``cpu`` here and ``cuda-sm90`` on
    the H100."""
    mine, ref = stores
    stats = {"seconds": 1e-3, "trials": 2}
    pk = PA.TunedStore().put("neg_fused", NEG_DIMS,
                             {"scatter_impl": "two_pass"},
                             backend="cuda-sm90", stats=stats)
    s = PA.TunedStore()
    s.put("neg_fused", NEG_DIMS, {"scatter_impl": "two_pass"},
          backend="cuda-sm90", stats=stats)
    s.save()
    j = JA.TunedStore()
    jk = j.put("neg_fused", NEG_DIMS, {"scatter_impl": "two_pass"},
               backend="tpu", stats=stats)
    j.save()
    assert pk.rsplit("|", 1) == [jk.rsplit("|", 1)[0], "cuda-sm90"]
    got, want = json.load(open(mine)), json.load(open(ref))
    assert got["version"] == want["version"] == 1
    assert got["entries"][pk] == want["entries"][jk]
    assert open(mine).read() == open(ref).read().replace("tpu", "cuda-sm90")
    assert PA.TunedStore.key("neg_fused", NEG_DIMS).endswith(
        "|" + PA.default_backend())
    assert PA.default_backend() == ("cpu" if not torch.cuda.is_available()
                                    else PA.backend_of("cuda"))


def _both(knob="scatter_impl", dims=NEG_DIMS):
    return (PA.resolve("neg_fused", dims, knob, backend="cpu"),
            JA.resolve("neg_fused", dims, knob, backend="cpu"))


@pytest.mark.parametrize("case", ["missing", "corrupt", "not_a_dict",
                                  "stale", "valid", "other_backend"])
def test_resolve_scatter_impl_matches_reference(stores, case):
    """``resolve`` of ``neg_fused.scatter_impl`` gives the reference's
    answer on a missing, corrupt, stale (a value no longer valid) and
    valid entry, and on an entry stored for another backend."""
    mine, ref = stores
    for path, mod in ((mine, PA), (ref, JA)):
        if case == "corrupt":
            open(path, "w").write("{not json")
        elif case == "not_a_dict":
            json.dump({"version": 1, "entries": "nope"}, open(path, "w"))
        elif case != "missing":
            value = "magic" if case == "stale" else "two_pass"
            backend = "cuda-sm90" if case == "other_backend" else "cpu"
            st = mod.TunedStore()
            st.put("neg_fused", NEG_DIMS, {"scatter_impl": value},
                   backend=backend)
            st.save()
    got, want = _both()
    assert got == want == ("two_pass" if case == "valid" else "fused")


def test_cache_invalidated_on_rewrite(stores):
    for mod in (PA, JA):
        st = mod.TunedStore()
        for value in ("two_pass", "fused", "two_pass"):
            st.put("neg_fused", NEG_DIMS, {"scatter_impl": value},
                   backend="cpu")
            st.save()
            assert mod.resolve("neg_fused", NEG_DIMS, "scatter_impl",
                               backend="cpu") == value


def test_resolve_is_memoised_until_save_or_clear(stores):
    """``resolve`` answers from its memo (a wrapper consults it at every
    launch): a store rewritten behind its back is read after
    ``clear_cache()``; a save through ``TunedStore`` drops the memo."""
    mine, _ = stores
    assert PA.resolve("neg_fused", NEG_DIMS, "scatter_impl",
                      backend="cpu") == "fused"
    key = PA.TunedStore.key("neg_fused", NEG_DIMS, "cpu")
    json.dump({"version": 1, "entries": {key: {
        "config": {"scatter_impl": "two_pass"}, "stats": {}}}},
        open(mine, "w"))
    assert PA.resolve("neg_fused", NEG_DIMS, "scatter_impl",
                      backend="cpu") == "fused"
    PA.clear_cache()
    assert PA.resolve("neg_fused", NEG_DIMS, "scatter_impl",
                      backend="cpu") == "two_pass"
    st = PA.TunedStore()
    st.put("neg_fused", NEG_DIMS, {"scatter_impl": "fused"}, backend="cpu")
    st.save()
    assert PA.resolve("neg_fused", NEG_DIMS, "scatter_impl",
                      backend="cpu") == "fused"


def test_port_never_reads_the_reference_store(stores, monkeypatch):
    """The port's store is its own: a winner in the reference's store (or
    the port's default path, with its variable unset) changes nothing."""
    _, ref = stores
    j = JA.TunedStore()
    j.put("neg_fused", NEG_DIMS, {"scatter_impl": "two_pass"}, backend="cpu")
    j.save()
    assert PA.resolve("neg_fused", NEG_DIMS, "scatter_impl",
                      backend="cpu") == "fused"
    monkeypatch.delenv("REPRO_TORCH_TUNED_JSON")
    assert PA.default_path() != JA.default_path()
    assert PA.default_path().endswith(os.path.join("repro_torch", "kernels",
                                                   "tuned.json"))


def test_committed_store_is_empty():
    """The store the port reads by default holds no entry, so no launch's
    knob moves unless a sweep was run and saved."""
    path = os.path.join(os.path.dirname(PA.__file__), "tuned.json")
    assert json.load(open(path)) == {"entries": {}, "version": 1}


def test_sweep_records_and_persists(stores):
    """A CPU sweep: every candidate measured as spans on track
    ``autotune``, the trials sorted by time, the metrics published, the
    winner stored and read back by ``resolve`` (as the reference's)."""
    mine, _ = stores
    x = torch.ones(32, 8)

    def run_fn(cfg):
        return lambda: x * float(cfg["row_split"])

    tracer, metrics = Tracer(enabled=True), MetricsRegistry()
    dims = dict(K9_DIMS, T=128)
    res = PA.sweep("neg_logits_fwd", dims, run_fn, iters=2, warmup=0,
                   tracer=tracer, metrics=metrics, device="cpu")
    splits = sorted(t["config"]["row_split"] for t in res["trials"])
    assert splits == [1, 2, 4]                  # 8 · 32 > R = 128
    secs = [t["seconds"] for t in res["trials"]]
    assert secs == sorted(secs) and res["best"] == res["trials"][0]
    spans = [s for s in tracer.spans() if s.track == "autotune"]
    assert len(spans) == 2 * 3
    assert {s.name for s in spans} == {"neg_logits_fwd:" +
                                       PA.shape_bucket(dims)}
    snap = metrics.snapshot()
    assert "autotune_trial_seconds" in snap
    assert any(k.startswith("autotune_neg_logits_fwd") for k in snap)
    stored = json.load(open(mine))
    assert res["key"] in stored["entries"]
    assert stored["entries"][res["key"]]["stats"]["trials"] == 3
    assert PA.resolve("neg_logits_fwd", dims, "row_split",
                      default=fwd_row_split(128, 128)) == \
        res["best"]["config"]["row_split"]
    # the reference's sweep over the same candidates stores the same layout
    jr = JA.sweep("lookup_gather", {"n": 32, "D": 8, "itemsize": 4},
                  lambda c: (lambda: x * c["rows_per_step"]), top_k=2,
                  iters=2, warmup=0, tracer=None, metrics=None)
    assert set(jr) == set(res) and set(jr["best"]) >= set(res["best"])


@pytest.mark.parametrize("R,accept,reject", [
    (128, [1, 2, 4], [0, 8, 3.0, True, "2", None]),
    (256, [1, 2, 4, 8], [16, -1]),
    (8, [1], [2, 4])])
def test_knob_valid_row_split(R, accept, reject):
    """K9-fwd's split: any positive int with split · 32 rows ≤ R, and 1
    always (the split every result equals); the heuristic's choice is
    always valid."""
    dims = dict(K9_DIMS, R=R)
    for v in accept:
        assert PA.knob_valid("neg_logits_fwd", dims, "row_split", v), v
    for v in reject:
        assert not PA.knob_valid("neg_logits_fwd", dims, "row_split", v), v
    for T in (1, 128, 8192):
        assert PA.knob_valid("neg_logits_fwd", dims, "row_split",
                             fwd_row_split(T, R))
    assert [c["row_split"] for c in PA.enumerate_candidates(
        "neg_logits_fwd", dims)] == accept[:4]


def test_knob_valid_scatter_impl_matches_reference():
    for v in ("fused", "two_pass", "magic", None, 1):
        assert (PA.knob_valid("neg_fused", NEG_DIMS, "scatter_impl", v)
                == JA.knob_valid("neg_fused", NEG_DIMS, "scatter_impl", v))
    assert PA.enumerate_candidates("neg_fused", NEG_DIMS) == [
        {"scatter_impl": "fused"}, {"scatter_impl": "two_pass"}]
    assert not PA.knob_valid("attn_worklist", {}, "pairs_per_step", 1)


def _fused(scatter_impl=None):
    g = torch.Generator().manual_seed(0)
    T, R, D, V = 64, 8, 16, 50
    o = torch.randn(T, D, generator=g)
    pos = torch.randn(T, generator=g)
    table = torch.randn(V, D, generator=g)
    ids = torch.randint(0, V, (T, R), generator=g)
    sink = TableGradSink(extra_rows=0)
    o.requires_grad_()
    lse = fused_recall_lse(o, pos, table, ids, segment=16, expansion=2,
                           generator=torch.Generator().manual_seed(1),
                           scatter_impl=scatter_impl, table_grad_pairs=sink)
    lse.sum().backward()
    return sink


def test_fused_path_takes_scatter_impl_from_the_store(stores):
    """``fused_recall_lse`` without a ``scatter_impl`` takes the stored
    one for its shape (here the CPU's key): the factored form by default,
    the built rows when ``two_pass`` is stored; an explicit argument
    wins."""
    assert _fused().neg is not None                     # fused: factored
    st = PA.TunedStore()
    st.put("neg_fused", NEG_DIMS, {"scatter_impl": "two_pass"},
           backend="cpu")
    st.save()
    two = _fused()
    assert two.neg is None and two.rows.shape == (64 * 8, 16)
    assert _fused("fused").neg is not None
    w, o, scale = _fused("fused").neg
    rows = (w[:64, :, None] * (o[:64].float() * scale)[:, None]).reshape(
        -1, 16)
    np.testing.assert_array_equal(rows.detach().numpy(), two.rows.numpy())
