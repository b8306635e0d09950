"""§4.2.1 HSP (``repro_torch/core/hsp.py``) against the reference
(``repro.core.hsp``): ``unique_accumulate`` on the same ids in process;
the lookup's forward and backward, the grad wire dtypes and Eq. 1 over
four AdaGrad steps in worlds of gloo rank processes on the CPU (meshes
(data 2, model 2) and (1, 4), and the global-sharding baseline on (2, 2)),
against ``jnp.take``, ``jax.grad`` and the reference's ``adagrad_update``
computed here on the full table.

Tolerances: the forward is bitwise (each row has one owner, fp32 and bf16
casts round the same way); grads 1e-4 and weights and AdaGrad states 1e-5,
the reference's own limits (``tests/test_hsp.py``: fp32 sums in another
order); bf16 and int8 wire grads 0.02 and 0.05 of the largest grad
(``test_grad_wire_compression_dtypes``; the port compresses twice, within
the group and across replicas, each rounding at most 2^-8 or 1/254 of a
row's largest value). The data replicas' Eq.-1 states are held bit for
bit."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hsp as JH
from repro_torch.core import hsp as PH
from repro_torch.launch import mesh as M

import torch_parity  # noqa: F401  (one intra-op thread per process)

HERE = os.path.dirname(os.path.abspath(__file__))
V, D, LR = 64, 8, 0.1
CAP = 10                        # unique grad rows a rank may send


def test_unique_accumulate_matches_reference():
    """Duplicates, −1s, ids past the table and a capacity below the
    distinct count: the same ids, the same row sums (1e-5: sums in another
    order), the same −1 fill."""
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 40, 200).astype(np.int32)
    ids[:5] = [5000, 5000, -1, 39, 0]             # past any table, repeats
    rows = rng.standard_normal((200, 6)).astype(np.float32)
    for num_out in (None, 200, 17):
        ju, jr = JH.unique_accumulate(jnp.asarray(ids), jnp.asarray(rows),
                                      num_out)
        pu, pr = PH.unique_accumulate(torch.from_numpy(ids),
                                      torch.from_numpy(rows), num_out)
        np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), atol=1e-5)
    t = rng.standard_normal((40, 6)).astype(np.float32)
    got = PH.scatter_add_rows(torch.from_numpy(t), torch.from_numpy(ids),
                              torch.from_numpy(rows))
    want = JH.scatter_add_rows(jnp.asarray(t), jnp.asarray(ids),
                               jnp.asarray(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    g = rng.standard_normal((40, 6)).astype(np.float32)
    a = np.abs(rng.standard_normal((40, 6))).astype(np.float32)
    pw, pa = PH.adagrad_update(torch.from_numpy(t), torch.from_numpy(a),
                               torch.from_numpy(g), LR)
    jw, ja = JH.adagrad_update(jnp.asarray(t), jnp.asarray(a),
                               jnp.asarray(g), LR)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), atol=1e-6)


def _inputs(tmp):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((V, D)).astype(np.float32)
    odd = rng.integers(0, V, (8, 16)).astype(np.int32)
    odd[0, :4] = [-1, V, V + 7, -1]               # zeros, row V−1 twice
    z = dict(table=table, ids=rng.integers(0, V, (8, 16)).astype(np.int32),
             odd_ids=odd, lr=LR, cap=CAP,
             eq1_table=rng.standard_normal((V // 2, 4)).astype(np.float32),
             eq1_ids=[rng.integers(0, V // 2, (8, 16)).astype(np.int32)
                      for _ in range(4)],
             eq1_tgt=[rng.standard_normal((8, 16, 4)).astype(np.float32)
                      for _ in range(4)])
    path = os.path.join(tmp, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(z, f)
    return z, path


def _start(tmp, shape, arms, store):
    run_dir = os.path.join(tmp, "x".join(map(str, shape)))
    z, path = _inputs(tmp)
    out = os.path.join(run_dir, "out{rank}.pkl")
    procs = M.spawn_ranks("torch_hsp_ranks:lookup_cases",
                          dict(inputs=path, out=out, arms=list(arms)),
                          shape=shape, run_dir=run_dir, device="cpu",
                          timeout_s=30, store=store, sys_path=[HERE])
    return z, procs, out


def _collect(z, procs, out):
    rcs = M.wait_ranks(procs, 120)
    assert rcs == [0] * len(procs), M.rank_logs(os.path.dirname(out),
                                                len(procs))
    res = []
    for r in range(len(procs)):
        with open(out.format(rank=r), "rb") as f:
            res.append(dict(pickle.load(f), run_dir=os.path.dirname(out)))
    return z, res


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, run side by side: one over a FileStore, one over a
    TCP store on a free port."""
    tmp = str(tmp_path_factory.mktemp("hsp"))
    started = {(2, 2): _start(tmp, (2, 2), ("hsp", "global"), "file"),
               (1, 4): _start(tmp, (1, 4), ("hsp",), "tcp")}
    return {k: _collect(*s) for k, s in started.items()}


CASES = [((2, 2), "hsp"), ((1, 4), "hsp"), ((2, 2), "global")]


def _ref_grad(table, ids):
    return np.asarray(jax.grad(lambda t: jnp.sum(jnp.sin(
        jnp.take(t, ids, axis=0))))(jnp.asarray(table)))


@pytest.mark.parametrize("shape,arm", CASES)
def test_lookup_forward_backward(worlds, shape, arm):
    """Each rank's rows of ``emb`` bit for bit ``jnp.take``'s (fp32; bf16
    through the cast; ids < 0 zero, ids ≥ V row V − 1); its shard's grad of
    sum(sin(emb)) within 1e-4 of ``jax.grad``'s rows."""
    z, res = worlds[shape]
    table, world = z["table"], len(res)
    per = 8 // world
    gref = _ref_grad(table, z["ids"])
    odd = z["odd_ids"]
    want_odd = np.where((odd >= 0)[..., None],
                        table[np.clip(odd, 0, V - 1)], 0).astype(np.float32)
    want_bf = np.asarray(jnp.asarray(want_odd).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    for r, rr in enumerate(res):
        got = rr[arm]
        rows = slice(r * per, (r + 1) * per)
        want = np.asarray(jnp.take(jnp.asarray(table),
                                   jnp.asarray(z["ids"][rows]), axis=0))
        np.testing.assert_array_equal(got["emb"], want)
        np.testing.assert_array_equal(got["odd_fp32"], want_odd[rows])
        np.testing.assert_array_equal(got["odd_bf16"], want_bf[rows])
        lo = got["lo"]
        np.testing.assert_allclose(got["grad"],
                                   gref[lo:lo + got["grad"].shape[0]],
                                   atol=1e-4)


@pytest.mark.parametrize("shape,arm", CASES)
def test_grad_wire_compression_dtypes(worlds, shape, arm):
    z, res = worlds[shape]
    gref = _ref_grad(z["table"], z["ids"])
    scale = np.abs(gref).max()
    limits = {"float32": 1e-6, "bfloat16": 0.02, "int8": 0.05}
    for rr in res:
        lo = rr[arm]["lo"]
        for name, g in rr[arm]["wire"].items():
            err = np.abs(g - gref[lo:lo + g.shape[0]]).max() / scale
            assert err < limits[name], (name, err)


@pytest.mark.parametrize("shape,arm", CASES)
def test_unique_capacity_bounds_each_rank_message(worlds, shape, arm):
    """``unique_capacity``: each rank sends the grads of its CAP smallest
    distinct ids only (the reference's capacity drops the rest); the
    shard's grad is the sum of what was sent (1e-4, fp32 sums)."""
    z, res = worlds[shape]
    table, world = z["table"], len(res)
    per = 8 // world
    want = np.zeros_like(table)
    for r in range(world):
        ids = z["ids"][r * per:(r + 1) * per].reshape(-1)
        keep = np.isin(ids, np.unique(ids)[:CAP])
        np.add.at(want, ids[keep], np.cos(table[ids[keep]]))
    for rr in res:
        lo = rr[arm]["lo"]
        g = rr[arm]["capped"]
        np.testing.assert_allclose(g, want[lo:lo + g.shape[0]], atol=1e-4)


@pytest.mark.parametrize("shape,arm", CASES)
def test_adagrad_state_identity_across_groups(worlds, shape, arm):
    """Eq. 1: four AdaGrad steps through the HSP lookup equal centralized
    training (the reference's ``adagrad_update`` on ``jax.grad`` of the
    full table) within 1e-5, and the data replicas of each shard hold the
    same bits."""
    z, res = worlds[shape]
    w, acc = jnp.asarray(z["eq1_table"]), jnp.zeros_like(z["eq1_table"])
    for ids, tgt in zip(z["eq1_ids"], z["eq1_tgt"]):
        g = jax.grad(lambda t: jnp.mean((jnp.take(t, ids, axis=0) - tgt)
                                        ** 2))(w)
        w, acc = JH.adagrad_update(w, acc, g, LR)
    w, acc = np.asarray(w), np.asarray(acc)
    by_lo = {}
    for rr in res:
        got = rr[arm]
        lo, n = got["eq1_lo"], got["eq1_master"].shape[0]
        np.testing.assert_allclose(got["eq1_master"], w[lo:lo + n], atol=1e-5)
        np.testing.assert_allclose(got["eq1_accum"], acc[lo:lo + n],
                                   atol=1e-5)
        if lo in by_lo:                 # another replica of the shard
            np.testing.assert_array_equal(got["eq1_master"], by_lo[lo][0])
            np.testing.assert_array_equal(got["eq1_accum"], by_lo[lo][1])
        by_lo[lo] = (got["eq1_master"], got["eq1_accum"])
    if arm == "hsp" and shape == (2, 2):
        assert len(by_lo) == 2          # two shards, two replicas each


def test_lookup_bytes_hsp_below_global(worlds):
    """Table 4's axis as byte counts: on (2, 2) the lookup exchange of the
    HSP arm (a group of 2) sends fewer bytes over the ranks than global
    sharding (a group of 4), and never to more than its group's peers."""
    _, res = worlds[(2, 2)]
    total = {arm: sum(rr[arm]["stats"][k]["bytes"] for rr in res
                      for k in ("lookup_ids", "lookup_rows"))
             for arm in ("hsp", "global")}
    assert total["hsp"] < total["global"], total
    assert max(rr["hsp"]["stats"]["lookup_rows"]["peers"] for rr in res) == 1
    assert "grad_replicas" in res[0]["hsp"]["stats"]
    assert "grad_replicas" not in res[0]["global"]["stats"]


def test_tcp_store_world_and_timed_exchange(worlds):
    """The (1, 4) world met over a TCP store on a free port (its spec names
    ``tcp://localhost:<port>``, no FileStore), and every exchange kind of
    every rank carries its bytes beside its time: ``wait_s`` (the device's
    queue) and ``seconds`` (the exchange), both ≥ 0, and some time in each
    kind that made calls."""
    import json
    _, res = worlds[(1, 4)]
    for rr in res:
        for k, s in rr["hsp"]["stats"].items():
            assert s["seconds"] >= 0 and s["wait_s"] >= 0, (k, s)
            if s["calls"]:
                assert s["seconds"] + s["wait_s"] > 0, (k, s)
    spec = json.load(open(os.path.join(res[0]["run_dir"], "spec.json")))
    assert spec["mesh"]["init_method"].startswith("tcp://localhost:")
    assert "store_dir" not in spec["mesh"]
