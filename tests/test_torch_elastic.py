"""Elastic restart over a sharded table (``repro_torch/training/elastic.py``)
in worlds of gloo rank processes on the CPU: ``viable_mesh_shape`` against
the reference's on a grid; a node drop (4 ranks, 2 of which exit at step
5) recovered by the supervisor on 1 × 2 from the step-3 checkpoint, bit
for bit the run that shrank from 4 ranks to 2 at step 3 without a fault
(losses and the final checkpoint's CRC32s); typed straggler events at
step 0; a 4-rank checkpoint restored by the single-process port and by the
reference (the same bits in every leaf); ``reshard`` of a full state."""
import os
import pickle
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.models.model_zoo import get_bundle as j_bundle
from repro.training import checkpoint as JCKPT
from repro.training import trainer as JT
from repro.training.elastic import viable_mesh_shape as j_viable
from repro_torch.convert import (gr_params_from_numpy, gr_params_to_numpy,
                                 unshard_table_states)
from repro_torch.launch import mesh as M
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import gr_train_state
from repro_torch.training.elastic import (ElasticRunner, reshard,
                                          viable_mesh_shape)
from test_torch_hsp_engine import LK, R, VOCAB, _batches
from torch_parity import configs, tree_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
BUILD = dict(arch="hstu-tiny", reduce=True,
             overrides=dict(vocab_size=512, max_seq_len=32, num_negatives=8),
             data=dict(users=60, mean_len=30, max_len=80, users_per_device=2,
                       max_seq_len=32, seed=3),
             loss_kwargs=dict(neg_segment=32))


def test_viable_mesh_shape_matches_reference():
    for n in list(range(1, 40)) + [240, 255, 256, 512]:
        for mp in (1, 2, 3, 4, 8, 16):
            assert viable_mesh_shape(n, mp) == j_viable(n, mp), (n, mp)


def _runner(d, **kw):
    return ElasticRunner("repro_torch.training.elastic:build_gr_engine", d,
                         build_kwargs=BUILD, model_parallel=2, ckpt_every=3,
                         device="cpu", mesh_timeout_s=30,
                         segment_deadline_s=240, **kw)


def test_node_drop_recovers_bit_for_bit(tmp_path):
    """4 ranks (data 2 × model 2), 2 of which exit when step 5 begins: the
    survivors' collectives fail, the supervisor restarts on
    ``viable_mesh_shape(2, 2)`` = 1 × 2 from the newest intact checkpoint
    (step 3) and runs to step 8. Against the run that saved at step 3 on 4
    ranks and went on from it on 2 with no fault: the same losses, the same
    CRC32 in every leaf of the step-8 checkpoint."""
    crash = _runner(str(tmp_path / "crash"))
    assert crash.run(8, world=4, fail_at={5: 2}) == 8
    assert crash.events == [("node_failure", 5), ("recovery", 3)]
    assert crash.failures == [5]
    first, second = crash.segments
    assert first["world"] == 4 and second["world"] == 2
    assert first["rcs"][2:] == [0, 0] and all(first["rcs"][:2])
    assert second["rcs"] == [0, 0] and second["shape"] == (1, 2)
    clean = _runner(str(tmp_path / "clean"))
    clean.run(3, world=4)
    clean.run(8, world=2)
    assert clean.events == []
    assert [r["world"] for r in clean.records] == [4] * 3 + [2] * 5
    assert [r["step"] for r in crash.records] == list(range(8))
    assert [r["loss"] for r in crash.records] == \
        [r["loss"] for r in clean.records]
    m = [CKPT.read_manifest(str(tmp_path / k / "step_8"))
         for k in ("crash", "clean")]
    assert m[0]["crc32s"] == m[1]["crc32s"]


def test_typed_straggler_events_at_step0(tmp_path):
    r = _runner(str(tmp_path), step_timeout_s=1e-9)
    r.model_parallel = 1
    r.run(2, world=1)
    assert {k for k, _ in r.events} == {"straggler"}
    assert ("straggler", 0) in r.events
    assert r.failures == []


@pytest.fixture(scope="module")
def four_rank_checkpoint(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ckpt4"))
    cj, cp = configs("float32", n_items=VOCAB, max_seq_len=32)
    cj, cp = cj.replace(num_negatives=R), cp.replace(num_negatives=R)
    key = jax.random.PRNGKey(0)
    jb = j_bundle(cj)
    dense, table = jb.init_dense(key), np.asarray(jb.init_table(key))
    z = dict(arch="hstu-tiny", dense=tree_numpy(dense), master=table,
             batches=_batches(4, 3), loss_kwargs=LK,
             overrides=dict(vocab_size=VOCAB, max_seq_len=32,
                            dtype="float32", num_negatives=R))
    path = os.path.join(tmp, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(z, f)
    out = os.path.join(tmp, "out{rank}.pkl")
    ckpt = os.path.join(tmp, "ckpt")
    procs = M.spawn_ranks("torch_hsp_ranks:save_and_dump",
                          dict(inputs=path, out=out, ckpt_dir=ckpt, steps=3),
                          shape=(2, 2), run_dir=os.path.join(tmp, "ranks"),
                          device="cpu", timeout_s=60, sys_path=[HERE])
    rcs = M.wait_ranks(procs, 240)
    assert rcs == [0] * 4, M.rank_logs(os.path.join(tmp, "ranks"), 4)
    parts = []
    for r in range(4):
        with open(out.format(rank=r), "rb") as f:
            parts.append(pickle.load(f))
    return dict(cj=cj, cp=cp, ckpt=ckpt, z=z,
                full=unshard_table_states(parts, (2, 2)))


def test_four_rank_checkpoint_restores_single_process(four_rank_checkpoint):
    """The single-process port restores the 4-rank save (step 3): master,
    accumulator, τ=1 carry and dense params bit for bit the ranks'."""
    c = four_rank_checkpoint
    full = c["full"]
    g = torch.Generator().manual_seed(5)
    from repro_torch.models.model_zoo import GRBundle
    b = GRBundle(c["cp"])
    tmpl = gr_train_state(b.init_dense(g, device=CPU),
                          b.init_table(g, device=CPU), qdtype=None)
    st, used = CKPT.restore_with_step(c["ckpt"], tmpl)
    assert used == 3 and st.step == 3 and st.dense_opt.count == 3
    np.testing.assert_array_equal(st.table.master.numpy(), full["master"])
    np.testing.assert_array_equal(st.table.accum.numpy(), full["accum"])
    np.testing.assert_array_equal(st.pending_ids.numpy(),
                                  full["pending_ids"])
    np.testing.assert_array_equal(st.pending_rows.numpy(),
                                  full["pending_rows"])
    for n, p in st.dense.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), full["dense"][n])
    assert full["pending_ids"].size > 0


def test_four_rank_checkpoint_restores_in_the_reference(
        four_rank_checkpoint):
    """The reference restores the same 4-rank save: the same master,
    accumulator and dense params, the carry as the same (id, row) pairs."""
    c = four_rank_checkpoint
    full = c["full"]
    jb = j_bundle(c["cj"])
    key = jax.random.PRNGKey(7)
    tmpl = JT.gr_train_state(jb.init_dense(key), jb.init_table(key),
                             qdtype=None, pending_slots=JT.gr_pending_slots(
                                 c["z"]["batches"][0]))
    js, used = JCKPT.restore_with_step(c["ckpt"], tmpl)
    assert used == 3 and int(js.step) == 3
    np.testing.assert_array_equal(np.asarray(js.table.master), full["master"])
    np.testing.assert_array_equal(np.asarray(js.table.accum), full["accum"])
    ids = np.asarray(js.pending_ids)
    keep = ids >= 0
    order = np.argsort(ids[keep], kind="stable")
    np.testing.assert_array_equal(ids[keep][order], full["pending_ids"])
    np.testing.assert_array_equal(np.asarray(js.pending_rows)[keep][order],
                                  full["pending_rows"])
    model = gr_params_from_numpy(tree_numpy(js.dense), c["cp"], device=CPU)
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), full["dense"][n])
    assert gr_params_to_numpy(model).keys() == tree_numpy(js.dense).keys()


def test_reshard_takes_the_rank_rows_and_carry():
    """``reshard`` of a full state: rows [lo, hi) of each table tensor,
    the carry's pairs of those rows with shard-relative ids, the dense
    params copied (the full state untouched)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.model_zoo import GRBundle
    cfg = reduced(get_arch("hstu-tiny")).replace(vocab_size=64)
    b = GRBundle(cfg)
    g = torch.Generator().manual_seed(0)
    st = gr_train_state(b.init_dense(g, device=CPU),
                        b.init_table(g, device=CPU))
    st = st._replace(pending_ids=torch.tensor([3, 17, 40, 63],
                                              dtype=torch.int32),
                     pending_rows=torch.arange(4 * cfg.d_model,
                                               dtype=torch.float32)
                     .reshape(4, -1))
    hsp = SimpleNamespace(mesh=SimpleNamespace(device=CPU),
                          shard_range=lambda V: (32, 64))
    part = reshard(st, hsp)
    assert torch.equal(part.table.master, st.table.master[32:])
    assert torch.equal(part.table.shadow, st.table.shadow[32:])
    assert part.pending_ids.tolist() == [8, 31]
    assert torch.equal(part.pending_rows, st.pending_rows[2:])
    assert part.dense is not st.dense
    assert st.table.master.shape[0] == 64


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_reshard_and_convert_split_a_state_alike(shape):
    """One ownership rule (``core/hsp.py`` ``shard_bounds`` and
    ``carry_span``, ``launch/mesh.py`` ``group_index``): for every rank,
    ``reshard`` of a torch state and ``convert.shard_table_state`` of the
    same state as numpy give the same rows and carry pairs, bit for bit,
    and a rank's draw of its rows alone (``GRBundle.init_table(rows=)``)
    equals its rows of the whole table's draw."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.convert import shard_table_state
    from repro_torch.core.hsp import shard_bounds
    from repro_torch.models.model_zoo import GRBundle
    cfg = reduced(get_arch("hstu-tiny")).replace(vocab_size=64)
    b = GRBundle(cfg)
    g = torch.Generator().manual_seed(0)
    st = gr_train_state(b.init_dense(g, device=CPU),
                        b.init_table(g, device=CPU))
    ids = torch.tensor([0, 3, 15, 16, 17, 40, 47, 48, 63], dtype=torch.int32)
    st = st._replace(pending_ids=ids, pending_rows=torch.randn(
        len(ids), cfg.d_model, generator=torch.Generator().manual_seed(1)))
    full = dict(master=st.table.master.numpy(),
                shadow=st.table.shadow.numpy(),
                accum=st.table.accum.numpy(),
                pending_ids=ids.numpy(),
                pending_rows=st.pending_rows.numpy())
    for r in range(int(np.prod(shape))):
        idx, size = M.group_index(r, shape, ("model",))
        hsp = SimpleNamespace(mesh=SimpleNamespace(device=CPU),
                              shard_range=lambda V: shard_bounds(V, idx,
                                                                 size))
        part = reshard(st, hsp)
        want = shard_table_state(full, r, shape)
        assert want["lo"] == hsp.shard_range(64)[0]
        for k in ("master", "shadow", "accum"):
            np.testing.assert_array_equal(
                getattr(part.table, k).numpy(), want[k])
        np.testing.assert_array_equal(part.pending_ids.numpy(),
                                      want["pending_ids"])
        np.testing.assert_array_equal(part.pending_rows.numpy(),
                                      want["pending_rows"])
        g = torch.Generator().manual_seed(0)
        b.init_dense(g, device=CPU)
        alone = b.init_table(g, device=CPU, rows=hsp.shard_range(64))
        assert torch.equal(alone, st.table.master[slice(
            *hsp.shard_range(64))])
