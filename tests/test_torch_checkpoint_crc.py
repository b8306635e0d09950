"""The checkpoint's CRC32s on threads (``training/checkpoint.py``): a leaf
larger than ``CRC_SPLIT_BYTES`` is checksummed in segments of whole pieces
on ``CRC_THREADS`` threads and the CRCs combined; ``manifest_of`` records
what a save would, from the state itself (no host copy of a card state).
Small pieces here, so that a small table is cut in segments. No jax."""
import os
import zlib

import numpy as np
import pytest
import torch

import repro_torch.configs as PC
from repro_torch.models.model_zoo import GRBundle
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import gr_train_state

torch.set_num_threads(1)


@pytest.fixture
def small_pieces(monkeypatch):
    monkeypatch.setattr(CKPT, "PIECE_BYTES", 1 << 12)
    monkeypatch.setattr(CKPT, "CRC_SPLIT_BYTES", 4 << 12)


def _state(seed=0, vocab=3000):
    cfg = PC.reduced(PC.get_arch("hstu-tiny")).replace(vocab_size=vocab)
    b = GRBundle(cfg)
    g = torch.Generator().manual_seed(seed)
    return gr_train_state(b.init_dense(g, device="cpu"),
                          b.init_table(g, device="cpu"))


def _whole_crcs(snap):
    return [zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
            for a in snap.arrays]


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 5 * 4096 + 7,
                               64 * 4096])
def test_segments_cover_the_leaf_and_combine(small_pieces, n):
    segs = CKPT._segments(n)
    assert segs[0][0] == 0 and segs[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    assert all(lo % CKPT.PIECE_BYTES == 0 for lo, _ in segs)
    a = np.frombuffer(np.random.default_rng(n).bytes(n), np.uint8)
    assert CKPT._leaf_crcs([a]) == [zlib.crc32(a)]


def test_manifest_of_is_what_a_save_records(small_pieces, tmp_path):
    st = _state()
    m = CKPT.manifest_of(st)
    snap = CKPT.snapshot(st)
    assert m["crc32s"] == _whole_crcs(snap) == CKPT.crc32s(CKPT.snapshot(st))
    assert m["shapes"] == [list(s) for s in snap.shapes]
    assert m["dtypes"] == list(snap.dtypes)
    assert CKPT.manifest_of(CKPT.snapshot(st)) == m
    CKPT.save(str(tmp_path), 2, st)
    saved = CKPT.read_manifest(os.path.join(tmp_path, "step_2"))
    assert saved["crc32s"] == m["crc32s"]


def test_restore_checks_segments_and_refuses_a_flipped_byte(small_pieces,
                                                            tmp_path):
    st = _state(1)
    CKPT.save(str(tmp_path), 3, st)
    got, used = CKPT.restore_with_step(str(tmp_path), _state(2))
    assert used == 3
    assert torch.equal(got.table.master, st.table.master)
    d = os.path.join(tmp_path, "step_3")
    path = max((os.path.join(d, f) for f in os.listdir(d)
                if f.endswith(".npy")), key=os.path.getsize)
    assert os.path.getsize(path) > CKPT.CRC_SPLIT_BYTES
    with open(path, "r+b") as f:       # a byte in the last segment
        f.seek(os.path.getsize(path) - 100)
        b = f.read(1)
        f.seek(os.path.getsize(path) - 100)
        f.write(bytes([b[0] ^ 0x5A]))
    fresh = _state(2)
    before = fresh.table.master.clone()
    with pytest.raises(CKPT.CheckpointCorrupt, match="CRC mismatch"):
        CKPT.restore_with_step(str(tmp_path), fresh, step=3)
    assert torch.equal(fresh.table.master, before)
