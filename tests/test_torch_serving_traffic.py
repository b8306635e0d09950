"""Random open-loop traffic through the port's ``StreamingRecallEngine`` on
the CPU (the kernels' plain versions), every user a tick encoded held to a
cold encode of its history bit for bit (``tests/torch_stream_traffic.py``;
the same traffic runs at full depth on the card in
``tests/test_torch_gpu.py``).

A file of its own: the suite runs with ``--dist loadfile``, so this, its
longest test, gets a worker of its own instead of setting the pace of the
streaming engine's other tests."""
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread per worker)
from repro_torch.serving import StreamingRecallEngine
from test_torch_serving_stream import _tiny
from torch_stream_traffic import drive


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_random_traffic_warm_equals_cold(dtype):
    """Random open-loop traffic (new users, hits, 1-3-event appends, bursts
    of three, evictions and full resends; rows crossing positions 128 and
    256) through the engine: after every tick each user it encoded holds a
    cold encode's embedding and live K/V of every layer bit for bit."""
    cfg, model, table = _tiny(dtype, seq=300)
    eng = StreamingRecallEngine(cfg, model, table, max_users=12, k=10,
                                retrieval_block=128, max_rows_per_tick=4,
                                device="cpu")
    out = drive(eng, np.random.default_rng(1), 60)
    assert out["warm_rows"] >= 20 and out["cold_rows"] >= 20, out
    assert out["evictions"] > 0 and out["checked"] > 0, out
    assert out["resends"] > 0, out
    assert out["over_128"] > 0 and out["over_256"] > 0, out
