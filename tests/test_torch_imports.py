"""The port stands alone: it imports no jax and nothing of the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as PC
from repro_torch.convert import gr_params_from_numpy, table_from_numpy
from repro_torch.models.gr import GRModel
from repro_torch.serving import RecallEngine

ROOT = Path(__file__).resolve().parents[1]
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")

_GUARDED = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import repro_torch
from repro_torch.configs import get_arch, reduced
from repro_torch.models.gr import GRModel
from repro_torch.serving import RecallEngine
cfg = reduced(get_arch("hstu-tiny")).replace(vocab_size=300, max_seq_len=40)
g = torch.Generator().manual_seed(0)
model = GRModel(cfg, device="cpu", generator=g)
master = torch.randn(cfg.vocab_size, cfg.d_model, generator=g) * 0.02
eng = RecallEngine(cfg, model, master, num_shards=2, users_per_shard=2,
                   k=5, retrieval_block=128, device="cpu")
rng = np.random.default_rng(0)
reqs = [(u, rng.integers(0, 300, 9 + u), np.arange(9 + u) * 7)
        for u in range(5)]
res = eng.serve(reqs)
assert len(res) == 5 and all(np.isfinite(r.user_emb).all() for r in res)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK", eng.encoded_batches)
"""


def test_port_runs_with_jax_and_reference_blocked():
    out = subprocess.run([sys.executable, "-c", _GUARDED, str(ROOT / "src")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def test_source_has_no_jax_or_reference_imports():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if IMPORT_RE.match(line)]
    assert not bad, bad


def _cfg():
    return PC.reduced(PC.get_arch("hstu-tiny")).replace(vocab_size=64)


def _cpu_model():
    return GRModel(_cfg(), device="cpu",
                   generator=torch.Generator().manual_seed(0))


ENTRY_POINTS = {
    "GRModel": lambda: GRModel(_cfg()),
    "RecallEngine": lambda: RecallEngine(_cfg(), _cpu_model(),
                                         torch.zeros(64, 128)),
    "gr_params_from_numpy": lambda: gr_params_from_numpy({}, _cfg()),
    "table_from_numpy": lambda: table_from_numpy(np.zeros((4, 2),
                                                          np.float32)),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """device=None means CUDA; with no card the entry point raises rather
    than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()
