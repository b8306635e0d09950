"""The port's kernel build (``repro_torch.kernels._build``) without nvcc:
every source's local includes lie under ``csrc/``, a library's name
follows its source, the shared headers and the flags, and the flags keep
the precise math the plain versions are held to."""
import re
import shutil

import pytest

from repro_torch.kernels import _build

INCLUDE_RE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_local_includes_are_in_csrc(name):
    src = (_build.CSRC / _build.SOURCES[name]).read_text()
    for header in INCLUDE_RE.findall(src):
        assert (_build.CSRC / header).is_file(), (name, header)
        assert header.endswith(".cuh"), (name, header)


def test_attention_sources_share_the_time_bias():
    """K1-fwd and K2 compute the time bias from one header, so the two
    cannot drift apart; neither source defines it again."""
    for name in ("jagged_attn_fwd", "jagged_attn_bwd"):
        src = (_build.CSRC / _build.SOURCES[name]).read_text()
        assert '#include "time_bias.cuh"' in src, name
        assert "time_bucket(int qt" not in src, name
        assert "functional_E(int qt" not in src, name


@pytest.mark.parametrize("edit", ["source", "header", "flags", "none"])
def test_library_path_follows_source_headers_and_flags(tmp_path, monkeypatch,
                                                      edit):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    if edit == "source":
        with open(csrc / _build.SOURCES["runsum"], "a") as f:
            f.write("\n// edited\n")
    elif edit == "header":
        with open(csrc / "time_bias.cuh", "a") as f:
            f.write("\n// edited\n")
    elif edit == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-g"])
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    changed = {n for n in _build.SOURCES if after[n] != before[n]}
    want = {"source": {"runsum"}, "header": set(_build.SOURCES),
            "flags": set(_build.SOURCES), "none": set()}[edit]
    assert changed == want


def test_flags_keep_precise_math():
    """The functional bias and the time bucket need IEEE division and the
    precise logf/expf to agree with their plain versions."""
    flags = " ".join(_build.NVCC_FLAGS)
    for fast in ("fast-math", "fast_math", "ftz=true", "prec-div=false",
                 "prec-sqrt=false"):
        assert fast not in flags, fast
    assert "sm_90a" in flags
