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


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_sources_sum_without_atomics(name):
    """Every kernel's sums are taken in a fixed order, so its results are
    the same bits from run to run: no source uses an atomic add."""
    src = (_build.CSRC / _build.SOURCES[name]).read_text()
    assert not re.search(r"\batomic[A-Z]\w*\(|[\s\"](red|atom)\.", src), name


def test_attention_backward_bf16_products_on_tensor_cores():
    """K2's bf16 kernels take their products from the tensor cores
    (mma.sync fed by ldmatrix, the chunks brought in by cp.async), and the
    launcher sends bf16 to them and fp32 to the FMA kernels."""
    src = (_build.CSRC / _build.SOURCES["jagged_attn_bwd"]).read_text()
    for needle in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "ldmatrix.sync.aligned", ".trans", "cp.async.cg",
                   "attn_bwd_kv_tc_kernel<D, FUNC>",
                   "attn_bwd_q_tc_kernel<D, FUNC>",
                   "std::is_same<T, __nv_bfloat16>"):
        assert needle in src, needle
