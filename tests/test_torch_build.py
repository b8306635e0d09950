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
                   "attn_bwd_kv_tc_kernel<D, FUNC, CAUSAL>",
                   "attn_bwd_q_tc_kernel<D, FUNC, CAUSAL>",
                   "std::is_same<T, __nv_bfloat16>"):
        assert needle in src, needle


def _with_local_headers(name):
    """A source's text followed by the text of the local headers it
    includes, where the primitives it calls are written out."""
    src = (_build.CSRC / _build.SOURCES[name]).read_text()
    return "\n".join([src] + [(_build.CSRC / h).read_text()
                              for h in INCLUDE_RE.findall(src)])


def test_attention_forward_bf16_products_on_tensor_cores():
    """K1-fwd's bf16 kernel takes both products from the tensor cores
    (mma.sync fed by ldmatrix, .trans for v, the K and V sub-tiles brought
    in by cp.async), a goes from the accumulators to the A operand without
    a shared-memory tile, and the launcher sends bf16 to it and fp32 to the
    FMA kernel, which remains."""
    src = (_build.CSRC / _build.SOURCES["jagged_attn_fwd"]).read_text()
    full = _with_local_headers("jagged_attn_fwd")
    for needle in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "ldmatrix.sync.aligned", ".trans", "cp.async.cg"):
        assert needle in full, needle
    for needle in ("attn_fwd_tc_kernel<D, FUNC, APPEND, CAUSAL>",
                   "attn_fwd_kernel<T, D, FUNC, APPEND, CAUSAL>",
                   "std::is_same<T, __nv_bfloat16>", "mma16816(", "ldsm_x4(",
                   "ldsm_x4_t(", "cp_async16(", "fmaf("):
        assert needle in src, needle
    assert "a_s[" not in src.split("attn_fwd_tc_kernel", 1)[1]


def test_append_launch_is_the_cold_kernels_with_the_pack_meta_in_place():
    """K1-fwd's append launch is the same two kernels instantiated with
    APPEND: one epilogue (the live test, the bias, SiLU, the weight's
    rounding) serves both launches, and only the meta, the q tile, the
    walk and the output rows are taken another way."""
    src = (_build.CSRC / _build.SOURCES["jagged_attn_fwd"]).read_text()
    assert 'extern "C" int jagged_attn_fwd_append(' in src
    assert "launch_dtype<float, true, true>" in src
    assert "launch_dtype<__nv_bfloat16, true, true>" in src
    for kernel in ("attn_fwd_kernel(", "attn_fwd_tc_kernel("):
        body = src.split(kernel, 1)[1].split("\n}\n", 1)[0]
        assert body.count("if constexpr (APPEND)") >= 4, kernel
        assert body.count("qseg") >= 2 and "window_seg(" in body, kernel
        # one live test for both launches
        assert body.count("const bool live = ") == 1, kernel


def test_neg_logits_forward_keeps_one_warp_sum_per_logit():
    """K9-fwd's logits keep their bits whatever its grid: each is one
    warp's sum (lanes in order, then a fixed xor tree) scaled by
    __fmul_rn; the grid takes the wrapper's split."""
    src = (_build.CSRC / _build.SOURCES["neg_logits"]).read_text()
    fwd = src.split("neg_logits_fwd_kernel", 1)[1].split(
        "neg_logits_bwd_kernel", 1)[0]
    for needle in ("__shfl_xor_sync", "__fmul_rn(acc[j], inv_tau)",
                   "acc[j] = fmaf(ov[e], to_f32(el[e]), acc[j])",
                   "blockIdx.x / split"):
        assert needle in fwd, needle


def _kernel_body(name, kernel):
    """The text of ``kernel``'s definition in source ``name``: from its
    name up to the next function at the top level."""
    src = (_build.CSRC / _build.SOURCES[name]).read_text()
    body = src.split(f"\n{kernel}(", 1)[1]
    return re.split(r"\n(?:template <|cudaError_t |__device__ )", body)[0]


def test_neg_bwd_gathers_each_row_once_with_the_two_pass_arithmetic():
    """K4 gathers the table's rows at one site, into its ring (no second
    pass, no segment_logits), keeps no (seg, R) logit or weight array, and
    keeps the arithmetic of the two-pass kernel it replaced: the logit's
    fmaf order, xor tree and 1/tau, the weight expression and its fold
    over the consumers, and dout's __fmul_rn/__fadd_rn sum in r order."""
    body = _kernel_body("neg_fused", "neg_bwd_kernel")
    assert len(re.findall(r"\btable\b", body)) == 2, "one gather site"
    assert body.count("stage_row<TT, NCH>(") == 1
    assert "segment_logits<" not in body
    for gone in ("float* lg", "float* ws", "lg[", "ws["):
        assert gone not in body, gone
    for needle in ("part = fmaf(ov[i], x[i], part)",
                   "__fmul_rn(warp_sum(part), inv_tau)",
                   "float wv = g_t * expf(l - lse_t)",
                   "const float masked = valid_t ? l : NEG_POOL",
                   "fold += g_s[c] * expf(masked - lse_s[c])",
                   "wv += fold",
                   "acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(wv, x[i]), "
                   "inv_tau))",
                   "dpos[tok] = g_t * expf(pos[tok] - lse_t)",
                   "cp_async_wait<STAGES - 1>()"):
        assert needle in body, needle


def test_neg_logits_backward_splits_rows_and_keeps_dn_product():
    """K9-bwd adds its row groups' do partials through shared memory in
    group order (no atomic), takes gs = g * inv_tau first and rounds dn's
    product once (__fmul_rn); the wrapper's split reaches the kernel."""
    body = _kernel_body("neg_logits", "neg_logits_bwd_kernel")
    for needle in ("gs_s[r] = __fmul_rn(g[(size_t)t * R + r], inv_tau)",
                   "d[e] = __fmul_rn(gs, ov[e])",
                   "acc[e] = fmaf(gs, to_f32(el[e]), acc[e])",
                   "for (int y = 1; y < split; ++y)", "__syncthreads()"):
        assert needle in body, needle
    assert not re.search(r"atomic|\bred\.|\batom\.", body)
    src = (_build.CSRC / _build.SOURCES["neg_logits"]).read_text()
    assert "BWD_COLS * split" in src


def test_cached_library_keeps_its_build_log(tmp_path, monkeypatch):
    """A library built by an earlier process reports the nvcc/ptxas output
    kept beside it (what chip_smoke.py's register and spill check reads),
    and "cached" when there is none."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    lib = _build.library_path("runsum")
    lib.write_bytes(b"")
    assert _build.build_all(["runsum"])["runsum"]["log"] == "cached"
    lib.with_suffix(".log").write_text("ptxas info    : Used 40 registers")
    assert "40 registers" in _build.build_all(["runsum"])["runsum"]["log"]
