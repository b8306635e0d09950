#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from anywhere: ``python3 chip_smoke.py``.

Phases, each printed on its own lines; any failure exits non-zero. Every
phase starts with gc, ``torch.cuda.empty_cache()`` and a line giving
``torch.cuda.memory_allocated()``: two full-vocab tables do not fit on
one card, so each phase frees its own.

  1. device  — the card's name, count, power limit, maximum SM clock; no
               card is a failure.
  2. build   — nvcc builds every CUDA source of the port from this
               checkout (one nvcc per source, all started together);
               cuobjdump shows K1-fwd's and K2's bf16 kernels on the tensor
               cores (HMMA in their SASS) and their fp32 kernels on the FMA
               path; ptxas shows no spill in K1-fwd's bf16 kernels.
  3. kernels — every kernel of the serving and training paths against its
               plain PyTorch version on the card, at the paths' shapes, with
               its time beside its bound: K1-fwd and K2 (attention forward
               and backward; H=8, D=128, block 128; bf16 and fp32; a
               long-tail pack of G=2 shards of 8192 tokens, a pack with
               empty rows beside an all-padding shard, and the engine's
               training pack of 1 shard x 4 users x 2048, where fp32 is
               held to the float64 plain version) in both time modes,
               HSTU's bucket table and FuXi's functional encoder (amp ~1,
               sigma = exp(linspace(2, 12)), rho from linspace(-2, 2)), K3/K4
               (the fused negative path; T=8192 tokens, R=128, d 1024, bf16
               o, fp16 shadow of 2^22 rows, invalid tokens, expansion 1 and
               4), K6 (the sorted run-sum; ~1.06 M rows of 1024 on a mix of
               run lengths) and K5 (the weighted run-sum scatter, on the
               same ids: ~1.05 M negative slots generated from bf16 o and
               ~16 K ready rows), K5 also bitwise against two-pass rows + K6
               and beside its library call (cuSPARSE SpMM) and on the same
               slots without its long runs; K2 also split by kernel (the
               profiler); K8 (the dense-
               grid schedule of K1-fwd/K2) on K1/K2's inputs, bitwise
               against them; K9 (logits over materialised negative rows,
               T=8192, R=128, d 1024, bf16 and fp16 rows, and a 128-token
               segment timed on the profiler's device clock) and K7 (the
               lookup's row gather, 8192 ids with -1s from the fp32 master
               of 2^22 rows to bf16), beside their library calls.
  4. serve   — RecallEngine on full-width hstu-large (vocab 2^22, fp32
               master + fp16 shadow on the card, 16 layers, bf16) serves a
               cold, a pure-hit and an incremental round; the kernels'
               launch counts are zeroed just before and read just after
               each round. serve_fuxi: the same on full-width fuxi-large
               (d_ff 2368, the functional time encoder).
  4b. stream — StreamingRecallEngine (64 slots, 32 rows a tick, k 100) on
               full-width hstu-large with prefix reuse: the norms' row
               statistics at 1-32 rows against 32768 (none may differ),
               warmup, then the
               serve trace's cold, pure-hit and incremental rounds and two
               more chained append rounds (1 event; 3 events with one row
               crossing a 128-row block), launch counts zeroed before and
               read after each (a cold encode: one K1-fwd launch per layer;
               a warm one: one append launch per layer); after each append
               round every appended user's embedding and live K/V of all
               layers held bit for bit to a from-scratch cold encode; the
               append launch against its plain version (bf16 and fp32) at
               the round's shapes; both engines against an fp32 encode of
               the same histories and against each other (STREAM_TOL:
               per-row relative L2, top-100 overlap, the "sure" ids); the
               rank step's CUDA graph against the eager rank step,
               bitwise; an open-loop run (Poisson arrivals, OPEN_LOOP_MIX,
               the proportions of examples/serve_recall.py) at two
               multiples of the closed-loop rate, with warm == cold held
               bit for bit on the users it appended to. Then fuxi-large and
               sasrec-large through the flat, cold-only path (FuXi: K1-fwd's
               functional mode; SASRec: no kernel).
  5. train   — make_gr_train_step on full-width hstu-large (16 layers,
               vocab 2^22; fp32 master, fp32 AdaGrad accumulator and fp16
               shadow on the card) over the port's GRLoader on synthetic
               KuaiRand (1 shard x 4 users x 2048 events, R=128), with the
               two-pass negative scatter (K6's path): 3 sync steps, then 3
               tau=1 steps, launch counts zeroed before and read after each
               step; then one profiled step.
  6. engine  — the main path of the training entry point: GREngine on the
               same model and loader mix with the default fused scatter
               (K5), tau=1, 8 steps of the Algorithm-1 pipeline with launch
               counts zeroed before and read after, then 6 more under the
               profiler (a steady-state window), then 8 steps of the flat
               schedule from the same init, which must give the same
               losses bit for bit. engine_fuxi: the same on full-width
               fuxi-large, 6 steps a schedule.
  6b. ablation — the §4.3 / Table-7 ablation on hstu-large, the engine's
               loader mix: the first step's loss from one init and batch in
               the fused, segmented and baseline modes; GREngine
               (Algorithm 1, tau=1) 6 steps with the baseline path (K9),
               the kernel lookup (K7) and the dense-grid attention (K8),
               and 6 steps with the segmented path and sharing (K9 per
               segment), each with launch counts, step walls and the peak
               above the state.
  7. parity  — at full width, 2 layers, vocab 2^18: one training step's
               dense pass and table-grad pairs with the kernels against the
               plain versions on the card (hstu-large two-pass and fused,
               fuxi-large fused with the functional RAB grads, with the
               work-list and with the dense-grid attention); GREngine
               (algorithm1 and flat) against make_gr_train_step on
               hstu-large, 4 steps, sync and tau=1, bit for bit.
  8. cli     — python -m repro_torch.launch.train as four subprocesses
               side by side, on hstu-large (8 steps) and fuxi-large (4
               steps), and on hstu-large with --neg-mode segmented and
               --neg-mode baseline (4 steps each), on preprocessed
               synthetic KuaiRand.
  9. result  — one JSON line of kernel numbers, the nvidia-smi line, and
               the final status line.
"""
import copy
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

# fp32 comparisons hold fp32 arithmetic against fp32 arithmetic: keep
# cuBLAS off TF32 even where the environment turns it on by default.
os.environ["NVIDIA_TF32_OVERRIDE"] = "0"

ROOT = Path(__file__).resolve().parent
SEED = 0
# Kernel vs plain version. fp32: the same fp32 arithmetic with keys summed
# in another order, a few ulps of O(1) outputs: max abs. bf16: a weight or
# an output that rounds the other way moves by one bf16 ulp of its own
# size (at most 2^-7 relative), and long rows' outputs are small (the
# 1/(pos+1) weights), so bf16 is held per (token, head) by the relative L2
# error along the head dim; one k-block lost from a 2048-token row moves
# its rows by about 0.25.
ABS_TOL_FP32 = 1e-4
REL_TOL_BF16 = 1e-2
EMB_TOL_BF16 = 5e-2
# The streaming engine and RecallEngine serve the same bf16 function with
# K1-fwd's keys tiled at other offsets, so each carries its own bf16
# rounding. An fp32 encode of the same histories (the bf16 weights
# widened) is the witness: on the H100 each engine's user embedding lies
# up to 0.110 (median 0.031) per-row relative L2 from it, with top-100
# overlaps down to 0.76, while the two engines lie 0.0174 apart with
# overlaps of at least 0.93, less than either's own distance from the fp32
# encode. Each engine is held to the fp32 encode (fp32_*), the two to each
# other (pair_*), every limit just outside its reading; pair_rel lies
# between the reading and the sum of the two distances from fp32.
STREAM_TOL = dict(fp32_rel=0.15, pair_rel=3e-2, fp32_overlap=0.7,
                  pair_overlap=0.9)
# fp32 results summed in another order (K2's table grads, K4's dout, K6's
# totals): max abs error over the largest value
GRAD_TOL_FP32 = 1e-4
# Dense peak rates by dtype: the port's cited figures for the card
# (repro_torch.obs.PEAK_FLOPS, by the name the card reports), set by
# phase_device, so the kernels' bounds and the engine's measured MFU use
# one peak.
PEAK_FLOPS = {}
PEAK_BYTES = 3.35e12
# special-function (MUFU) instructions: 16 per clock per SM (Hopper's
# SFUs), 132 SMs; the clock is the card's maximum SM clock (nvidia-smi)
SFU_PER_CLOCK = 16 * 132
CARD = {}        # "sm_clock_hz", set by phase_device
# Special-function (MUFU) instructions that the attention's function
# needs, derived from its math (not read from the kernels' code, which may
# do more), by what they depend on. Per score entry and head: SiLU's exp
# (EX2) and reciprocal (RCP), and in the functional mode the bias's two
# exps, z^rho = exp(rho * ln z) and exp(-z^rho). Per (query, key) pair,
# once for all heads: the time bucket's division (RCP); logf, precise, is
# a polynomial on the FMA pipe, and ln z = ln(dt + eps) - ln sigma needs
# no division per entry (1/sigma and ln sigma are per head). K2 needs each
# entry's bias and SiLU' once, so its counts are the same.
MUFU_PER_ENTRY_HEAD = {"bucket": 2, "functional": 4}
MUFU_PER_PAIR = {"bucket": 1, "functional": 0}


def say(*parts):
    print(*parts, flush=True)


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def timed_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def fenced_ms(fn, iters, pre):
    """Device time of one call of ``fn`` without the host's share: each call
    is enqueued behind ``pre`` (work that keeps the stream busy for longer
    than the host takes to enqueue the call) and timed by the events around
    it alone; the median over ``iters`` calls. For kernels of a few µs,
    whose Python wrappers take longer to call than the card to run them."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in ev:
        pre()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sorted(e0.elapsed_time(e1) for e0, e1 in ev)[iters // 2]


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------

def phase_device():
    import torch
    check(torch.cuda.is_available(), "no CUDA device: this test needs the "
          "card and has no CPU fallback")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr}")
    CARD["sm_clock_hz"] = float(clk.stdout.strip().splitlines()[0]) * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.obs import peak_flops_of
    for dt in ("bfloat16", "float16", "float32"):
        PEAK_FLOPS[dt] = peak_flops_of(name, dt)
    CARD["smi_line"] = smi_line
    say(f"[device] peak FLOP/s {PEAK_FLOPS} (the port's cited figures for "
        f"{name!r})")
    say(f"[device] {name} x{count}; nvidia-smi: {smi_line}; max SM clock "
        f"{CARD['sm_clock_hz'] / 1e6:.0f} MHz; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; matmul tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    return name, count, smi_line


# --------------------------------------------------------------------------
# phase 2: build
# --------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    say(f"[build] {sorted(info)} in {time.perf_counter() - t0:.1f} s")
    for name, i in info.items():
        lines = [ln.strip() for ln in str(i["log"]).splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        say(f"[build] {name}: {i['seconds']:.1f} s; ptxas:")
        for ln in lines:
            say(f"[build]   {ln}")
    # K1-fwd's and K2's bf16 kernels run their products on the tensor
    # cores (HMMA in their SASS; 16 K1-fwd kernels: 4 head dims x 2 time
    # modes x the cold and the append launch, 16 K2 kernels: two per
    # pair), their fp32 kernels keep the FMA path (no HMMA); ptxas spills
    # none of K1-fwd's bf16 kernels
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for src, n_tc, fp32_tags in (
            ("jagged_attn_fwd", 16, ("attn_fwd_kernelIf",)),
            ("jagged_attn_bwd", 16, ("attn_bwd_kv_kernelIf",
                                     "attn_bwd_q_kernelIf"))):
        hmma = _sass_hmma_counts(_build.library_path(src), cuobjdump)
        tc = {f: n for f, n in hmma.items() if "_tc_kernel" in f}
        fp32 = {f: n for f, n in hmma.items()
                if any(tag in f for tag in fp32_tags)}
        say(f"[build] {src} SASS: HMMA per bf16 kernel "
            f"{sorted(tc.values())} ({len(tc)} kernels), per fp32 kernel "
            f"{sorted(fp32.values())} ({len(fp32)} kernels)")
        check(len(tc) == n_tc and min(tc.values()) > 0,
              f"the bf16 {src} kernels are not all on the tensor cores")
        check(len(fp32) == n_tc and max(fp32.values()) == 0,
              f"the fp32 {src} kernels left the FMA path")
    usage = _ptxas_usage(str(info["jagged_attn_fwd"]["log"]))
    tc = {f: u for f, u in usage.items() if "attn_fwd_tc_kernel" in f}
    say(f"[build] jagged_attn_fwd bf16 kernels (ptxas): registers "
        f"{sorted(u['registers'] for u in tc.values())}, spill stores "
        f"{sorted(u['spill_stores'] for u in tc.values())}, spill loads "
        f"{sorted(u['spill_loads'] for u in tc.values())}")
    check(len(tc) == 16, f"ptxas reported {len(tc)} bf16 K1-fwd kernels")
    spills = sorted(f for f, u in tc.items()
                    if u["spill_stores"] or u["spill_loads"])
    check(not spills, f"bf16 K1-fwd kernels spill: {spills}")
    return info


def _ptxas_usage(log):
    """{kernel function (mangled): registers, spill stores and loads in
    bytes} from ``ptxas -v`` output."""
    import re
    usage, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            fn = m.group(1)
            usage.setdefault(fn, dict(registers=-1, spill_stores=-1,
                                      spill_loads=-1))
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            usage[fn]["spill_stores"] = int(m.group(1))
            usage[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            usage[fn]["registers"] = int(m.group(1))
    return {f: u for f, u in usage.items() if u["registers"] >= 0}


def _sass_hmma_counts(lib, cuobjdump):
    """{kernel function (mangled): HMMA instructions in its SASS}."""
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    counts, fn = {}, None
    for ln in out.stdout.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in ln:
            counts[fn] += 1
    return counts


def _long_tail_lengths(rng, total, max_len):
    lens = []
    while sum(lens) < total:
        n = int(min(max_len, max(1, rng.lognormal(5.5, 1.2))))
        lens.append(min(n, total - sum(lens)))
    return lens


def _packs(rng, cap, max_len):
    """{name: (offsets (G, S+1), timestamps (G, cap))} as numpy."""
    import numpy as np

    def stack(rows):
        S = max(len(r) for r in rows)
        offs = np.zeros((len(rows), S + 1), np.int32)
        for g, r in enumerate(rows):
            o = np.concatenate([[0], np.cumsum(r)])
            offs[g, :len(o)] = o
            offs[g, len(o):] = o[-1]
        ts = np.cumsum(rng.integers(0, 4000, (len(rows), cap)), axis=1)
        return offs, ts.astype(np.int32)

    long_tail = [_long_tail_lengths(rng, cap, max_len) for _ in range(2)]
    long_tail[0][0] = max_len                       # one full-length row
    long_tail[0] = _fit(long_tail[0], cap)
    sparse = [0, 700, 0, 0, 2048, 0, 1, 300, 0]
    return {"long_tail": stack(long_tail),
            "empty_rows+all_padding": stack([sparse, [0, 0, 0]]),
            # the engine's training pack: 1 shard x 4 users x 2048 events
            "train_1x4x2048": stack([[max_len] * 4])}


def _fit(lens, cap):
    out, tot = [], 0
    for n in lens:
        if tot + n > cap:
            n = cap - tot
        if n <= 0:
            break
        out.append(n)
        tot += n
    return out


def _bound(flops, byts, mufu, dtype_name):
    """The least time of a work item on this card: the largest of its
    tensor-core operations at the dtype's peak, its bytes at the memory
    rate and its special-function instructions at the SFU rate; and the
    name of the one that binds."""
    t = {"operations": flops / PEAK_FLOPS[dtype_name] * 1e3,
         "bytes": byts / PEAK_BYTES * 1e3,
         "special functions": mufu / (SFU_PER_CLOCK * CARD["sm_clock_hz"])
         * 1e3}
    by = max(t, key=t.get)
    return t[by], by, t


def _attn_mufu(n_live, H, mode):
    """Special-function instructions of the entries of n_live live block
    pairs (128² pairs of a query and a key each, H heads per pair)."""
    pairs = 128 * 128 * n_live
    return pairs * (H * MUFU_PER_ENTRY_HEAD[mode] + MUFU_PER_PAIR[mode])


def _attn_bound(plan, G, capp, H, D, itemsize, dtype_name, mode):
    """K1-fwd: 4·b²·D flops per live block pair and head, q, k, v read and
    out written once, the plan and the bias tables, and the special
    functions of :func:`_attn_mufu`."""
    n_live = int(plan.n_live.sum())
    flops = 4 * 128 * 128 * D * H * n_live
    byts = (4 * G * capp * H * D * itemsize          # q, k, v read, out
            + plan.meta_i32.numel() * 4 + plan.meta_f32.numel() * 4
            + plan.q_wl.numel() * 4 + plan.q_rowptr.numel() * 4
            + (256 + (3 if mode == "functional" else 32)) * H * 4)
    bound_ms, bound_by, parts = _bound(flops, byts,
                                       _attn_mufu(n_live, H, mode),
                                       dtype_name)
    return bound_ms, bound_by, n_live, flops, byts, parts


def _functional_rab(rab, H, dev):
    """FuXi's time parameters at working values beside the bucket case's
    position table: amp about 1 (at init it is 0.02, which would keep the
    bias below 0.02 and hide a wrong exponent), σ = exp(linspace(2, 12)),
    ρ from time_rho = linspace(−2, 2), i.e. 0.43 to 1.57."""
    import torch
    return {"pos_table": rab["pos_table"],
            "time_amp": torch.linspace(0.8, 1.2, H, device=dev),
            "time_log_sigma": torch.linspace(2.0, 12.0, H, device=dev),
            "time_rho": torch.linspace(-2.0, 2.0, H, device=dev)}


def phase_kernels():
    import numpy as np
    import torch
    from repro_torch.configs import RABConfig
    from repro_torch.kernels.jagged_attention import (jagged_attention,
                                                      jagged_attention_ref,
                                                      ops)
    from repro_torch.kernels.jagged_attention.ref import (max_row_rel_err,
                                                          time_buckets)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    cap, H, D, max_len = 8192, 8, 128, 2048
    rab_cfg = RABConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rab = {"pos_table": torch.randn(256, H, device=dev, generator=gen) * .5,
           "time_table": torch.randn(32, H, device=dev, generator=gen) * .5}
    rabs = {"bucket": rab, "functional": _functional_rab(rab, H, dev)}
    amp, sigma, rho = ops.functional_time_table(rabs["functional"]).tolist()
    say(f"[kernels] functional time parameters: amp "
        f"{[round(x, 3) for x in amp]}, sigma "
        f"{[round(x, 1) for x in sigma]}, rho {[round(x, 3) for x in rho]}")
    results = {}
    for pack_name, (offs, ts) in _packs(rng, cap, max_len).items():
        G = offs.shape[0]
        o_t = torch.from_numpy(offs).to(dev)
        ts_t = torch.from_numpy(ts).to(dev)
        plan = ops.build_attn_plan(o_t, ts_t, cap, block=128,
                                   max_row_len=max_len)
        lens = np.diff(offs, axis=1)
        say(f"[kernels] pack {pack_name}: G={G} cap={cap} rows/shard "
            f"{(lens > 0).sum(1).tolist()} tokens/shard "
            f"{offs[:, -1].tolist()} longest {int(lens.max())} live pairs "
            f"{plan.n_live.flatten().tolist()}")
        # the kernel's time buckets against the plain version's formula,
        # over every causal same-row (q, k) pair of the pack; both are fp32
        # floor(log(1+dt)/denom), so they can part only where the quotient
        # lies within an ulp of an integer — reported, with the float64
        # bucket of each such dt
        mism = pairs = 0
        bad = {}
        denom = ops.time_bucket_denom(rab_cfg.time_bucket_scale)
        for g in range(G):
            for r in range(lens.shape[1]):
                lo, hi = int(offs[g, r]), int(offs[g, r + 1])
                if hi <= lo:
                    continue
                t = ts_t[g, lo:hi]
                kb = ops.kernel_time_buckets(t, t, rab_cfg.time_bucket_scale,
                                             rab_cfg.num_time_buckets)
                dti = (t[:, None] - t[None, :]).abs()
                pb = time_buckets(dti, denom, rab_cfg.num_time_buckets)
                causal = torch.ones_like(pb, dtype=torch.bool).tril()
                m = (kb.long() != pb) & causal
                mism += int(m.sum())
                pairs += int(causal.sum())
                for dt_, k_, p_ in zip(dti[m].tolist(), kb[m].tolist(),
                                       pb[m].tolist()):
                    bad[dt_] = (k_, p_, math.floor(
                        math.log1p(dt_) / (math.log(10.0)
                                           * rab_cfg.time_bucket_scale)))
        say(f"[kernels] time-bucket mismatches kernel vs plain: {mism} of "
            f"{pairs} causal pairs; dt -> (kernel, plain, float64): "
            f"{dict(sorted(bad.items())[:8])}")
        # fp32 at the engine's training pack is held to the float64 plain
        # version: its RAB-table grads sum millions of terms of both signs,
        # whose fp32 order alone moves them by ~1e-4 of their largest value
        # (the fp32 plain version's own order is printed beside it)
        f64 = pack_name.startswith("train")
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q, k, v = (torch.randn(G, cap, H, D, device=dev, generator=gen)
                       .to(dtype) for _ in range(3))
            for mode in ("bucket", "functional"):
                fname = "attn_fwd" + ("_functional" if mode == "functional"
                                      else "")
                args = (q, k, v, o_t, ts_t, rabs[mode], rab_cfg)
                kw = dict(plan=plan, time_mode=mode)
                before = ops.KERNEL_LAUNCHES[fname]
                out = jagged_attention(*args, **kw)
                torch.cuda.synchronize()
                check(ops.KERNEL_LAUNCHES[fname] == before + 1,
                      f"the wrapper did not launch the {mode} kernel")
                plain = jagged_attention_ref(*args, **kw)
                torch.cuda.synchronize()
                if f64 and dtype == torch.float32:
                    plain32 = plain
                    plain = ops.run_attention(*args, core=_plain_core_f64,
                                              **kw)
                    say(f"[kernels] {fname} {pack_name} {dname} against the "
                        f"float64 plain version: kernel max_abs "
                        f"{(out - plain).abs().max().item():.3e}, the fp32 "
                        f"plain version "
                        f"{(plain32 - plain).abs().max().item():.3e}; kernel "
                        f"vs fp32 plain "
                        f"{(out - plain32).abs().max().item():.3e}")
                    del plain32
                err = (out.float() - plain.float()).abs().max().item()
                rel = max_row_rel_err(out, plain)
                pf = plain.float()
                live = pf.norm(dim=-1) > 0
                rms = (pf.norm(dim=-1)[live] / math.sqrt(D)).median().item()
                pad = [out[g, int(offs[g, -1]):] for g in range(G)]
                pad_ok = all(int(torch.count_nonzero(p)) == 0 for p in pad)
                ms = timed_ms(lambda: jagged_attention(*args, **kw), 20)
                plain_ms = timed_ms(lambda: jagged_attention_ref(*args, **kw),
                                    3, warmup=1)
                bound_ms, bound_by, n_live, flops, byts, parts = _attn_bound(
                    plan, G, cap, H, D, q.element_size(), dname, mode)
                say(f"[kernels] {fname} {pack_name} {dname}: max_abs_err "
                    f"{err:.3e} worst row relative {rel:.3e} on outputs of "
                    f"max |plain| {pf.abs().max().item():.3e}, median row "
                    f"rms {rms:.3e}; pad_zero {pad_ok} | kernel {ms:.4f} ms"
                    f"  plain {plain_ms:.3f} ms  bound {bound_ms:.5f} ms by "
                    f"{bound_by} (operations {parts['operations']:.5f}, "
                    f"bytes {parts['bytes']:.5f}, special functions "
                    f"{parts['special functions']:.5f} ms; "
                    f"{flops / 1e9:.2f} GFLOP, {byts / 1e6:.2f} MB, "
                    f"{n_live} live pairs) -> {bound_ms / ms:.4f} of bound; "
                    f"{flops / ms / 1e9:.1f} TFLOP/s of the needed products "
                    f"({'tensor cores' if dname == 'bfloat16' else 'fp32 FMA'}"
                    f")")
                check(torch.isfinite(out.float()).all().item(),
                      "non-finite kernel output")
                if dtype == torch.float32:
                    check(err <= ABS_TOL_FP32, f"{fname} {pack_name} fp32: "
                          f"max_abs_err {err} > {ABS_TOL_FP32}")
                else:
                    check(rel <= REL_TOL_BF16, f"{fname} {pack_name} bf16: "
                          f"row relative err {rel} > {REL_TOL_BF16}")
                check(pad_ok, "pad slots not zero")
                results[(fname, pack_name, dname)] = dict(
                    max_abs_err=err, row_rel_err=rel, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    tflops=flops / ms / 1e9)
                # K8-fwd: the dense-grid schedule on the same plan, held to
                # K1-fwd's bits (its CTAs visit the same live k-blocks in
                # the same order); its plain version is K1-fwd's
                k8name = ops.launch_counter("fwd", dense=True,
                                            functional=mode == "functional")
                dkw = dict(kw, schedule="dense")
                before = dict(ops.KERNEL_LAUNCHES)
                dout = jagged_attention(*args, **dkw)
                torch.cuda.synchronize()
                moved = {n for n in before
                         if ops.KERNEL_LAUNCHES[n] != before[n]}
                check(moved == {k8name}, f"the dense schedule launched "
                      f"{moved}, not {k8name}")
                same = torch.equal(dout, out)
                dms = timed_ms(lambda: jagged_attention(*args, **dkw), 20)
                say(f"[kernels] {k8name} {pack_name} {dname}: bitwise equal "
                    f"to {fname} {same} | kernel {dms:.4f} ms beside "
                    f"{fname}'s {ms:.4f} ms (the dense grid's scan of "
                    f"{plan.num_blocks} blocks per CTA: "
                    f"{dms - ms:+.4f} ms)  bound {bound_ms:.5f} ms by "
                    f"{bound_by} (the same live work) -> "
                    f"{bound_ms / dms:.4f} of bound")
                check(same, f"{k8name} {pack_name} {dname} differs from "
                      f"{fname}")
                results[(k8name, pack_name, dname)] = dict(
                    max_abs_err=err, row_rel_err=rel, ms=dms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    tflops=flops / dms / 1e9)
                del dout
                bname = fname.replace("fwd", "bwd")
                results[(bname, pack_name, dname)], dense_bwd = \
                    _check_attn_bwd(q, k, v, rabs[mode], plan, pack_name,
                                    dname, gen, mode,
                                    f64=f64 and dtype == torch.float32)
                results[(ops.launch_counter(
                    "bwd", dense=True, functional=mode == "functional"),
                    pack_name, dname)] = dense_bwd
            del q, k, v, out, plain
    say("[kernels] no single PyTorch call computes K1-fwd, K2 or K8 in "
        "either time mode (scaled_dot_product_attention has no SiLU "
        "weights, RAB or jagged rows): their library_ms is null")
    return results


def _plain_core_f64(q, k, v, pt, tt, plan, *, schedule="worklist", **kw):
    """K1-fwd's plain version in float64 (an ``ops.run_attention`` core)."""
    import torch
    from repro_torch.kernels.jagged_attention.ref import attention_fwd_plain
    return attention_fwd_plain(q, k, v, pt, tt, plan,
                               acc_dtype=torch.float64, **kw)


def _rel_to_max(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def _check_attn_bwd(q, k, v, rab, plan, pack_name, dname, gen, mode,
                    f64=False):
    """K2 (its wrapper launches the dk/dv kernel, the dq + RAB-partials
    kernel and the fixed-order partial sum) against its plain version on
    the forward check's inputs and a random cotangent, in the time mode
    ``mode``; in the functional mode the time grads are d(amp, σ, ρ). With
    ``f64`` the plain version runs in float64 (the fp32 plain version's
    errors printed beside). Then K8-bwd, the dense-grid schedule, on the
    same inputs, held to K2's bits. → (K2's results, K8-bwd's)."""
    import torch
    from repro_torch.kernels.jagged_attention import ops
    from repro_torch.kernels.jagged_attention.ref import (attention_bwd_plain,
                                                          max_row_rel_err)
    G, cap, H, D = q.shape
    functional = mode == "functional"
    bname = "attn_bwd_functional" if functional else "attn_bwd"
    dy = torch.randn(q.shape, device=q.device, generator=gen).to(q.dtype)
    p = ops._as_batched(plan)
    pt = rab["pos_table"]
    tt = (ops.functional_time_table(rab) if functional
          else rab["time_table"])
    kw = dict(scale=D ** -0.5, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=True, time_functional=functional)
    args = (q, k, v, dy, pt, tt, p)
    before = ops.KERNEL_LAUNCHES[bname]
    got = ops._launch_bwd(*args, **kw)
    again = ops._launch_bwd(*args, **kw)
    torch.cuda.synchronize()
    check(ops.KERNEL_LAUNCHES[bname] == before + 2,
          "the K2 wrapper did not launch the kernels")
    want = attention_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = {}
    tname = "d(amp,sigma,rho)" if functional else "dtt"
    if f64:
        want32 = want
        want = attention_bwd_plain(*args, acc_dtype=torch.float64, **kw)
        say(f"[kernels] {bname} {pack_name} {dname}, of the largest value "
            f"of the float64 plain version: " + "; ".join(
                f"{n} kernel {_rel_to_max(a, b):.3e}, fp32 plain "
                f"{_rel_to_max(c, b):.3e}" for n, a, b, c in zip(
                    ("dq", "dk", "dv", "dpt", tname), got, want, want32)))
        del want32
    for name, a, b in zip(("dq", "dk", "dv", "dpt", tname), got, want):
        check(torch.isfinite(a.float()).all().item(), f"K2 {name} non-finite")
        errs[name] = dict(max_abs=(a.float() - b.float()).abs().max().item(),
                          rel_to_max=_rel_to_max(a, b),
                          row_rel=(max_row_rel_err(a, b) if a.dim() == 4
                                   else None))
    if functional:
        say(f"[kernels] {bname} {pack_name} {dname}: d(amp, sigma, rho) "
            f"kernel {got[4].tolist()} plain {want[4].tolist()}")
    ms = timed_ms(lambda: ops._launch_bwd(*args, **kw), 10)
    plain_ms = timed_ms(lambda: attention_bwd_plain(*args, **kw), 2,
                        warmup=1)
    # the work needs S, dP, dV, dK and dQ, 2·b²·D each per live pair and
    # head, and each entry's bias and SiLU' once; the kernel's
    # recomputation of S, dP and the bias in its second kernel is its own
    # choice and not counted
    n_live = int(plan.n_live.sum())
    flops = 10 * 128 * 128 * D * H * n_live
    ntb = tt.shape[0]
    byts = (7 * G * cap * H * D * q.element_size()   # q k v dy in, 3 out
            + p.meta_i32.numel() * 4 + p.meta_f32.numel() * 4
            + (p.q_wl.numel() + p.kv_wl.numel() + p.q_rowptr.numel()
               + p.kv_rowptr.numel()) * 4 + 2 * (256 + ntb) * H * 4)
    bound_ms, bound_by, parts = _bound(flops, byts,
                                       _attn_mufu(n_live, H, mode), dname)
    err = max(e["max_abs"] for e in errs.values())
    unit = "tensor cores" if dname == "bfloat16" else "fp32 FMA"
    say(f"[kernels] {bname} {pack_name} {dname}: "
        + "; ".join(f"{n} max_abs {e['max_abs']:.3e} rel_to_max "
                    f"{e['rel_to_max']:.3e}"
                    + (f" row_rel {e['row_rel']:.3e}" if e["row_rel"]
                       is not None else "") for n, e in errs.items())
        + f"; bit-identical rerun {same} | kernel {ms:.4f} ms  plain "
        f"{plain_ms:.3f} ms  bound {bound_ms:.5f} ms by {bound_by} "
        f"(operations {parts['operations']:.5f}, bytes "
        f"{parts['bytes']:.5f}, special functions "
        f"{parts['special functions']:.5f} ms; {flops / 1e9:.2f} GFLOP, "
        f"{byts / 1e6:.2f} MB, {n_live} live pairs) -> "
        f"{bound_ms / ms:.4f} of bound; {flops / ms / 1e9:.1f} TFLOP/s "
        f"of the needed products ({unit})")
    if dname == "bfloat16" and pack_name == "long_tail":
        _attn_bwd_split(lambda: ops._launch_bwd(*args, **kw), bname)
    check(same, "K2 differs between two runs on the same inputs")
    for name, e in errs.items():
        # fp32 (and the fp32 table and time grads): the same fp32
        # arithmetic summed in another order, held to 1e-4 of the largest
        # value (the three time grads of a head each sum ~10^7 terms, and
        # d sigma is small for heads of large sigma: relative to the
        # largest over the heads, not per element); bf16 q/k/v grads: one
        # bf16 rounding of an fp32 sum, per (token, head) by relative L2,
        # as K1-fwd
        if e["row_rel"] is not None and dname == "bfloat16":
            check(e["row_rel"] <= REL_TOL_BF16,
                  f"K2 {pack_name} {dname} {name}: row relative "
                  f"{e['row_rel']} > {REL_TOL_BF16}")
        else:
            check(e["rel_to_max"] <= GRAD_TOL_FP32,
                  f"K2 {mode} {pack_name} {dname} {name}: "
                  f"{e['rel_to_max']} of max > {GRAD_TOL_FP32}")
    k2 = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, errs=errs, tflops=flops / ms / 1e9)
    k8name = ops.launch_counter("bwd", dense=True, functional=functional)
    before = dict(ops.KERNEL_LAUNCHES)
    dgot = ops._launch_bwd(*args, dense=True, **kw)
    torch.cuda.synchronize()
    moved = {n for n in before if ops.KERNEL_LAUNCHES[n] != before[n]}
    check(moved == {k8name}, f"K8-bwd launched {moved}, not {k8name}")
    dsame = all(torch.equal(a, b) for a, b in zip(dgot, got))
    dms = timed_ms(lambda: ops._launch_bwd(*args, dense=True, **kw), 10)
    say(f"[kernels] {k8name} {pack_name} {dname}: bitwise equal to {bname} "
        f"(dq, dk, dv and the table grads) {dsame} | kernel {dms:.4f} ms "
        f"beside {bname}'s {ms:.4f} ms ({dms - ms:+.4f} ms)  bound "
        f"{bound_ms:.5f} ms by {bound_by} -> {bound_ms / dms:.4f} of bound; "
        f"{flops / dms / 1e9:.1f} TFLOP/s")
    check(dsame, f"{k8name} {pack_name} {dname} differs from {bname}")
    return k2, dict(k2, ms=dms, tflops=flops / dms / 1e9)


def _attn_bwd_split(launch, bname, iters=5):
    """Where K2's time goes: the device time of each of its three kernels
    (dk/dv, dq + RAB partials, the partials' sum) over `iters` calls,
    from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            launch()
        torch.cuda.synchronize()
    split = {}
    for ms, n, key in _device_rows(prof):
        for part, tag in (("kv", "attn_bwd_kv"), ("q", "attn_bwd_q"),
                          ("partial sum", "rab_partial_sum")):
            if tag in key:
                split[part] = split.get(part, 0.0) + ms / iters
    say(f"[kernels] {bname} long_tail bfloat16 by kernel (profiler, "
        f"{iters} calls): " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in split.items()))


def phase_neg_kernels():
    """K3 and K4 against their plain versions at the training step's shape
    (T = 8192 tokens, R = 128, d 1024, bf16 o, the fp16 shadow of 2^22
    rows), with a quarter of the tokens invalid, at expansion 1 (the main
    path) and 4 (generator-drawn perms)."""
    import torch
    from repro_torch.kernels import neg_logits as NL
    from repro_torch.kernels.neg_logits import ref as NR
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    T, R, D, V, seg = 8192, 128, 1024, 2 ** 22, 128
    shadow = (torch.randn(V, D, device=dev, generator=gen) * 0.02).half()
    o = torch.randn(T, D, device=dev, generator=gen).to(torch.bfloat16)
    ids = torch.randint(0, V, (T, R), device=dev, generator=gen)
    valid = torch.rand(T, device=dev, generator=gen) > 0.25
    pos = torch.randn(T, device=dev, generator=gen) * 0.64
    per_cta = NL.ops.NEG_BWD_TOKENS
    out = {}
    for expansion in (1, 4):
        o_p, pos_p, ids_p, valid_p, perms, _ = NL.prepare_fused_inputs(
            o, pos, V, ids, segment=seg, expansion=expansion, generator=gen,
            valid=valid)
        kw = dict(segment=seg, R=R, expansion=expansion, inv_tau=1.0,
                  fetch_dtype=None)
        args = (o_p, pos_p, shadow, ids_p, valid_p, perms)
        before = dict(NL.KERNEL_LAUNCHES)
        lse = NL.neg_fwd(*args, **kw)
        g = torch.rand(T, device=dev, generator=gen) * valid_p / T
        w, dout, dpos = NL.neg_bwd(*args, lse, g, **kw)
        torch.cuda.synchronize()
        check(NL.KERNEL_LAUNCHES["neg_fwd"] == before["neg_fwd"] + 1
              and NL.KERNEL_LAUNCHES["neg_bwd"] == before["neg_bwd"] + 1,
              "the K3/K4 wrappers did not launch their kernels")
        same = (torch.equal(NL.neg_fwd(*args, **kw), lse)
                and all(torch.equal(a, b) for a, b in
                        zip(NL.neg_bwd(*args, lse, g, **kw), (w, dout, dpos))))
        p_lse = NR.neg_fwd_plain(*args, **kw)
        pw, pdout, pdpos = NR.neg_bwd_plain(*args, p_lse, g, **kw)
        torch.cuda.synchronize()
        e_lse = (lse - p_lse).abs().max().item()
        e_w = (w - pw).abs().max().item()
        r_w = _rel_to_max(w, pw)
        e_dout = (dout - pdout).abs().max().item()
        r_dout = _rel_to_max(dout, pdout)
        e_dpos = (dpos - pdpos).abs().max().item()
        fwd_ms = timed_ms(lambda: NL.neg_fwd(*args, **kw), 10)
        bwd_ms = timed_ms(lambda: NL.neg_bwd(*args, lse, g, **kw), 10)
        fwd_plain = timed_ms(lambda: NR.neg_fwd_plain(*args, **kw), 2,
                             warmup=1)
        bwd_plain = timed_ms(lambda: NR.neg_bwd_plain(*args, lse, g, **kw),
                             2, warmup=1)
        rows_b = T * R * D * 2                    # each gathered row once
        small = T * D * 2 + T * R * 4 + perms.numel() * 4
        fwd_bytes = rows_b + small + 3 * T * 4
        bwd_bytes = rows_b + small + 4 * T * 4 + T * R * 4 + T * D * 4 + T * 4
        fwd_ops, bwd_ops = 2 * T * R * D, 4 * T * R * D
        res = {}
        for name, ms, plain_ms, byts, ops_, err in (
                ("neg_fwd", fwd_ms, fwd_plain, fwd_bytes, fwd_ops, e_lse),
                ("neg_bwd", bwd_ms, bwd_plain, bwd_bytes, bwd_ops,
                 max(e_w, e_dout, e_dpos))):
            t_ops = ops_ / PEAK_FLOPS["float16"] * 1e3
            t_bytes = byts / PEAK_BYTES * 1e3
            res[name] = dict(ms=ms, plain_ms=plain_ms,
                             bound_ms=max(t_ops, t_bytes),
                             bound_by="operations" if t_ops > t_bytes
                             else "bytes", max_abs_err=err)
        say(f"[kernels] neg expansion {expansion}: lse max_abs {e_lse:.3e}, "
            f"w {e_w:.3e} ({r_w:.3e} of max), dout {e_dout:.3e} "
            f"({r_dout:.3e} of max), dpos {e_dpos:.3e}; bit-identical rerun {same} | K3 {fwd_ms:.4f} ms"
            f" (plain {fwd_plain:.2f}) bound {res['neg_fwd']['bound_ms']:.4f}"
            f" ms by {res['neg_fwd']['bound_by']} "
            f"({fwd_bytes / 1e9:.3f} GB) -> "
            f"{res['neg_fwd']['bound_ms'] / fwd_ms:.3f} of bound | K4 "
            f"{bwd_ms:.4f} ms (plain {bwd_plain:.2f}) bound "
            f"{res['neg_bwd']['bound_ms']:.4f} ms ({bwd_bytes / 1e9:.3f} GB)"
            f" -> {res['neg_bwd']['bound_ms'] / bwd_ms:.3f} of bound; K4 grid "
            f"{T // per_cta} CTAs of {per_cta} warps, a warp a token, each "
            f"row gathered once through a {NL.ops.NEG_BWD_STAGES}-row ring "
            f"per warp")
        check(same, "K3/K4 differ between two runs on the same inputs")
        # fp32 sums over d and R in another order: lse to 1e-4 absolute
        # (values O(5)); w, dout and dpos (scaled by g <= 1/T) to
        # GRAD_TOL_FP32 of their largest values
        check(e_lse <= 1e-4 and r_w <= GRAD_TOL_FP32
              and r_dout <= GRAD_TOL_FP32
              and _rel_to_max(dpos, pdpos) <= GRAD_TOL_FP32,
              f"K3/K4 expansion {expansion} disagree with the plain version")
        out[expansion] = res
    say("[kernels] no single PyTorch call computes K3 or K4 (a gather by "
        "id, a row-wise dot, the sharing term and a logsumexp): their "
        "library_ms is null")
    del shadow
    torch.cuda.empty_cache()
    return out[1]


def phase_runsum_kernel():
    """K6 against its plain version at the training step's shape: the
    candidate pairs of one batch, T·(R+2) ≈ 1.06 M rows of 1024 — zipf-
    distributed input ids and labels (runs up to thousands of rows) and
    uniform negatives (runs of one) — plus a run of dropped ids, through
    ``run_totals``, the wrapper the training path calls."""
    import numpy as np
    import torch
    from repro_torch.kernels.jagged_lookup import ops as JL
    from repro_torch.kernels.jagged_lookup.ref import run_totals_plain
    dev = torch.device("cuda")
    T, R, D, V = 8192, 128, 1024, 2 ** 22
    ids = torch.from_numpy(np.concatenate(_k6_phase_ids(
        np.random.default_rng(SEED), T, R, V))).to(dev)
    n = ids.numel()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = torch.randn(n, D, device=dev, generator=gen)
    order, sids = JL.sort_pairs(ids)
    before = JL.KERNEL_LAUNCHES["runsum"]
    u, out = JL.run_totals(rows, order, sids)
    u2, again = JL.run_totals(rows, order, sids)
    torch.cuda.synchronize()
    check(JL.KERNEL_LAUNCHES["runsum"] == before + 2,
          "the K6 wrapper did not launch the kernel")
    same = torch.equal(out, again) and torch.equal(u, u2)
    del again
    starts, num_runs = JL.run_starts(sids)
    n_runs = int(num_runs)
    ids_ok = torch.equal(u, torch.unique(ids[ids >= 0]).to(u.dtype))
    plain = run_totals_plain(rows, order, sids, n_runs, JL.DROP_KEY)
    plain = plain[:u.numel()]
    err = (out - plain).abs().max().item()
    rel = _rel_to_max(out, plain)
    lens = torch.diff(starts[:n_runs + 1])
    # a run of one row totals that row exactly, in any order: bitwise
    single = lens[:u.numel()] == 1
    single_ok = torch.equal(out[single], plain[single])
    del plain
    lens = lens.cpu().numpy()
    buf = torch.empty((n_runs, D), device=dev)
    ms = timed_ms(lambda: JL._launch_runsum(rows, order, sids, starts,
                                            num_runs, buf), 10)
    wrapper_ms = timed_ms(lambda: JL.run_totals(rows, order, sids), 5)
    plain_ms = timed_ms(lambda: run_totals_plain(rows, order, sids, n_runs,
                                                 JL.DROP_KEY), 2, warmup=1)
    # the library yardstick: index_add_ of every row into its run's total
    run = torch.empty(n, dtype=torch.int64, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sids[1:] != sids[:-1]
    run[order] = torch.cumsum(is_start.long(), 0) - 1
    lib_out = torch.zeros((n_runs, D), device=dev)
    lib_ms = timed_ms(lambda: lib_out.index_add_(0, run, rows), 10)
    # rows read once, one total written per run, the order, the sorted ids
    # and the run pointers read
    byts = n * D * 4 + n_runs * D * 4 + n * 8 + n * 4 + (n_runs + 1) * 4
    t_ops = n * D / PEAK_FLOPS["float32"] * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                               else "bytes")
    say(f"[kernels] runsum: {n} rows, {n_runs} runs (lengths 1 to "
        f"{lens.max()}, {(lens == 1).mean():.3f} of runs single rows), "
        f"{u.numel()} unique ids >= 0; ids equal {ids_ok}, max_abs "
        f"{err:.3e} ({rel:.3e} of max), single-row runs bitwise "
        f"{single_ok}, bit-identical rerun {same} | kernel {ms:.4f} ms "
        f"(wrapper with sort pointers and run-count sync {wrapper_ms:.4f} "
        f"ms)  plain {plain_ms:.3f} ms  index_add_ {lib_ms:.4f} ms  bound "
        f"{bound_ms:.4f} ms by {bound_by} ({byts / 1e9:.3f} GB) -> "
        f"{bound_ms / ms:.3f} of bound")
    # fp32 sums of up to thousands of rows in another order (the plain
    # version adds on the card with atomics): 1e-4 of the largest total
    check(same and ids_ok and single_ok and rel <= GRAD_TOL_FP32,
          "K6 disagrees with its plain version")
    del rows, out, buf, lib_out
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def _k6_phase_ids(rng, T, R, V):
    """The K6 phase's ids: zipf input ids and labels (2T), uniform
    negatives (T·R), 64 dropped."""
    import numpy as np
    from repro_torch.data import SyntheticKuaiRand
    zipf = SyntheticKuaiRand(num_items=V)._items(rng, 2 * T)
    return (zipf.astype(np.int32), rng.integers(0, V, T * R, dtype=np.int32),
            np.full((64,), -1, np.int32))


def phase_wscatter_kernel():
    """K5 on the K6 phase's mix, laid out as the training path lays out a
    step's slots: the T·R = 1,048,576 negative slots first (uniform ids,
    rows w·(o·scale) from bf16 o, T = 8192, R = 128, d 1024), then the
    2T zipf input/label ids and the 64 dropped ids as ready fp32 rows,
    through ``weighted_run_totals``, the wrapper the training path calls.
    Held against its plain version, against two-pass rows + K6 (bitwise)
    and against itself (bitwise). The path's scale is 1/τ = 1; 1/0.7 is
    used here so that the bitwise check also sees the products' order."""
    import numpy as np
    import torch
    from repro_torch.kernels.jagged_lookup import ops as JL
    from repro_torch.kernels.jagged_lookup.ref import weighted_run_totals_plain
    dev = torch.device("cuda")
    T, R, D, V = 8192, 128, 1024, 2 ** 22
    zipf, neg, drop = _k6_phase_ids(np.random.default_rng(SEED), T, R, V)
    ids = torch.from_numpy(np.concatenate([neg, zipf, drop])).to(dev)
    n, TR = ids.numel(), T * R
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    o = torch.randn(T, D, device=dev, generator=gen).to(torch.bfloat16)
    w = torch.rand(T, R, device=dev, generator=gen) / R
    extra = torch.randn(n - TR, D, device=dev, generator=gen)
    scale = 1 / 0.7
    order, sids = JL.sort_pairs(ids)
    before = JL.KERNEL_LAUNCHES["wscatter"]
    u, out = JL.weighted_run_totals(o, w, extra, order, sids, scale=scale)
    u2, again = JL.weighted_run_totals(o, w, extra, order, sids, scale=scale)
    torch.cuda.synchronize()
    check(JL.KERNEL_LAUNCHES["wscatter"] == before + 2,
          "the K5 wrapper did not launch the kernel")
    same = torch.equal(out, again) and torch.equal(u, u2)
    del again
    ids_ok = torch.equal(u, torch.unique(ids[ids >= 0]).to(u.dtype))
    starts, num_runs, n_runs, _, _ = JL._runs(sids)
    plain = weighted_run_totals_plain(o, w, extra, order, sids, n_runs,
                                      JL.DROP_KEY, scale)[:u.numel()]
    err = (out - plain).abs().max().item()
    rel = _rel_to_max(out, plain)
    del plain
    # the two-pass composition: every row built (the (T·R, D) buffer),
    # then K6 over all slots
    rows = torch.empty((n, D), device=dev)
    neg_rows = rows[:TR].view(T, R, D)

    def two_pass_rows():
        torch.mul(w[:, :, None], (o.float() * scale)[:, None], out=neg_rows)
    two_pass_rows()
    rows[TR:] = extra
    u6, out6 = JL.run_totals(rows, order, sids)
    torch.cuda.synchronize()
    bitwise = torch.equal(u6, u) and torch.equal(out6, out)
    del out6
    buf = torch.empty((n_runs, D), device=dev)
    ms = timed_ms(lambda: JL._launch_wscatter(o, w, extra, order, sids,
                                              starts, num_runs, buf,
                                              scale=scale), 10)
    wrapper_ms = timed_ms(lambda: JL.weighted_run_totals(
        o, w, extra, order, sids, scale=scale), 5)
    plain_ms = timed_ms(lambda: weighted_run_totals_plain(
        o, w, extra, order, sids, n_runs, JL.DROP_KEY, scale), 2, warmup=1)

    def two_pass():
        two_pass_rows()
        JL._launch_runsum(rows, order, sids, starts, num_runs, buf)
    two_pass_ms = timed_ms(two_pass, 5)
    del rows, neg_rows
    # the library call: the sorted slots as a CSR matrix, a row per run and
    # a column per row of o and per ready row, w (1 for a ready row) as the
    # value; one cuSPARSE SpMM of it with [o·scale; extra] gives every run's
    # total without building the rows. The matrix is built outside the
    # timed region.
    neg_slot = order < TR
    csr = torch.sparse_csr_tensor(
        starts[:n_runs + 1].long(),
        torch.where(neg_slot, order // R, T + order - TR),
        torch.where(neg_slot, w.reshape(-1)[order.clamp(max=TR - 1)], 1.0),
        size=(n_runs, T + n - TR))
    library = lambda: torch.sparse.mm(                      # noqa: E731
        csr, torch.cat([o.float() * scale, extra]))
    lib_rel = _rel_to_max(out, library()[:u.numel()])
    lib_ms = timed_ms(library, 5)
    del csr
    # bf16 o, the weights, the ready rows, the order, the sorted ids and the
    # run pointers read once; one total written per run
    byts = (T * D * 2 + TR * 4 + (n - TR) * D * 4 + n * 8 + n * 4
            + (n_runs + 1) * 4 + n_runs * D * 4)
    ops = 3 * TR * D + (n - TR) * D
    t_ops = ops / PEAK_FLOPS["float32"] * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                               else "bytes")
    say(f"[kernels] wscatter: {n} slots ({TR} negative from bf16 o, "
        f"{n - TR} ready rows), {n_runs} runs, {u.numel()} unique ids >= 0; "
        f"ids equal {ids_ok}, max_abs {err:.3e} ({rel:.3e} of max), "
        f"bitwise equal to two-pass rows + K6 {bitwise}, bit-identical "
        f"rerun {same} | kernel {ms:.4f} ms (wrapper with sort pointers and "
        f"run-count sync {wrapper_ms:.4f} ms)  plain {plain_ms:.3f} ms  "
        f"two-pass (mul + K6) {two_pass_ms:.4f} ms  bound {bound_ms:.4f} ms "
        f"by {bound_by} ({byts / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP) -> "
        f"{bound_ms / ms:.3f} of bound; {byts / ms / 1e6:.1f} GB/s")
    say(f"[kernels] wscatter library call, CSR (runs x [o; extra]) "
        f"torch.sparse.mm: {lib_ms:.4f} ms, {lib_rel:.3e} of max from K5")
    # the same slots with every ready row's id made unique: no run longer
    # than the warp path takes, so the difference is the long runs' share
    lens = torch.diff(starts[:n_runs + 1])
    uniq = torch.cat([ids[:TR], torch.arange(V - (n - TR), V, device=dev,
                                             dtype=ids.dtype)])
    u_order, u_sids = JL.sort_pairs(uniq)
    u_starts, u_num, u_runs, _, _ = JL._runs(u_sids)
    u_buf = torch.empty((u_runs, D), device=dev)
    short_ms = timed_ms(lambda: JL._launch_wscatter(
        o, w, extra, u_order, u_sids, u_starts, u_num, u_buf, scale=scale),
        10)
    say(f"[kernels] wscatter runs longer than 32 rows: "
        f"{int((lens > 32).sum())} with {int(lens[lens > 32].sum())} rows "
        f"(longest {int(lens.max())}); the same slots with unique ready "
        f"ids ({u_runs} runs, none longer than "
        f"{int(torch.diff(u_starts[:u_runs + 1]).max())}): {short_ms:.4f} ms")
    del u_buf
    # fp32 sums of up to thousands of rows in another order (the plain
    # version and cuSPARSE add on the card in their own orders): 1e-4 of
    # the largest total; against two-pass + K6 the same products added in
    # the same order
    check(same and ids_ok and rel <= GRAD_TOL_FP32,
          "K5 disagrees with its plain version")
    check(lib_rel <= GRAD_TOL_FP32, "K5 disagrees with the CSR library call")
    check(bitwise, "K5 differs from two-pass rows + K6")
    del out, buf, extra, o, w
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms,
                two_pass_ms=two_pass_ms, gb_per_s=byts / ms / 1e6)


def _nl_bound(T, R, D, itemsize, bwd):
    """K9's least time: n read once (and dn written once in backward), o,
    g (backward) and the logits or do; 2 (forward) or 3 (backward, do's
    FMA and dn's product) operations per element of n at the half-precision
    tensor-core rate."""
    if bwd:
        byts = 2 * T * R * D * itemsize + T * D * 2 + T * R * 4 + T * D * 4
        ops_ = 3 * T * R * D
    else:
        byts = T * R * D * itemsize + T * D * 2 + T * R * 4
        ops_ = 2 * T * R * D
    t_ops = ops_ / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes"), byts


def phase_neg_logits_kernel():
    """K9 against its plain version at the ablation path's shape (T = 8192
    tokens, R = 128, d 1024, bf16 o): n bf16 (the baseline's rows of the
    master cast to the model's dtype) and fp16 (the segmented path's
    fetch, over all T and over one 128-token segment, the launch that path
    makes). The logits and do are fp32 sums in another order (1e-4 of
    their largest value); dn is one rounding of the same fp32 product
    (bitwise); both directions bit-identical run to run. Times beside the
    byte bound and the library calls (torch.bmm, and for the backward
    torch.bmm plus the broadcast multiply, on o and g in n's dtype: the
    same products, rounded to n's dtype where K9 keeps fp32). The
    segment's calls take a few µs, less than their Python wrappers, so
    there each call is timed alone on the card (:func:`fenced_ms`): warm,
    behind a sleep kernel and the rows' cast from fp32, as the path meets
    them (its fetch has just written them), and cold, behind a sum over
    256 MB that leaves them in device memory only. Kernel and library call
    are timed in turns (kernel, library, library, kernel, ...), the means
    of their medians kept."""
    import torch
    from repro_torch.kernels import neg_logits as NL
    from repro_torch.kernels.neg_logits import ref as NR
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    T, R, D, seg = 8192, 128, 1024, 128
    o = torch.randn(T, D, device=dev, generator=gen).to(torch.bfloat16)
    n = torch.randn(T, R, D, device=dev, generator=gen,
                    dtype=torch.bfloat16) * 0.02
    g = torch.randn(T, R, device=dev, generator=gen) * 1e-4
    out = {}
    for name, nn, sl in (("bf16", n, slice(None)),
                         ("fp16", None, slice(None)),
                         ("fp16 segment", None, slice(0, seg))):
        if nn is None:
            nn = n.to(torch.float16)[sl].contiguous()
        oo, gg = o[sl].contiguous(), g[sl].contiguous()
        Tn = oo.shape[0]
        before = dict(NL.KERNEL_LAUNCHES)
        lg = NL.neg_logits_fwd(oo, nn, inv_tau=1.0)
        do, dn = NL.neg_logits_bwd(oo, nn, gg, inv_tau=1.0)
        torch.cuda.synchronize()
        check(NL.KERNEL_LAUNCHES["neg_logits_fwd"]
              == before["neg_logits_fwd"] + 1
              and NL.KERNEL_LAUNCHES["neg_logits_bwd"]
              == before["neg_logits_bwd"] + 1,
              "the K9 wrappers did not launch their kernels")
        do2, dn2 = NL.neg_logits_bwd(oo, nn, gg, inv_tau=1.0)
        same = (torch.equal(NL.neg_logits_fwd(oo, nn, inv_tau=1.0), lg)
                and torch.equal(do, do2) and torch.equal(dn, dn2))
        del do2, dn2
        p_lg = NR.neg_logits_ref(oo, nn)
        r_lg, e_lg = _rel_to_max(lg, p_lg), (lg - p_lg).abs().max().item()
        del p_lg
        p_do, p_dn = NR.neg_logits_bwd_plain(oo, nn, gg, inv_tau=1.0)
        r_do, e_do = _rel_to_max(do, p_do), (do - p_do).abs().max().item()
        dn_bitwise = torch.equal(dn, p_dn)
        del p_do, p_dn, dn
        k9f = lambda: NL.neg_logits_fwd(oo, nn, inv_tau=1.0)  # noqa: E731
        k9b = lambda: NL.neg_logits_bwd(oo, nn, gg, inv_tau=1.0)  # noqa
        fwd_plain = timed_ms(lambda: NR.neg_logits_ref(oo, nn), 2, warmup=1)
        bwd_plain = timed_ms(lambda: NR.neg_logits_bwd_plain(
            oo, nn, gg, inv_tau=1.0), 2, warmup=1)
        # the library calls take o and g in n's dtype (cast outside the
        # timed region: the fp16 rows' calls see o rounded to fp16)
        ol, gb = oo.to(nn.dtype), gg.to(nn.dtype)
        lbf = lambda: torch.bmm(nn, ol[:, :, None])  # noqa: E731
        lbb = lambda: (torch.bmm(gb[:, None, :], nn),  # noqa: E731
                       gb[:, :, None] * ol[:, None, :])
        turns = (("fwd", k9f), ("fwd lib", lbf), ("bwd", k9b),
                 ("bwd lib", lbb), ("bwd lib", lbb), ("bwd", k9b),
                 ("fwd lib", lbf), ("fwd", k9f))
        fenced = {}
        if Tn == T:
            looped = {}
            for name_, fn in turns + turns[:4]:
                looped.setdefault(name_, []).append(timed_ms(fn, 20))
            fwd_ms, bwd_ms, lib = (
                sum(looped["fwd"]) / 3, sum(looped["bwd"]) / 3,
                {k: sum(looped[f"{k} lib"]) / 3 for k in ("fwd", "bwd")})
        else:
            # one call at a time, warm and cold; the first of four passes
            # warms the sleep, cast and fill kernels and the clocks up and
            # is not kept
            flush = torch.zeros(64 << 20, dtype=torch.float32, device=dev)
            src = n[sl].float()
            pres = {"warm": lambda: (torch.cuda._sleep(200_000),
                                     nn.copy_(src)),
                    "cold": flush.sum}
            for rep in range(4):
                for temp, pre in pres.items():
                    for name_, fn in turns:
                        ms_ = fenced_ms(fn, 25, pre)
                        if rep:
                            fenced.setdefault((name_, temp), []).append(ms_)
            fenced = {k: sum(v) / len(v) for k, v in fenced.items()}
            del flush, src
            fwd_ms, bwd_ms = fenced[("fwd", "warm")], fenced[("bwd", "warm")]
            lib = {"fwd": fenced[("fwd lib", "warm")],
                   "bwd": fenced[("bwd lib", "warm")]}
        del ol, gb
        res = {}
        for kind, ms, plain_ms, err in (("fwd", fwd_ms, fwd_plain, e_lg),
                                        ("bwd", bwd_ms, bwd_plain, e_do)):
            bound_ms, bound_by, byts = _nl_bound(Tn, R, D, nn.element_size(),
                                                 kind == "bwd")
            res[f"neg_logits_{kind}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err, bytes=byts,
                library_ms=lib.get(kind))
        f, b = res["neg_logits_fwd"], res["neg_logits_bwd"]
        if fenced:
            say(f"[kernels] neg_logits {name} n, one call at a time on the "
                f"card (ms, warm: rows in L2 as on the path | cold: after a "
                f"256 MB sum): K9-fwd {fenced[('fwd', 'warm')]:.4f} | "
                f"{fenced[('fwd', 'cold')]:.4f}, torch.bmm "
                f"{fenced[('fwd lib', 'warm')]:.4f} | "
                f"{fenced[('fwd lib', 'cold')]:.4f}, byte bound "
                f"{f['bound_ms']:.4f} ({f['bytes'] / 1e6:.1f} MB); K9-bwd "
                f"{fenced[('bwd', 'warm')]:.4f} | "
                f"{fenced[('bwd', 'cold')]:.4f}, torch.bmm + mul "
                f"{fenced[('bwd lib', 'warm')]:.4f} | "
                f"{fenced[('bwd lib', 'cold')]:.4f}, byte bound "
                f"{b['bound_ms']:.4f}; K9-fwd / torch.bmm warm "
                f"{fenced[('fwd', 'warm')] / fenced[('fwd lib', 'warm')]:.3f}"
                f", cold "
                f"{fenced[('fwd', 'cold')] / fenced[('fwd lib', 'cold')]:.3f}"
                f" ({NL.fwd_row_split(Tn, R)} CTAs a token); K9-bwd / "
                f"(torch.bmm + mul) warm "
                f"{fenced[('bwd', 'warm')] / fenced[('bwd lib', 'warm')]:.3f}"
                f", cold "
                f"{fenced[('bwd', 'cold')] / fenced[('bwd lib', 'cold')]:.3f}"
                f" ({NL.bwd_row_split(Tn, R)} row groups a token)")
            f["cold_ms"], f["cold_library_ms"] = (fenced[("fwd", "cold")],
                                                  fenced[("fwd lib", "cold")])
            b["cold_ms"], b["cold_library_ms"] = (fenced[("bwd", "cold")],
                                                  fenced[("bwd lib", "cold")])
        say(f"[kernels] neg_logits {name} n (T={Tn}, R={R}, d={D}; K9-fwd "
            f"{NL.fwd_row_split(Tn, R)} CTA(s) a token, K9-bwd "
            f"{NL.bwd_row_split(Tn, R)} row group(s)): logits "
            f"max_abs {e_lg:.3e} ({r_lg:.3e} of max), do max_abs {e_do:.3e} "
            f"({r_do:.3e} of max), dn bitwise "
            f"{dn_bitwise}, bit-identical rerun {same} | K9-fwd {fwd_ms:.4f}"
            f" ms (plain {fwd_plain:.3f}, torch.bmm "
            f"{lib['fwd']:.4f}: K9-fwd / torch.bmm "
            f"{fwd_ms / lib['fwd']:.3f}) bound "
            f"{f['bound_ms']:.4f} ms by {f['bound_by']} "
            f"({f['bytes'] / 1e9:.3f} GB) -> {f['bound_ms'] / fwd_ms:.3f} of"
            f" bound | K9-bwd {bwd_ms:.4f} ms (plain {bwd_plain:.3f}, "
            f"torch.bmm + mul {lib['bwd']:.4f}) bound "
            f"{b['bound_ms']:.4f} ms ({b['bytes'] / 1e9:.3f} GB) -> "
            f"{b['bound_ms'] / bwd_ms:.3f} of bound")
        check(same, f"K9 {name} differs between two runs on the same inputs")
        check(r_lg <= GRAD_TOL_FP32 and r_do <= GRAD_TOL_FP32 and dn_bitwise,
              f"K9 {name} disagrees with its plain version")
        out[name] = res
        del nn
    del n, o, g
    torch.cuda.empty_cache()
    return out


def phase_gather_kernel():
    """K7 at the lookup's shape on the path: n = 8192 ids (a quarter −1,
    padding) from the fp32 master of 2^22 x 1024 to bf16, through
    ``gather_rows``, the wrapper ``jagged_lookup`` calls. Held bitwise
    against the plain version and against index_select + mask + cast. The
    rows are random, so a launch reads them from device memory, not from
    L2: the timed launches cycle through 8 id sets (256 MB of rows)."""
    import torch
    from repro_torch.kernels import jagged_lookup as JL
    from repro_torch.kernels.jagged_lookup import ref as JR
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    V, D, n = 2 ** 22, 1024, 8192
    master = torch.randn(V, D, device=dev, generator=gen) * 0.02
    sets = []
    for _ in range(8):
        ids = torch.randint(0, V, (n,), device=dev, generator=gen,
                            dtype=torch.int32)
        ids[torch.rand(n, device=dev, generator=gen) < 0.25] = -1
        sets.append(ids)
    ids = sets[0]
    before = JL.KERNEL_LAUNCHES["gather"]
    out = JL.gather_rows(master, ids, torch.bfloat16)
    torch.cuda.synchronize()
    check(JL.KERNEL_LAUNCHES["gather"] == before + 1,
          "the K7 wrapper did not launch the kernel")
    valid = ids >= 0
    plain = JR.jagged_lookup_ref(master, ids)
    lib = (torch.index_select(master, 0, ids.clamp(min=0))
           .to(torch.bfloat16) * valid[:, None].to(torch.bfloat16))
    bit_plain, bit_lib = torch.equal(out, plain), torch.equal(out, lib)
    it = iter(range(10 ** 9))
    ms = timed_ms(lambda: JL.gather_rows(master, sets[next(it) % 8],
                                         torch.bfloat16), 40)
    plain_ms = timed_ms(lambda: JR.jagged_lookup_ref(
        master, sets[next(it) % 8]), 16)
    lib_ms = timed_ms(lambda: torch.index_select(
        master, 0, sets[next(it) % 8].clamp(min=0)), 40)
    n_valid = int(valid.sum())
    byts = n_valid * D * 4 + n * D * 2 + n * 4
    bound_ms = byts / PEAK_BYTES * 1e3
    say(f"[kernels] gather: {n} ids ({n - n_valid} < 0) from {V} x {D} fp32 "
        f"to bf16; bitwise equal to the plain version {bit_plain}, to "
        f"index_select + mask + cast {bit_lib} | kernel {ms:.4f} ms  plain "
        f"(clamp, gather, cast, where) {plain_ms:.4f} ms  index_select "
        f"alone (fp32 rows, no mask or cast) {lib_ms:.4f} ms  bound "
        f"{bound_ms:.5f} ms by bytes ({byts / 1e6:.2f} MB) -> "
        f"{bound_ms / ms:.3f} of bound")
    check(bit_plain and bit_lib, "K7 differs from its plain version or "
          "from index_select + mask + cast")
    del master, out, plain, lib
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)


# --------------------------------------------------------------------------
# phase 4: serving
# --------------------------------------------------------------------------

class _PlainAttention:
    """The model's attention with the plain version called explicitly."""

    def __init__(self, inner):
        self.inner = inner

    def make_plan(self, *a):
        return self.inner.make_plan(*a)

    def plain(self, q, k, v, offsets, timestamps, rab_params, rab, *,
              time_mode="bucket", plan=None):
        from repro_torch.kernels.jagged_attention import jagged_attention_ref
        i = self.inner
        return jagged_attention_ref(q, k, v, offsets, timestamps, rab_params,
                                    rab, time_mode=time_mode,
                                    block=i.block, plan=plan,
                                    max_row_len=i.max_row_len)

    __call__ = plain


class _BothAttention(_PlainAttention):
    """The kernel's result goes on down the stack; the plain version runs
    on the same layer inputs beside it, and each layer's worst per-row
    relative difference is kept."""

    def __init__(self, inner):
        super().__init__(inner)
        self.errs = []

    def __call__(self, *args, **kw):
        from repro_torch.kernels.jagged_attention.ref import max_row_rel_err
        y = self.inner(*args, **kw)
        self.errs.append(max_row_rel_err(y, self.plain(*args, **kw)))
        return y


def _trace(rng, users, vocab, max_len):
    import numpy as np
    hist = {}
    for u in range(users):
        n = int(min(max_len, max(1, rng.lognormal(5.5, 1.3))))
        if u % 11 == 0:
            n = max_len
        hist[u] = (rng.integers(0, vocab, n).astype(np.int32),
                   np.cumsum(rng.integers(1, 3600, n)).astype(np.int32))
    inc = []
    for u in range(0, users, 2):
        m = int(rng.integers(1, 4))
        last = int(hist[u][1][-1])
        inc.append((u, rng.integers(0, vocab, m).astype(np.int32),
                    (last + np.cumsum(rng.integers(1, 3600, m))).astype(
                        np.int32)))
    return hist, [("cold", [(u, *hist[u]) for u in hist]),
                  ("hit", [(u, [], []) for u in hist]),
                  ("incremental", inc)]


def _attn_counter(cfg, kind="fwd", schedule="worklist"):
    """The launch counter of the attention kernels' time mode that
    ``cfg``'s block runs (HSTU the bucket table, FuXi the functional
    encoder), in ``schedule`` (K1/K2 or, "dense", K8)."""
    from repro_torch.kernels.jagged_attention import ops
    return ops.launch_counter(kind, dense=schedule == "dense",
                              functional=cfg.gr_block == "fuxi")


def phase_serve(arch="hstu-large", tag="serve"):
    """RecallEngine on full-width ``arch``: cold, pure-hit and incremental
    rounds with the launch counts zeroed before and read after each; then
    the cold round's first micro-batch with the plain version beside the
    kernel in every layer, and end to end."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.embedding.tables import lookup
    from repro_torch.kernels.jagged_attention import ops
    from repro_torch.models import gr as GR
    from repro_torch.serving import RecallEngine, RequestScheduler

    dev = torch.device("cuda")
    cfg = get_arch(arch)
    counter = _attn_counter(cfg)
    V, d = cfg.vocab_size, cfg.d_model
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = GR.GRModel(cfg, device=dev, generator=gen)
    master = torch.randn(V, d, device=dev, generator=gen) * 0.02
    kw = dict(num_shards=2, users_per_shard=8, tokens_per_shard=8192, k=100)
    eng = RecallEngine(cfg, model, master, device=dev, **kw)
    torch.cuda.synchronize()
    say(f"[{tag}] {cfg.name}: d={d} layers={cfg.num_layers} heads="
        f"{cfg.num_heads} qkv={cfg.qkv_dim} d_ff={cfg.d_ff} max_seq_len="
        f"{cfg.max_seq_len} "
        f"vocab={V} dtype={cfg.dtype}; master {tuple(master.shape)} "
        f"{master.dtype} + shadow {eng.table.shadow.dtype} on the card; "
        f"set-up {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SEED)
    hist, rounds = _trace(rng, 40, V, cfg.max_seq_len)
    lens = np.array([len(hist[u][0]) for u in hist])
    say(f"[{tag}] trace: {len(hist)} users, history lengths min "
        f"{lens.min()} median {int(np.median(lens))} max {lens.max()}, "
        f"{lens.sum()} events")

    torch.cuda.reset_peak_memory_stats()
    out = {}
    per_round = []
    launches = {name: 0 for name in ops.KERNEL_LAUNCHES}
    for rname, reqs in rounds:
        enc0 = eng.encoded_batches
        _zero_counts()                         # counts of this round only
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(ops.KERNEL_LAUNCHES)
        for name, n in counts.items():
            launches[name] += n
        n_enc = eng.encoded_batches - enc0
        n_l = counts[counter]
        hits = sum(r.cache_hit for r in res)
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_round.append(dict(round=rname, requests=len(reqs), hits=hits,
                              micro_batches=n_enc, launches=n_l,
                              wall_s=wall, peak_mem_gib=peak,
                              **{f"{k}_s": v for k, v in
                                 eng.last_step_s.items()}))
        say(f"[{tag}] round {rname}: {len(reqs)} requests, {hits} hits, "
            f"{n_enc} micro-batches, {n_l} {counter} launches (all "
            f"attention counts {counts}), wall "
            f"{wall * 1e3:.1f} ms, phases "
            f"{ {k: round(v * 1e3, 1) for k, v in eng.last_step_s.items()} }"
            f" ms, peak device memory so far {peak:.2f} GiB")
        check(len(res) == len(reqs), "a request got no result")
        check(n_l == cfg.num_layers * n_enc
              and sum(counts.values()) == n_l,
              f"{counter} launched {n_l} times (all counts {counts}) for "
              f"{n_enc} micro-batches of {cfg.num_layers} layers")
        for r in res:
            check(np.isfinite(r.user_emb).all(), "non-finite embedding")
            check(((r.item_ids >= 0) & (r.item_ids < V)).all(),
                  "top-k id out of range")
            check(np.isfinite(r.scores).all(), "non-finite score")
        out[rname] = {r.user: r for r in res}
    check(launches[counter] > 0, f"the main path launched no {counter}")
    check(per_round[0]["micro_batches"] > 0 and per_round[1]["hits"] ==
          len(hist) and per_round[1]["micro_batches"] == 0,
          "the hit round encoded")
    for u, r in out["hit"].items():
        c = out["cold"][u]
        check(r.cache_hit and np.array_equal(r.item_ids, c.item_ids)
              and np.array_equal(r.scores, c.scores)
              and np.array_equal(r.user_emb, c.user_emb),
              f"hit for user {u} differs from its cold result")
    inc_users = {u for u, _, _ in rounds[2][1]}
    check(all(not out["incremental"][u].cache_hit for u in inc_users),
          "an incremental request was served from the cache")
    say(f"[{tag}] checks: embeddings finite, ids in [0, {V}), hits "
        f"bit-identical to cold, launches = layers x micro-batches; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if tag == "serve":
        _serve_obs_round(cfg, model, eng, kw, rounds[0][1], tag)

    # the cold round's first micro-batch again (the same 16 requests pack
    # the same way): with the plain version beside the kernel in every
    # layer, then with the plain version alone through the whole stack
    sch = RequestScheduler(kw["num_shards"], kw["users_per_shard"],
                           cfg.max_seq_len,
                           tokens_per_shard=kw["tokens_per_shard"])
    for u, ids, ts in rounds[0][1][:16]:
        sch.submit(u, ids, ts)
    mb = sch.flush()[0]
    x = lookup(master, torch.from_numpy(mb.ids).to(dev), dtype=torch.bfloat16)
    args = [torch.from_numpy(a).to(dev) for a in (mb.offsets, mb.timestamps,
                                                  mb.last_pos)]
    attn = GR.default_attn_fn(cfg)
    both = _BothAttention(attn)
    emb_k = GR.gr_user_embeddings_sharded(model, cfg, x, *args,
                                          attn_fn=both).float()
    emb_p = GR.gr_user_embeddings_sharded(model, cfg, x, *args,
                                          attn_fn=_PlainAttention(attn)
                                          ).float()
    torch.cuda.synchronize()
    rows = [(s.shard, s.row) for s in mb.slots]
    ek = torch.stack([emb_k[g, r] for g, r in rows])
    ep = torch.stack([emb_p[g, r] for g, r in rows])
    err = (ek - ep).abs().max().item()
    rel = ((ek - ep).norm(dim=-1) / ep.norm(dim=-1)).max().item()
    eng_err = max(float(np.abs(emb_k[s.shard, s.row].cpu().numpy()
                               - out["cold"][s.user].user_emb).max())
                  for s in mb.slots)
    say(f"[{tag}] micro-batch of {len(mb.slots)} users, {mb.num_tokens} "
        f"tokens. Per layer, kernel vs plain on the same layer inputs: "
        f"worst row relative {max(both.errs):.3e} (tol {REL_TOL_BF16}), by "
        f"layer "
        f"{[float(f'{e:.2e}') for e in both.errs]}")
    say(f"[{tag}] end to end through {cfg.num_layers} bf16 layers, kernel "
        f"path vs plain path: max abs {err:.3e} on |emb| up to "
        f"{ep.abs().max().item():.2f}, worst per-user relative L2 {rel:.3e} "
        f"(tol {EMB_TOL_BF16}); direct call vs the engine's cold round max "
        f"abs {eng_err:.3e}")
    check(max(both.errs) <= REL_TOL_BF16, "per-layer kernel vs plain "
          f"row relative {max(both.errs)} > {REL_TOL_BF16}")
    # each layer's bf16 rounding flips compound over 16 layers (a flip is
    # 2^-8 relative, renormalised by the next layernorm), so the two stacks
    # are held to the bf16 tolerance relative to the embedding's norm
    check(rel <= EMB_TOL_BF16, f"slice embeddings: kernel vs plain "
          f"relative {rel} > {EMB_TOL_BF16}")
    return launches, per_round, _profile_encode(model, cfg, x, args, attn,
                                                tag)


def _serve_obs_round(cfg, model, eng, kw, reqs, tag):
    """The cold round on two fresh engines over the same weights and table,
    one with ``obs=Obs()``: the same results bit for bit and the same stats
    (the latency clock given); the obs engine's spans and its stats mirrored
    into the registry."""
    import numpy as np
    from repro_torch.obs import Obs
    from repro_torch.serving import RecallEngine
    obs = Obs()
    runs = []
    for o in (None, obs):
        e = RecallEngine(cfg, model, eng.table, device=eng.device, obs=o,
                         **kw)
        res = e.serve(reqs, now=1.0)
        runs.append((res, e.stats()))
        del e
    (r0, s0), (r1, s1) = runs
    check(s0 == s1, f"{tag}: stats with obs {s1} differ from {s0}")
    for a, b in zip(r0, r1):
        check(np.array_equal(a.item_ids, b.item_ids)
              and np.array_equal(a.scores, b.scores)
              and np.array_equal(a.user_emb, b.user_emb),
              f"{tag}: user {a.user}'s result differs with obs")
    spans = obs.tracer.spans()
    names = sorted({(s.name, s.track) for s in spans})
    snap = obs.snapshot()
    check(names == [("encode", "serve_encode"), ("retrieval", "serve_rank")]
          and snap["serve_encoded_batches"]["values"][""]
          == s1["encoded_batches"], f"{tag}: obs recorded {names}")
    say(f"[{tag}] cold round with obs=Obs() on a fresh engine: {len(r1)} "
        f"results and the stats equal the engine's without obs bit for bit; "
        f"spans {[(s.name, round(s.dur * 1e3, 1)) for s in spans]} ms "
        f"(host clock); {len(snap)} serve_ gauges")


def _profile_encode(model, cfg, x, args, attn, tag):
    """Device time by kernel over one micro-batch encode, and the device's
    idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import gr as GR
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        GR.gr_user_embeddings_sharded(model, cfg, x, *args, attn_fn=attn)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    say(f"[profile] {tag}: one micro-batch encode: wall {wall:.1f} ms, "
        f"device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}")
    for ms, n, key in rows[:8]:
        say(f"[profile]   {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    return {"wall_ms": wall, "busy_ms": busy,
            "top": [(r[2][:60], r[0], r[1]) for r in rows[:8]]}


# --------------------------------------------------------------------------
# phase 4b: continuous-batching serving (StreamingRecallEngine)
# --------------------------------------------------------------------------

# Open-loop traffic in the proportions of the client in
# examples/serve_recall.py (:63-101): 32 new sessions sending their full
# history, 32 pure hits, 32 appends of one event, and a burst of 3
# one-event submits to one user at once. Each arrival draws its kind with
# these weights; a new user's history length is drawn as _trace draws it.
OPEN_LOOP_MIX = {"new": 32, "hit": 32, "append": 32, "burst": 1}
OPEN_LOOP_BURST = 3
OPEN_LOOP_SECONDS = 3.0
OPEN_LOOP_RATES = (0.5, 1.5)          # multiples of the closed-loop rate
STREAM_KW = dict(max_users=64, max_rows_per_tick=32, k=100)


class _Ticks:
    """Counts the engine's cold and warm encodes (each one a tick's batch
    of rows) by wrapping its two encode methods."""

    def __init__(self, eng):
        self.cold = self.warm = 0
        run_cold, run_warm = eng._run_cold, eng._run_warm

        def cold(*a):
            self.cold += 1
            return run_cold(*a)

        def warm(*a):
            self.warm += 1
            return run_warm(*a)
        eng._run_cold, eng._run_warm = cold, warm


def _stream_setup(arch):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import gr as GR
    from repro_torch.serving import StreamingRecallEngine
    dev = torch.device("cuda")
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = GR.GRModel(cfg, device=dev, generator=gen)
    master = torch.randn(cfg.vocab_size, cfg.d_model, device=dev,
                         generator=gen) * 0.02
    eng = StreamingRecallEngine(cfg, model, master, device=dev, **STREAM_KW)
    torch.cuda.synchronize()
    say(f"[stream] {arch}: prefix reuse {eng.prefix_reuse}, "
        f"{STREAM_KW}; slot buffer {eng.buffer.device_bytes / 1e9:.2f} GB "
        f"on the card (K/V caches "
        f"{tuple(eng.buffer.kv_k.shape) if eng.prefix_reuse else None}); "
        f"set-up {time.perf_counter() - t0:.3f} s")
    return cfg, model, eng


def _stream_round(eng, ticks, reqs, tag, rname):
    """Serve one closed-loop round with the launch counts zeroed before and
    read after; → (results by user, record)."""
    import numpy as np
    import torch
    from repro_torch.kernels.jagged_attention import ops
    c0, w0, r0 = ticks.cold, ticks.warm, eng.rank_batches
    _zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {k: v for k, v in ops.KERNEL_LAUNCHES.items() if v}
    rec = dict(round=rname, requests=len(reqs),
               hits=sum(r.cache_hit for r in res), cold_ticks=ticks.cold - c0,
               warm_ticks=ticks.warm - w0,
               rank_batches=eng.rank_batches - r0, launches=counts,
               wall_s=wall)
    say(f"[{tag}] round {rname}: {len(reqs)} requests, {rec['hits']} hits, "
        f"{rec['cold_ticks']} cold / {rec['warm_ticks']} warm encodes, "
        f"{rec['rank_batches']} rank batches, launches {counts}, wall "
        f"{wall * 1e3:.1f} ms")
    check(len(res) == len(reqs), f"{tag} {rname}: a request got no result")
    for r in res:
        check(np.isfinite(r.user_emb).all() and np.isfinite(r.scores).all()
              and ((r.item_ids >= 0) & (r.item_ids < eng.cfg.vocab_size))
              .all(), f"{tag} {rname}: non-finite or out-of-range result")
    return {r.user: r for r in res}, rec


def _check_stream_launches(cfg, rec, tag):
    """A cold encode is one K1-fwd launch per layer in the block's time
    mode, a warm one one append launch per layer; SASRec launches none."""
    from repro_torch.kernels.jagged_attention import ops
    L = cfg.num_layers
    want = {}
    if cfg.gr_block != "sasrec":
        if rec["cold_ticks"]:
            want[_attn_counter(cfg)] = L * rec["cold_ticks"]
        if rec["warm_ticks"]:
            want[ops.launch_counter("fwd_append", dense=False,
                                    functional=False)] = L * rec["warm_ticks"]
    check(rec["launches"] == want, f"{tag} {rec['round']}: launches "
          f"{rec['launches']}, expected {want}")


def _rel_rows(a, b):
    """Per-row relative L2 of a against b, (n, d) numpy."""
    import numpy as np
    return np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)


def _compare_engines(eng, res_s, res_r, emb32, tag, rname):
    """StreamingRecallEngine's results against RecallEngine's on the same
    requests, and each against ``emb32``, an fp32 encode of the same
    histories (the users in sorted order). Not bitwise: RecallEngine
    places a user at another offset of a shared pack, so K1-fwd sums the
    user's keys in other tiles and the two take different bf16 roundings
    through 16 layers. The fp32 encode shows that: each engine's
    distance from it is held to STREAM_TOL's fp32 limits, the two engines'
    distance from each other to its tighter pair limits. The top-k lists of the two engines may differ where
    scores lie within the embeddings' score difference of the (k+1)-th:
    with D the largest score difference over the union of the two lists,
    every id one engine ranks above its (k+1)-th score by more than 2D
    (the "sure" ids) must be in the other engine's list (an exact
    consequence; the CPU tests hold the same)."""
    import numpy as np
    import torch
    from repro_torch.serving import topk_blocked
    users = sorted(res_s)
    dev = eng.device
    k = eng.k
    E = {w: torch.from_numpy(np.stack([res[u].user_emb for u in users]))
         .to(dev) for w, res in (("s", res_s), ("r", res_r))}
    kth1 = {w: topk_blocked(e, eng._scan, k=k + 1, block_v=eng._block_v)[0]
            [:, k].cpu().numpy() for w, e in E.items()}
    ids32 = topk_blocked(emb32, eng._scan, k=k, block_v=eng._block_v)[1] \
        .cpu().numpy()
    e32 = emb32.cpu().numpy()
    rel = {"s": _rel_rows(E["s"].cpu().numpy(), e32),
           "r": _rel_rows(E["r"].cpu().numpy(), e32),
           "sr": _rel_rows(E["s"].cpu().numpy(), E["r"].cpu().numpy())}
    ov = {"s": [], "r": [], "sr": []}
    sure_n = []
    for i, u in enumerate(users):
        a, b = res_s[u], res_r[u]
        ov["sr"].append(len(set(a.item_ids) & set(b.item_ids)) / k)
        ov["s"].append(len(set(a.item_ids) & set(ids32[i])) / k)
        ov["r"].append(len(set(b.item_ids) & set(ids32[i])) / k)
        union = np.union1d(a.item_ids, b.item_ids)
        rows = eng._scan[torch.from_numpy(union).to(dev).long()].float()
        sc = {w: (rows @ E[w][i]).cpu().numpy() for w in E}
        delta = float(np.abs(sc["s"] - sc["r"]).max()) + 1e-4
        for w, other in (("s", b.item_ids), ("r", a.item_ids)):
            sure = union[sc[w] > kth1[w][i] + 2 * delta]
            sure_n.append(len(sure))
            check(set(sure.tolist()) <= set(other.tolist()),
                  f"{tag} {rname}: user {u}: ids ranked clearly above the "
                  f"(k+1)-th by one engine are missing from the other's "
                  f"top-{k}")
    rec = {f"{w}_rel_max": float(rel[w].max()) for w in rel}
    rec.update({f"{w}_rel_median": float(np.median(rel[w])) for w in rel})
    rec.update({f"{w}_overlap_min": float(min(ov[w])) for w in ov})
    rec.update({f"{w}_overlap_mean": float(np.mean(ov[w])) for w in ov})
    rec.update(sure_min=min(sure_n), sure_max=max(sure_n), users=len(users))
    names = {"s": "streaming vs fp32", "r": "RecallEngine vs fp32",
             "sr": "streaming vs RecallEngine"}
    for w, name in names.items():
        u = users[int(np.argmax(rel[w]))]
        say(f"[{tag}] {rname}: {name}: per-user relative L2 max "
            f"{rec[w + '_rel_max']:.4e} (user {u}, "
            f"{int(eng.buffer.length[eng.buffer.slot_of(u)])} events) median "
            f"{rec[w + '_rel_median']:.4e}; top-{k} overlap min "
            f"{rec[w + '_overlap_min']:.3f} mean "
            f"{rec[w + '_overlap_mean']:.3f}")
    say(f"[{tag}] {rname}: {len(users)} users; every sure id in both "
        f"engines' lists (sure sets of {min(sure_n)} to {max(sure_n)} ids); "
        f"limits {STREAM_TOL}")
    for w in ("s", "r"):
        check(rec[w + "_rel_max"] <= STREAM_TOL["fp32_rel"]
              and rec[w + "_overlap_min"] >= STREAM_TOL["fp32_overlap"],
              f"{tag} {rname}: {names[w]}: relative {rec[w + '_rel_max']}, "
              f"overlap {rec[w + '_overlap_min']}; limits {STREAM_TOL}")
    check(rec["sr_rel_max"] <= STREAM_TOL["pair_rel"]
          and rec["sr_overlap_min"] >= STREAM_TOL["pair_overlap"],
          f"{tag} {rname}: {names['sr']}: relative {rec['sr_rel_max']}, "
          f"overlap {rec['sr_overlap_min']}; limits {STREAM_TOL}")
    return rec


def _stream_cold_reference(eng, model, cfg, slots):
    """From-scratch cold encodes of the given slots' host histories in
    ``cfg.dtype``, into caches of their own: (emb (n, d), k, v
    (L, n, cap, H, D), lengths)."""
    import numpy as np
    import torch
    from repro_torch.embedding.tables import lookup
    from repro_torch.models import gr as GR
    b = eng.buffer
    dev = b.device
    dt = GR.torch_dtype(cfg.dtype)
    n, S = len(slots), b.max_seq_len
    ids = np.zeros((n, S), np.int32)
    ts = np.zeros((n, S), np.int32)
    lens = np.zeros(n, np.int32)
    for i, s in enumerate(slots):
        L = int(b.length[s])
        ids[i, :L], ts[i, :L], lens[i] = b.h_ids[s, :L], b.h_ts[s, :L], L
    shape = (cfg.num_layers, n) + tuple(b.kv_k.shape[2:])
    k = torch.zeros(shape, dtype=dt, device=dev)
    v = torch.zeros_like(k)
    x = lookup(eng.table.master, torch.from_numpy(ids).to(dev), dtype=dt)
    emb = GR.gr_encode_slots(model, cfg, x, torch.from_numpy(ts).to(dev),
                             torch.from_numpy(lens).to(dev), k, v,
                             torch.arange(n, device=dev, dtype=torch.int32))
    return emb, k, v, lens


def _fp32_encode(eng, model32, cfg32, users, chunk=8):
    """The users' resident histories encoded from scratch in fp32 (the
    model's weights widened, K1-fwd's fp32 kernel), ``chunk`` users at a
    time to bound the fp32 K/V scratch: (n, d) fp32, the yardstick both
    bf16 engines approximate."""
    import torch
    slots = [eng.buffer.slot_of(u) for u in users]
    return torch.cat([_stream_cold_reference(eng, model32, cfg32,
                                             slots[i:i + chunk])[0]
                      for i in range(0, len(slots), chunk)])


def _row_stats_check(d, tag):
    """The premise of the warm path's norms (``models/hstu.py``
    ``_row_stats``): a row's fp32 variance in a tensor of M rows equals
    its variance in one of 32768. For M rows drawn at random (2048 rows a
    size), count the rows that differ, with PyTorch's own reduction over
    the M rows and with ``_row_stats``; the latter must count none."""
    import torch
    from repro_torch.models.hstu import _row_stats
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    X = (torch.randn(32768, d, device=dev, generator=g) * 3 + 0.5
         ).bfloat16().float()

    def plain_var(x):
        return ((x - x.mean(-1, keepdim=True)) ** 2).mean(-1, keepdim=True)

    full_plain, full_stats = plain_var(X), _row_stats(X)[1]
    out = {}
    for M in (1, 2, 4, 8, 16, 32):
        n_plain = n_stats = 0
        for _ in range(2048 // M):
            idx = torch.randint(0, X.shape[0], (M,), device=dev, generator=g)
            n_plain += int((plain_var(X[idx]) != full_plain[idx]).sum())
            n_stats += int((_row_stats(X[idx])[1] != full_stats[idx]).sum())
        out[M] = dict(rows=2048 // M * M, plain=n_plain, row_stats=n_stats)
    say(f"[{tag}] norm statistics at d {d}, rows whose fp32 variance at M "
        f"rows differs from a 32768-row tensor's (PyTorch's reduction / "
        f"_row_stats): " + ", ".join(
            f"M={M}: {r['plain']} / {r['row_stats']} of {r['rows']}"
            for M, r in out.items()))
    check(all(r["row_stats"] == 0 for r in out.values()),
          f"{tag}: _row_stats depends on the row count: {out}")
    return out


def _check_warm_equals_cold(eng, model, cfg, users, tag, rname):
    """Every given user's device embedding row and the live K/V of every
    layer equal a from-scratch cold encode bit for bit."""
    import torch
    b = eng.buffer
    slots = [b.slot_of(u) for u in users]
    emb, k, v, lens = _stream_cold_reference(eng, model, cfg, slots)
    bad = []
    for i, s in enumerate(slots):
        n = int(lens[i])
        if not (torch.equal(b.emb[s], emb[i])
                and torch.equal(b.kv_k[:, s, :n], k[:, i, :n])
                and torch.equal(b.kv_v[:, s, :n], v[:, i, :n])):
            bad.append((users[i], n))
    check(not bad, f"{tag} {rname}: warm != cold for (user, length) {bad}")
    return len(slots)


def _append_bound(rows_n, pref, total, H, D, itemsize, dtype_name):
    """The append launch's least time, as K1-fwd's (:func:`_attn_bound`)
    from the window's live (query, key) pairs: each live query at position
    i sees the i + 1 keys before and at it; 4·D flops per pair and head,
    the special functions of each entry; bytes: the window's q read and
    output written, each row's K and V read over its T live keys, the
    rows' timestamps and 1/(pos+1), the tables."""
    pairs = sum((T * (T + 1) - p * (p + 1)) // 2 for p, T in zip(pref, total))
    live_q = sum(T - p for p, T in zip(pref, total))
    flops = 4 * D * H * pairs
    byts = (2 * rows_n * H * D * itemsize               # q read, out written
            + 2 * sum(total) * H * D * itemsize         # K, V prefixes
            + 4 * sum(total) + 4 * max(total) + (256 + 32) * H * 4)
    mufu = pairs * (H * MUFU_PER_ENTRY_HEAD["bucket"]
                    + MUFU_PER_PAIR["bucket"])
    bound_ms, bound_by, parts = _bound(flops, byts, mufu, dtype_name)
    return bound_ms, bound_by, pairs, live_q, flops, byts


def _append_kernel_check(eng, cfg, slots, tag):
    """The append launch at the main path's shapes (the incremental
    round's rows, each with a window of its last 3 events in a 4-wide
    bucket, layer 0's cache of hstu-large) against its plain version, bf16
    and fp32, bitwise run to run; its time one call at a time (fenced_ms)
    beside the plain version's and its bound."""
    import torch
    from repro_torch.kernels.jagged_attention import ops
    from repro_torch.kernels.jagged_attention.ref import (
        attention_append_plain, max_row_rel_err)
    b = eng.buffer
    dev = b.device
    # rows whose 4-wide window ending a row past its last event fits
    warm_slots = [s for s in slots if int(b.length[s]) < b.max_seq_len]
    H, D = cfg.num_heads, cfg.qkv_dim
    R = eng.row_ladder.bucket(len(warm_slots))
    slots = list(warm_slots) + [b.pad_row] * (R - len(warm_slots))
    p = [int(b.length[s]) - 3 if s != b.pad_row else 0 for s in slots]
    p = [max(x, 1) for x in p]
    total = [min(x + 3, int(b.length[s])) if s != b.pad_row else 0
             for x, s in zip(p, slots)]
    total = [max(t, x) for t, x in zip(total, p)]
    Q = 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cap = b.kv_k.shape[2]
    ts = torch.zeros((R, cap), dtype=torch.int32, device=dev)
    ts[:, :b.max_seq_len] = b.timestamps[torch.tensor(slots, device=dev)]
    t32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
    rab = dict(eng.model.blocks[0].rab.items())
    pt, tt, tkw = ops.rab_tables(rab, cfg.rab, H, dev, "bucket")
    out = {}
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        kc = b.kv_k[0] if dt == torch.bfloat16 else b.kv_k[0].float()
        vc = b.kv_v[0] if dt == torch.bfloat16 else b.kv_v[0].float()
        q = (torch.randn((R, Q, H, D), generator=gen, device=dev)
             * 0.5).to(dt)
        args = (q, kc, vc, t32(slots), ts, t32(p), t32(total), pt, tt,
                ops.position_ninv(cap, dev))
        kw = dict(scale=D ** -0.5, **tkw)
        a = ops.attention_append(*args, **kw)
        a2 = ops.attention_append(*args, **kw)
        plain = attention_append_plain(*args, block=128, **kw)
        torch.cuda.synchronize()
        check(torch.equal(a, a2), f"append launch {dname}: not bitwise run "
              "to run")
        if dt == torch.bfloat16:
            err = max_row_rel_err(a, plain)
            check(err <= REL_TOL_BF16, f"append launch bf16: row relative "
                  f"{err} > {REL_TOL_BF16}")
        else:
            err = (a - plain).abs().max().item()
            check(err <= ABS_TOL_FP32, f"append launch fp32: max abs {err} "
                  f"> {ABS_TOL_FP32}")
        ms = fenced_ms(lambda: ops.attention_append(*args, **kw), 21,
                       lambda: torch.cuda._sleep(200_000))
        plain_ms = timed_ms(lambda: attention_append_plain(
            *args, block=128, **kw), 2, warmup=0)
        bound_ms, bound_by, pairs, live_q, flops, byts = _append_bound(
            R * Q, p, total, H, D, q.element_size(), dname)
        out[dname] = dict(max_abs_err=(a.float() - plain.float()).abs().max()
                          .item(), row_rel_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None, rows=R, window=Q,
                          live_queries=live_q, live_pairs=pairs)
        say(f"[{tag}] append launch {dname}: {R} rows x window {Q} (live "
            f"queries {live_q}, query-key pairs {pairs}, K/V prefixes of "
            f"{sum(total)} tokens), {ms:.4f} ms one call at a time, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({byts / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP) -> {bound_ms / ms:.3f}; plain "
            f"{plain_ms:.1f} ms; {'row relative' if dname == 'bfloat16' else 'max abs'} "
            f"err {err:.3e}; bitwise run to run")
    return out


def _open_loop(eng, model, hist, gone, rate, seconds, rng, counts, tag):
    """Poisson arrivals at ``rate`` per second for ``seconds`` on the host's
    monotonic clock, the traffic of :data:`OPEN_LOOP_MIX`; requests are
    submitted at their arrival time and the engine ticks whenever work is
    pending. A client that gets ``resend_full`` (its user was evicted)
    resends the full history at once. Afterwards up to 16 of the users it
    appended to that are still resident are held bit for bit to cold
    encodes (emb and live K/V). ``hist`` holds every user the client has
    met, ``gone`` those it gave up (shed while not resident: the engine
    holds no history for them), both carried from run to run.
    ``counts`` is the engine's :class:`_Ticks`. → the run's record."""
    import numpy as np
    import torch
    V = eng.cfg.vocab_size
    S = eng.cfg.max_seq_len
    n = int(rng.poisson(rate * seconds))
    arrivals = time.monotonic() + 0.01 + np.cumsum(
        rng.exponential(1.0 / rate, n))
    w = np.array(list(OPEN_LOOP_MIX.values()), np.float64)
    kinds = rng.choice(list(OPEN_LOOP_MIX), size=n, p=w / w.sum())
    users = [u for u in hist if u not in gone]
    appended = set()
    rid0 = eng.sched._next_rid
    c0 = eng.compile_cache.compiles
    g0 = eng.graph_captures
    cold0, warm0 = counts.cold, counts.warm
    out0 = dict(eng.sched.outcomes)
    resends = 0
    requests = 0

    def submit(u, ids, ts, at):
        """One client request for a known user: the client keeps the
        user's full history, adds the events once the engine accepted
        them, and answers ``resend_full`` (the user was evicted) with the
        full history at once."""
        nonlocal resends, requests
        requests += 1
        a = eng.submit(u, ids, ts, now=at)
        if a.accepted or a.outcome == "resend_full":
            hist[u] = (np.concatenate([hist[u][0], ids])[-S:],
                       np.concatenate([hist[u][1], ts])[-S:])
        if a.accepted and len(ids):
            appended.add(u)
        if a.outcome == "resend_full":
            resends += 1
            appended.discard(u)
            a = eng.submit(u, *hist[u], now=at)
        if not a.accepted and eng.buffer.slot_of(u) is None:
            users.remove(u)            # shed while not resident: give it up
            gone.add(u)
        return a

    def events(u, m):
        ids = rng.integers(0, V, m).astype(np.int32)
        ts = (int(hist[u][1][-1]) + np.cumsum(rng.integers(1, 3600, m))
              ).astype(np.int32)
        return ids, ts

    def arrive(kind, at):
        nonlocal requests
        if kind == "new":
            u = max(hist) + 1
            m = int(min(S, max(1, rng.lognormal(5.5, 1.3))))
            hist[u] = (rng.integers(0, V, m).astype(np.int32),
                       np.cumsum(rng.integers(1, 3600, m)).astype(np.int32))
            requests += 1
            if eng.submit(u, *hist[u], now=at).accepted:
                users.append(u)
            else:
                gone.add(u)
            return
        u = users[int(rng.integers(len(users)))]
        if kind == "hit":
            submit(u, np.zeros(0, np.int32), np.zeros(0, np.int32), at)
            return
        for _ in range(OPEN_LOOP_BURST if kind == "burst" else 1):
            if u in users:
                submit(u, *events(u, 1), at)

    _zero_counts()
    i = 0
    ticks = 0
    t_start = time.monotonic()
    while True:
        now = time.monotonic()
        while i < n and arrivals[i] <= now:
            arrive(kinds[i], float(arrivals[i]))
            i += 1
        if eng.pending:
            eng.tick()
            ticks += 1
        elif i < n:
            time.sleep(max(0.0, arrivals[i] - time.monotonic()))
        else:
            break
    torch.cuda.synchronize()
    from repro_torch.kernels.jagged_attention import ops
    launches = {k: v for k, v in ops.KERNEL_LAUNCHES.items() if v}
    recs = [r for rid, r in eng.sched.records.items() if rid >= rid0]
    done = [r for r in recs if np.isfinite(r["t_done"])]
    lat = np.array([r["t_done"] - r["t_enqueue"] for r in done])
    span = max(r["t_done"] for r in done) - float(arrivals[0])
    outcomes = {k: eng.sched.outcomes[k] - out0.get(k, 0)
                for k in eng.sched.outcomes}
    rec = dict(offered_qps=rate, arrivals=n, requests=requests,
               offered_requests_qps=rate * requests / max(n, 1),
               kinds={k: int((kinds == k).sum()) for k in OPEN_LOOP_MIX},
               resends=resends, completed=len(done),
               cold_encodes=counts.cold - cold0,
               warm_encodes=counts.warm - warm0,
               sustained_qps=len(done) / span,
               p50_ms=float(np.percentile(lat, 50)) * 1e3,
               p99_ms=float(np.percentile(lat, 99)) * 1e3,
               outcomes=outcomes, ticks=ticks,
               wall_s=time.monotonic() - t_start,
               compiles_after_warmup=eng.compile_cache.compiles - c0,
               graph_captures_after_warmup=eng.graph_captures - g0,
               launches=launches)
    say(f"[{tag}] open loop at {rate:.1f} arrivals/s offered for {seconds} "
        f"s: {n} arrivals {rec['kinds']}, {requests} requests "
        f"({rec['offered_requests_qps']:.1f} req/s offered; +{resends} full "
        f"resends after eviction), {len(done)} done, sustained "
        f"{rec['sustained_qps']:.1f} req/s, latency p50 {rec['p50_ms']:.1f} "
        f"ms p99 {rec['p99_ms']:.1f} ms, outcomes {outcomes}, {ticks} ticks "
        f"({rec['cold_encodes']} cold / {rec['warm_encodes']} warm encodes),"
        f" compiles / graph captures after warmup "
        f"{rec['compiles_after_warmup']} / "
        f"{rec['graph_captures_after_warmup']}, launches {launches}")
    check(len(done) == len(recs), f"{tag}: {len(recs) - len(done)} admitted "
          "requests never finished")
    check(rec["warm_encodes"] > 0, f"{tag}: the open loop ran no warm encode")
    sample = [u for u in sorted(appended) if eng.buffer.slot_of(u) is not None]
    check(sample, f"{tag}: no user it appended to is still resident")
    sample = [sample[int(j)] for j in rng.choice(
        len(sample), size=min(16, len(sample)), replace=False)]
    rec["warm_checked"] = _check_warm_equals_cold(
        eng, model, eng.cfg, sample, tag, f"open loop at {rate:.1f} req/s")
    say(f"[{tag}] open loop at {rate:.1f} req/s: warm == cold bit for bit "
        f"for {rec['warm_checked']} resident users it appended to")
    return rec


def phase_stream():
    """StreamingRecallEngine on full-width hstu-large (prefix reuse),
    fuxi-large and sasrec-large (cold-only, the flat path): cold, pure-hit
    and incremental rounds of phase_serve's trace with launch counts
    zeroed before and read after each; on hstu-large chained appends
    (a 1-wide one, one crossing a 128-row block) held bit for bit to
    from-scratch cold encodes, the append launch against its plain
    version, the engine against RecallEngine, the rank graph against the
    eager rank step, and an open-loop run at two offered rates."""
    import numpy as np
    import torch
    from repro_torch.serving import RecallEngine, topk_from_slots
    out = {"rounds": {}, "launches": {}, "vs_recall_engine": {}}
    tag = "stream"
    cfg, model, eng = _stream_setup("hstu-large")
    out["row_stats"] = _row_stats_check(cfg.d_model, tag)
    ticks = _Ticks(eng)
    t = time.perf_counter()
    built = eng.warmup(q_caps=(1, 2, 4, 8, 16))
    say(f"[{tag}] warmup: {built} step entries ({eng.stats()['compile']}) "
        f"in {time.perf_counter() - t:.2f} s")
    rng = np.random.default_rng(SEED)
    hist, rounds = _trace(rng, 40, cfg.vocab_size, cfg.max_seq_len)
    base = RecallEngine(cfg, model, eng.table, device=eng.device,
                        num_shards=2, users_per_shard=8,
                        tokens_per_shard=8192, k=STREAM_KW["k"])
    model32 = copy.deepcopy(model).float()
    cfg32 = cfg.replace(dtype="float32")
    launches = {}
    res = {}
    recs = []
    S = cfg.max_seq_len
    inc_users = [u for u, _, _ in rounds[2][1]]

    def grow(u, ids, ts):
        hist[u] = (np.concatenate([hist[u][0], ids])[-S:],
                   np.concatenate([hist[u][1], ts])[-S:])

    def serve(rname, reqs, compare=False):
        r, rec = _stream_round(eng, ticks, reqs, tag, rname)
        _check_stream_launches(cfg, rec, tag)
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
        recs.append(rec)
        res[rname] = r
        if compare:
            emb32 = _fp32_encode(eng, model32, cfg32, sorted(r))
            out["vs_recall_engine"][rname] = _compare_engines(
                eng, r, {x.user: x for x in base.serve(reqs)}, emb32, tag,
                rname)
        return r, rec

    serve("cold", rounds[0][1], compare=True)
    hit, rec = serve("hit", rounds[1][1])
    check(rec["hits"] == len(hist) and rec["cold_ticks"] == rec[
        "warm_ticks"] == rec["rank_batches"] == 0, "the hit round encoded")
    for u, x in hit.items():
        c = res["cold"][u]
        check(np.array_equal(x.item_ids, c.item_ids)
              and np.array_equal(x.user_emb, c.user_emb),
              f"hit for user {u} differs from its cold result")
    for u, ids, ts in rounds[2][1]:
        grow(u, ids, ts)
    serve("incremental", rounds[2][1], compare=True)
    n_checked = _check_warm_equals_cold(eng, model, cfg, inc_users, tag,
                                        "incremental")
    # a 1-wide append for each of the same users, then a round where one
    # row crosses a 128-row block and the others add 3 events
    chain = [("append_1", lambda L: 1),
             ("append_cross_128", None)]
    lens = {u: len(hist[u][0]) for u in inc_users}
    cross_u = max((u for u in inc_users if lens[u] < S - 256),
                  key=lambda u: lens[u] % 128)
    for rname, m_of in chain:
        reqs = []
        for u in inc_users:
            m = (m_of(lens[u]) if m_of else
                 (128 - lens[u] % 128 + 2 if u == cross_u else 3))
            ids = rng.integers(0, cfg.vocab_size, m).astype(np.int32)
            ts = (int(hist[u][1][-1]) + np.cumsum(rng.integers(1, 3600, m))
                  ).astype(np.int32)
            grow(u, ids, ts)
            reqs.append((u, ids, ts))
        serve(rname, reqs)
        n_checked += _check_warm_equals_cold(eng, model, cfg, inc_users, tag,
                                             rname)
        lens = {u: len(hist[u][0]) for u in inc_users}
    say(f"[{tag}] warm == cold bit for bit (emb and the live K/V of all "
        f"{cfg.num_layers} layers) for {n_checked} user rows over three "
        f"chained append rounds (1-3 events, 1 event, and user {cross_u} "
        f"crossing position {lens[cross_u] // 128 * 128})")
    out["append_kernel"] = _append_kernel_check(
        eng, cfg, [eng.buffer.slot_of(u) for u in inc_users], tag)
    # the rank graph against the eager rank step, one batch of 32 slots
    rows = torch.tensor([eng.buffer.slot_of(u) for u in list(hist)[:32]],
                        dtype=torch.int32, device=eng.device)
    B = eng.row_ladder.bucket(len(rows))
    graph_fn = eng._rank_fn(B)
    torch.cuda.synchronize()
    t = time.perf_counter()
    g = [x.clone() for x in graph_fn(rows)]
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    e = topk_from_slots(eng.buffer.emb, rows, eng._scan, k=eng.k,
                        block_v=eng._block_v)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t) * 1e3
    check(all(torch.equal(a, b) for a, b in zip(g, e)),
          "rank graph replay != eager topk_from_slots")
    say(f"[{tag}] rank batch of {B} rows over {eng._scan.shape[0]} items "
        f"({eng._scan.dtype}, {-(-eng._scan.shape[0] // eng._block_v)} "
        f"blocks): graph replay {graph_ms:.2f} ms, eager {eager_ms:.2f} ms "
        f"(wall, host clock); results bitwise equal")
    out["rank_ms"] = {"graph": graph_ms, "eager": eager_ms, "rows": B}
    # open loop on the same engine, at multiples of the closed-loop rate
    # of the cold, hit and incremental rounds (the example's three rounds)
    closed = (sum(r["requests"] for r in recs[:3])
              / sum(r["wall_s"] for r in recs[:3]))
    say(f"[{tag}] closed-loop rate of the cold, hit and incremental rounds:"
        f" {closed:.1f} req/s")
    del model32
    gone = set()
    out["open_loop"] = [_open_loop(eng, model, hist, gone, m * closed,
                                   OPEN_LOOP_SECONDS, rng, ticks, tag)
                        for m in OPEN_LOOP_RATES]
    for r in out["open_loop"]:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["rounds"]["hstu-large"] = recs
    out["stats"] = eng.stats()
    del eng, base, model, ticks
    gc.collect()
    torch.cuda.empty_cache()
    # FuXi and SASRec: the flat path, cold-only
    for arch in ("fuxi-large", "sasrec-large"):
        cfg, model, eng = _stream_setup(arch)
        ticks = _Ticks(eng)
        t = time.perf_counter()
        built = eng.warmup()
        say(f"[{tag}] {arch} warmup: {built} step entries in "
            f"{time.perf_counter() - t:.2f} s")
        rng = np.random.default_rng(SEED)
        hist, rounds = _trace(rng, 40, cfg.vocab_size, cfg.max_seq_len)
        arecs = []
        for rname, reqs in rounds:
            _, rec = _stream_round(eng, ticks, reqs, tag, rname)
            _check_stream_launches(cfg, rec, tag)
            check(rec["warm_ticks"] == 0, f"{arch}: a warm encode without "
                  "prefix reuse")
            for k, v in rec["launches"].items():
                launches[k] = launches.get(k, 0) + v
            arecs.append(rec)
        out["rounds"][arch] = arecs
        del eng, model, ticks
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = launches
    say(f"[{tag}] launches over the rounds and open-loop runs: {launches}")
    return out


# --------------------------------------------------------------------------
# phase 5: training
# --------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels.jagged_attention import ops as AO
    from repro_torch.kernels import jagged_lookup as JL
    from repro_torch.kernels import neg_logits as NL
    return (AO.KERNEL_LAUNCHES, NL.KERNEL_LAUNCHES, JL.KERNEL_LAUNCHES)


def _zero_counts():
    for c in _counters():
        for k in c:
            c[k] = 0


def _read_counts():
    out = {}
    for c in _counters():
        out.update(c)
    return out


def _train_loader(V, users=64):
    """The port's GRLoader over the port's synthetic KuaiRand: 1 shard x 4
    users x 2048 events (cap 8192), R = 128 negatives per token."""
    from repro_torch.data import GRLoader, SyntheticKuaiRand
    gen = SyntheticKuaiRand(num_users=users, num_items=V, mean_len=1800,
                            sigma_len=0.6, max_len=4096, seed=SEED)
    seqs = {u: (d["item"], d["ts"]) for u, d in
            ((u, gen.interactions(u)) for u in range(users))}
    return GRLoader(seqs, num_devices=1, users_per_device=4,
                    max_seq_len=2048, num_negatives=128, num_items=V,
                    seed=SEED)


def _train_batches(V, steps):
    return list(_train_loader(V).batches(steps))


def phase_train():
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import (gr_train_state, host_unique_candidates,
                                      make_gr_train_step, to_device)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    cfg = get_arch("hstu-large")
    V, d = cfg.vocab_size, cfg.d_model
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bundle = GRBundle(cfg)
    state = gr_train_state(bundle.init_dense(gen, device=dev),
                           bundle.init_table(gen, device=dev))
    tbl = state.table
    table_bytes = sum(t.numel() * t.element_size()
                      for t in (tbl.master, tbl.shadow, tbl.accum))
    batches = _train_batches(V, 7)
    torch.cuda.synchronize()
    say(f"[train] {cfg.name}: d={d} layers={cfg.num_layers} heads="
        f"{cfg.num_heads} qkv={cfg.qkv_dim} vocab={V} dtype={cfg.dtype} "
        f"R={cfg.num_negatives}; master {tbl.master.dtype} + shadow "
        f"{tbl.shadow.dtype} + accum {tbl.accum.dtype} on the card: "
        f"{table_bytes / 1e9:.2f} GB; set-up "
        f"{time.perf_counter() - t0:.1f} s")
    tokens = [int(b["offsets"][0, -1]) for b in batches]
    say(f"[train] batches: tokens per step {tokens} of cap "
        f"{batches[0]['ids'].shape[1]}, rows per step "
        f"{[int((np.diff(b['offsets'][0]) > 0).sum()) for b in batches]}")

    def loss_fn(dd, t, bt, **kw):
        return bundle.loss(dd, t, bt, neg_scatter_impl="two_pass", **kw)

    steps = {semi: make_gr_train_step(loss_fn,
                                      input_gather=bundle.input_gather,
                                      semi_async=semi, stage_times=True)
             for semi in (False, True)}
    base = torch.cuda.memory_allocated()
    per_step, touched = [], []
    for i, batch in enumerate(batches[:6]):
        semi = i >= 3
        dbatch = to_device(batch, dev)
        touched.append(host_unique_candidates(batch, V)[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t = time.perf_counter()
        state, m = steps[semi](state, dbatch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = _read_counts()
        loss = float(m["loss"])
        peak = torch.cuda.max_memory_allocated() - base
        stage = {k[:-2]: v for k, v in m.items() if k.endswith("_s")}
        fb = stage.get("emb_fwd", 0.0) + stage["dense_fwd_bwd"]
        opt = stage.get("sparse_apply", 0.0) + stage["emb_bwd"]
        per_step.append(dict(step=i, schedule="tau1" if semi else "sync",
                             loss=loss, wall_s=wall, fwd_bwd_s=fb,
                             optimizer_s=opt, stages_s=stage,
                             peak_above_tables_gb=peak / 1e9,
                             carry_pairs=int(state.pending_ids.numel()),
                             launches=counts))
        say(f"[train] step {i} ({'tau=1' if semi else 'sync'}): loss "
            f"{loss:.5f}; wall {wall * 1e3:.1f} ms = fwd/bwd "
            f"{fb * 1e3:.1f} + optimizer {opt * 1e3:.1f} (stages "
            f"{ {k: round(v * 1e3, 1) for k, v in stage.items()} } ms); peak "
            f"{peak / 1e9:.2f} GB above the tables; carry "
            f"{state.pending_ids.numel()} pairs; launches {counts}")
        want = _step_launches(cfg, "runsum")
        check(counts == want, f"step {i} launched {counts}, expected {want}")
        check(math.isfinite(loss), f"step {i} loss {loss} is not finite")
        # no (V, d) fp32 array: one alone would lift the peak by V·d·4
        check(peak < V * d * 4, f"step {i} peaks {peak / 1e9:.2f} GB above "
              f"the tables, not below a (V, d) fp32 array "
              f"({V * d * 4 / 1e9:.2f} GB)")
    losses = [r["loss"] for r in per_step]
    check(4.6 <= losses[0] <= 5.6, f"first loss {losses[0]} outside "
          f"[4.6, 5.6] (ln(129) + 0.64²/2 = 5.07 at init)")
    # the shadow invariant on every row the six steps touched
    rows = torch.from_numpy(np.unique(np.concatenate(touched))).to(dev)
    bad = 0
    for lo in range(0, rows.numel(), 1 << 18):
        idx = rows[lo:lo + (1 << 18)].long()
        bad += int((tbl.shadow[idx] != tbl.master[idx].half()).sum())
    check(bad == 0, f"shadow != master.half() at {bad} elements")
    check(bool(torch.isfinite(state.pending_rows).all()),
          "non-finite carried grad rows")
    say(f"[train] checks: losses finite, first {losses[0]:.4f} in [4.6, "
        f"5.6]; shadow == master.half() bitwise on the {rows.numel()} "
        f"touched rows; peak above the tables "
        f"{max(r['peak_above_tables_gb'] for r in per_step):.2f} GB < "
        f"{V * d * 4 / 1e9:.2f} GB (no (V, d) fp32 array); total "
        f"allocated peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"in the last step")
    prof = _profile_step(steps[True], state, to_device(batches[6], dev))
    del state, tbl
    torch.cuda.empty_cache()
    return per_step, prof


def _profile_step(step, state, batch):
    """Device time by kernel over one tau=1 step, and the device's idle
    share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    say(f"[profile] one tau=1 train step: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}")
    for ms, n, key in rows[:12]:
        say(f"[profile]   {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    return {"wall_ms": wall, "busy_ms": busy,
            "top": [(r[2][:60], r[0], r[1]) for r in rows[:12]]}


def _device_rows(prof):
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        # host ops (their kernels are listed on their own) and the
        # profiler's step annotations (they span the step's kernels)
        if (e.device_type == DeviceType.CPU
                or e.key.startswith("ProfilerStep")):
            continue
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows


# --------------------------------------------------------------------------
# phase 6: the engine (the training entry point's main path)
# --------------------------------------------------------------------------

ENGINE_STEPS = {"hstu-large": 8, "fuxi-large": 6}


def _engine_run(arch, schedule, V, base_note, tag, loss_kwargs=None,
                n_steps=None, before_run=None, obs=None):
    """GREngine on full-width ``arch``, tau=1, ``loss_kwargs`` (default:
    the fused path with its default scatter), ``n_steps`` steps (default
    ENGINE_STEPS[arch]); per step the loss, the host wall between the ends
    of consecutive steps (each step's loss is realised on the host, so the
    host waits on the card once a step) and the peak above the tables.
    ``before_run(engine)`` runs first, before the counts are zeroed;
    ``obs`` is handed to the engine."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import GREngine
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch(arch)
    n_steps = n_steps or ENGINE_STEPS[arch]
    t0 = time.perf_counter()
    eng = GREngine(GRBundle(cfg), _train_loader(V), seed=SEED,
                   schedule=schedule, semi_async=True, device=dev,
                   loss_kwargs=loss_kwargs, obs=obs)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if before_run is not None:
        before_run(eng)
    base = torch.cuda.memory_allocated()
    marks, peaks = [], []

    def on_step(i, rec, state):
        marks.append(time.perf_counter())
        peaks.append(torch.cuda.max_memory_allocated() - base)
        torch.cuda.reset_peak_memory_stats()

    eng.step_callback = on_step
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recs = eng.run(n_steps)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = _read_counts()
    walls = [m - p for m, p in zip(marks, [t0] + marks[:-1])]
    steps = [dict(step=r["step"], loss=r["loss"], tokens=r["tokens"],
                  wall_s=wl, peak_above_tables_gb=pk / 1e9,
                  **{k: r[k] for k in ("mfu", "step_wall_s") if k in r})
             for r, wl, pk in zip(recs, walls, peaks)]
    name = schedule
    for r in steps:
        say(f"[{tag}] {name} step {r['step']}: loss {r['loss']:.5f}; "
            f"{r['tokens']} tokens; wall {r['wall_s'] * 1e3:.1f} ms "
            f"(step end to step end); peak {r['peak_above_tables_gb']:.2f} "
            f"GB above the tables")
    tl = eng.timeline_report()
    say(f"[{tag}] {name}: set-up {setup:.1f} s ({base_note}); run "
        f"{total * 1e3:.1f} ms for {n_steps} steps, steady steps 3.. "
        f"mean {1e3 * sum(walls[3:]) / len(walls[3:]):.1f} ms; timeline "
        f"computing {tl['computing_ratio']:.4f}, comm not overlapped "
        f"{tl['comm_not_overlapped_ratio']:.4f}, free "
        f"{tl['free_ratio']:.4f}; stage busy "
        f"{ {k: round(v * 1e3, 1) for k, v in tl['stage_s'].items()} } ms; "
        f"launches {counts}")
    return eng, dict(schedule=name, steps=steps, total_s=total,
                     timeline=tl, launches=counts)


def _step_launches(cfg, scatter="wscatter", *, neg_mode="fused",
                   schedule="worklist", lookup=False, neg_launches=1):
    """The kernel launches of one training step of full-width ``cfg``, for
    every counter of the port: the attention forward twice per layer
    (forward and checkpoint recompute) and its backward once, in the
    block's time mode and ``schedule``; in the fused ``neg_mode`` K3, K4
    and the scatter's run-sum (K5 ``wscatter`` or K6 ``runsum``) once, in
    the baseline and segmented modes K9 ``neg_launches`` times each way
    (once, or once per segment) and K6 once; with a ``lookup`` (K7) two
    gathers, the inputs' and the labels'."""
    L = cfg.num_layers
    want = {k: 0 for k in _read_counts()}
    want[_attn_counter(cfg, "fwd", schedule)] = 2 * L
    want[_attn_counter(cfg, "bwd", schedule)] = L
    if neg_mode == "fused":
        want.update({"neg_fwd": 1, "neg_bwd": 1, scatter: 1})
    else:
        want.update(neg_logits_fwd=neg_launches, neg_logits_bwd=neg_launches,
                    runsum=1)
    if lookup:
        want["gather"] = 2
    return want


def phase_engine(arch="hstu-large", tag="engine"):
    """The training entry point's main path at full width: GREngine over
    the port's GRLoader (1 x 4 x 2048, R 128, vocab 2^22), tau=1, the
    default fused scatter, Algorithm-1 schedule, then a profiled window,
    then the flat schedule from the same init."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.configs import get_arch
    from repro_torch.training import host_unique_candidates
    cfg = get_arch(arch)
    V, d = cfg.vocab_size, cfg.d_model
    n_steps = ENGINE_STEPS[arch]
    eng, alg = _engine_run(arch, "algorithm1", V, "tables drawn on the card",
                           tag)
    losses = [r["loss"] for r in alg["steps"]]
    want = {k: n_steps * v
            for k, v in _step_launches(cfg, "wscatter").items()}
    check(alg["launches"] == want, f"the engine launched {alg['launches']}, "
          f"expected {want}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(4.6 <= losses[0] <= 5.6, f"first loss {losses[0]} outside [4.6, "
          f"5.6] (ln(129) + 0.64²/2 = 5.07 at init)")
    peak = max(r["peak_above_tables_gb"] for r in alg["steps"])
    check(peak < V * d * 4 / 1e9, f"the engine peaks {peak:.2f} GB above "
          f"the tables, not below a (V, d) fp32 array "
          f"({V * d * 4 / 1e9:.2f} GB)")
    tbl = eng.state.table
    touched = np.unique(np.concatenate(
        [host_unique_candidates(b, V)[0]
         for b in _train_loader(V).batches(n_steps)]))
    rows = torch.from_numpy(touched).to(tbl.master.device)
    bad = 0
    for lo in range(0, rows.numel(), 1 << 18):
        idx = rows[lo:lo + (1 << 18)].long()
        bad += int((tbl.shadow[idx] != tbl.master[idx].half()).sum())
    check(bad == 0, f"{tag}: shadow != master.half() at {bad} elements")
    say(f"[{tag}] checks: launches {n_steps} x one step's; losses "
        f"finite, first {losses[0]:.4f}; peak above the tables {peak:.2f} "
        f"GB < {V * d * 4 / 1e9:.2f} GB (no (V, d) fp32 array); shadow == "
        f"master.half() bitwise on the {rows.numel()} touched rows; carry "
        f"{eng.state.pending_ids.numel()} pairs")

    # a steady-state window under the profiler: 6 more steps (the carry of
    # the first run lands mid-prologue), steps 3 and 4 recorded
    window, marks = [], []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=2, warmup=1, active=2, repeat=1),
                 on_trace_ready=lambda p: window.append(_device_rows(p))
                 ) as prof:
        def on_step(i, rec, state):
            marks.append(time.perf_counter())
            prof.step()
        eng.step_callback = on_step
        more = eng.run(6)
        torch.cuda.synchronize()
    check(len(window) == 1 and all(math.isfinite(r["loss"]) for r in more),
          f"{tag}: the profiled window recorded nothing or lost finite "
          "losses")
    rows_ = window[0]
    wall = (marks[4] - marks[2]) * 1e3
    busy = sum(r[0] for r in rows_)
    say(f"[profile] {tag} algorithm1 steady window (2 steps): wall "
        f"{wall:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall:.3f}")
    for ms, n, key in rows_[:12]:
        say(f"[profile]   {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    prof_out = {"wall_ms": wall, "busy_ms": busy,
                "top": [(r[2][:60], r[0], r[1]) for r in rows_[:12]]}
    del eng, tbl, rows
    flat_eng, flat = _engine_run(arch, "flat", V, "the same seed", tag)
    del flat_eng
    torch.cuda.empty_cache()
    flat_losses = [r["loss"] for r in flat["steps"]]
    check(flat["launches"] == want, f"flat launched {flat['launches']}")
    check(flat_losses == losses, f"flat losses {flat_losses} differ from "
          f"algorithm1's {losses}")
    say(f"[{tag}] flat schedule from the same init: losses equal to "
        f"algorithm1's bit for bit")
    if arch == "hstu-large":
        prof_out["obs"] = _engine_obs_run(arch, V, tag, losses,
                                          alg["timeline"])
    return alg, flat, prof_out


def _engine_obs_run(arch, V, tag, losses, plain_timeline):
    """The phase's Algorithm-1 run once more with ``obs=Obs()`` from the
    same init: the losses bit for bit the plain run's; the exported trace
    parsed back, its stage tracks' busy time ``timeline_report``'s; the
    steady steps' measured MFU against the card's peak, and the pipeline's
    goodput."""
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.obs import Obs, gr_dense_params, trace_busy_by_track
    gc.collect()
    torch.cuda.empty_cache()
    obs = Obs()
    eng, run = _engine_run(arch, "algorithm1", V, "the same seed, obs on",
                           f"{tag}_obs", obs=obs)
    got = [r["loss"] for r in run["steps"]]
    check(got == losses, f"{tag}: losses with obs {got} differ from the "
          f"plain run's {losses}")
    tl = eng.timeline_report()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        obs.export_trace(path)
        with open(path) as f:
            busy = trace_busy_by_track(json.load(f))
    worst = max(abs(busy[k] - v) / max(v, 1e-12)
                for k, v in tl["stage_s"].items())
    check(set(busy) == set(tl["stage_s"]) and worst <= 1e-6,
          f"{tag}: trace busy {busy} vs timeline_report {tl['stage_s']}")
    snap = obs.snapshot()
    val = lambda k: snap[k]["values"][""]                # noqa: E731
    mfus = [r["mfu"] for r in run["steps"][3:]]
    walls = [r["step_wall_s"] for r in run["steps"][3:]]
    cfg = get_arch(arch)
    out = dict(mfu_steady_mean=sum(mfus) / len(mfus), mfu_steady=mfus,
               step_wall_steady_s=walls, peak_flops=eng.peak_flops,
               flops_per_token=6.0 * gr_dense_params(cfg),
               goodput=val("train_pipeline_goodput"),
               bubble_ratio=val("train_pipeline_bubble_ratio"),
               last_mfu_gauge=val("train_mfu_measured"),
               trace_busy_s=busy, worst_busy_rel=worst,
               tokens_per_step=[r["tokens"] for r in run["steps"]],
               card=CARD.get("smi_line"))
    say(f"[{tag}_obs] losses bit for bit the plain run's; trace tracks' "
        f"busy time = timeline_report's (worst relative {worst:.2e}); "
        f"steady steps 3.. measured MFU mean {out['mfu_steady_mean']:.4f} "
        f"(per step {[round(m, 4) for m in mfus]}) against the peak "
        f"{eng.peak_flops:.4g} FLOP/s (6 x {gr_dense_params(cfg)} dense "
        f"params x tokens), pipeline goodput {out['goodput']:.4f}, bubble "
        f"{out['bubble_ratio']:.4f}; card {CARD.get('smi_line')}")
    del eng
    return out


# --------------------------------------------------------------------------
# phase 6c: supervised recovery (GREngine.run_resilient) at full width
# --------------------------------------------------------------------------

RESILIENT_VOCAB = 1 << 18         # ~4.5 GB a checkpoint instead of ~37 GB
RESILIENT_STEPS = 12


def _state_bits(st):
    """Every tensor of a training state on the host (the shadow included),
    for bitwise comparisons across engines."""
    from repro_torch.training import state_tensors
    return [t.detach().cpu() for t in state_tensors(st)]


def phase_resilient():
    """GREngine.run_resilient on full-width, full-depth hstu-large (d 1024,
    16 layers, bf16; the engine's loader mix, fused with K5, tau=1,
    Algorithm 1) at vocab 2^18: 12 uninterrupted steps, then 12 under
    supervision (async checkpoints every 4, keep 2) with an escalated stage
    exception, a NaN-poisoned batch and a torn save (a flipped byte that
    only the CRC sees), each followed by a restore of step 4; every loss
    and the whole final state bit for bit the uninterrupted run's, and the
    replayed steps' launches counted. Then the final checkpoint restored
    into a fresh engine trains 2 more steps bit for bit as the
    uninterrupted run continued. Checkpoints go to a temporary directory,
    removed at the end."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.obs import Obs
    from repro_torch.training import GREngine
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import resilience as R
    tag = "resilient"
    dev = torch.device("cuda")
    cfg = get_arch("hstu-large").replace(vocab_size=RESILIENT_VOCAB)
    bundle = GRBundle(cfg)
    N = RESILIENT_STEPS
    t0 = time.perf_counter()
    batches = list(_train_loader(cfg.vocab_size).batches(N + 2))
    say(f"[{tag}] {cfg.name} d={cfg.d_model} layers={cfg.num_layers} "
        f"{cfg.dtype}, vocab {cfg.vocab_size} (cut from 2^22 so that a "
        f"checkpoint is ~4.5 GB), loader 1 x 4 x 2048, R 128; {N + 2} "
        f"batches in {time.perf_counter() - t0:.1f} s")

    ref = GREngine(bundle, lambda i: batches[i], seed=SEED, device=dev)
    losses = [r["loss"] for r in ref.run(N)]
    want = _state_bits(ref.state)
    more = GREngine(bundle, lambda i: batches[N + i], state=ref.state)
    more_losses = [r["loss"] for r in more.run(2)]
    want_more = _state_bits(more.state)
    del ref, more
    gc.collect()
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses + more_losses),
          f"{tag}: uninterrupted losses {losses + more_losses}")

    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        obs = Obs()
        eng = GREngine(bundle, lambda i: batches[i], seed=SEED, device=dev,
                       obs=obs)
        # the torn save flips a byte of the largest leaf (the master, 1.07
        # GB): the leaf loads, and only its CRC can refuse the step
        faults = [R.FaultSpec("dense_fwd", 5, "exception"),
                  R.FaultSpec("dense_fwd", 7, "nan"),
                  R.FaultSpec(R.SAVE_SITE, 8, "torn_save", tear="bitflip")]
        inj = R.FaultInjector(faults)
        refused = []
        load = CKPT._load_step_arrays

        def spy(ckpt_dir, step, *a, **kw):
            try:
                return load(ckpt_dir, step, *a, **kw)
            except CKPT.CheckpointCorrupt as e:
                refused.append((step, str(e)))
                raise
        CKPT._load_step_arrays = spy
        _zero_counts()
        t = time.perf_counter()
        try:
            recs = eng.run_resilient(N, ckpt_dir=d, ckpt_every=4,
                                     keep_last_n=2, async_save=True,
                                     policy=R.FaultPolicy(retries={}),
                                     injector=inj)
        finally:
            CKPT._load_step_arrays = load
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = _read_counts()
        got = [r["loss"] for r in recs]
        check(inj.exhausted and len(eng.recoveries) == 3,
              f"{tag}: {len(eng.recoveries)} recoveries, faults left "
              f"{inj._pending}")
        check([ev.restored_step for ev in eng.recoveries] == [4, 4, 4]
              and [s for s, _ in refused] == [8]
              and "CRC mismatch" in refused[0][1],
              f"{tag}: restored steps "
              f"{[ev.restored_step for ev in eng.recoveries]}, refused "
              f"{refused} (want step 8 refused by its CRC, then step 4)")
        check(got == losses, f"{tag}: resilient losses {got} differ from "
              f"the uninterrupted run's {losses}")
        bits = _state_bits(eng.state)
        check(len(bits) == len(want) and all(
            torch.equal(a, b) for a, b in zip(bits, want)),
            f"{tag}: the final state differs from the uninterrupted run's")
        del bits
        replayed = sum(ev.steps_lost for ev in eng.recoveries)
        per_step = _step_launches(cfg, "wscatter")
        need = {k: v * (N + replayed) for k, v in per_step.items() if v}
        check(replayed > 0 and all(counts[k] >= v for k, v in need.items()),
              f"{tag}: launches {counts} for {N} steps + {replayed} "
              f"replayed, need at least {need}")
        snapv = obs.snapshot()
        save = snapv["ckpt_save_s"]["values"][""]
        rest = snapv["ckpt_restore_s"]["values"][""]
        nbytes = eng.snapshots[-1][2]
        d2h = [s for _, s, _ in eng.snapshots]
        out = dict(
            wall_s=wall, losses=got, recoveries=[
                dict(failed=ev.failed_step, restored=ev.restored_step,
                     steps_lost=ev.steps_lost, wall_s=ev.wall_s,
                     error=ev.error[:80]) for ev in eng.recoveries],
            steps_replayed=replayed, launches=counts,
            ckpt_bytes=nbytes, saves=save["count"],
            save_mean_s=save["sum"] / save["count"],
            restores=rest["count"],
            restore_mean_s=rest["sum"] / max(rest["count"], 1),
            d2h_s=d2h, card=CARD.get("smi_line"))
        say(f"[{tag}] run_resilient to step {N}: {wall:.1f} s; recoveries "
            f"{out['recoveries']}; {replayed} steps replayed; losses and "
            f"every state tensor bit for bit the uninterrupted run's; "
            f"launches {counts} (at least {need})")
        say(f"[{tag}] checkpoints of {nbytes / 1e9:.3f} GB: {save['count']} "
            f"saves (async thread) mean {out['save_mean_s']:.2f} s "
            f"({nbytes / out['save_mean_s'] / 1e9:.2f} GB/s, CRC32 + write "
            f"+ fsync); {rest['count']} restores mean "
            f"{out['restore_mean_s']:.2f} s "
            f"({nbytes / max(out['restore_mean_s'], 1e-9) / 1e9:.2f} GB/s, "
            f"read + CRC32 + copy to the card); host copies (D2H, on the "
            f"caller's thread) {[round(x, 3) for x in d2h]} s; card "
            f"{CARD.get('smi_line')}")
        check(CKPT.intact_steps(d) == [N, N - 4], f"{tag}: intact steps "
              f"{CKPT.intact_steps(d)} (keep_last_n=2)")
        # the steps' walls with and without a save on the saver thread:
        # after the last restore (step 4) steps 5-7 ran with none in
        # flight, steps 9-11 beside the step-8 save (step 4 and 8 walls
        # hold the run's start and the save's host copy)
        wall = {r["step"]: r["step_wall_s"] for r in recs}
        quiet = [wall[s] for s in (5, 6, 7)]
        busy = [wall[s] for s in (9, 10, 11)]
        out["step_wall_no_save_s"], out["step_wall_beside_save_s"] = \
            quiet, busy
        say(f"[{tag}] step walls with no save in flight (steps 5-7) "
            f"{[round(x * 1e3, 1) for x in quiet]} ms, beside the step-8 "
            f"save (9-11) {[round(x * 1e3, 1) for x in busy]} ms")
        del eng, obs
        gc.collect()
        torch.cuda.empty_cache()

        fresh = GREngine(bundle, lambda i: batches[N + i], seed=SEED + 1,
                         device=dev)
        t = time.perf_counter()
        fresh.state, used = CKPT.restore_with_step(d, fresh.state)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t
        cont = [r["loss"] for r in fresh.run(2)]
        check(used == N and cont == more_losses, f"{tag}: restored step "
              f"{used}, then losses {cont} vs {more_losses}")
        bits = _state_bits(fresh.state)
        check(all(torch.equal(a, b) for a, b in zip(bits, want_more)),
              f"{tag}: the resumed engine's state differs")
        out.update(resume_restore_s=t_restore, resume_losses=cont)
        say(f"[{tag}] step {used} restored into a fresh engine in "
            f"{t_restore:.2f} s; 2 more steps bit for bit the uninterrupted "
            f"run continued ({cont})")
        del fresh, bits
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 6b: the §4.3 / Table-7 ablation (baseline and segmented negatives)
# --------------------------------------------------------------------------

ABLATION_STEPS = 6
# Losses of one init and batch across the negative paths. segmented vs
# fused: the same fp16 rows (the shadow is the master rounded to fp16) and
# the same fp32 logits, summed in another order (K9 against K3): 1e-5 of
# the loss. baseline vs fused: the baseline's rows are the master rounded
# to bf16 (2^-9 relative per element against fp16's 2^-12), which moves
# each logit by ~1e-3 of its size at random; over 8 K tokens x 128
# negatives the mean loss moves far less: 1e-3 of the loss.
ABLATION_LOSS_TOL = {"segmented": 1e-5, "baseline": 1e-3}


def phase_ablation(fused_peak_gb):
    """The §4.3 / Table-7 ablation on full-width hstu-large over the
    engine's loader mix (1 x 4 x 2048, R 128, vocab 2^22), tau=1. First the
    first step's loss from one init and batch in the fused, segmented and
    baseline modes. Then GREngine (Algorithm 1) in two runs of
    ABLATION_STEPS steps, launch counts zeroed before and read after: (a)
    the baseline (K9 over the materialised (T, R, d) bf16 rows) with the
    kernel lookup (K7) as lookup_fn and the dense-grid attention (K8); (b)
    the segmented path (K9 per 128-token segment of fp16 rows) with §4.3.3
    sharing, expansion 2. → (per-run results, the first-step losses)."""
    from functools import partial

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.embedding.tables import live_shadow
    from repro_torch.kernels.jagged_attention import make_attn_fn
    from repro_torch.kernels.jagged_lookup import jagged_lookup
    from repro_torch.training import to_device
    cfg = get_arch("hstu-large")
    V, d = cfg.vocab_size, cfg.d_model
    dev = torch.device("cuda")
    first = {}

    def first_losses(eng):
        batch = to_device(next(iter(_train_loader(V).batches(1))), dev)
        st = eng.state
        with torch.no_grad():
            for mode in ("fused", "segmented", "baseline"):
                kw = {"shadow": live_shadow(st.table)} if mode == "fused" \
                    else {}
                first[mode] = float(eng.bundle.loss(
                    st.dense, st.table.master, batch, neg_mode=mode, **kw))
        rel = {m: abs(first[m] - first["fused"]) / abs(first["fused"])
               for m in ABLATION_LOSS_TOL}
        say(f"[ablation] first-step loss, one init and batch: fused "
            f"{first['fused']:.6f}, segmented {first['segmented']:.6f} "
            f"({rel['segmented']:.2e} of fused), baseline "
            f"{first['baseline']:.6f} ({rel['baseline']:.2e} of fused)")
        for m, tol in ABLATION_LOSS_TOL.items():
            check(rel[m] <= tol, f"{m} first loss {first[m]} is "
                  f"{rel[m]:.2e} of fused's {first['fused']}, above {tol}")

    T = _train_loader(V).batches(1).__next__()["ids"].size
    runs = {
        "a": (dict(neg_mode="baseline",
                   lookup_fn=partial(jagged_lookup,
                                     compute_dtype=torch.bfloat16),
                   attn_fn=make_attn_fn(schedule="dense",
                                        max_row_len=cfg.max_seq_len)),
              _step_launches(cfg, neg_mode="baseline", schedule="dense",
                             lookup=True),
              "baseline, lookup_fn = K7, schedule dense (K8)", first_losses),
        "b": (dict(neg_mode="segmented", expansion=2),
              _step_launches(cfg, neg_mode="segmented",
                             neg_launches=T // 128),
              "segmented, expansion 2", None)}
    out = {}
    for key, (lk, per_step, note, before) in runs.items():
        eng, res = _engine_run("hstu-large", "algorithm1", V, note,
                               f"ablation {key}", loss_kwargs=lk,
                               n_steps=ABLATION_STEPS, before_run=before)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        losses = [r["loss"] for r in res["steps"]]
        walls = [r["wall_s"] for r in res["steps"]][3:]
        peak = max(r["peak_above_tables_gb"] for r in res["steps"])
        res.update(steady_ms=1e3 * sum(walls) / len(walls), peak_gb=peak,
                   per_step_launches={k: v / ABLATION_STEPS
                                      for k, v in res["launches"].items()
                                      if v})
        say(f"[ablation {key}] {note}: steady step (steps 3..) "
            f"{res['steady_ms']:.1f} ms; peak above the state {peak:.2f} "
            f"GB; launches per step {res['per_step_launches']}")
        want = {k: ABLATION_STEPS * v for k, v in per_step.items()}
        check(res["launches"] == want, f"ablation {key} launched "
              f"{res['launches']}, expected {want}")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        check(4.6 <= losses[0] <= 5.6, f"ablation {key}: first loss "
              f"{losses[0]} outside [4.6, 5.6]")
        check(peak < V * d * 4 / 1e9, f"ablation {key} peaks {peak:.2f} GB "
              f"above the state, not below a (V, d) fp32 array")
        out[key] = res
    say(f"[ablation] Table 7, peak device memory above the state (tables, "
        f"dense params, AdamW moments) of a tau=1 engine step on "
        f"hstu-large, T = {T} token slots, R = {cfg.num_negatives}: "
        f"baseline {out['a']['peak_gb']:.2f} GB, segmented "
        f"{out['b']['peak_gb']:.2f} GB, fused {fused_peak_gb:.2f} GB "
        f"(phase engine); steady step baseline {out['a']['steady_ms']:.1f} "
        f"ms, segmented {out['b']['steady_ms']:.1f} ms")
    return out, first


# --------------------------------------------------------------------------
# phase 7: kernels against plain versions; the engine's bitwise contract
# --------------------------------------------------------------------------

class _PlainVersions:
    """Within the block, the training path's kernel wrappers call their
    plain versions on card tensors (a check only: the port's wrappers
    launch the kernel for every card tensor)."""

    def __enter__(self):
        from repro_torch.kernels.jagged_attention import ops as AO
        from repro_torch.kernels.jagged_lookup import ops as LO
        from repro_torch.kernels.neg_logits import ops as NO
        from repro_torch.kernels.neg_logits import ref as NR
        self.saved = [(AO, "attention_core", AO.attention_core),
                      (NO, "neg_fwd", NO.neg_fwd),
                      (NO, "neg_bwd", NO.neg_bwd),
                      (LO, "_device_check", LO._device_check)]
        AO.attention_core = AO.plain_core
        NO.neg_fwd = NR.neg_fwd_plain
        NO.neg_bwd = NR.neg_bwd_plain
        LO._device_check = lambda rows: False
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_parity():
    """At full width, 2 layers, vocab 2^18, from one init: (a) one sync
    step's dense_fwd_bwd + table-grad pairs, kernels against plain
    versions on the card: hstu-large with the two-pass scatter (K6) and
    the fused one (K5), fuxi-large (the functional K1-fwd and K2, then the
    functional K8 of the dense schedule) with the fused one; (b) GREngine on hstu-large, algorithm1 and flat, against
    make_gr_train_step over 4 steps, sync and tau=1: losses, every state
    tensor and the carry bit for bit. Returns the results and the kernel
    launches of the kernel runs of (a)."""
    import torch
    launches = {}
    res, state, bundle, batches = _dense_pass_parity(
        "hstu-large", ("two_pass", "fused"), launches)
    same = (torch.equal(res["fused"]["ids"], res["two_pass"]["ids"])
            and torch.equal(res["fused"]["pairs"], res["two_pass"]["pairs"]))
    say(f"[parity] kernels, fused vs two-pass table-grad pairs bit for bit: "
        f"{same}; peak above the state over one dense pass + pairs "
        f"(T = {batches[0]['ids'].size} tokens, R = "
        f"{bundle.cfg.num_negatives}): two-pass "
        f"{res['peak_gb']['two_pass']:.2f} GB, fused "
        f"{res['peak_gb']['fused']:.2f} GB")
    check(same, "parity: the fused and two-pass steps' pairs differ")
    for impl in ("two_pass", "fused"):
        del res[impl]["ids"], res[impl]["pairs"]
    res["engine"] = _engine_contract(bundle, state, batches)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    for schedule in ("worklist", "dense"):
        fuxi, state, _, _ = _dense_pass_parity("fuxi-large", ("fused",),
                                               launches, schedule)
        del state, fuxi["fused"]["ids"], fuxi["fused"]["pairs"]
        res["fuxi" if schedule == "worklist" else "fuxi_dense"] = fuxi
        gc.collect()
        torch.cuda.empty_cache()
    return res, launches


def _dense_pass_parity(arch, impls, launches, schedule="worklist"):
    """One sync step's dense pass + table-grad pairs of full-width ``arch``
    cut to 2 layers and vocab 2^18, kernels against plain versions, per
    scatter in ``impls``, the attention in ``schedule``; adds the kernel
    runs' launches to ``launches``. → (results by impl with "peak_gb", the
    init state, bundle, batches)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.jagged_attention import make_attn_fn
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import gr_train_state, make_gr_stages, to_device
    from repro_torch.training.trainer import _table_grad_pairs
    dev = torch.device("cuda")
    cfg = get_arch(arch).replace(num_layers=2, vocab_size=2 ** 18)
    V = cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    bundle = GRBundle(cfg)
    state = gr_train_state(bundle.init_dense(gen, device=dev),
                           bundle.init_table(gen, device=dev))
    if cfg.gr_block == "fuxi":
        # FuXi's time amplitude at working values (0.02 at init would
        # keep the time bias, and its grads' effect, below 0.02)
        with torch.no_grad():
            for bp in state.dense.blocks:
                bp.rab["time_amp"].fill_(1.0)
    batches = _train_batches(V, 4)
    batch = to_device(batches[0], dev)

    peaks = {}

    attn_fn = make_attn_fn(schedule=schedule, max_row_len=cfg.max_seq_len)

    def run(impl):
        st = make_gr_stages(
            lambda dd, t, bt, **kw: bundle.loss(dd, t, bt,
                                                neg_scatter_impl=impl,
                                                attn_fn=attn_fn, **kw),
            input_gather=bundle.input_gather, semi_async=False)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = st.dense_fwd_bwd(state.dense, state.table, batch)
        ids, rows = _table_grad_pairs(out.table_contribs.pop(), V)
        torch.cuda.synchronize()
        peaks.setdefault(impl, (torch.cuda.max_memory_allocated() - base)
                         / 1e9)
        return out.loss.item(), out.grads_dense, ids, rows

    res = {}
    for impl in impls:
        kname = {"two_pass": "runsum", "fused": "wscatter"}[impl]
        _zero_counts()
        kl, kg, kids, krows = run(impl)
        counts = _read_counts()
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        with _PlainVersions():
            _zero_counts()
            pl, pg, pids, prows = run(impl)
            plain_counts = _read_counts()
        want = _step_launches(cfg, kname, schedule=schedule)
        check(counts == want and not any(plain_counts.values()),
              f"{arch} {impl}: kernel run launched {counts}, expected "
              f"{want}; plain run {plain_counts}")
        g_err = {n: _rel_to_max(kg[n], pg[n]) for n in kg}
        worst = max(g_err, key=g_err.get)
        ids_equal = torch.equal(kids, pids)
        r_err = _rel_to_max(krows, prows) if ids_equal else math.inf
        say(f"[parity] {cfg.name} x {cfg.num_layers} layers, vocab {V}, "
            f"bf16, {impl} scatter, {schedule} attention: loss kernels "
            f"{kl:.6f} plain {pl:.6f} "
            f"(|d| {abs(kl - pl):.2e}); dense grads worst {worst} "
            f"{g_err[worst]:.3e} of its max (median over {len(g_err)} "
            f"tensors {sorted(g_err.values())[len(g_err) // 2]:.3e}); "
            f"table-grad pairs {kids.numel()} ids equal {ids_equal}, rows "
            f"{r_err:.3e} of max")
        rab_err = {n: e for n, e in g_err.items() if ".rab." in n}
        say(f"[parity] {cfg.name} RAB grads, of their max: "
            + ", ".join(f"{n} {e:.3e}" for n, e in sorted(rab_err.items())))
        # bf16 activations: an attention output or weight that rounds the
        # other way moves by one bf16 ulp (2^-8 relative) and the loss and
        # grads carry it through 2 layers: loss to 1e-3 of itself, grads
        # (the RAB's, the functional time encoder's included) and table
        # rows to 5e-2 of their largest values
        check(abs(kl - pl) <= 1e-3 * abs(pl), f"parity {arch} {impl}: loss")
        check(g_err[worst] <= 5e-2, f"parity {arch} {impl}: dense grad "
              f"{worst}")
        check(ids_equal and r_err <= 5e-2,
              f"parity {arch} {impl}: table-grad pairs")
        res[impl] = dict(loss=(kl, pl), grad_worst=(worst, g_err[worst]),
                         rab_grads=rab_err, rows=r_err, ids=kids,
                         pairs=krows)
    res["peak_gb"] = peaks
    return res, state, bundle, batches


def _engine_contract(bundle, init, batches):
    """GREngine (algorithm1, flat) against make_gr_train_step over 4
    steps from ``init``, sync and tau=1, kernels on: every loss, state
    tensor and the carry equal bit for bit."""
    import torch
    from repro_torch.training import (GREngine, clone_state, make_gr_step_fn,
                                      state_tensors, to_device)
    out = {}
    for semi in (False, True):
        step = make_gr_step_fn(bundle, semi_async=semi)
        ref = clone_state(init)
        losses = []
        for b in batches:
            ref, m = step(ref, to_device(b, init.table.master.device))
            losses.append(float(m["loss"]))
        for sched in ("algorithm1", "flat"):
            eng = GREngine(bundle, lambda i: batches[i],
                           state=clone_state(init), semi_async=semi,
                           schedule=sched)
            got = [r["loss"] for r in eng.run(len(batches))]
            st = eng.state
            equal = (got == losses and st.step == ref.step
                     and all(torch.equal(a, b) for a, b in
                             zip(state_tensors(st), state_tensors(ref))))
            name = f"{'tau1' if semi else 'sync'} {sched}"
            say(f"[parity] GREngine {name} vs make_gr_train_step, "
                f"{len(batches)} steps: losses {got}; every state tensor "
                f"and the carry ({st.pending_ids.numel()} pairs) bit for "
                f"bit: {equal}")
            check(equal, f"GREngine {name} differs from make_gr_train_step")
            out[name] = equal
            del eng, st
        del ref
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 8: the training CLI
# --------------------------------------------------------------------------

CLI_ARGS = ["--synthetic-users", "400", "--num-items", "200000",
            "--max-seq-len", "512", "--users-per-device", "2",
            "--num-negatives", "32", "--log-every", "4"]
CLI_RUNS = (("hstu-large", 8, "fused"), ("fuxi-large", 4, "fused"),
            ("hstu-large", 4, "segmented"), ("hstu-large", 4, "baseline"),
            ("hstu-large", 4, "resilient"))
# the resilient run's flags; it is then resumed to CLI_RESUME_STEPS
CLI_RESILIENT = ["--ckpt-every", "2", "--keep-last-n", "2",
                 "--metrics-every", "2"]
CLI_RESUME_STEPS = 6


def phase_cli():
    """``python -m repro_torch.launch.train`` on the card, as a user runs
    it: hstu-large and fuxi-large on the fused path, and hstu-large with
    ``--neg-mode segmented`` and ``--neg-mode baseline``, and hstu-large
    with checkpoints and telemetry (``--ckpt-dir``, ``--ckpt-every``,
    ``--trace-out``, ``--metrics-out``), the processes side by side (each
    holds a few GB): each must exit 0 and end with ``[done]`` and a finite
    final loss. Then the resilient run is resumed (``--resume``) to more
    steps: it must print ``[resume] restored intact checkpoint step N``,
    and both output files must parse."""
    import shutil
    import tempfile
    import torch
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    t = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    files = {"--ckpt-dir": os.path.join(tmp, "ckpt"),
             "--trace-out": os.path.join(tmp, "trace.json"),
             "--metrics-out": os.path.join(tmp, "metrics.json")}
    resilient = [x for k, v in files.items() for x in (k, v)] + CLI_RESILIENT
    procs = {}

    def start(args):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *args]
        return subprocess.Popen(cmd, cwd=ROOT, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    for arch, steps, mode in CLI_RUNS:
        args = ["--arch", arch, "--steps", str(steps), *CLI_ARGS]
        args += (resilient if mode == "resilient" else ["--neg-mode", mode])
        procs[f"{arch} {mode}"] = (args, start(args))
    out = {}
    try:
        for arch, (args, p) in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            wall = time.perf_counter() - t
            for ln in stdout.strip().splitlines():
                say(f"[cli] {ln}")
            check(p.returncode == 0, f"the CLI ({arch}) exited "
                  f"{p.returncode}: {stderr[-3000:]}")
            done = [ln for ln in stdout.splitlines()
                    if ln.startswith("[done]")]
            check(len(done) == 1 and "final loss" in done[0],
                  f"the CLI ({arch}) printed no [done] line with a final "
                  f"loss")
            final = float(done[0].rsplit("final loss", 1)[1])
            check(math.isfinite(final), f"the CLI's final loss {final}")
            say(f"[cli] {' '.join(args)}: exit 0, {wall:.1f} s after the "
                f"start of all {len(procs)}, final loss {final:.4f}")
            out[arch] = dict(wall_s=wall, final_loss=final)
        first = out["hstu-large resilient"]
        args = (["--arch", "hstu-large", "--steps", str(CLI_RESUME_STEPS),
                 *CLI_ARGS, "--resume"] + resilient)
        procs["resume"] = (args, start(args))
        stdout, stderr = procs["resume"][1].communicate(timeout=600)
        for ln in stdout.strip().splitlines():
            say(f"[cli] resume: {ln}")
        check(procs["resume"][1].returncode == 0, f"the resumed CLI exited "
              f"{procs['resume'][1].returncode}: {stderr[-3000:]}")
        want = f"[resume] restored intact checkpoint step {CLI_RUNS[-1][1]}"
        check(want in stdout, f"the resumed CLI did not print {want!r}")
        check(any(ln.startswith(f"[done] {CLI_RESUME_STEPS} steps")
                  for ln in stdout.splitlines()), "the resumed CLI printed "
              "no [done] line")
        with open(files["--trace-out"]) as f:
            trace = json.load(f)
        with open(files["--metrics-out"]) as f:
            metrics = json.load(f)
        n_x = sum(ev["ph"] == "X" for ev in trace["traceEvents"])
        steps_total = metrics["train_steps_total"]["values"][""]
        check(n_x > 0 and steps_total == CLI_RESUME_STEPS - CLI_RUNS[-1][1],
              f"the resumed CLI's trace has {n_x} spans and its metrics "
              f"{steps_total} steps")
        say(f"[cli] resumed to {CLI_RESUME_STEPS} steps: printed {want!r}; "
            f"its trace ({n_x} spans) and metrics snapshot "
            f"({len(metrics)} families, train_steps_total {steps_total}) "
            f"parse; {time.perf_counter() - t:.1f} s after the start")
        first["resumed"] = dict(trace_spans=n_x, metric_families=len(metrics))
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# --------------------------------------------------------------------------

def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        say(f"FAIL: no src/repro_torch beside {Path(__file__).name}: run "
            f"this script from a checkout of the repository")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    times = {}

    def run(name, fn, *args):
        import torch
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
            say(f"[phase] {name}: torch.cuda.memory_allocated() "
                f"{torch.cuda.memory_allocated() / 1e9:.3f} GB at the start")
        t = time.perf_counter()
        out = fn(*args)
        times[name] = round(time.perf_counter() - t, 1)
        return out

    try:
        name, count, smi_line = phase_device()
        run("build", phase_build)
        attn = run("attn_kernels", phase_kernels)
        neg = run("neg_kernels", phase_neg_kernels)
        rs = run("runsum_kernel", phase_runsum_kernel)
        ws = run("wscatter_kernel", phase_wscatter_kernel)
        k9 = run("neg_logits_kernel", phase_neg_logits_kernel)
        k7 = run("gather_kernel", phase_gather_kernel)
        serve = run("serve", phase_serve, "hstu-large", "serve")
        serve_fuxi = run("serve_fuxi", phase_serve, "fuxi-large",
                         "serve_fuxi")
        stream = run("stream", phase_stream)
        per_step, train_prof = run("train", phase_train)
        alg, flat, engine_prof = run("engine", phase_engine, "hstu-large",
                                     "engine")
        f_alg, f_flat, f_prof = run("engine_fuxi", phase_engine,
                                    "fuxi-large", "engine_fuxi")
        ablation, first_losses = run(
            "ablation", phase_ablation,
            max(r["peak_above_tables_gb"] for r in alg["steps"]))
        resilient = run("resilient", phase_resilient)
        parity, parity_launches = run("parity", phase_parity)
        run("cli", phase_cli)
    except Failed as e:
        say(f"FAIL: {e}")
        return 1
    except Exception:                                # noqa: BLE001 — report
        traceback.print_exc()
        say("FAIL: exception (traceback above)")
        return 1
    train_launches = {}
    for r in per_step:
        for k, v in r["launches"].items():
            train_launches[k] = train_launches.get(k, 0) + v
    say(f"[result] total {time.perf_counter() - t_start:.1f} s; phases "
        f"{times}; rounds {json.dumps(serve[1])}; FuXi rounds "
        f"{json.dumps(serve_fuxi[1])}")
    say(f"[result] stream {json.dumps({k: v for k, v in stream.items() if k != 'stats'})}")
    say(f"[result] train steps {json.dumps(per_step)}")
    say(f"[result] engine {json.dumps([alg, flat, engine_prof])}")
    say(f"[result] engine_fuxi {json.dumps([f_alg, f_flat, f_prof])}")
    say(f"[result] ablation {json.dumps([ablation, first_losses])}")
    say(f"[result] resilient {json.dumps(resilient)}")
    main_attn = lambda k: attn[(k, "long_tail", "bfloat16")]  # noqa: E731
    attn_src = "src/repro/kernels/jagged_attention/kernel.py"
    rows = [("attn_fwd", "jagged_attn_fwd.cu", f"{attn_src}:384",
             main_attn("attn_fwd"), None),
            ("attn_bwd", "jagged_attn_bwd.cu", f"{attn_src}:781",
             main_attn("attn_bwd"), None),
            ("attn_fwd_functional", "jagged_attn_fwd.cu", f"{attn_src}:384",
             main_attn("attn_fwd_functional"), None),
            ("attn_fwd_append", "jagged_attn_fwd.cu", f"{attn_src}:384",
             stream["append_kernel"]["bfloat16"], None),
            ("attn_bwd_functional", "jagged_attn_bwd.cu", f"{attn_src}:781",
             main_attn("attn_bwd_functional"), None),
            ("attn_fwd_dense", "jagged_attn_fwd.cu", f"{attn_src}:333",
             main_attn("attn_fwd_dense"), None),
            ("attn_bwd_dense", "jagged_attn_bwd.cu", f"{attn_src}:696",
             main_attn("attn_bwd_dense"), None),
            ("attn_fwd_dense_functional", "jagged_attn_fwd.cu",
             f"{attn_src}:333", main_attn("attn_fwd_dense_functional"),
             None),
            ("attn_bwd_dense_functional", "jagged_attn_bwd.cu",
             f"{attn_src}:696", main_attn("attn_bwd_dense_functional"),
             None),
            ("neg_fwd", "neg_fused.cu",
             "src/repro/kernels/neg_logits/fused.py:159", neg["neg_fwd"],
             None),
            ("neg_bwd", "neg_fused.cu",
             "src/repro/kernels/neg_logits/fused.py:279", neg["neg_bwd"],
             None),
            ("runsum", "runsum.cu",
             "src/repro/kernels/jagged_lookup/kernel.py:128", rs,
             rs["library_ms"]),
            ("wscatter", "wscatter.cu",
             "src/repro/kernels/jagged_lookup/kernel.py:177", ws,
             ws["library_ms"]),
            ("gather", "gather.cu",
             "src/repro/kernels/jagged_lookup/kernel.py:57", k7,
             k7["library_ms"]),
            ("neg_logits_fwd", "neg_logits.cu",
             "src/repro/kernels/neg_logits/kernel.py:31",
             k9["bf16"]["neg_logits_fwd"],
             k9["bf16"]["neg_logits_fwd"]["library_ms"]),
            ("neg_logits_bwd", "neg_logits.cu",
             "src/repro/kernels/neg_logits/kernel.py:57",
             k9["bf16"]["neg_logits_bwd"],
             k9["bf16"]["neg_logits_bwd"]["library_ms"])]
    kernels = []
    for kname, src, replaces, r, lib in rows:
        by_path = {"serve": serve[0].get(kname, 0),
                   "serve_fuxi": serve_fuxi[0].get(kname, 0),
                   "stream": stream["launches"].get(kname, 0),
                   "train": train_launches.get(kname, 0),
                   "engine": alg["launches"][kname]
                   + flat["launches"][kname],
                   "engine_fuxi": f_alg["launches"][kname]
                   + f_flat["launches"][kname],
                   "ablation": sum(r["launches"][kname]
                                   for r in ablation.values()),
                   "resilient": resilient["launches"][kname],
                   "parity": parity_launches.get(kname, 0)}
        if sum(by_path.values()) == 0:
            say(f"FAIL: {kname} was launched on no path")
            return 1
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            # special-function instructions are operations, at the SFUs'
            # rate; bound_detail names which operations bind
            "bound_by": ("bytes" if r["bound_by"] == "bytes"
                         else "operations"),
            "bound_detail": r["bound_by"], "library_ms": lib})
        # the achieved rate (K2: TFLOP/s of the needed products; K5: GB/s
        # of the bytes it must move) and the attention's time at the
        # engine's training pack
        if "tflops" in r:
            kernels[-1]["tflops"] = r["tflops"]
        if "gb_per_s" in r:
            kernels[-1]["gb_per_s"] = r["gb_per_s"]
        if kname == "attn_fwd_append":
            # K1-fwd's launch for the warm window, where the reference runs
            # pointwise_attention_append in XLA; fp32 beside it
            kernels[-1]["computes"] = "src/repro/models/hstu.py:333"
            kernels[-1]["fp32_ms"] = stream["append_kernel"]["float32"]["ms"]
        train_pack = attn.get((kname, "train_1x4x2048", "bfloat16"))
        if train_pack is not None:
            kernels[-1]["train_pack_ms"] = train_pack["ms"]
        # K9 at the segmented path's 128-token launch, fp16 rows, one call
        # at a time (warm, and cold beside it)
        seg = k9["fp16 segment"].get(kname)
        if seg is not None:
            kernels[-1]["segment"] = {
                k: seg[k] for k in ("ms", "library_ms", "bound_ms",
                                    "cold_ms", "cold_library_ms")}
    say(json.dumps({"kernels": kernels}))
    say(smi_line)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
