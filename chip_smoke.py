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
               checkout (one nvcc per source, all started together, on a
               thread beside phase 6f, which runs none of the kernels);
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
  3b. acausal — the non-causal mask (every key of the row, the weights
               over the row length): make_attn_fn(causal=False) forward
               and backward through autograd at full width on the training
               pack (q/k/v (8192, 8, 128) bf16), both time modes, both
               schedules, launch counts zeroed before and read after; then
               the acausal K1-fwd, K2 and K8 against the float64 plain
               version at the long-tail and training packs, bf16 and fp32,
               run to run bitwise, K8 bitwise K1-fwd/K2, times beside
               bounds and beside the causal kernels on the same inputs.
  3c. offload — the asynchronous negative offload: T=8192, R=128, d 1024
               fp16 rows gathered from an fp16 shadow of 2^22 rows, in
               pinned host memory (offload_negatives), streamed to K9 a
               128-token segment at a time (neg_logits_offloaded), forward
               and backward, launch counts zeroed before and read after;
               logits, do and dn bitwise K9 on the same segments held on the
               card; each direction's wall, the link's own GB/s (a plain
               pinned copy), K9's summed time, the hidden share, and the
               peak device memory against the same pass with the rows on
               the card.
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
               fuxi-large, 6 steps a schedule. engine_sasrec: full-width
               sasrec-large, 6 Algorithm-1 and 6 flat steps (K3/K4/K5;
               its softmax attention is plain PyTorch), bit for bit.
  6b. ablation — the §4.3 / Table-7 ablation on hstu-large, the engine's
               loader mix: the first step's loss from one init and batch in
               the fused, segmented and baseline modes; GREngine
               (Algorithm 1, tau=1) 6 steps with the baseline path (K9),
               the kernel lookup (K7) and the dense-grid attention (K8),
               and 6 steps with the segmented path and sharing (K9 per
               segment), each with launch counts, step walls and the peak
               above the state.
  6c. resilient — run_resilient on full-width hstu-large at vocab 2^22,
               uncached, in a process of its own: a torn first save (the
               anchor), a fault after the first intact save; losses and the
               final save's CRC32s the uninterrupted run's, peak host RSS
               within the run's count, save and restore GB/s; each
               final state's CRC32s checksummed from the card on 8 threads
               (checkpoint.manifest_of), and the seconds that frees against
               the runs before it.
               (check_cached_resilient, the same with the embedding cache
               and a round trip, is run by a card test.)
  6d. cache  — GREngine with the embedding cache at vocab 2^22 (window 512
               of 4096 chunks, Zipf ids): uncached, cached Algorithm 1,
               cached flat, bit for bit.
  6e. hsp    — ranks as processes time-sharing the card (gloo between
               them): hstu-large at full width over a 2^22-row table
               split between 2 ranks, 6 Algorithm-1 + 6 flat steps on the
               engine cell's 8192 tokens, held to the single-process engine
               on the same batch (a child first: losses, table rows at the
               last step's ids), algorithm1 = flat, dense replicas and
               shadow bitwise, per-rank launches, exchange bytes equal to
               the counts the batches give, peaks, walls; Appendix C's
               alpha of the engine cell's id stream. hsp_mesh: 2 layers,
               vocab 2^20, 4 ranks: HSP (2 x 2) against global sharding
               (bytes by kind, data replicas bitwise each step), and a
               world of one bitwise the single process; then logit sharing
               across the ranks (expansion 2, the pool the global batch's):
               2 tau=1 steps at segment 128 (aligned with the 2048-token
               packs) and 2 at segment 96 (2048 % 96 = 32: straddling
               segments' tokens travel to their owner), each in the same
               spawns (the world of one bitwise the single process; the 4
               ranks' losses within HSP_LOSS_TOL of a single process over
               the same 4 packs, run in this process; after the first
               step the same table rows carry, the carry at rows the
               straddling segments' tokens feed within SHARE_GRAD_TOL of
               the single process's, and the dense first moments too;
               replicas, shadow, launches, and the share_* bytes equal to
               the counts the layout gives). elastic: the
               hsp_mesh configuration under ElasticRunner, 2 of 4 ranks
               lost at step 5, restarted on 1 x 2 from step 3, bitwise the
               fault-free shrink at step 3 (losses, step-8 CRC32s).
  6f. lm     — (run beside phase 2's build) the LM zoo, bf16, random
               weights from SEED, no kernel of the port's (the reference
               computes these in XLA): starcoder2-3b
               at full width and depth (3 make_lm_train_step steps on one
               batch of 8 x 4096 tokens as 8 microbatches, the loss of step
               3 below step 1's, tokens/s, peak, measured MFU; prefill 2 x
               4096 and 8 greedy decode steps held to a forward over the
               same tokens within 3 x the bf16 forward's distance from an
               fp32 forward, the same argmax; a 1 x 32768 prefill; 16 decode
               steps at batch 16 against a 32768-position cache),
               mamba2-2.7b at full width and depth (3 steps on 4 x 4096, the
               check, batch-1 decode steps), olmoe-1b-7b (the check at full
               depth, capacity factor 8; 3 steps cut to 4 layers, the share
               of slots dropped), the other configs one layer deep (jamba at
               reduced()): one forward and backward, every grad finite.
  6g. autotune — the port's autotune harness (kernels/autotune.py) on a
               store in a temporary directory (REPRO_TORCH_TUNED_JSON; the
               committed tuned.json stays empty): K9-fwd's row split swept
               at T 8192, R 128, D 1024 (o and rows bf16) and at the
               segment's T 128 (rows fp16), the fused path's scatter_impl
               (K5 against two-pass rows + K6) at the engine's T 8192;
               every candidate's outputs bit for bit its default's, each
               one's time (one call at a time, CUDA events) beside the
               card's name and power limit, resolve() returning the stored
               winner and neg_logits_fwd launching with it.
  6h. dryrun — the launch tooling (launch/partition.py, op_analysis.py,
               roofline.py, dryrun.py). (a) In a process of its own, on
               the host beside the card phases from the end of the build
               on: both production meshes over a fake world of 512 ranks,
               DRYRUN_CELLS on meta (per-device state bytes, FLOPs, bytes,
               collective bytes by kind, the dominant term), among them a
               multi-pod LM cell of each family (glm4-9b prefill_32k,
               olmoe-1b-7b train_4k, mamba2-2.7b decode_32k, jamba-1.5-
               large-398b prefill_32k on pod2x16x16, under the card
               machine's torch), each record ok, its state bytes equal to
               DTensor's local shards of its specs; and the world-1 cells
               of (b). (b) On a (1, 1) mesh (NCCL at world
               1): starcoder2-3b at full width and depth as DTensors, its
               state against memory_allocated() (within 1%), one 1 x 4096
               microbatch's FLOPs under op_analysis equal to the dry-run's
               on meta, its loss and grads bit for bit the plain LM's;
               hstu-large at phase engine's pack, vocab 2^22: the state
               within 1%, a segmented step's counted FLOPs (the kernels'
               live counts) at most the dry-run's worst case; the
               roofline terms beside the measured walls.
  7. parity  — at full width, 2 layers, vocab 2^18: one training step's
               dense pass and table-grad pairs with the kernels against the
               plain versions on the card (hstu-large two-pass and fused,
               fuxi-large fused with the functional RAB grads, with the
               work-list and with the dense-grid attention); GREngine
               (algorithm1 and flat) against make_gr_train_step on
               hstu-large, 4 steps, sync and tau=1, bit for bit.
  8. cli     — python -m repro_torch.launch.train as six subprocesses
               side by side, on hstu-large (8 steps), fuxi-large and
               sasrec-large (4 steps), on hstu-large with --neg-mode
               segmented and --neg-mode baseline (4 steps each), and on
               hstu-large with checkpoints and telemetry, then resumed; on
               preprocessed synthetic KuaiRand.
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
import tempfile
import time
import traceback
import weakref
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
CARD = {}        # "sm_clock_hz", set by phase_device
# Every kernel's bound comes from the port's cost model,
# repro_torch.kernels.cost: its operations, bytes and special-function
# (MUFU) counts, the memory rate and the SFU count (H100 SXM
# specification figures), and bound_ms, which takes the peaks above and
# the card's maximum SM clock (nvidia-smi).


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
    # the first torch.utils.checkpoint call of a process imports
    # torch._dynamo (~840 modules; its seconds are printed below): paid
    # here, once, before the build's nvcc processes take the host's cores
    t = time.perf_counter()
    from torch.utils.checkpoint import checkpoint
    checkpoint(lambda x: x * 2, torch.ones(1, requires_grad=True),
               use_reentrant=False)
    import_s = time.perf_counter() - t
    from repro_torch.obs import peak_flops_of
    for dt in ("bfloat16", "float16", "float32"):
        PEAK_FLOPS[dt] = peak_flops_of(name, dt)
    CARD["smi_line"] = smi_line
    say(f"[device] peak FLOP/s {PEAK_FLOPS} (the port's cited figures for "
        f"{name!r})")
    say(f"[device] {name} x{count}; nvidia-smi: {smi_line}; max SM clock "
        f"{CARD['sm_clock_hz'] / 1e6:.0f} MHz; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; matmul tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}; the first checkpoint "
        f"call's imports {import_s:.1f} s")
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
    # cores (HMMA in their SASS; 24 K1-fwd kernels: 4 head dims x 2 time
    # modes x the cold causal, the cold acausal and the append launch; 16
    # K2 kernels in each mask's library: two per (head dim, time mode)),
    # their fp32 kernels keep the FMA path (no HMMA); ptxas spills none of
    # K1-fwd's bf16 kernels
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    k2_tags = ("attn_bwd_kv_kernelIf", "attn_bwd_q_kernelIf")
    for src, n_tc, fp32_tags in (
            ("jagged_attn_fwd", 24, ("attn_fwd_kernelIf",)),
            ("jagged_attn_bwd", 16, k2_tags),
            ("jagged_attn_bwd_acausal", 16, k2_tags)):
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
    check(len(tc) == 24, f"ptxas reported {len(tc)} bf16 K1-fwd kernels")
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


def _bound(cost, dtype_name):
    """The least time of a work item of ``cost`` (operations, bytes,
    special functions; ``repro_torch.kernels.cost``) on this card, the
    name of the term that binds, and every term."""
    from repro_torch.kernels import cost as KC
    return KC.bound_ms(cost, PEAK_FLOPS[dtype_name], CARD["sm_clock_hz"])


def _attn_bound(plan, G, capp, H, D, itemsize, dtype_name, mode):
    """K1-fwd's bound (``kernels.cost.attn_fwd_cost``) at the plan's live
    block pairs."""
    from repro_torch.kernels import cost as KC
    n_live = KC.plan_live_pairs(plan)
    c = KC.attn_fwd_cost(plan, G, capp, H, D, itemsize, mode, n_live)
    bound_ms, bound_by, parts = _bound(c, dtype_name)
    return bound_ms, bound_by, n_live, c.operations, c.bytes, parts


def _attn_bwd_bound(plan, G, capp, H, D, itemsize, dtype_name, mode, ntb):
    """K2's bound (``kernels.cost.attn_bwd_cost``) at the plan's live
    block pairs."""
    from repro_torch.kernels import cost as KC
    n_live = KC.plan_live_pairs(plan)
    c = KC.attn_bwd_cost(plan, G, capp, H, D, itemsize, mode, n_live, ntb)
    bound_ms, bound_by, parts = _bound(c, dtype_name)
    return bound_ms, bound_by, n_live, c.operations, c.bytes, parts


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


def _plain_core_f64(q, k, v, pt, tt, plan, *, schedule="worklist",
                    causal=True, **kw):
    """K1-fwd's plain version in float64 (an ``ops.run_attention`` core)."""
    import torch
    from repro_torch.kernels.jagged_attention import ops
    from repro_torch.kernels.jagged_attention.ref import attention_fwd_plain
    ops.check_causal(plan, causal)
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
    bound_ms, bound_by, n_live, flops, byts, parts = _attn_bwd_bound(
        p, G, cap, H, D, q.element_size(), dname, mode, tt.shape[0])
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
    from repro_torch.kernels import cost as KC
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
        fwd_c = KC.neg_fwd_cost(T, R, D, perms.numel())
        bwd_c = KC.neg_bwd_cost(T, R, D, perms.numel())
        fwd_bytes, bwd_bytes = fwd_c.bytes, bwd_c.bytes
        res = {}
        for name, ms, plain_ms, c, err in (
                ("neg_fwd", fwd_ms, fwd_plain, fwd_c, e_lse),
                ("neg_bwd", bwd_ms, bwd_plain, bwd_c,
                 max(e_w, e_dout, e_dpos))):
            b_ms, b_by, _ = _bound(c, KC.PEAK_DTYPE[name])
            res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=err)
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
    # and the run pointers read (kernels.cost.runsum_cost)
    from repro_torch.kernels import cost as KC
    c = KC.runsum_cost(n, n_runs, D)
    byts = c.bytes
    bound_ms, bound_by, _ = _bound(c, KC.PEAK_DTYPE["runsum"])
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
    # (kernels.cost.wscatter_cost)
    from repro_torch.kernels import cost as KC
    c = KC.wscatter_cost(T, TR, n, n_runs, D)
    byts, ops = c.bytes, c.operations
    bound_ms, bound_by, _ = _bound(c, KC.PEAK_DTYPE["wscatter"])
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
    """K9's least time (``kernels.cost.neg_logits_cost``) at the
    half-precision tensor-core rate."""
    from repro_torch.kernels import cost as KC
    c = KC.neg_logits_cost(T, R, D, itemsize, bwd)
    bound_ms, bound_by, _ = _bound(c, KC.PEAK_DTYPE["neg_logits_fwd"])
    return bound_ms, bound_by, c.bytes


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
    plain_ms = timed_ms(lambda: JR.jagged_lookup_ref(
        master, sets[next(it) % 8]), 16)
    # K7 and index_select (its library call) in turns, one call at a time
    # behind a sleep kernel (a ~25 µs kernel takes less time than its
    # wrapper takes to call); earlier runs timed K7 by a loop of calls, at
    # 0.0243 and at 0.0494 ms, never beside index_select
    fns = {"k7": lambda: JL.gather_rows(master, sets[next(it) % 8],
                                        torch.bfloat16),
           "index_select": lambda: torch.index_select(
               master, 0, sets[next(it) % 8].clamp(min=0))}
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    evs = {k: [] for k in fns}
    for _ in range(41):
        for k, f in fns.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(200_000)
            e0.record()
            f()
            e1.record()
            evs[k].append((e0, e1))
    torch.cuda.synchronize()
    med = {k: sorted(a.elapsed_time(b) for a, b in v)[len(v) // 2]
           for k, v in evs.items()}
    ms, lib_ms = med["k7"], med["index_select"]
    n_valid = int(valid.sum())
    from repro_torch.kernels import cost as KC
    c = KC.gather_cost(n, n_valid, D)
    byts = c.bytes
    bound_ms = _bound(c, KC.PEAK_DTYPE["gather"])[0]
    say(f"[kernels] gather: {n} ids ({n - n_valid} < 0) from {V} x {D} fp32 "
        f"to bf16; bitwise equal to the plain version {bit_plain}, to "
        f"index_select + mask + cast {bit_lib} | kernel {ms:.4f} ms  plain "
        f"(clamp, gather, cast, where) {plain_ms:.4f} ms  index_select "
        f"alone (fp32 rows, no mask or cast) {lib_ms:.4f} ms (the two in "
        f"turns, one call at a time, medians of 41: K7 "
        f"{'wins' if ms < lib_ms else 'loses'})  bound "
        f"{bound_ms:.5f} ms by bytes ({byts / 1e6:.2f} MB) -> "
        f"{bound_ms / ms:.3f} of bound")
    check(bit_plain and bit_lib, "K7 differs from its plain version or "
          "from index_select + mask + cast")
    del master, out, plain, lib
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)


# --------------------------------------------------------------------------
# phase 3b: the non-causal mask (acausal K1-fwd, K2, K8)
# --------------------------------------------------------------------------

ACAUSAL_PACKS = ("long_tail", "train_1x4x2048")


def phase_acausal():
    """The non-causal mask (``causal=False``: a query sees every key of its
    row, its weights divided by the row length). First the path, at full
    width with the launch counts zeroed just before and read just after:
    ``make_attn_fn(causal=False)`` forward and backward through autograd
    on the engine's training pack (q/k/v (8192, 8, 128) bf16, 1 x 4 x 2048
    rows), HSTU's bucket table (pos 256 / time 32) and FuXi's functional
    (3, H), the work-list and the dense schedule. Then each acausal
    instantiation of K1-fwd, K2 and K8 at the long-tail and the training
    pack, bf16 and fp32, against the float64 plain version (bf16 outputs and
    q/k/v grads per (token, head) by relative L2, fp32 ones and every table
    grad by max abs over the largest value), bit-identical run to run, K8
    bit for bit K1-fwd/K2 on the plan; each with its time, bound, TFLOP/s
    and the causal kernel's time on the same inputs."""
    import numpy as np
    import torch
    from repro_torch.configs import RABConfig
    from repro_torch.kernels.jagged_attention import make_attn_fn, ops
    from repro_torch.kernels.jagged_attention.ref import (attention_bwd_plain,
                                                          attention_fwd_plain,
                                                          max_row_rel_err)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 24)
    cap, H, D, max_len = 8192, 8, 128, 2048
    rab_cfg = RABConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    rab = {"pos_table": torch.randn(256, H, device=dev, generator=gen) * .5,
           "time_table": torch.randn(32, H, device=dev, generator=gen) * .5}
    rabs = {"bucket": rab, "functional": _functional_rab(rab, H, dev)}
    packs = {n: tuple(torch.from_numpy(a).to(dev) for a in v)
             for n, v in _packs(rng, cap, max_len).items()
             if n in ACAUSAL_PACKS}
    # the path: full width, launches counted
    o_t, ts_t = packs["train_1x4x2048"]
    qkv = [torch.randn(1, cap, H, D, device=dev, generator=gen)
           .to(torch.bfloat16) for _ in range(3)]
    dy = torch.randn(1, cap, H, D, device=dev, generator=gen).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _zero_counts()
    for mode in ("bucket", "functional"):
        for sched in ops.SCHEDULES:
            fn = make_attn_fn(schedule=sched, max_row_len=max_len,
                              causal=False)
            leaves = [t.clone().requires_grad_() for t in qkv]
            tables = {n: t.clone().requires_grad_()
                      for n, t in rabs[mode].items()}
            out = fn(*leaves, o_t, ts_t, tables, rab_cfg, time_mode=mode,
                     plan=fn.make_plan(o_t, ts_t, cap))
            out.backward(dy)
            check(all(torch.isfinite(t.grad.float()).all().item()
                      for t in leaves + list(tables.values())),
                  f"acausal {mode} {sched}: a non-finite grad")
    torch.cuda.synchronize()
    counts = _read_counts()
    path_s = time.perf_counter() - t0
    launches = {n: c for n, c in counts.items() if n.startswith("attn_")}
    want = {ops.launch_counter(kind, dense=dense, functional=func): 1
            for kind in ("fwd", "bwd") for dense in (False, True)
            for func in (False, True)}
    say(f"[acausal] the path (make_attn_fn(causal=False), forward and "
        f"backward through autograd, training pack, both time modes and "
        f"schedules): {path_s:.2f} s; launches {launches}")
    check({n: c for n, c in launches.items() if c} == want,
          f"acausal path launches {launches}, expected {want}")
    del qkv, dy, out, leaves, tables
    results = {}
    for pack_name, (o_t, ts_t) in packs.items():
        G = o_t.shape[0]
        plan = ops._as_batched(ops.build_attn_plan(
            o_t, ts_t, cap, block=128, max_row_len=max_len, causal=False))
        cplan = ops._as_batched(ops.build_attn_plan(
            o_t, ts_t, cap, block=128, max_row_len=max_len))
        n_a, n_c = int(plan.n_live.sum()), int(cplan.n_live.sum())
        say(f"[acausal] pack {pack_name}: G={G} live block pairs {n_a} "
            f"acausal against {n_c} causal ({n_a / n_c:.3f}x)")
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q, k, v, dy = (torch.randn(G, cap, H, D, device=dev,
                                       generator=gen).to(dtype)
                           for _ in range(4))
            dy = ops._masked(plan.meta_i32, dy).contiguous()
            for mode in ("bucket", "functional"):
                func = mode == "functional"
                pt = rabs[mode]["pos_table"]
                tt = (ops.functional_time_table(rabs[mode]) if func
                      else rabs[mode]["time_table"])
                kw = dict(scale=D ** -0.5,
                          tb_denom=ops.time_bucket_denom(
                              rab_cfg.time_bucket_scale),
                          use_pos=True, use_time=True, time_functional=func)
                fargs = (q, k, v, pt, tt)
                bargs = (q, k, v, dy, pt, tt)
                out = ops._launch_fwd(*fargs, plan, **kw)
                same = torch.equal(out, ops._launch_fwd(*fargs, plan, **kw))
                dense_same = torch.equal(
                    out, ops._launch_fwd(*fargs, plan, dense=True, **kw))
                got = ops._launch_bwd(*bargs, plan, **kw)
                same &= all(torch.equal(a, b) for a, b in zip(
                    got, ops._launch_bwd(*bargs, plan, **kw)))
                dense_same &= all(torch.equal(a, b) for a, b in zip(
                    got, ops._launch_bwd(*bargs, plan, dense=True, **kw)))
                torch.cuda.synchronize()
                t = time.perf_counter()
                plain = attention_fwd_plain(*fargs, plan,
                                            acc_dtype=torch.float64, **kw)
                torch.cuda.synchronize()
                plain_fwd_ms = (time.perf_counter() - t) * 1e3
                t = time.perf_counter()
                want_b = attention_bwd_plain(*bargs, plan,
                                             acc_dtype=torch.float64, **kw)
                torch.cuda.synchronize()
                plain_bwd_ms = (time.perf_counter() - t) * 1e3
                out_m, plain_m = (ops._masked(plan.meta_i32, x)
                                  for x in (out, plain))
                errs = {"out": (out_m, plain_m)}
                errs.update(zip(("dq", "dk", "dv", "dpt",
                                 "d(amp,sigma,rho)" if func else "dtt"),
                                ((ops._masked(plan.meta_i32, a)
                                  if a.dim() == 4 else a, b)
                                 for a, b in zip(got, want_b))))
                worst = {}
                for name, (a, b) in errs.items():
                    check(torch.isfinite(a.float()).all().item(),
                          f"acausal {name} non-finite")
                    if a.dim() == 4 and dtype == torch.bfloat16:
                        worst[name] = ("row_rel", max_row_rel_err(a, b),
                                       REL_TOL_BF16)
                    else:
                        worst[name] = ("rel_to_max", _rel_to_max(a, b),
                                       GRAD_TOL_FP32)
                del plain, want_b, errs, out_m, plain_m
                ms = {}
                for kname, fn_, it in (
                        ("fwd", lambda: ops._launch_fwd(*fargs, plan, **kw),
                         10),
                        ("fwd_dense", lambda: ops._launch_fwd(
                            *fargs, plan, dense=True, **kw), 10),
                        ("fwd_causal", lambda: ops._launch_fwd(
                            *fargs, cplan, **kw), 10),
                        ("bwd", lambda: ops._launch_bwd(*bargs, plan, **kw),
                         5),
                        ("bwd_dense", lambda: ops._launch_bwd(
                            *bargs, plan, dense=True, **kw), 5),
                        ("bwd_causal", lambda: ops._launch_bwd(
                            *bargs, cplan, **kw), 5)):
                    ms[kname] = timed_ms(fn_, it)
                fb = _attn_bound(plan, G, cap, H, D, q.element_size(), dname,
                                 mode)
                bb = _attn_bwd_bound(plan, G, cap, H, D, q.element_size(),
                                     dname, mode, tt.shape[0])
                suffix = "_functional" if func else ""
                for kind, bound, pms in (("fwd", fb, plain_fwd_ms),
                                         ("bwd", bb, plain_bwd_ms)):
                    bound_ms, bound_by, _, flops, byts, parts = bound
                    err = max(worst[n][1] for n in worst
                              if (n == "out") == (kind == "fwd"))
                    for dense in (False, True):
                        t_ms = ms[kind + ("_dense" if dense else "")]
                        results[(f"attn_{kind}{'_dense' if dense else ''}"
                                 f"{suffix}", pack_name, dname)] = dict(
                            max_abs_err=err, ms=t_ms, plain_ms=pms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            tflops=flops / t_ms / 1e9,
                            causal_ms=ms[f"{kind}_causal"])
                    say(f"[acausal] attn_{kind}{suffix} {pack_name} {dname}:"
                        f" kernel {ms[kind]:.4f} ms, dense (K8) "
                        f"{ms[kind + '_dense']:.4f} ms, causal on the same "
                        f"inputs {ms[kind + '_causal']:.4f} ms "
                        f"({ms[kind] / ms[kind + '_causal']:.3f}x); plain "
                        f"(float64) {pms:.1f} ms; bound {bound_ms:.5f} ms by "
                        f"{bound_by} (operations {parts['operations']:.5f}, "
                        f"bytes {parts['bytes']:.5f}, special functions "
                        f"{parts['special functions']:.5f}; "
                        f"{flops / 1e9:.2f} GFLOP, {byts / 1e6:.2f} MB) -> "
                        f"{bound_ms / ms[kind]:.4f} of bound; "
                        f"{flops / ms[kind] / 1e9:.1f} TFLOP/s")
                say(f"[acausal] {mode} {pack_name} {dname} against the "
                    f"float64 plain version: " + "; ".join(
                        f"{n} {w[0]} {w[1]:.3e}" for n, w in worst.items())
                    + f"; bit-identical rerun {same}; K8 = K1-fwd/K2 "
                    f"{dense_same}")
                check(same, f"acausal {mode} {pack_name} {dname} differs "
                      f"between two runs")
                check(dense_same, f"acausal K8 {mode} {pack_name} {dname} "
                      f"differs from K1-fwd/K2")
                for n, (kind_, val, tol) in worst.items():
                    check(val <= tol, f"acausal {mode} {pack_name} {dname} "
                          f"{n}: {kind_} {val} > {tol}")
            del q, k, v, dy, out, got
    torch.cuda.empty_cache()
    return {"launches": launches, "results": results, "path_s": path_s}


# --------------------------------------------------------------------------
# phase 3c: the asynchronous negative offload (K9 over streamed host rows)
# --------------------------------------------------------------------------

OFFLOAD_SHAPE = dict(T=8192, R=128, D=1024, V=2 ** 22, segment=128)
# the offloaded pass holds two segments of rows and two of dn, the logits,
# do and o's grad: ~0.19 GB at OFFLOAD_SHAPE; the (T, R, D) rows are 2.15
OFFLOAD_PEAK_GB = 0.25
ONCARD_PEAK_GB = 2.1


def phase_offload():
    """The asynchronous negative offload at the engine's shape (T = 8192
    tokens, R = 128, d 1024): fp16 rows gathered from an fp16 shadow of
    2^22 x 1024 drawn from seed 0, moved to pinned host memory by
    ``offload_negatives``, and ``neg_logits_offloaded`` forward and
    backward through autograd (o bf16, a 128-token segment a launch, the
    launch counts zeroed before and read after its two passes, the first
    of which also pins the grad's 2.15 GB). The logits, do (in o's dtype)
    and dn are held bit for bit to K9 launched on the same segments of the
    rows held on the card; the rows and their grad must be pinned, the
    offloaded pass's peak device memory above its inputs below
    OFFLOAD_PEAK_GB and the same pass with the rows on the card (the
    baseline path) at least ONCARD_PEAK_GB above. Printed: each direction's
    wall, the link's own rate (a plain pinned copy of the same bytes each
    way), K9's summed device time per direction (profiler), and the hidden
    share 1 - wall / (copy time + K9 time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.negative_sampling import (neg_logits_baseline,
                                                    neg_logits_offloaded,
                                                    offload_negatives)
    from repro_torch.kernels import neg_logits as NL
    dev = torch.device("cuda")
    T, R, D, V, seg = (OFFLOAD_SHAPE[k] for k in
                       ("T", "R", "D", "V", "segment"))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shadow = torch.empty((V, D), dtype=torch.float16, device=dev)
    chunk = 1 << 20
    for lo in range(0, V, chunk):
        shadow[lo:lo + chunk] = torch.randn(chunk, D, device=dev,
                                            generator=gen) * 0.02
    ids = torch.randint(0, V, (T * R,), device=dev, generator=gen)
    rows = shadow[ids].view(T, R, D)
    del shadow, ids
    o = torch.randn(T, D, device=dev, generator=gen).to(torch.bfloat16)
    g = torch.randn(T, R, device=dev, generator=gen) * 1e-4
    nbytes = rows.numel() * rows.element_size()
    torch.cuda.synchronize()
    t = time.perf_counter()
    host = offload_negatives(rows)
    offload_s = time.perf_counter() - t
    check(host.is_pinned() and host.dtype == rows.dtype
          and host.shape == rows.shape, "offload_negatives did not return "
          "pinned host rows of the card rows' dtype and shape")
    # the link's own rate: a plain pinned copy of the same bytes, each way
    # (the card → host copy writes the same values back)
    buf = torch.empty_like(rows)
    h2d_ms = timed_ms(lambda: buf.copy_(host, non_blocking=True), 3,
                      warmup=1)
    d2h_ms = timed_ms(lambda: host.copy_(buf, non_blocking=True), 3,
                      warmup=1)
    check(torch.equal(buf, rows), "the pinned rows differ from the card's")
    del buf
    # K9 on the same segments of the card rows: the bitwise yardstick, and
    # K9's summed device time per direction
    ref_lg = torch.empty((T, R), dtype=torch.float32, device=dev)
    ref_do = torch.empty((T, D), dtype=torch.float32, device=dev)
    ref_dn = torch.empty_like(rows)
    k9 = {}
    for kind in ("fwd", "bwd"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for lo in range(0, T, seg):
                s = slice(lo, lo + seg)
                if kind == "fwd":
                    ref_lg[s] = NL.neg_logits_fwd(o[s], rows[s], inv_tau=1.0)
                else:
                    ref_do[s], _ = NL.neg_logits_bwd(
                        o[s], rows[s], g[s], inv_tau=1.0, dn=ref_dn[s])
            torch.cuda.synchronize()
        k9[kind] = sum(ms for ms, _, key in _device_rows(prof)
                       if f"neg_logits_{kind}_kernel" in key)
    # the same pass with the rows on the card (the baseline path, K9 over
    # all T): its peak above the inputs holds the (T, R, D) grad
    oo = o.clone().requires_grad_()
    rl = rows.clone().requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    lg = neg_logits_baseline(oo, rl)
    torch.cuda.synchronize()
    card_fwd = time.perf_counter() - t
    t = time.perf_counter()
    lg.backward(g)
    torch.cuda.synchronize()
    card_bwd = time.perf_counter() - t
    card_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    del lg, oo, rl
    torch.cuda.empty_cache()
    # the offloaded path: two passes, launches counted over both
    oo = o.clone().requires_grad_()
    hl = host.requires_grad_()
    passes = []
    _zero_counts()
    for rep in range(2):
        oo.grad = hl.grad = None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        lg = neg_logits_offloaded(oo, hl, segment=seg)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t
        t = time.perf_counter()
        lg.backward(g)
        torch.cuda.synchronize()
        t_bwd = time.perf_counter() - t
        passes.append(dict(
            fwd_s=t_fwd, bwd_s=t_bwd,
            peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9))
        if rep == 0:
            lg = None
    launches = {n: c for n, c in _read_counts().items() if c}
    n_seg = T // seg
    check(launches == {"neg_logits_fwd": 2 * n_seg,
                       "neg_logits_bwd": 2 * n_seg},
          f"the offloaded passes launched {launches}, not K9-fwd and "
          f"K9-bwd {2 * n_seg} times each")
    check(hl.grad.is_pinned() and hl.grad.dtype == rows.dtype,
          "the host rows' grad is not pinned in their dtype")
    same_lg = torch.equal(lg, ref_lg)
    same_do = torch.equal(oo.grad, ref_do.to(o.dtype))
    same_dn = all(torch.equal(hl.grad[s].to(dev), ref_dn[s])
                  for s in (slice(lo, lo + seg) for lo in range(0, T, seg)))
    fwd_s, bwd_s = passes[1]["fwd_s"], passes[1]["bwd_s"]
    hidden_fwd = 1 - fwd_s * 1e3 / (h2d_ms + k9["fwd"])
    hidden_bwd = 1 - bwd_s * 1e3 / (h2d_ms + d2h_ms + k9["bwd"])
    peak = max(p["peak_gb"] for p in passes)
    say(f"[offload] T={T} R={R} d={D} fp16 rows ({nbytes / 1e9:.3f} GB) "
        f"from an fp16 shadow of {V} x {D}; offload_negatives "
        f"{offload_s:.3f} s; link (plain pinned copy of the same bytes) "
        f"host->card {h2d_ms:.2f} ms = {nbytes / h2d_ms / 1e6:.2f} GB/s, "
        f"card->host {d2h_ms:.2f} ms = {nbytes / d2h_ms / 1e6:.2f} GB/s; "
        f"K9 summed over the {n_seg} segments (profiler): fwd "
        f"{k9['fwd']:.3f} ms, bwd {k9['bwd']:.3f} ms")
    for i, p in enumerate(passes):
        pins = "" if i else " (pins the grad)"
        say(f"[offload] offloaded pass {i}{pins}: forward "
            f"{p['fwd_s'] * 1e3:.2f} ms, backward {p['bwd_s'] * 1e3:.2f} "
            f"ms, peak above the inputs {p['peak_gb']:.4f} GB")
    say(f"[offload] hidden share 1 - wall / (copy + K9): forward "
        f"{hidden_fwd:.4f} (wall {fwd_s * 1e3:.2f} ms against "
        f"{h2d_ms:.2f} + {k9['fwd']:.3f}), backward {hidden_bwd:.4f} (wall "
        f"{bwd_s * 1e3:.2f} ms against {h2d_ms:.2f} + {d2h_ms:.2f} + "
        f"{k9['bwd']:.3f}); rows on the card (baseline, K9 over all T): "
        f"forward {card_fwd * 1e3:.2f} ms, backward {card_bwd * 1e3:.2f} ms,"
        f" peak above the inputs {card_peak:.4f} GB; offloaded peak "
        f"{peak:.4f} GB")
    say(f"[offload] bitwise against K9 on the card's segments: logits "
        f"{same_lg}, do {same_do}, dn {same_dn}; launches {launches}")
    check(same_lg and same_do and same_dn, "the offloaded path differs "
          "from K9 on the card's segments")
    check(peak < OFFLOAD_PEAK_GB, f"the offloaded pass's peak {peak:.4f} GB "
          f"above its inputs is not below {OFFLOAD_PEAK_GB}")
    check(card_peak >= ONCARD_PEAK_GB, f"the on-card pass's peak "
          f"{card_peak:.4f} GB is below {ONCARD_PEAK_GB}")
    del rows, host, hl, oo, lg, ref_lg, ref_do, ref_dn, o, g
    torch.cuda.empty_cache()
    return dict(launches=launches, h2d_gb_s=nbytes / h2d_ms / 1e6,
                d2h_gb_s=nbytes / d2h_ms / 1e6, k9_fwd_ms=k9["fwd"],
                k9_bwd_ms=k9["bwd"], passes=passes, hidden_fwd=hidden_fwd,
                hidden_bwd=hidden_bwd, peak_gb=peak, card_peak_gb=card_peak,
                card_fwd_s=card_fwd, card_bwd_s=card_bwd,
                offload_s=offload_s)


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
    """The append launch's least time (``kernels.cost.attn_append_cost``)
    from the window's live (query, key) pairs."""
    from repro_torch.kernels import cost as KC
    pairs, live_q = KC.append_live_pairs(pref, total)
    c = KC.attn_append_cost(rows_n, pref, total, H, D, itemsize)
    bound_ms, bound_by, parts = _bound(c, dtype_name)
    return bound_ms, bound_by, pairs, live_q, c.operations, c.bytes


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

ENGINE_STEPS = {"hstu-large": 8, "fuxi-large": 6, "sasrec-large": 6}


def _engine_run(arch, schedule, V, base_note, tag, loss_kwargs=None,
                n_steps=None, before_run=None, obs=None, data=None,
                cache=None):
    """GREngine on full-width ``arch``, tau=1, ``loss_kwargs`` (default:
    the fused path with its default scatter), ``n_steps`` steps (default
    ENGINE_STEPS[arch]); per step the loss, the host wall between the ends
    of consecutive steps (each step's loss is realised on the host, so the
    host waits on the card once a step) and the peak above the tables.
    ``before_run(engine)`` runs first, before the counts are zeroed;
    ``obs`` and ``cache`` are handed to the engine; ``data`` (default the
    engine cell's loader) feeds it."""
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
    eng = GREngine(GRBundle(cfg), data or _train_loader(V), seed=SEED,
                   schedule=schedule, semi_async=True, device=dev,
                   loss_kwargs=loss_kwargs, obs=obs, cache=cache)
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
                  **{k: r[k] for k in ("mfu", "step_wall_s", "cache")
                     if k in r})
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
    if cfg.gr_block != "sasrec":          # SASRec's attention: no kernel
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


def phase_engine_sasrec():
    """GREngine on full-width sasrec-large (d 1024, 16 layers, 8 heads,
    qkv 128, vocab 2^22, bf16) over the engine cell's loader (1 x 4 x 2048,
    R 128), fused (K3/K4/K5), tau=1: Algorithm 1, then the flat schedule
    from the same init, ENGINE_STEPS steps each. Losses finite and bit for
    bit equal across the schedules; K3, K4 and K5 once a step and no
    attention kernel (SASRec's softmax attention is plain PyTorch, as the
    reference computes it inline); the steady step wall and the peak above
    the state."""
    import torch
    from repro_torch.configs import get_arch
    arch, tag = "sasrec-large", "engine_sasrec"
    cfg = get_arch(arch)
    V, n = cfg.vocab_size, ENGINE_STEPS[arch]
    eng, alg = _engine_run(arch, "algorithm1", V, "tables drawn on the card",
                           tag)
    del eng
    flat_eng, flat = _engine_run(arch, "flat", V, "the same seed", tag)
    del flat_eng
    gc.collect()
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in alg["steps"]]
    flat_losses = [r["loss"] for r in flat["steps"]]
    want = {k: n * v for k, v in _step_launches(cfg, "wscatter").items()}
    for name, run in (("algorithm1", alg), ("flat", flat)):
        check(run["launches"] == want, f"{tag} {name} launched "
              f"{run['launches']}, expected {want}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    check(flat_losses == losses, f"{tag}: flat losses {flat_losses} differ "
          f"from algorithm1's {losses}")
    steady = {name: sum(r["wall_s"] for r in run["steps"][3:])
              / len(run["steps"][3:]) for name, run in
              (("algorithm1", alg), ("flat", flat))}
    peak = {name: max(r["peak_above_tables_gb"] for r in run["steps"])
            for name, run in (("algorithm1", alg), ("flat", flat))}
    say(f"[{tag}] losses {losses[0]:.5f} -> {losses[-1]:.5f}, bit for bit "
        f"equal in both schedules; K3, K4, K5 once a step ({n} steps), no "
        f"attention kernel; steady steps 3.. mean "
        f"{ {k: round(v * 1e3, 1) for k, v in steady.items()} } ms; peak "
        f"above the state {peak} GB; card {CARD.get('smi_line')}")
    return alg, flat, dict(steady_wall_ms={k: v * 1e3
                                           for k, v in steady.items()},
                           peak_above_state_gb=peak,
                           card=CARD.get("smi_line"))


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
# phase 6c: supervised recovery (GREngine.run_resilient) at full width and
# the full vocab
# --------------------------------------------------------------------------

RESILIENT_STEPS = 6
RESILIENT_EVERY = 4
# One 2^22 checkpoint is written (~35.6 GB): a call on the card machine may
# write 45 GiB to its disk in all, deleted files included. So the run saves
# step 4 only (no final save): its first save is torn (the leaves half
# written, no manifest: the anchor), then step 4 is saved, and a fault after
# it restores it. The CRC's refusal at this size is shown on that step
# afterwards, a byte flipped in its largest leaf.
RESILIENT_FAULTS = (("save", 4, "torn_save", "partial_dir"),
                    ("dense_fwd", 5, "exception", None))
RESILIENT_RESTORED = [0, 4]
RESILIENT_SAVED = 4


# The final state's CRC32s took the uninterrupted child 23.7 and 26.8 s
# and the resilient child 82.48 and 68.41 s in this script's last two runs
# before the change (NVIDIA H100 80GB HBM3, 700.00 W): each took a pageable
# host copy
# of the 35.4 GB state, which the resilient child made beside the 44 GB of
# pinned buffers its saver had left cached in the host allocator, and
# then checksummed the two 17.2 GB tables on a thread each. Now the leaves
# are checksummed from the card through piece buffers, each table in
# segments on 8 threads (checkpoint.manifest_of), in both children.
BEFORE_CRC_S = ((23.7, 82.48), (26.8, 68.41))
# Phase resilient's seconds in those two runs.
BEFORE_RESILIENT_S = (302.6, 301.4)


def _manifest_of(tree):
    """What a save of ``tree`` records of its leaves: CRC32s, shapes,
    dtypes (checksummed, no file written, no host copy of a card state)."""
    from repro_torch.training import checkpoint as CKPT
    return CKPT.manifest_of(tree)


def _resilient_reference():
    """The uninterrupted run the resilient children are held to (in this
    process: its state is checksummed from the card, no host copy):
    GREngine from SEED on full-width hstu-large (vocab 2^22) over the Zipf
    batches of cell *cache*, RESILIENT_STEPS steps; its losses and what a
    save of its final carry-convention state would record. The card's
    memory is freed for the child that follows."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import GREngine
    dev = torch.device("cuda")
    cfg = get_arch("hstu-large")
    N = RESILIENT_STEPS
    batches = _zipf_batches(cfg.vocab_size, N)
    t = time.perf_counter()
    ref = GREngine(GRBundle(cfg), lambda i: batches[i], seed=SEED, device=dev)
    out = dict(losses=[r["loss"] for r in ref.run(N)])
    t1 = time.perf_counter()
    out["manifest"] = _manifest_of(ref.checkpoint_tree())
    out["crc_s"] = time.perf_counter() - t1
    out["wall_s"] = time.perf_counter() - t
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _run_child(fn, tag, timeout=1000, args=()):
    """``chip_smoke.<fn>(*args)`` in a process of its own (its peak
    resident set is the run's alone); its lines relayed, its
    ``[child-result]`` JSON returned. Fails if it does not exit 0."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]; import chip_smoke as c; "
            f"sys.exit(c.{fn}(*{tuple(args)!r}))")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    result = None
    for ln in out.splitlines():
        if ln.startswith("[child-result] "):
            result = json.loads(ln[len("[child-result] "):])
        else:
            say(ln)
    check(p.returncode == 0 and result is not None,
          f"{tag}: the child process exited {p.returncode}")
    return result


def resilient_child_uncached():
    return _child_main(_resilient_child, False)


def resilient_child_cached():
    return _child_main(_resilient_child, True)


def _child_main(fn, *args):
    try:
        out = fn(*args)
    except Failed as e:
        say(f"FAIL: {e}")
        return 1
    say("[child-result] " + json.dumps(out))
    return 0


def _flip_a_byte(step_dir):
    """Flip one byte in the middle of a step's largest leaf (in place: a
    torn page the file's size does not show); returns (path, offset, the
    byte) to undo it."""
    path = max((os.path.join(step_dir, n) for n in os.listdir(step_dir)
                if n.endswith(".npy")), key=os.path.getsize)
    pos = os.path.getsize(path) // 2
    with open(path, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0xFF]))
    return path, pos, byte


def _undo_flip(path, pos, byte):
    with open(path, "r+b") as f:
        f.seek(pos)
        f.write(byte)


def _resilient_child(cached):
    """A fresh run_resilient on full-width hstu-large at vocab 2^22 over
    the Zipf batches (uncached, or with the embedding cache of cell
    *cache*): RESILIENT_STEPS steps, async checkpoints every
    RESILIENT_EVERY and no final save, the faults of RESILIENT_FAULTS.
    Checked here: the recoveries (the torn first save: the anchor; then
    step 4), the shadow, the peak resident set against what the run
    counted; then, a byte of step 4's largest leaf flipped, an explicit
    restore of it refused by its CRC before it writes anything (the state's
    CRC32s, taken next, are the parent's check of that). Returned for the
    parent: the losses, the final state's CRC32s (no file), launches,
    timings. With the cache, the byte is put back and a fresh cached
    engine restores step 4 and trains to RESILIENT_STEPS; its state's
    CRC32s (streamed from the store) come back too."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.obs import Obs
    from repro_torch.training import GREngine
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import resilience as R
    tag = "cache resilient" if cached else "resilient"
    dev = torch.device("cuda")
    cfg = get_arch("hstu-large")
    V, d = cfg.vocab_size, cfg.d_model
    bundle = GRBundle(cfg)
    N = RESILIENT_STEPS
    avail0 = CKPT.host_available_bytes() / 1e9
    t0 = time.perf_counter()
    batches = _zipf_batches(V, N)
    obs = Obs()
    if cached:
        cache, _ = _seeded_cache(bundle, batches, CACHE_CAPACITY)
        eng = GREngine(bundle, lambda i: batches[i], seed=SEED, cache=cache,
                       obs=obs)
    else:
        eng = GREngine(bundle, lambda i: batches[i], seed=SEED, device=dev,
                       obs=obs)
    torch.cuda.synchronize()
    gc.collect()
    setup = time.perf_counter() - t0
    counted = eng.resilient_host_bytes(batches[0])
    anchor = []
    full_snapshot = eng.full_snapshot

    def timed_anchor(*a):
        t = time.perf_counter()
        snap = full_snapshot(*a)
        anchor.append(time.perf_counter() - t)
        return snap
    eng.full_snapshot = timed_anchor
    checks = []
    load = CKPT._load_step_arrays

    def spy(ckpt_dir, step, *a, **kw):
        t = time.perf_counter()
        try:
            got = load(ckpt_dir, step, *a, **kw)
        except CKPT.CheckpointCorrupt as e:
            checks.append((step, time.perf_counter() - t, str(e)[:120]))
            raise
        checks.append((step, time.perf_counter() - t, None))
        return got
    CKPT._load_step_arrays = spy
    d_dir = tempfile.mkdtemp(prefix="chip_smoke_resilient_")
    st = os.statvfs(d_dir)
    free_gb = st.f_bavail * st.f_frsize / 1e9
    rss0, hwm0 = _host_rss_gb()
    say(f"[{tag}] {cfg.name} d={d} layers={cfg.num_layers} {cfg.dtype} "
        f"vocab {V} (not cut); Zipf({CACHE_ZIPF_A}) batches 1 x 4 x 2048, "
        f"R 128; set-up {setup:.1f} s; host at the child's start "
        f"{avail0:.2f} GB available, before the run: RSS {rss0:.2f} GB "
        f"(peak {hwm0:.2f}), {CKPT.host_available_bytes() / 1e9:.2f} GB "
        f"available; the run "
        f"counts {sum(counted.values()) / 1e9:.2f} GB "
        f"({ {k: round(v / 1e9, 2) for k, v in counted.items()} }); "
        f"{free_gb:.1f} GB free on the checkpoint disk")
    inj = R.FaultInjector([R.FaultSpec(R.SAVE_SITE if site == "save"
                                       else site, step, kind, tear=tear)
                           for site, step, kind, tear in RESILIENT_FAULTS])
    try:
        _zero_counts()
        t = time.perf_counter()
        try:
            recs = eng.run_resilient(N, ckpt_dir=d_dir,
                                     ckpt_every=RESILIENT_EVERY,
                                     final_save=False,
                                     policy=R.FaultPolicy(retries={}),
                                     injector=inj)
        finally:
            CKPT._load_step_arrays = load
            eng.full_snapshot = full_snapshot
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = _read_counts()
        hwm = _host_rss_gb()[1]
        # the store is resident before the run (in rss0)
        held = cache.host_nbytes if cached else 0
        limit = (sum(counted.values()) - held) / 1e9 + rss0
        restored = [ev.restored_step for ev in eng.recoveries]
        check(inj.exhausted and restored == RESILIENT_RESTORED,
              f"{tag}: restored steps {restored}, faults left "
              f"{inj._pending}")
        check(CKPT.intact_steps(d_dir) == [RESILIENT_SAVED],
              f"{tag}: intact steps {CKPT.intact_steps(d_dir)}")
        check(hwm <= limit, f"{tag}: peak host RSS {hwm:.2f} GB above the "
              f"run's count plus the RSS before it ({limit:.2f} GB)")
        win = cache.window if cached else eng.state.table
        shadow_bad = _window_shadow_bad(win)
        check(shadow_bad == 0, f"{tag}: shadow != master.half() at "
              f"{shadow_bad} elements")
        snapv = obs.snapshot()
        save = snapv["ckpt_save_s"]["values"][""]
        rest = snapv["ckpt_restore_s"]["values"][""]
        nbytes = eng.snapshots[-1][2]
        say(f"[{tag}] run_resilient to step {N}: {wall:.1f} s; recoveries "
            f"{[(ev.failed_step, ev.restored_step, round(ev.wall_s, 2)) for ev in eng.recoveries]}"
            f" (failed, restored, s); launches {counts}")
        # a byte of the saved step flipped: the CRC refuses it, nothing is
        # written (the parent holds the state's CRC32s taken next)
        step_dir = os.path.join(d_dir, f"step_{RESILIENT_SAVED}")
        flip = _flip_a_byte(step_dir)
        t = time.perf_counter()
        try:
            CKPT.restore_with_step(d_dir, eng.full_template() if cached
                                   else eng.state, step=RESILIENT_SAVED)
            refused = None
        except CKPT.CheckpointCorrupt as e:
            refused = str(e)
        refuse_s = time.perf_counter() - t
        check(refused is not None and "CRC mismatch" in refused,
              f"{tag}: the flipped step restored ({refused})")
        t = time.perf_counter()
        manifest = _manifest_of(eng.checkpoint_tree())
        crc_s = time.perf_counter() - t
        verify = [x for _, x, e in checks if e is None]
        out = dict(
            cached=cached, losses=[r["loss"] for r in recs], wall_s=wall,
            manifest=manifest, crc_s=crc_s,
            recoveries=[dict(failed=ev.failed_step,
                             restored=ev.restored_step,
                             steps_lost=ev.steps_lost, wall_s=ev.wall_s,
                             error=ev.error[:80])
                        for ev in eng.recoveries],
            steps_replayed=sum(ev.steps_lost for ev in eng.recoveries),
            launches=counts, ckpt_bytes=nbytes, saves=save["count"],
            save_s=save["sum"] / save["count"], restores=rest["count"],
            restore_s=rest["sum"] / max(rest["count"], 1),
            verify_s=verify, refused=refused[:120], refuse_s=refuse_s,
            host_copies=[(s, x, n) for s, x, n in eng.snapshots],
            anchor_s=anchor, counted_gb={k: v / 1e9
                                         for k, v in counted.items()},
            rss_before_gb=rss0, hwm_before_gb=hwm0, hwm_gb=hwm,
            limit_gb=limit, disk_free_gb=free_gb, setup_s=setup)
        if cached:
            out["counters"] = cache.counters()
            out["cow_chunks"] = cache.stats.cow_chunks
        say(f"[{tag}] one checkpoint of {nbytes / 1e9:.3f} GB: "
            f"{save['count']} save (saver thread) {out['save_s']:.2f} s "
            f"({nbytes / out['save_s'] / 1e9:.3f} GB/s, CRC32 + write + "
            f"fsync); {rest['count']} restore {out['restore_s']:.2f} s "
            f"({nbytes / max(out['restore_s'], 1e-9) / 1e9:.3f} GB/s), its "
            f"CRC pass {[round(x, 2) for x in verify]} s; host copies "
            f"(step, s, bytes) {out['host_copies']} (the first allocates "
            f"the pinned buffers); anchor {[round(x, 2) for x in anchor]} "
            f"s; a flipped byte refused by the CRC in {refuse_s:.2f} s; "
            f"the state's CRC32s in {crc_s:.2f} s")
        say(f"[{tag}] peak host RSS {hwm:.2f} GB <= the run's count "
            f"{sum(counted.values()) / 1e9:.2f} GB, less "
            f"{held / 1e9:.2f} GB held already, + the RSS before it "
            f"{rss0:.2f} GB = {limit:.2f} GB (getrusage's peak, which a "
            f"process starts with its parent's: {hwm0:.2f} GB before the "
            f"run); shadow == master.half() on the card")
        if cached:
            _undo_flip(*flip)
            del eng, win, cache
            gc.collect()
            torch.cuda.empty_cache()
            out["round_trip"] = _cached_round_trip(bundle, batches, d_dir,
                                                   tag)
    finally:
        shutil.rmtree(d_dir, ignore_errors=True)
    return out


def _cached_round_trip(bundle, batches, ckpt_dir, tag):
    """Step RESILIENT_SAVED restored into a fresh cached engine (another
    seed, a zero host store, the same warm-up): restore into its
    full_template, adopt_full_state (the table streamed into the store),
    then train to RESILIENT_STEPS; the losses and the CRC32s of the state
    (its table streamed from the store, no file)."""
    import numpy as np
    import torch
    from repro_torch.data import stream_id_histogram
    from repro_torch.embedding import CachedShadowedTable
    from repro_torch.training import GREngine
    from repro_torch.training import checkpoint as CKPT
    cfg = bundle.cfg
    V, S = cfg.vocab_size, RESILIENT_SAVED
    t = time.perf_counter()
    cache = CachedShadowedTable(
        np.broadcast_to(np.float32(0), (V, cfg.d_model)),
        capacity_chunks=CACHE_CAPACITY, chunk_rows=CACHE_CHUNK_ROWS,
        device=torch.device("cuda"))
    cache.warm_up(stream_id_histogram(batches[:2], V))
    cache.init_window()
    eng = GREngine(bundle, lambda i: batches[S + i], seed=SEED + 1,
                   cache=cache)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t
    t = time.perf_counter()
    full, used = CKPT.restore_with_step(ckpt_dir, eng.full_template())
    eng.adopt_full_state(full)
    del full
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    check(used == S, f"{tag}: the round trip restored step {used}")
    losses = [r["loss"] for r in eng.run(RESILIENT_STEPS - S)]
    manifest = _manifest_of(eng.checkpoint_tree())
    say(f"[{tag}] round trip: step {used} restored into a fresh cached "
        f"engine (set-up {setup:.1f} s) in {restore_s:.2f} s (CRC pass, "
        f"then the table streamed into the host store); "
        f"{RESILIENT_STEPS - S} more steps {losses}")
    out = dict(losses=losses, manifest=manifest, restore_s=restore_s,
               setup_s=setup, counters=cache.counters())
    del eng, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _same_manifest(got, want, tag, what):
    bad = [i for i, (a, b) in enumerate(zip(got["crc32s"], want["crc32s"]))
           if a != b]
    check(got["shapes"] == want["shapes"] and got["dtypes"] == want["dtypes"]
          and len(got["crc32s"]) == len(want["crc32s"]) and not bad,
          f"{tag}: {what}: leaves {bad} differ from the uninterrupted "
          f"run's (CRC32s, shapes, dtypes)")


def phase_resilient():
    """GREngine.run_resilient on full-width, full-depth hstu-large (d 1024,
    16 layers, bf16) at the full vocab 2^22, uncached: the uninterrupted
    run in this process (RESILIENT_STEPS steps over the Zipf batches of
    cell *cache*, fused with K5, tau=1, Algorithm 1; its final state's
    CRC32s checksummed from the card, no file), then in a process of its
    own a fresh supervised
    run from the same seed (async checkpoints every RESILIENT_EVERY)
    through a torn first save (the anchor) and a fault after the first
    intact save (restored), and a flipped byte in the saved step that only
    its CRC refuses; its losses bit for bit the uninterrupted run's, its
    final state's CRC32s, shapes and dtypes the uninterrupted state's, its
    peak host RSS within what run_resilient counted; save and restore
    GB/s, host copies. Checkpoints go to a temporary directory, removed at
    the end."""
    from repro_torch.configs import get_arch
    tag = "resilient"
    ref = _resilient_reference()
    check(all(math.isfinite(x) for x in ref["losses"]),
          f"{tag}: uninterrupted losses {ref['losses']}")
    say(f"[{tag}] uninterrupted (in this process): {RESILIENT_STEPS} "
        f"steps, losses {ref['losses']}; its state's CRC32s in "
        f"{ref['crc_s']:.1f} s; {ref['wall_s']:.1f} s")
    out = _run_child("resilient_child_uncached", tag)
    check(out["losses"] == ref["losses"], f"{tag}: resilient losses "
          f"{out['losses']} differ from the uninterrupted run's "
          f"{ref['losses']}")
    _same_manifest(out["manifest"], ref["manifest"], tag, "the final state")
    N = RESILIENT_STEPS
    need = {k: v * (N + out["steps_replayed"]) for k, v in
            _step_launches(get_arch("hstu-large"), "wscatter").items() if v}
    check(all(out["launches"][k] >= v for k, v in need.items()),
          f"{tag}: launches {out['launches']} for {N} steps + "
          f"{out['steps_replayed']} replayed, need at least {need}")
    say(f"[{tag}] losses bit for bit the uninterrupted run's; the final "
        f"state's {len(ref['manifest']['crc32s'])} leaves' CRC32s, shapes "
        f"and dtypes its state's (so the refused restore wrote nothing)")
    out["card"] = CARD.get("smi_line")
    out["ref_crc_s"] = ref["crc_s"]
    now = ref["crc_s"] + out["crc_s"]
    out["crc_freed_s"] = min(a + b for a, b in BEFORE_CRC_S) - now
    say(f"[{tag}] the final states' CRC32s: {ref['crc_s']:.2f} s "
        f"(uninterrupted) + {out['crc_s']:.2f} s (resilient) = {now:.2f} s, "
        f"against "
        f"{' and '.join(f'{a} + {b} = {a + b:.2f}' for a, b in BEFORE_CRC_S)}"
        f" s in the two runs before: {out['crc_freed_s']:.2f} s freed "
        f"(against the lesser)")
    return out


def check_cached_resilient():
    """The cached counterpart of phase *resilient* (a card test runs it:
    ``tests/test_torch_gpu.py -k full_vocab``, in a call of its own: it
    writes a 2^22 checkpoint too): the uninterrupted uncached run, then in
    a process of its own a fresh cached run_resilient (window 512 of 4096
    chunks) through the same faults, its checkpoint streamed from the host
    store, held to it (losses, the final state's CRC32s, shapes, dtypes;
    peak host RSS within the count), and step 4 restored into a fresh
    cached engine that trains on to the uninterrupted run's losses and
    CRC32s."""
    tag = "cache resilient"
    ref = _resilient_reference()
    out = _run_child("resilient_child_cached", tag)
    check(out["losses"] == ref["losses"], f"{tag}: losses {out['losses']} "
          f"vs the uninterrupted run's {ref['losses']}")
    _same_manifest(out["manifest"], ref["manifest"], tag, "the final state")
    rt = out["round_trip"]
    check(rt["losses"] == ref["losses"][RESILIENT_SAVED:],
          f"{tag}: round trip losses {rt['losses']} vs "
          f"{ref['losses'][RESILIENT_SAVED:]}")
    _same_manifest(rt["manifest"], ref["manifest"], tag,
                   "the round trip's state")
    say(f"[{tag}] losses and the final state bit for bit the uninterrupted "
        f"uncached run's; the round trip's steps and state too")
    return out


# --------------------------------------------------------------------------
# phase 6d: the host-offloaded embedding cache (CachedShadowedTable)
# --------------------------------------------------------------------------

# Zipf(1.8), id = popularity rank, rejected into the vocab: the access law of
# the reference's cache benchmark (benchmarks/bench_cache_embedding.py:36-51)
CACHE_ZIPF_A = 1.8
CACHE_CHUNK_ROWS = 1024
CACHE_CAPACITY = 512              # of 4096 chunks at vocab 2^22: 5.4 GB
# At capacity 512 the first evictions take chunks the warm-up admitted on a
# tie and no batch touched (clean); the first dirty victim comes with the
# prefetch of step 11 (a host-only run of the chunk manager on these
# batches), so 12 steps make the run write back.
CACHE_STEPS = 12


def _zipf_ids(rng, shape, vocab):
    import numpy as np
    out = rng.zipf(CACHE_ZIPF_A, size=shape) - 1
    while True:
        bad = out >= vocab
        if not bad.any():
            return out.astype(np.int32)
        out[bad] = rng.zipf(CACHE_ZIPF_A, size=int(bad.sum())) - 1


def _zipf_batches(V, steps):
    """The engine cell's loader batches (1 x 4 x 2048, R 128) with ids,
    labels and neg_ids redrawn, in the same shapes, from the Zipf law."""
    import numpy as np
    out = []
    for i, b in enumerate(_train_loader(V).batches(steps)):
        rng = np.random.default_rng(10_000 + i)
        out.append({**b, **{k: _zipf_ids(rng, b[k].shape, V)
                            for k in ("ids", "labels", "neg_ids")}})
    return out


def _host_rss_gb():
    """(resident set now, its peak so far) of this process in GB (the peak
    from ``getrusage``: the card machine's ``/proc/self/status`` has no
    VmHWM)."""
    import resource
    rss = float("nan")
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) * 1024 / 1e9
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    return rss, peak


def _seeded_master(bundle):
    """The master GREngine draws from SEED on the card (after the dense
    params), copied to a host array a slice at a time."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bundle.init_dense(gen, device=dev)
    init = bundle.init_table(gen, device=dev)
    host = np.empty(tuple(init.shape), np.float32)
    for lo in range(0, init.shape[0], 1 << 16):
        torch.from_numpy(host[lo:lo + (1 << 16)]).copy_(
            init[lo:lo + (1 << 16)])
    del init
    gc.collect()
    torch.cuda.empty_cache()
    return host


def _seeded_cache(bundle, batches, capacity, master=None):
    """A CachedShadowedTable over the master the engine draws from SEED
    (``master``: that master on the host, already drawn), warmed up with
    the id histogram of the first two batches; (cache, seconds)."""
    import torch
    from repro_torch.data import stream_id_histogram
    from repro_torch.embedding import CachedShadowedTable
    dev = torch.device("cuda")
    t = time.perf_counter()
    if master is None:
        master = _seeded_master(bundle)
    cache = CachedShadowedTable(master, capacity_chunks=capacity,
                                chunk_rows=CACHE_CHUNK_ROWS, device=dev)
    cache.warm_up(stream_id_histogram(batches[:2], bundle.cfg.vocab_size))
    cache.init_window()
    torch.cuda.synchronize()
    return cache, time.perf_counter() - t


def _host_equals_card(host, card, rows_per=1 << 16):
    """Elements where a host array and a card tensor of the same shape
    differ, compared a slice of rows at a time (no full host copy)."""
    import torch
    bad = 0
    for lo in range(0, card.shape[0], rows_per):
        h = torch.from_numpy(host[lo:lo + rows_per]).to(card.device)
        bad += int((h != card[lo:lo + rows_per]).sum())
    return bad


def _window_shadow_bad(win, rows_per=1 << 17):
    return sum(int((win.shadow[lo:lo + rows_per]
                    != win.master[lo:lo + rows_per].half()).sum())
               for lo in range(0, win.master.shape[0], rows_per))


def phase_cache():
    """GREngine with the host-offloaded embedding cache on full-width,
    full-depth hstu-large (d 1024, 16 layers, bf16, vocab 2^22; the
    engine's mix with Zipf ids, fused, tau=1): (a) the uncached engine,
    Algorithm 1; (b) the cached engine (the table in host RAM, a window of
    512 of 4096 chunks of 1024 rows on the card), Algorithm 1; (c) the
    cached engine, flat; CACHE_STEPS steps each from one init. Losses of
    the three and the final state (flushed host master and accumulator
    chunk by chunk, the globalized carry, the dense params and moments)
    bit for bit; the window's shadow == master.half(); misses, evictions
    and writebacks. (The cached checkpoints and run_resilient at this vocab
    are ``check_cached_resilient``, run by a card test.)"""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import GRBundle
    tag = "cache"
    cfg = get_arch("hstu-large")
    V, d = cfg.vocab_size, cfg.d_model
    bundle = GRBundle(cfg)
    N = CACHE_STEPS
    t0 = time.perf_counter()
    batches = _zipf_batches(V, N)
    data = lambda i: batches[i]                         # noqa: E731
    t1 = time.perf_counter()
    # the initial master on the host once (the card cannot draw a second
    # 17.2 GB table beside the uncached run's state), for both caches
    init = _seeded_master(bundle)
    say(f"[{tag}] {cfg.name} d={d} layers={cfg.num_layers} {cfg.dtype} "
        f"vocab {V}; {N} loader batches with Zipf({CACHE_ZIPF_A}) ids, "
        f"labels and negatives in {t1 - t0:.1f} s; the initial master "
        f"drawn on the card and copied to the host in "
        f"{time.perf_counter() - t1:.1f} s; window {CACHE_CAPACITY} of "
        f"{-(-V // CACHE_CHUNK_ROWS)} chunks of {CACHE_CHUNK_ROWS} rows")

    a_eng, a = _engine_run("hstu-large", "algorithm1", V,
                           "tables drawn on the card", f"{tag} a", data=data,
                           n_steps=N)
    losses = [r["loss"] for r in a["steps"]]
    st = a_eng.state
    a_master, a_accum = st.table.master, st.table.accum
    a_ids = st.pending_ids.cpu().numpy()
    a_rows = st.pending_rows.cpu().numpy()
    a_dense = ([p.detach() for p in st.dense.parameters()]
               + list(st.dense_opt.mu.values())
               + list(st.dense_opt.nu.values()))
    shadow_ref = weakref.ref(st.table.shadow)
    del a_eng, st
    gc.collect()
    torch.cuda.empty_cache()
    kept = sum(t.numel() * t.element_size()
               for t in [a_master, a_accum] + a_dense)
    say(f"[{tag} a] kept for the comparisons: master, accumulator, dense "
        f"params and moments, {kept / 1e9:.2f} GB; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; the shadow freed: "
        f"{shadow_ref() is None}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")

    def cached_run(schedule, name):
        cache, setup = _seeded_cache(bundle, batches, CACHE_CAPACITY, init)
        win = cache.window
        say(f"[{tag} {name}] host store {cache.host_nbytes / 1e9:.2f} GB, "
            f"window {sum(t.numel() * t.element_size() for t in win) / 1e9:.2f}"
            f" GB (master, accumulator, shadow), built and warmed up in "
            f"{setup:.1f} s")
        eng, run = _engine_run("hstu-large", schedule, V,
                               "the same seed, the table in host RAM",
                               f"{tag} {name}", data=data, n_steps=N,
                               cache=cache)
        got = [r["loss"] for r in run["steps"]]
        check(got == losses, f"{tag} {name}: losses {got} differ from the "
              f"uncached run's {losses}")
        rss = _host_rss_gb()
        t = time.perf_counter()
        cache.flush()
        flush_s = time.perf_counter() - t
        bad = (_host_equals_card(cache.host_master[:V], a_master),
               _host_equals_card(cache.host_accum[:V], a_accum))
        check(bad == (0, 0), f"{tag} {name}: the flushed host master and "
              f"accumulator differ from the uncached run's at {bad} "
              f"elements")
        est = eng.state
        ids, rows = cache.globalize_pending_pairs(est.pending_ids,
                                                  est.pending_rows)
        check(np.array_equal(ids, a_ids) and np.array_equal(rows, a_rows),
              f"{tag} {name}: the globalized carry ({ids.size} pairs) "
              f"differs from the uncached run's ({a_ids.size})")
        mine = ([p.detach() for p in est.dense.parameters()]
                + list(est.dense_opt.mu.values())
                + list(est.dense_opt.nu.values()))
        check(all(torch.equal(x, y) for x, y in zip(mine, a_dense))
              and est.dense_opt.count == N,
              f"{tag} {name}: the dense params or moments differ")
        shadow_bad = _window_shadow_bad(cache.window)
        check(shadow_bad == 0, f"{tag} {name}: window shadow != "
              f"master.half() at {shadow_bad} elements")
        out = dict(run, counters=cache.counters(), flush_s=flush_s,
                   setup_s=setup, host_rss_gb=rss[0], host_hwm_gb=rss[1],
                   window_gb=sum(t.numel() * t.element_size() for t in win)
                   / 1e9, host_store_gb=cache.host_nbytes / 1e9)
        say(f"[{tag} {name}] losses bit for bit the uncached run's; "
            f"flushed in {flush_s:.2f} s, host master and accumulator = "
            f"the uncached run's chunk by chunk; carry of {ids.size} pairs "
            f"= the uncached run's; dense params and moments equal; window "
            f"shadow == master.half(); host RSS {rss[0]:.1f} GB (peak "
            f"{rss[1]:.1f}); counters {cache.counters()}")
        del eng, est, mine, cache, win
        gc.collect()
        torch.cuda.empty_cache()
        return out

    b = cached_run("algorithm1", "b")
    c = cached_run("flat", "c")
    del a_master, a_accum, a_dense, init
    gc.collect()
    torch.cuda.empty_cache()
    want = {k: N * v for k, v in _step_launches(cfg, "wscatter").items()}
    for name, run in (("b", b), ("c", c)):
        check(run["launches"] == want, f"{tag} {name}: launched "
              f"{run['launches']}, expected {want}")
    k = b["counters"]
    check(k["misses"] > 0 and k["evictions"] > 0 and k["writebacks"] > 0,
          f"{tag} b: misses {k['misses']}, evictions {k['evictions']}, "
          f"writebacks {k['writebacks']} (each must be > 0)")
    steady = lambda r: [s["wall_s"] for s in r["steps"][3:]]  # noqa: E731
    mean = lambda x: sum(x) / len(x)                           # noqa: E731
    per = [s["cache"] for s in b["steps"]]
    wb_share = k["writeback_rows_dirty"] / max(k["writeback_rows_total"], 1)
    out = dict(steps=N, losses=losses, a=a, b=b, c=c,
               hit_rate=k["hit_rate"],
               swap_in_bytes_per_step=k["swap_in_bytes"] / N,
               swap_out_bytes_per_step=k["swap_out_bytes"] / N,
               writeback_row_share=wb_share,
               steady_wall_ms={n: 1e3 * mean(steady(r))
                               for n, r in (("a", a), ("b", b), ("c", c))},
               unique_busy_ms={n: 1e3 * r["timeline"]["stage_s"]["unique"]
                               for n, r in (("a", a), ("b", b), ("c", c))},
               launches=b["launches"], launches_flat=c["launches"],
               card=CARD.get("smi_line"))
    say(f"[{tag}] (a) = (b) = (c) bit for bit: {N} losses ({losses[0]:.5f} "
        f"-> {losses[-1]:.5f}) and the final state; (b) hit rate "
        f"{k['hit_rate']:.6f}, {k['misses']} missed occurrences, "
        f"{k['evictions']} evictions, {k['writebacks']} writebacks "
        f"({wb_share:.4f} of the victims' rows copied back), swap-in "
        f"{out['swap_in_bytes_per_step'] / 1e6:.1f} MB and swap-out "
        f"{out['swap_out_bytes_per_step'] / 1e6:.3f} MB a step; per step "
        f"(misses, loaded, evicted) "
        f"{[(p['misses'], p['loaded_chunks'], p['evicted_chunks']) for p in per]}")
    say(f"[{tag}] steady step wall, steps 3..: (a) uncached "
        f"{out['steady_wall_ms']['a']:.1f} ms, (b) cached "
        f"{out['steady_wall_ms']['b']:.1f} ms, (c) cached flat "
        f"{out['steady_wall_ms']['c']:.1f} ms; unique stage busy "
        f"{ {n: round(v, 1) for n, v in out['unique_busy_ms'].items()} } ms "
        f"over the run; (b) computing {b['timeline']['computing_ratio']:.4f}"
        f", comm not overlapped "
        f"{b['timeline']['comm_not_overlapped_ratio']:.4f}, free "
        f"{b['timeline']['free_ratio']:.4f}; peak above the state (a) "
        f"{max(s['peak_above_tables_gb'] for s in a['steps']):.2f} GB, (b) "
        f"{max(s['peak_above_tables_gb'] for s in b['steps']):.2f} GB; "
        f"host RSS (b) {b['host_rss_gb']:.1f} GB; card "
        f"{CARD.get('smi_line')}")

    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 6g: the autotune harness
# --------------------------------------------------------------------------

AUTOTUNE_ITERS = 7
AUTOTUNE_BUDGET_S = 20.0


def phase_autotune():
    """The port's autotune harness on the card, on a store in a temporary
    directory named by REPRO_TORCH_TUNED_JSON (restored after; the
    committed tuned.json stays empty, so no other phase's launch moves):
    K9-fwd's row split at the ablation's T 8192 (o and rows bf16) and at
    the segmented path's 128-token launch (rows fp16), the fused path's
    scatter_impl (K5 over factored rows against two-pass rows + K6, the
    device sort included in both) at the engine's T 8192 x R 128 slots
    with its 2T ready rows. Every candidate's outputs are bit for bit the
    default's; each is timed one call at a time (autotune.measure: CUDA
    events, behind a sleep kernel), the sweep stores the fastest, resolve
    returns it, and a launch through neg_logits_fwd uses it (the split it
    launched with is recorded) and fused_recall_lse's backward hands its
    table gradient on in the stored form."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import neg_logits as NL
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.training.trainer import TableContribs, _table_grad_pairs
    tag = "autotune"
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="autotune_")
    before = os.environ.get(AT.ENV)
    os.environ[AT.ENV] = os.path.join(tmp, "tuned.json")
    tracer, metrics = Tracer(enabled=True), MetricsRegistry()
    out = {"card": CARD.get("smi_line"), "backend": AT.backend_of(dev)}
    try:
        gen = torch.Generator(device=dev).manual_seed(SEED + 26)
        T, R, D = 8192, 128, 1024
        o = torch.randn(T, D, device=dev, generator=gen).to(torch.bfloat16)
        n16 = (torch.randn(T, R, D, device=dev, generator=gen) * 0.02)
        shapes = {"T8192 bf16": (o, n16.to(torch.bfloat16)),
                  "T128 fp16": (o[:128].contiguous(),
                                n16[:128].to(torch.float16))}
        del n16
        for name, (oo, nn) in shapes.items():
            dims = NL.nl_fwd_dims(oo, nn)
            default = NL.fwd_row_split(nn.shape[0], R)
            want = NL.neg_logits_fwd(oo, nn, inv_tau=1.0, row_split=default)
            bits = {}

            def run_fn(cfg):
                got = NL.neg_logits_fwd(oo, nn, inv_tau=1.0,
                                        row_split=cfg["row_split"])
                bits[cfg["row_split"]] = torch.equal(got, want)
                return lambda: NL.neg_logits_fwd(
                    oo, nn, inv_tau=1.0, row_split=cfg["row_split"])
            res = AT.sweep("neg_logits_fwd", dims, run_fn,
                           iters=AUTOTUNE_ITERS, warmup=1, tracer=tracer,
                           metrics=metrics, device=dev)
            check(all(bits.values()) and len(bits) == len(res["trials"]),
                  f"{tag} {name}: a row split changed K9-fwd's bits {bits}")
            best = res["best"]["config"]["row_split"]
            got = AT.resolve("neg_logits_fwd", dims, "row_split",
                             default=default, backend=AT.backend_of(dev))
            check(got == best, f"{tag} {name}: resolve gave {got}, the "
                  f"sweep stored {best}")
            NL.neg_logits_fwd(oo, nn, inv_tau=1.0)
            used = NL.LAUNCH_KNOBS["neg_logits_fwd"]["row_split"]
            check(used == best, f"{tag} {name}: neg_logits_fwd launched "
                  f"with split {used}, the store holds {best}")
            times = {t["config"]["row_split"]: round(t["seconds"] * 1e3, 4)
                     for t in res["trials"]}
            say(f"[{tag}] K9-fwd row split at {name} ({res['bucket']}): ms "
                f"by split {times}, one call at a time, medians of "
                f"{AUTOTUNE_ITERS} (heuristic default {default}, stored "
                f"{best}; every split bit for bit the default's) on "
                f"{out['card']}")
            out[f"neg_logits_fwd {name}"] = dict(
                ms=times, default=default, best=best, key=res["key"])
        del shapes, want
        # scatter_impl at the engine's fused shape
        V = 2 ** 22
        zipf, neg, drop = _k6_phase_ids(np.random.default_rng(SEED), T, R, V)
        ids = torch.from_numpy(np.concatenate([neg, zipf, drop])).to(dev)
        n, TR = ids.numel(), T * R
        w = torch.rand(T, R, device=dev, generator=gen) / R
        extra = torch.randn(n - TR, D, device=dev, generator=gen)
        rows = torch.empty((n, D), device=dev)

        def variant(impl):
            if impl == "fused":
                return lambda: _table_grad_pairs(
                    TableContribs(ids, extra, (w, o, 1.0)), V)

            def two_pass():
                torch.mul(w[:, :, None], o.float()[:, None],
                          out=rows[:TR].view(T, R, D))
                rows[TR:] = extra
                return _table_grad_pairs(TableContribs(ids, rows, None), V)
            return two_pass
        ref_u, ref_t = variant("fused")()
        same = {}

        def run_scatter(cfg):
            u, t = variant(cfg["scatter_impl"])()
            same[cfg["scatter_impl"]] = (torch.equal(u, ref_u)
                                         and torch.equal(t, ref_t))
            return variant(cfg["scatter_impl"])
        sdims = dict(segment=128, R=R, D=D, T=T, expansion=1)
        res = AT.sweep("neg_fused", sdims, run_scatter,
                       iters=AUTOTUNE_ITERS, warmup=1, tracer=tracer,
                       metrics=metrics, device=dev)
        check(all(same.values()) and len(same) == 2, f"{tag}: the two "
              f"scatter impls differ {same}")
        best = res["best"]["config"]["scatter_impl"]
        check(AT.resolve("neg_fused", sdims, "scatter_impl",
                         backend=AT.backend_of(dev)) == best,
              f"{tag}: resolve does not give the stored scatter_impl")
        del rows, extra, w, ref_t
        # fused_recall_lse's backward at that shape takes the stored form
        table = torch.randn(2 ** 16, D, device=dev, generator=gen) * 0.02
        nid = torch.randint(0, 2 ** 16, (T, R), device=dev, generator=gen)
        oo = o.detach().requires_grad_()
        sink = NL.TableGradSink()
        NL.fused_recall_lse(oo, torch.zeros(T, device=dev), table, nid,
                            gather_table=table.half(),
                            table_grad_pairs=sink).sum().backward()
        check((sink.neg is None) == (best == "two_pass"), f"{tag}: the "
              f"fused path's table gradient is not in the stored form "
              f"{best}")
        times = {t["config"]["scatter_impl"]: round(t["seconds"] * 1e3, 4)
                 for t in res["trials"]}
        say(f"[{tag}] neg_fused scatter_impl at T {T}, R {R}, D {D} "
            f"({n} slots, the sort included): ms {times}, medians of "
            f"{AUTOTUNE_ITERS} (default fused, stored {best}; bit for bit "
            f"alike) on {out['card']}")
        out["neg_fused scatter_impl"] = dict(ms=times, best=best,
                                             key=res["key"])
        spans = [x for x in tracer.spans() if x.track == "autotune"]
        snap = metrics.snapshot()
        check(len(spans) == AUTOTUNE_ITERS * (3 + 3 + 2) and
              "autotune_trial_seconds" in snap, f"{tag}: {len(spans)} "
              f"spans, metrics {sorted(snap)}")
        stored = json.load(open(os.environ[AT.ENV]))["entries"]
        check(len(stored) == 3 and all(k.endswith("|" + out["backend"])
                                       for k in stored),
              f"{tag}: the store holds {sorted(stored)}")
        out["stored"] = stored
        out["seconds"] = time.perf_counter() - t_start
        say(f"[{tag}] checks: every candidate bit for bit its default; "
            f"{len(spans)} spans on track autotune; resolve gives the "
            f"stored winners ({len(stored)} entries, backend "
            f"{out['backend']}); phase {out['seconds']:.1f} s (budget "
            f"{AUTOTUNE_BUDGET_S:.0f} s)")
        return out
    finally:
        if before is None:
            os.environ.pop(AT.ENV, None)
        else:
            os.environ[AT.ENV] = before
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 6e: hierarchical sparse parallelism, semi-async, elastic restart
# --------------------------------------------------------------------------

HSP_STEPS = 6
HSP_UPD = 2                       # 2 packs x 2 users x 2048: the 8192 tokens
MESH_V = 2 ** 20
MESH_LAYERS = 2
MESH_STEPS = 4
#: the elastic phase's vocab: its runs write 6 checkpoints, which at
#: MESH_V (8.6 GB each) would pass the 45 GiB a call may write to disk
#: beside the resilient phase's 35.4 GB; at 2^17 they are ~1.1 GB each
ELASTIC_V = 2 ** 17
ELASTIC_STEPS = 8
ELASTIC_EVERY = 3
ELASTIC_FAIL = {5: 2}
#: the collectives' timeout of the ranks' meshes (a lost peer fails a
#: collective at once on a closed connection; a hung one after this)
HSP_TIMEOUT_S = 180
#: rows compared between the 2-rank run and the single-process run
HSP_SAMPLE = 16384
ARMS = {"hsp": (("model",), ("data",)), "global": (("data", "model"), ())}
# The 2-rank run against the single-process engine on the same global
# batch. The model is bf16: one process takes the dense grads of the whole
# batch in bf16, the ranks take each pack's in bf16 and sum the two in
# fp32, so grads differ at bf16's rounding (2^-8), which AdamW's first
# steps (lr·m/√v ≈ lr·sign(g) on small grads) carry into the params and
# the losses: on the H100 they lay 6.2e-4 apart over 6 steps from a table
# drawn whole and 1.59e-3 from the same seed's table drawn by row block
# (the same bits run to run); the limit was set at about three times the
# first. The table rows agree but where an element's first grad is near
# zero: AdaGrad's first step moves it by up to lr (4e-3) either way, so an
# element may differ by 2·lr (measured 2.4e-3 and 1.7e-3, at 1.7% and 2.2%
# of the elements past 1e-5), while the median stays at fp32 rounding
# (measured 4.7e-9 and 1.3e-8: limit 1e-6); the accumulators, sums of g²,
# differ by at most 2.6e-6 and 5.5e-6 (limit 1e-4).
HSP_LOSS_TOL = 2e-3
#: logit sharing across ranks in phase hsp_mesh: the expansion, its
#: segments (128 divides the 2048-token pack; 2048 % 96 = 32, so segments
#: straddle two ranks' packs, and 96 is a multiple of K4's 8 tokens a
#: CTA) and its steps a segment
SHARE_EXPANSION = 2
SHARE_SEGMENTS = (128, 96)
SHARE_STEPS = 2
#: rows of each sample set whose first-step table grads (the τ=1 carry
#: after step 1) the sharing runs compare with the single process's
SHARE_SAMPLE = 2048
#: the first-step grads of the sharing runs against the single process's,
#: each field's largest difference over its largest. The carry's rows
#: (summed table grads) differ only in the order of fp32 sums: the owner's
#: K3/K4 see the same segment bits as the single process's, the moved
#: tokens' included (H100: 7.9e-8 and 8.0e-8 at the moved rows, 8.5e-8
#: and 8.6e-8 at the control rows, segments 128 and 96); the dense first
#: moments differ at bf16's rounding, since each rank takes its pack's
#: dense grads in bf16 (3.8e-3 and 4.5e-3, with 1495 and 1481 of 10.5 M
#: elements' signs flipped). The limits are about 12x and 2x those.
SHARE_GRAD_TOL = {"table": 1e-6, "dense": 1e-2}
HSP_MASTER_TOL = 2 * 4e-3
HSP_MASTER_MEDIAN_TOL = 1e-6
HSP_ACCUM_TOL = 1e-4


def _hsp_loader(V, world, upd):
    """The engine cell's users and negatives split into ``world`` packs
    of ``upd`` users x 2048 events: GRLoader(num_devices=world)."""
    from repro_torch.data import GRLoader, SyntheticKuaiRand
    gen = SyntheticKuaiRand(num_users=64, num_items=V, mean_len=1800,
                            sigma_len=0.6, max_len=4096, seed=SEED)
    seqs = {u: (d["item"], d["ts"]) for u, d in
            ((u, gen.interactions(u)) for u in range(64))}
    return GRLoader(seqs, num_devices=world, users_per_device=upd,
                    max_seq_len=2048, num_negatives=128, num_items=V,
                    seed=SEED)


def _hsp_cfg(V, layers=None):
    from repro_torch.configs import get_arch
    cfg = get_arch("hstu-large").replace(vocab_size=V)
    return cfg.replace(num_layers=layers) if layers else cfg


def _shadow_bad(tbl, rows_per=1 << 17):
    bad = 0
    for lo in range(0, tbl.master.shape[0], rows_per):
        bad += int((tbl.shadow[lo:lo + rows_per]
                    != tbl.master[lo:lo + rows_per].half()).sum())
    return bad


def _run_hsp_engine(mesh, hsp, cfg, batches, steps, sched, tag,
                    loss_kwargs=None, on_first=None):
    """GREngine over ``mesh`` (this rank's shard, ``hsp``), tau=1,
    ``steps`` steps of ``sched`` (``loss_kwargs`` bound into the loss)
    with launch counts and exchange counters zeroed just before and read
    just after; the rank's walls, peaks and the final state's checksums.
    ``on_first(state)`` sees the state after the first step (its carry the
    step's table grads); the walls leave its time out."""
    import torch
    from repro_torch.core.hsp import bit_checksum
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import GREngine, state_tensors
    gc.collect()
    torch.cuda.empty_cache()
    # no rank builds its engine before all have freed the last run's state
    mesh.barrier()
    t0 = time.perf_counter()
    eng = GREngine(GRBundle(cfg), lambda i: batches[i], seed=SEED, hsp=hsp,
                   schedule=sched, semi_async=True, loss_kwargs=loss_kwargs)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    marks, peaks, clocks, held = [], [], [], [0.0]

    def on_step(i, rec, state):
        marks.append(time.perf_counter() - held[0])
        peaks.append(torch.cuda.max_memory_allocated() - base)
        torch.cuda.reset_peak_memory_stats()
        clocks.append({k: (v["seconds"], v["wait_s"])
                       for k, v in mesh.stats.items()})
        if i == 0 and on_first is not None:
            t = time.perf_counter()
            on_first(state)
            held[0] += time.perf_counter() - t

    eng.step_callback = on_step
    checks0 = dict(hsp.checks)
    _zero_counts()
    mesh.stats.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recs = eng.run(steps)
    torch.cuda.synchronize()
    counts = _read_counts()
    walls = [m - p for m, p in zip(marks, [t0] + marks[:-1])]
    st = eng.state
    out = dict(sched=sched, losses=[r["loss"] for r in recs],
               tokens=[r["tokens"] for r in recs], walls_s=walls,
               split=_exchange_split(walls, clocks),
               peaks_gb=[p / 1e9 for p in peaks], setup_s=setup,
               state_gb=base / 1e9, launches=counts,
               stats={k: dict(v) for k, v in mesh.stats.items()},
               checks={k: hsp.checks[k] - checks0[k] for k in checks0},
               shadow_bad=_shadow_bad(st.table),
               checksums=[int(c) for t in state_tensors(st)
                          for c in bit_checksum(t).tolist()],
               carry=int(st.pending_ids.numel()))
    say(f"[{tag} rank {mesh.rank}] {sched}: losses "
        f"{[round(x, 5) for x in out['losses']]}; walls (time-shared) "
        f"{[round(w * 1e3, 1) for w in walls]} ms; peak above the state "
        f"{max(out['peaks_gb']):.2f} GB (state {base / 1e9:.2f} GB); "
        f"launches {counts}; exchange bytes "
        f"{ {k: v['bytes'] for k, v in out['stats'].items()} }; checks "
        f"{out['checks']}; shadow != master.half() at {out['shadow_bad']}")
    return eng, out


def _exchange_split(walls, clocks):
    """Each step's wall split by the mesh's clocks (``Mesh.stats``, read
    at each step's end): ``exchange_s`` in the collectives (staging, gloo,
    peers' lateness), ``wait_s`` waiting for the card's queue before them,
    ``rest_s`` the remainder (host work outside the collectives); and the
    exchange seconds by kind."""
    out, prev = [], {}
    for w, c in zip(walls, clocks):
        kinds = {k: c[k][0] - prev.get(k, (0.0, 0.0))[0] for k in c}
        wait = sum(c[k][1] - prev.get(k, (0.0, 0.0))[1] for k in c)
        ex = sum(kinds.values())
        out.append(dict(wall_s=w, exchange_s=ex, wait_s=wait,
                        rest_s=w - ex - wait, by_kind=kinds))
        prev = c
    return out


def _split_line(split, first=2):
    """The steady steps' (from ``first``) mean split, as text."""
    import numpy as np
    st = split[first:] or split
    m = {k: float(np.mean([x[k] for x in st]))
         for k in ("wall_s", "exchange_s", "wait_s", "rest_s")}
    kinds = {k: round(1e3 * float(np.mean([x["by_kind"].get(k, 0.0)
                                           for x in st])), 1)
             for k in st[0]["by_kind"]}
    return (f"steady step (steps {first}..) {m['wall_s'] * 1e3:.1f} ms = "
            f"exchange {m['exchange_s'] * 1e3:.1f} ms + wait for the card "
            f"before a collective {m['wait_s'] * 1e3:.1f} ms + rest "
            f"{m['rest_s'] * 1e3:.1f} ms; exchange ms by kind {kinds}")


def hsp_rank(mesh, *, V, upd, steps, layers=None, arms=("hsp",),
             schedules=("algorithm1", "flat"), sample=None, out=None,
             tag="hsp", share_segments=(), share_steps=0, share_sample=None,
             share_out=None):
    """A rank of phase hsp / hsp_mesh: for each arm (``hsp``: the table
    over ``model``; ``global``: over the whole world) and schedule, the
    engine over the global batches of the phase's loader; with ``sample``
    (a .npy of global ids), the first run's final master and accumulator
    rows at those ids in this rank's shard, to ``out``. Then, for each of
    ``share_segments``, ``share_steps`` Algorithm-1 steps of the ``hsp``
    arm at expansion 2 and that segment (logit sharing across ranks); with
    ``share_sample`` (a .npy of global ids), the state after the first of
    them to the .npz ``share_out`` (:func:`_first_step_state`)."""
    import numpy as np
    import torch
    from repro_torch.core.hsp import make_hsp_lookup
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _hsp_cfg(V, layers)
    batches = list(_hsp_loader(V, mesh.world, upd).batches(steps))
    res = {"rank": mesh.rank, "coords": mesh.coords}
    for arm in arms:
        ga, da = ARMS[arm]
        hsp = make_hsp_lookup(mesh, group_axes=ga, dp_axes=da,
                              compute_dtype=torch.bfloat16)
        lo, hi = hsp.shard_range(V)
        res[arm] = {"lo": lo, "hi": hi}
        for k, sched in enumerate(schedules):
            eng, r = _run_hsp_engine(mesh, hsp, cfg, batches, steps, sched,
                                     tag)
            res[arm][sched] = r
            if sample is not None and k == 0:
                ids = np.load(sample)
                mine = ids[(ids >= lo) & (ids < hi)]
                idx = torch.from_numpy(mine - lo).long().to(mesh.device)
                tbl = eng.state.table
                np.savez(out.format(rank=mesh.rank), ids=mine,
                         master=tbl.master[idx].cpu().numpy(),
                         accum=tbl.accum[idx].cpu().numpy())
                del tbl, idx
            del eng                     # the next run draws its own table
    if share_segments:
        ga, da = ARMS["hsp"]
        hsp = make_hsp_lookup(mesh, group_axes=ga, dp_axes=da,
                              compute_dtype=torch.bfloat16)
        res["share"] = {}
        lo, hi = hsp.shard_range(V)
        for seg in share_segments:
            cap = None
            if share_sample is not None:
                cap = lambda st, seg=seg: np.savez(  # noqa: E731
                    share_out.format(rank=mesh.rank, seg=seg),
                    **_first_step_state(st, np.load(share_sample), lo, hi,
                                        dense=mesh.rank == 0))
            eng, r = _run_hsp_engine(
                mesh, hsp, cfg, batches, share_steps, "algorithm1",
                f"{tag} expansion 2 segment {seg}",
                loss_kwargs=dict(expansion=SHARE_EXPANSION, neg_segment=seg),
                on_first=cap)
            res["share"][str(seg)] = r
            del eng
    return res


def hsp_reference_child(V, steps, sample, out):
    return _child_main(_hsp_reference, V, steps, sample, out)


def _hsp_reference(V, steps, sample, out):
    """The single-process engine on the 2-rank run's global batches (G = 2
    packs on one card), algorithm1, tau=1: its losses, peak, and the final
    master and accumulator rows at the sampled ids."""
    import numpy as np
    import torch
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import GREngine
    dev = torch.device("cuda")
    batches = list(_hsp_loader(V, 2, HSP_UPD).batches(steps))
    t0 = time.perf_counter()
    eng = GREngine(GRBundle(_hsp_cfg(V)), lambda i: batches[i], seed=SEED,
                   device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    marks = []
    eng.step_callback = lambda i, rec, st: marks.append(time.perf_counter())
    t0 = time.perf_counter()
    losses = [r["loss"] for r in eng.run(steps)]
    torch.cuda.synchronize()
    walls = [m - p for m, p in zip(marks, [t0] + marks[:-1])]
    ids = np.load(sample)
    idx = torch.from_numpy(ids).long().to(dev)
    np.savez(out, ids=ids, master=eng.state.table.master[idx].cpu().numpy(),
             accum=eng.state.table.accum[idx].cpu().numpy())
    say(f"[hsp] single-process reference (G = 2 packs, one process): losses "
        f"{[round(x, 5) for x in losses]}; walls "
        f"{[round(w * 1e3, 1) for w in walls]} ms; peak above the state "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB")
    return dict(losses=losses, walls_s=walls, setup_s=setup,
                peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)


def _spawn_world(entry, kwargs, shape, tag, deadline_s=900):
    """``chip_smoke.<entry>(mesh, **kwargs)`` in a world of rank processes
    of a ``shape`` mesh, every rank on this card (gloo between them); their
    lines relayed; their results. The world's directory (store, logs,
    results) is removed."""
    import shutil
    import tempfile
    from repro_torch.launch import mesh as M
    run_dir = tempfile.mkdtemp(prefix=f"{tag}_")
    try:
        t0 = time.perf_counter()
        procs = M.spawn_ranks(f"chip_smoke:{entry}", kwargs, shape=shape,
                              run_dir=run_dir, device="cuda",
                              timeout_s=HSP_TIMEOUT_S, sys_path=[str(ROOT)])
        rcs = M.wait_ranks(procs, deadline_s)
        wall = time.perf_counter() - t0
        for r, lg in enumerate(M.rank_logs(run_dir, len(procs))):
            for ln in lg.splitlines():
                say(ln if ln.startswith("[") else f"[{tag} rank {r}] {ln}")
        check(rcs == [0] * len(procs), f"{tag}: rank exit codes {rcs}")
        say(f"[{tag}] world {shape} ran {wall:.1f} s (processes started to "
            f"all ended)")
        return M.rank_results(run_dir, len(procs))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _pack_reads(batch, V):
    """One pack's unique reads by kind, as the exchanges see them."""
    import numpy as np
    ids = np.asarray(batch["ids"]).reshape(-1)
    lab = np.asarray(batch["labels"]).reshape(-1)
    neg = np.clip(np.asarray(batch["neg_ids"]).reshape(-1), 0, V - 1)
    return dict(ids=np.unique(ids), labels=np.unique(lab),
                neg=np.unique(neg),
                cand=np.unique(np.concatenate([neg, ids, lab])))


def _expected_bytes(batches, V, shape, arm, d, share_segment=None):
    """Per rank, the exchange bytes a run over ``batches`` must count,
    from the batches alone: the ids and rows of the lookups (bf16 rows) and
    the negatives (fp16 rows), and the grad pairs (id + fp32 row) within
    the group and across replicas. With ``share_segment`` (logit sharing
    across ranks at that segment): a rank's negatives and negative grad
    pairs are those of the segments it owns, the global tokens [seg_lo,
    seg_hi) x segment (``share_layout``), and the straddling tokens travel
    (``share_tokens``: the bf16 o row, the fp32 positive logit and valid
    flag and R int32 ids of each token a rank sends; ``share_grads``: the
    bf16 dout and fp32 dpos of each token it borrowed)."""
    import numpy as np
    from repro_torch.kernels.neg_logits import share_layout
    world = int(np.prod(shape))
    M_ = shape[1]
    group = (lambda r: [r // M_ * M_ + j for j in range(M_)]) \
        if arm == "hsp" else (lambda r: list(range(world)))
    I = M_ if arm == "hsp" else world
    Vs = V // I
    sidx = (lambda r: r % M_) if arm == "hsp" else (lambda r: r)
    D = shape[0] if arm == "hsp" else 1
    out = [dict(lookup_ids=0, lookup_rows=0, neg_ids=0, neg_rows=0,
                grad_group=0, grad_replicas=0, share_tokens=0,
                share_grads=0) for _ in range(world)]
    for b in batches:
        reads = [_pack_reads({k: v[r:r + 1] for k, v in b.items()}, V)
                 for r in range(world)]
        if share_segment:
            cap = np.asarray(b["ids"]).shape[1]
            neg = np.asarray(b["neg_ids"]).reshape(world * cap, -1)
            R = neg.shape[1]
            for r in range(world):
                lay = share_layout(world, r, cap, share_segment)
                mine = np.unique(np.clip(neg[
                    lay.seg_lo * share_segment:
                    min(lay.seg_hi * share_segment, world * cap)], 0, V - 1))
                reads[r]["neg"] = mine
                reads[r]["cand"] = np.unique(np.concatenate(
                    [mine, reads[r]["ids"], reads[r]["labels"]]))
                if lay.moves:
                    out[r]["share_tokens"] += lay.keep * (2 * d + 8 + 4 * R)
                    out[r]["share_grads"] += lay.borrow * (2 * d + 4)
        for r in range(world):
            lo, hi = sidx(r) * Vs, (sidx(r) + 1) * Vs
            own = lambda u: (u >= lo) & (u < hi)          # noqa: E731
            e = out[r]
            for k in ("ids", "labels"):
                e["lookup_ids"] += 4 * int((~own(reads[r][k])).sum())
                e["lookup_rows"] += 2 * d * sum(
                    int(own(reads[p][k]).sum()) for p in group(r) if p != r)
            e["neg_ids"] += 4 * int((~own(reads[r]["neg"])).sum())
            e["neg_rows"] += 2 * d * sum(
                int(own(reads[p]["neg"]).sum()) for p in group(r) if p != r)
            e["grad_group"] += (4 + 4 * d) * int(
                (~own(reads[r]["cand"])).sum())
            if D > 1:
                mine = np.unique(np.concatenate(
                    [reads[p]["cand"] for p in group(r)]))
                e["grad_replicas"] += (4 + 4 * d) * int(
                    own(mine).sum()) * (D - 1)
    return out


def _rank_launch_want(cfg, steps, runsum):
    want = {k: steps * v for k, v in _step_launches(cfg, "wscatter").items()}
    want["gather"] = 3 * steps          # inputs, labels, negatives (owner)
    want["runsum"] = runsum * steps
    return want


def _id_stream_alpha(tag):
    """Appendix C's alpha of the engine cell's id stream (every table read
    of a step: inputs, labels, negatives) beside the delay-penalty bound
    at alpha and at alpha = 1."""
    import numpy as np
    from repro_torch.core.semi_async import collision_alpha, \
        delay_penalty_bound
    from repro_torch.training import host_unique_candidates
    V = _hsp_cfg(2 ** 22).vocab_size
    n = ENGINE_STEPS["hstu-large"]
    stream = []
    for b in _train_loader(V).batches(n):
        s, first, _ = host_unique_candidates(b, V)
        stream.append(s[first])
    alpha = collision_alpha(stream)
    b_at = delay_penalty_bound(alpha, 1.0, 1, n)
    b_one = delay_penalty_bound(1.0, 1.0, 1, n)
    b_sync = delay_penalty_bound(0.0, 1.0, 0, n)
    say(f"[{tag}] Appendix C: alpha of the engine cell's id stream (every "
        f"table read, {n} steps, {np.mean([len(x) for x in stream]):.0f} "
        f"distinct ids a step) {alpha:.5f}; delay_penalty_bound(alpha, L=1, "
        f"tau=1, T={n}) {b_at:.5f} against {b_one:.5f} at alpha = 1 and "
        f"{b_sync:.5f} synchronous")
    return dict(alpha=alpha, bound=b_at, bound_alpha1=b_one,
                bound_sync=b_sync)


def phase_hsp():
    """hstu-large at full width and depth over a table of 2^22 rows split
    between 2 ranks (mesh data 1 x model 2) on the one card, tau=1, R 128:
    6 Algorithm-1 and 6 flat steps on the engine cell's 8192 tokens (2
    packs), held to the single-process engine on the same global batch."""
    import numpy as np
    from repro_torch.obs import token_imbalance
    from repro_torch.training import host_unique_candidates
    import shutil
    tag = "hsp"
    alpha = _id_stream_alpha(tag)
    V = 2 ** 22
    cfg = _hsp_cfg(V)
    batches = list(_hsp_loader(V, 2, HSP_UPD).batches(HSP_STEPS))
    loads = np.asarray(batches[0]["offsets"])[:, -1]
    imb = [token_imbalance(np.asarray(b["offsets"])[:, -1]) for b in batches]
    say(f"[{tag}] packs: tokens {[np.asarray(b['offsets'])[:, -1].tolist() for b in batches]}; "
        f"token imbalance {[round(x, 4) for x in imb]}")
    import tempfile
    tmp = tempfile.mkdtemp(prefix="hsp_rows_")
    try:
        last = batches[-1]
        s, first, _ = host_unique_candidates(last, V)
        touched = s[first]
        rng = np.random.default_rng(SEED)
        sample = np.sort(rng.choice(touched, min(HSP_SAMPLE, touched.size),
                                    replace=False)).astype(np.int64)
        sample_path = os.path.join(tmp, "sample.npy")
        np.save(sample_path, sample)
        ref = _run_child("hsp_reference_child", tag,
                         args=(V, HSP_STEPS, sample_path,
                               os.path.join(tmp, "ref.npz")))
        res = _spawn_world("hsp_rank", dict(
            V=V, upd=HSP_UPD, steps=HSP_STEPS, sample=sample_path,
            out=os.path.join(tmp, "rank{rank}.npz")), (1, 2), tag)
        want = _rank_launch_want(cfg, HSP_STEPS, runsum=1)
        exp = _expected_bytes(batches, V, (1, 2), "hsp", cfg.d_model)
        for r in res:
            a, f = r["hsp"]["algorithm1"], r["hsp"]["flat"]
            check(a["losses"] == f["losses"] and a["checksums"] == f["checksums"],
                  f"{tag} rank {r['rank']}: algorithm1 and flat differ")
            check(a["losses"] == res[0]["hsp"]["algorithm1"]["losses"],
                  f"{tag}: the ranks report different losses")
            for run in (a, f):
                check(run["launches"] == want, f"{tag} rank {r['rank']} "
                      f"{run['sched']}: launches {run['launches']}, expected "
                      f"{want}")
                check(run["checks"]["dense"] == HSP_STEPS,
                      f"{tag}: dense replicas checked {run['checks']}")
                check(run["shadow_bad"] == 0, f"{tag}: shadow != master.half()")
                got = {k: run["stats"].get(k, {}).get("bytes", 0)
                       for k in exp[r["rank"]]}
                check(got == exp[r["rank"]], f"{tag} rank {r['rank']}: "
                      f"exchange bytes {got}, from the batches {exp[r['rank']]}")
        losses = res[0]["hsp"]["algorithm1"]["losses"]
        dl = float(np.max(np.abs(np.array(losses) - ref["losses"])))
        z = np.load(os.path.join(tmp, "ref.npz"))
        ids = np.concatenate([np.load(os.path.join(tmp, f"rank{r}.npz"))["ids"]
                              for r in range(2)])
        check(np.array_equal(ids, z["ids"]), f"{tag}: sampled rows missing")
        dm = np.concatenate([np.load(os.path.join(tmp, f"rank{r}.npz"))["master"]
                             for r in range(2)]) - z["master"]
        da = np.concatenate([np.load(os.path.join(tmp, f"rank{r}.npz"))["accum"]
                             for r in range(2)]) - z["accum"]
        rows = dict(master_max=float(np.abs(dm).max()),
                    master_median=float(np.median(np.abs(dm))),
                    master_share_1e5=float((np.abs(dm) > 1e-5).mean()),
                    accum_max=float(np.abs(da).max()),
                    accum_median=float(np.median(np.abs(da))))
        say(f"[{tag}] against the single-process engine on the same 8192 "
            f"tokens: losses max |diff| {dl:.3g} ({losses} vs {ref['losses']}); "
            f"master and accumulator rows at {ids.size} ids the last step "
            f"touched: {rows}")
        check(dl <= HSP_LOSS_TOL, f"{tag}: losses {dl:.3g} from the single "
              f"process, limit {HSP_LOSS_TOL}")
        check(rows["master_max"] <= HSP_MASTER_TOL and
              rows["master_median"] <= HSP_MASTER_MEDIAN_TOL and
              rows["accum_max"] <= HSP_ACCUM_TOL,
              f"{tag}: table rows {rows} beyond {HSP_MASTER_TOL} (median "
              f"{HSP_MASTER_MEDIAN_TOL}) / {HSP_ACCUM_TOL}")
        for r in res:
            a = r["hsp"]["algorithm1"]
            say(f"[{tag}] rank {r['rank']} (shard rows [{r['hsp']['lo']}, "
                f"{r['hsp']['hi']})): launches a run {a['launches']}; exchange "
                f"bytes a run { {k: v['bytes'] for k, v in a['stats'].items()} } "
                f"(peers { {k: v['peers'] for k, v in a['stats'].items()} }); "
                f"peak above the state {max(a['peaks_gb']):.2f} GB, state "
                f"{a['state_gb']:.2f} GB; steady step wall steps 2.. "
                f"{1e3 * np.mean(a['walls_s'][2:]):.1f} ms algorithm1, "
                f"{1e3 * np.mean(r['hsp']['flat']['walls_s'][2:]):.1f} ms flat "
                f"(two ranks time-sharing one card: not a scaling result)")
            for sched in ("algorithm1", "flat"):
                say(f"[{tag}] rank {r['rank']} {sched}: "
                    f"{_split_line(r['hsp'][sched]['split'])}")
        say(f"[{tag}] checks: algorithm1 = flat bit for bit on both ranks "
            f"(losses and exact checksums of every state tensor); dense "
            f"replicas equal at each of {HSP_STEPS} steps; shadow == "
            f"master.half() on both shards; launches {HSP_STEPS} x a step's "
            f"on each rank; exchange bytes equal to the counts the batches "
            f"give")
        return dict(ranks=res, reference=ref, rows=rows, loss_diff=dl,
                    alpha=alpha, imbalance=imb, expected_bytes=exp,
                    loads=loads.tolist())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def hsp_world1(mesh, *, V, upd, steps, share_segments=(), share_steps=0):
    """A world of one: the HSP engine against the single-process engine
    on the same batches, bit for bit (losses and every state tensor); then
    the same at expansion 2 for each of ``share_segments``,
    ``share_steps`` steps each."""
    import torch
    from repro_torch.core.hsp import make_hsp_lookup
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import GREngine, state_tensors
    cfg = _hsp_cfg(V, MESH_LAYERS)
    batches = list(_hsp_loader(V, 1, upd).batches(steps))
    hsp = make_hsp_lookup(mesh, compute_dtype=torch.bfloat16)
    out = {}
    for seg in (None, *share_segments):
        lk = None if seg is None else dict(expansion=SHARE_EXPANSION,
                                           neg_segment=seg)
        n = steps if seg is None else share_steps
        a = GREngine(GRBundle(cfg), lambda i: batches[i], seed=SEED,
                     hsp=hsp, loss_kwargs=lk)
        la = [r["loss"] for r in a.run(n)]
        b = GREngine(GRBundle(cfg), lambda i: batches[i], seed=SEED,
                     device=mesh.device, loss_kwargs=lk)
        lb = [r["loss"] for r in b.run(n)]
        same = la == lb and all(torch.equal(x, y) for x, y in zip(
            state_tensors(a.state), state_tensors(b.state)))
        what = ("" if seg is None else
                f" at expansion {SHARE_EXPANSION}, segment {seg}")
        say(f"[hsp_mesh] world of one{what}: HSP losses {la}, single "
            f"process {lb}; every state tensor equal: {same}")
        out["plain" if seg is None else str(seg)] = dict(
            losses=la, single=lb, bitwise=same)
        del a, b
        gc.collect()                    # the next pair draws its own tables
        torch.cuda.empty_cache()
    return out


def phase_hsp_mesh():
    """hstu-large widths at 2 layers over a 2^20-row table, 1 x 2048
    events per rank, 4 ranks on the one card: HSP (data 2 x model 2) and
    global sharding (a group of 4), 4 tau=1 steps each; and a world of one
    against the single-process engine."""
    import numpy as np
    tag = "hsp_mesh"
    V = MESH_V
    cfg = _hsp_cfg(V, MESH_LAYERS)
    w1 = _spawn_world("hsp_world1", dict(
        V=V, upd=1, steps=MESH_STEPS, share_segments=list(SHARE_SEGMENTS),
        share_steps=SHARE_STEPS), (1, 1), tag)
    for k, v in w1[0].items():
        check(v["bitwise"], f"{tag}: a world of one differs from the "
              f"single-process engine ({k})")
    batches = list(_hsp_loader(V, 4, 1).batches(MESH_STEPS))
    sample = _share_sample_ids(batches[0], V, 4, 2048, min(SHARE_SEGMENTS))
    share_dir = tempfile.mkdtemp(prefix="hsp_share_")
    ids_path = os.path.join(share_dir, "ids.npy")
    np.save(ids_path, np.unique(np.concatenate(list(sample.values()))))
    res = _spawn_world("hsp_rank", dict(
        V=V, upd=1, steps=MESH_STEPS, layers=MESH_LAYERS,
        arms=["hsp", "global"], schedules=["algorithm1"], tag=tag,
        share_segments=list(SHARE_SEGMENTS), share_steps=SHARE_STEPS,
        share_sample=ids_path,
        share_out=os.path.join(share_dir, "r{rank}_s{seg}.npz")),
        (2, 2), tag)
    totals = {}
    for arm in ("hsp", "global"):
        exp = _expected_bytes(batches, V, (2, 2), arm, cfg.d_model)
        want = _rank_launch_want(cfg, MESH_STEPS,
                                 runsum=2 if arm == "hsp" else 1)
        for r in res:
            run = r[arm]["algorithm1"]
            check(run["launches"] == want, f"{tag} {arm} rank {r['rank']}: "
                  f"launches {run['launches']}, expected {want}")
            check(run["shadow_bad"] == 0, f"{tag}: shadow != master.half()")
            got = {k: run["stats"].get(k, {}).get("bytes", 0)
                   for k in exp[r["rank"]]}
            check(got == exp[r["rank"]], f"{tag} {arm} rank {r['rank']}: "
                  f"exchange bytes {got}, from the batches "
                  f"{exp[r['rank']]}")
            check(run["checks"]["dense"] == MESH_STEPS and
                  run["checks"]["table"] == (MESH_STEPS if arm == "hsp"
                                             else 0),
                  f"{tag} {arm}: replica checks {run['checks']}")
            say(f"[{tag}] {arm} rank {r['rank']} {r['coords']}: exchange "
                f"bytes {got} (peers "
                f"{ {k: v['peers'] for k, v in run['stats'].items()} }); "
                f"{_split_line(run['split'], first=1)}")
        losses = [r[arm]["algorithm1"]["losses"] for r in res]
        check(all(x == losses[0] for x in losses),
              f"{tag} {arm}: the ranks report different losses")
        totals[arm] = {k: sum(r[arm]["algorithm1"]["stats"].get(k, {})
                              .get("bytes", 0) for r in res)
                       for k in ("lookup_ids", "lookup_rows", "neg_ids",
                                 "neg_rows", "grad_group", "grad_replicas",
                                 "dense")}
    for r in res:
        by_lo = [q for q in res if q["hsp"]["lo"] == r["hsp"]["lo"]]
        check(len(by_lo) == 2 and by_lo[0]["hsp"]["algorithm1"]["checksums"]
              == by_lo[1]["hsp"]["algorithm1"]["checksums"],
              f"{tag}: the data replicas of shard {r['hsp']['lo']} differ")
    look = {a: totals[a]["lookup_ids"] + totals[a]["lookup_rows"]
            for a in totals}
    check(look["hsp"] < look["global"], f"{tag}: HSP's lookup exchange "
          f"sent {look['hsp']} bytes, global sharding {look['global']}")
    say(f"[{tag}] bytes summed over the 4 ranks, {MESH_STEPS} steps: "
        f"{totals}; lookup exchange HSP {look['hsp']} < global "
        f"{look['global']} (ratio {look['hsp'] / look['global']:.3f}; "
        f"uniform ids would give (I-1)/I / (N-1)/N = 0.667)")
    say(f"[{tag}] checks: every rank's bytes equal the counts its batches "
        f"give, both arms; the data replicas of each shard and their "
        f"AdaGrad states equal at each of {MESH_STEPS} steps (row "
        f"checksums) and at the end (checksums of every state tensor); "
        f"a world of one bit for bit the single-process engine")
    try:
        share = _check_mesh_sharing(res, cfg, V, batches, tag, sample,
                                    share_dir)
    finally:
        import shutil
        shutil.rmtree(share_dir, ignore_errors=True)
    return dict(ranks=res, totals=totals, world1=w1[0], share=share)


def _first_step_state(state, ids, lo, hi, dense):
    """After a run's first step: the τ=1 carry's rows (that step's summed
    table grads) at the global ``ids`` in [lo, hi), whether each id has
    one, and with ``dense`` the AdamW first moments (0.1 x the step's
    dense grads, keys ``mu/<name>``), as numpy arrays."""
    import numpy as np
    import torch
    rows, dev = state.pending_rows, state.pending_rows.device
    mine = ids[(ids >= lo) & (ids < hi)]
    pid = state.pending_ids.long()
    pid = pid[pid >= 0]
    pos = torch.full((hi - lo,), -1, dtype=torch.long, device=dev)
    pos[pid] = torch.arange(pid.numel(), device=dev)
    at = pos[torch.from_numpy(mine - lo).long().to(dev)]
    out = dict(ids=mine, present=(at >= 0).cpu().numpy(),
               rows=rows[at.clamp_min(0)].float().cpu().numpy())
    if dense:
        out.update({f"mu/{n}": v.float().cpu().numpy()
                    for n, v in state.dense_opt.mu.items()})
    return out


def _share_sample_ids(batch, V, world, cap, seg):
    """Two samples of SHARE_SAMPLE table rows, neither an input nor a
    label of ``batch`` (whose grads pass through the bf16 dense
    backward): ``moved``, negatives of the tokens of the segments that
    straddle two ranks' packs at ``seg``, whose table grads the moved
    tokens' logits feed; ``control``, negatives of segment 0's tokens and
    of no straddling segment's."""
    import numpy as np
    R = batch["neg_ids"].shape[-1]
    neg = np.clip(np.asarray(batch["neg_ids"]).reshape(-1, R), 0, V - 1)
    skip = np.union1d(np.asarray(batch["ids"]).reshape(-1),
                      np.asarray(batch["labels"]).reshape(-1))
    n_tok = world * cap
    straddle = [s for s in range(-(-n_tok // seg))
                if (s * seg) // cap != (min((s + 1) * seg, n_tok) - 1) // cap]
    moved = np.unique(np.concatenate(
        [neg[s * seg:min((s + 1) * seg, n_tok)] for s in straddle]))
    moved = np.setdiff1d(moved, skip)
    control = np.setdiff1d(np.setdiff1d(np.unique(neg[:seg]), moved), skip)
    rng = np.random.default_rng(SEED)
    return {k: np.sort(rng.choice(v, min(SHARE_SAMPLE, v.size),
                                  replace=False)).astype(np.int64)
            for k, v in (("moved", moved), ("control", control))}


def _compare_first_step(single, ranks, sample):
    """The 4 ranks' first-step state (``ranks``: per rank, its .npz, one
    rank of each shard first) against the single process's (``single``:
    the same keys over the whole table): the dense first moments' largest
    difference over each leaf's largest and their sign flips (an element
    whose first AdamW step, ≈ lr·sign(g), goes the other way); per sample
    set, whether the same rows have a carry, its rows' largest difference
    over their largest and their sign flips (each a first AdaGrad step the
    other way)."""
    import numpy as np
    mu_r = {k[3:]: v for k, v in ranks[0].items() if k.startswith("mu/")}
    rel, flips, n = 0.0, 0, 0
    for name, b in single["mu"].items():
        a = mu_r[name]
        rel = max(rel, float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                       1e-30)))
        flips += int((a * b < 0).sum())
        n += b.size
    out = dict(dense_rel=rel, dense_flips=flips, dense_elems=n)
    seen, ids, present, rows = set(), [], [], []
    for z in ranks:
        key = (int(z["ids"][0]) if z["ids"].size else -1, z["ids"].size)
        if key in seen:
            continue                    # the other replica of a shard
        seen.add(key)
        ids.append(z["ids"])
        present.append(z["present"])
        rows.append(z["rows"])
    ids, present, rows = (np.concatenate(x) for x in (ids, present, rows))
    order = np.argsort(ids, kind="stable")
    ids, present, rows = ids[order], present[order], rows[order]
    check(np.array_equal(ids, single["ids"]), "sharing: the ranks' sampled "
          "ids are not the single process's")
    for k, want in sample.items():
        sel = np.isin(ids, want)
        p_r, p_s = present[sel], single["present"][sel]
        a, b = rows[sel][p_s], single["rows"][sel][p_s]
        out[k] = dict(rows=int(sel.sum()), with_carry=int(p_s.sum()),
                      same_carry=bool(np.array_equal(p_r, p_s)),
                      rel=float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                          1e-30))
                      if b.size else 0.0,
                      flips=int((a * b < 0).sum()), elems=int(b.size))
    return out


def _single_share(cfg, V, batches, seg, steps, sample=None):
    """The single-process engine over the 4 packs of phase hsp_mesh's
    global batches at expansion 2 and segment ``seg``: its losses, and
    with ``sample`` (global ids) its state after the first step at them
    (:func:`_first_step_state`, the moments as ``mu``)."""
    import torch
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import GREngine
    eng = GREngine(GRBundle(cfg), lambda i: batches[i], seed=SEED,
                   device=torch.device("cuda"), loss_kwargs=dict(
                       expansion=SHARE_EXPANSION, neg_segment=seg))
    first, held = {}, [0.0]
    if sample is not None:
        def on_step(i, rec, st):
            if i == 0:
                t = time.perf_counter()
                z = _first_step_state(st, sample, 0, V, dense=True)
                first.update(ids=z["ids"], present=z["present"],
                             rows=z["rows"], mu={k[3:]: v for k, v in
                                                 z.items()
                                                 if k.startswith("mu/")})
                held[0] += time.perf_counter() - t
        eng.step_callback = on_step
    t0 = time.perf_counter()
    losses = [r["loss"] for r in eng.run(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - held[0]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return losses, wall, first


def _check_mesh_sharing(res, cfg, V, batches, tag, sample, share_dir):
    """Logit sharing across the 4 ranks of phase hsp_mesh: at each segment
    every rank reports the same losses, within HSP_LOSS_TOL of the single
    process over the same 4 packs (run here); after the first step the
    same table rows have a carry as in the single process, and the carry
    at the rows the moved tokens' logits feed (``sample``) and the dense
    first moments lie within SHARE_GRAD_TOL of the single process's; K3
    and K4 once a step on each rank (each owns segments: a pack is longer
    than a segment), the other launches a step's; the share_* and every
    other exchange's bytes the counts the layout and the batches give
    (share_* 0 when the pack is a segment multiple); the data replicas of
    each shard and the shadow equal."""
    import numpy as np
    from repro_torch.kernels.neg_logits import share_layout
    ids = np.load(os.path.join(share_dir, "ids.npy"))
    out = {}
    want = _rank_launch_want(cfg, SHARE_STEPS, runsum=2)
    for seg in SHARE_SEGMENTS:
        key = str(seg)
        exp = _expected_bytes(batches[:SHARE_STEPS], V, (2, 2), "hsp",
                              cfg.d_model, share_segment=seg)
        runs = [r["share"][key] for r in res]
        for r, run in zip(res, runs):
            check(run["launches"] == want, f"{tag} sharing segment {seg} "
                  f"rank {r['rank']}: launches {run['launches']}, expected "
                  f"{want}")
            check(run["shadow_bad"] == 0, f"{tag}: shadow != master.half()")
            got = {k: run["stats"].get(k, {}).get("bytes", 0)
                   for k in exp[r["rank"]]}
            check(got == exp[r["rank"]], f"{tag} sharing segment {seg} rank "
                  f"{r['rank']}: exchange bytes {got}, from the batches "
                  f"{exp[r['rank']]}")
            check(run["losses"] == runs[0]["losses"], f"{tag} sharing: the "
                  f"ranks report different losses")
            check(run["checks"]["dense"] == SHARE_STEPS and
                  run["checks"]["table"] == SHARE_STEPS,
                  f"{tag} sharing: replica checks {run['checks']}")
        for r, run in zip(res, runs):
            twin = [q["share"][key] for q in res
                    if q["hsp"]["lo"] == r["hsp"]["lo"]]
            check(len(twin) == 2 and twin[0]["checksums"]
                  == twin[1]["checksums"], f"{tag} sharing: the data "
                  f"replicas of shard {r['hsp']['lo']} differ")
        single, wall, first = _single_share(cfg, V, batches, seg,
                                            SHARE_STEPS, sample=ids)
        dl = float(np.max(np.abs(np.array(runs[0]["losses"]) - single)))
        grads = _compare_first_step(
            first, [dict(np.load(os.path.join(share_dir,
                                              f"r{q}_s{seg}.npz")))
                    for q in range(4)], sample)
        lays = [share_layout(4, q, 2048, seg) for q in range(4)]
        say(f"[{tag}] sharing, expansion {SHARE_EXPANSION}, segment {seg}: "
            f"losses {runs[0]['losses']} on every rank, single process over "
            f"the same 4 packs {single} ({wall:.2f} s): max |diff| "
            f"{dl:.3g} (limit {HSP_LOSS_TOL}); segments owned "
            f"{[(x.seg_lo, x.seg_hi) for x in lays]}, tokens sent "
            f"{[x.keep for x in lays]} and borrowed "
            f"{[x.borrow for x in lays]} a rank; share bytes "
            f"{[{k: run['stats'].get(k, {}).get('bytes', 0) for k in ('share_tokens', 'share_grads')} for run in runs]}, "
            f"ms a step {[{k: round(1e3 * run['stats'][k]['seconds'] / SHARE_STEPS, 2) for k in ('share_tokens', 'share_grads') if k in run['stats']} for run in runs]}; "
            f"launches a rank {runs[0]['launches']}; walls (time-shared) "
            f"{[[round(w * 1e3, 1) for w in run['walls_s']] for run in runs]} ms")
        say(f"[{tag}] sharing, segment {seg}, after the first step against "
            f"the single process: dense first moments largest difference "
            f"{grads['dense_rel']:.3g} of a leaf's largest, sign flips "
            f"{grads['dense_flips']} of {grads['dense_elems']}; table grads "
            f"(the carry) at "
            + "; ".join(f"{k} rows ({g['rows']} sampled, {g['with_carry']} "
                        f"with a carry, the same rows as the single process "
                        f"{g['same_carry']}): largest difference "
                        f"{g['rel']:.3g} of their largest, sign flips "
                        f"{g['flips']} of {g['elems']}"
                        for k, g in grads.items() if isinstance(g, dict))
            + f" (limits {SHARE_GRAD_TOL})")
        check(dl <= HSP_LOSS_TOL, f"{tag} sharing segment {seg}: losses "
              f"{dl:.3g} from the single process, limit {HSP_LOSS_TOL}")
        for k in ("moved", "control"):
            check(grads[k]["same_carry"] and grads[k]["with_carry"] > 0,
                  f"{tag} sharing segment {seg}: the {k} rows with a carry "
                  f"differ from the single process's")
            check(grads[k]["rel"] <= SHARE_GRAD_TOL["table"],
                  f"{tag} sharing segment {seg}: {k} rows' first table "
                  f"grads {grads[k]['rel']:.3g} from the single process's, "
                  f"limit {SHARE_GRAD_TOL['table']}")
        check(grads["dense_rel"] <= SHARE_GRAD_TOL["dense"],
              f"{tag} sharing segment {seg}: dense first moments "
              f"{grads['dense_rel']:.3g} from the single process's, limit "
              f"{SHARE_GRAD_TOL['dense']}")
        out[key] = dict(losses=runs[0]["losses"], single=single,
                        loss_diff=dl, single_wall_s=wall, first_step=grads,
                        share=[{k: run["stats"].get(k) for k in (
                            "share_tokens", "share_grads")} for run in runs],
                        walls_s=[run["walls_s"] for run in runs])
    say(f"[{tag}] sharing checks: at segments {list(SHARE_SEGMENTS)} the 4 "
        f"ranks' losses within {HSP_LOSS_TOL} of the single process, the "
        f"data replicas and the shadow equal, K3 and K4 once a step on each "
        f"rank, every exchange's bytes (share_* too) the layout's and the "
        f"batches' counts; a world of one bit for bit the single process")
    return out


def phase_elastic():
    """The hsp_mesh configuration (its vocab cut to ELASTIC_V, so the
    checkpoints fit the disk) under the elastic supervisor: 4 ranks, 2 of
    which exit when step 5 begins, restarted on 1 x 2 from the step-3
    checkpoint to step 8; against the run that shrank from 4 ranks to 2 at
    step 3 with no fault. The checkpoints go to the temp dir and are
    removed."""
    import shutil
    import tempfile
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.elastic import ElasticRunner
    tag = "elastic"
    root = tempfile.mkdtemp(prefix="elastic_")
    build = dict(arch="hstu-large",
                 overrides=dict(num_layers=MESH_LAYERS,
                                vocab_size=ELASTIC_V),
                 data=dict(users=64, mean_len=1800, sigma_len=0.6,
                           max_len=4096, users_per_device=1,
                           max_seq_len=2048, seed=SEED), seed=SEED)
    runs = {}
    try:
        for name in ("crash", "clean"):
            d = os.path.join(root, name)
            r = ElasticRunner("repro_torch.training.elastic:build_gr_engine",
                              d, build_kwargs=build, model_parallel=2,
                              ckpt_every=ELASTIC_EVERY, keep_last_n=1,
                              device="cuda", mesh_timeout_s=HSP_TIMEOUT_S,
                              segment_deadline_s=600,
                              run_dir=os.path.join(root, name + "_ranks"))
            t0 = time.perf_counter()
            if name == "crash":
                r.run(ELASTIC_STEPS, world=4, fail_at=dict(ELASTIC_FAIL))
            else:
                r.run(ELASTIC_EVERY, world=4)
                r.run(ELASTIC_STEPS, world=2)
            wall = time.perf_counter() - t0
            step_dir = os.path.join(d, f"step_{ELASTIC_STEPS}")
            m = CKPT.read_manifest(step_dir)
            ckpt_gb = sum(os.path.getsize(os.path.join(step_dir, f))
                          for f in os.listdir(step_dir)) / 1e9
            runs[name] = dict(events=r.events, segments=[
                {k: v for k, v in s.items() if k != "results"}
                for s in r.segments], losses=[x["loss"] for x in r.records],
                worlds=[x["world"] for x in r.records], crc32s=m["crc32s"],
                wall_s=wall, ckpt_gb=ckpt_gb)
            for s in r.segments:
                r0 = s["results"][0] or {}
                say(f"[{tag}] {name}: segment from step {s['start']} on "
                    f"{s['world']} ranks {s['shape']}, exit codes "
                    f"{s['rcs']}, {s['wall_s']:.1f} s (rank 0: engine "
                    f"built in {r0.get('build_s', float('nan')):.1f} s, "
                    f"restore {r0.get('restore_s', float('nan')):.1f} s, "
                    f"run {r0.get('run_s', float('nan')):.1f} s, saves "
                    f"(step, s) {[x[:2] for x in r0.get('saves', [])]})")
            say(f"[{tag}] {name}: losses {[round(x, 5) for x in runs[name]['losses']]}; "
                f"worlds {runs[name]['worlds']}; events {r.events}; "
                f"{wall:.1f} s")
            if name == "crash":
                seg1, seg2 = r.segments
                first = min(x["t"] for x in r.records
                            if x["world"] == 2)
                runs[name]["restart_wall_s"] = first - seg1["ended"]
                runs[name]["seg2"] = seg2["results"][0]
            shutil.rmtree(d, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    c, k = runs["crash"], runs["clean"]
    check(c["events"] == [("node_failure", 5), ("recovery", ELASTIC_EVERY)],
          f"{tag}: events {c['events']}")
    check(c["losses"] == k["losses"] and c["crc32s"] == k["crc32s"],
          f"{tag}: the recovered run differs from the uninterrupted one")
    say(f"[{tag}] restart wall (the failed segment's end to the first step "
        f"of the new world) {c['restart_wall_s']:.1f} s, of which the new "
        f"ranks' engine build {c['seg2']['build_s']:.1f} s and restore "
        f"{c['seg2']['restore_s']:.1f} s; the recovered run "
        f"equals the uninterrupted run with the same world sequence bit for "
        f"bit: {len(c['losses'])} losses and the CRC32s of the step-"
        f"{ELASTIC_STEPS} checkpoint's {len(c['crc32s'])} leaves; "
        f"checkpoints of {c['ckpt_gb']:.2f} GB in the temp dir")
    return runs


# --------------------------------------------------------------------------
# phase 6f: the LM zoo
# --------------------------------------------------------------------------

# Phase lm's time budget (s); the seconds freed elsewhere must cover it.
LM_BUDGET_S = 90.0
# Tokens a sequence in the prefill/decode checks, and the greedy steps.
LM_PROMPT = 4096
LM_STEPS = 8
# The decode check, bf16 at full depth: each greedy step's logits against
# a forward over the same tokens (the reference's check,
# tests/test_models.py:42-78, which holds fp32 at 1e-4). The two bf16
# paths round in other places (GEMMs of B rows against B·S rows pick other
# kernels and split-K orders; the attention reads the cache in blocks of
# another size; Mamba's recurrence against its chunked scan), and how far
# such roundings carry through L random layers is not a constant: it is
# measured. The same forward with the weights widened to fp32 is the
# witness: its distance from the bf16 forward is bf16's own error on these
# tokens (the floor). Each bf16 path lies within its error of the fp32
# forward; the decode path's is allowed twice the forward's, so the two
# may differ by LM_DECODE_FLOORS = 3 floors. bf16 logits tie at the top
# (an 8-bit mantissa over 49152 values; the first CPU rehearsal met a gap
# of 0), and a tie has no argmax to agree on: there the decode's pick
# must be tied with the forward's within the same limit, in the forward's
# logits, and the count of such steps is printed.
LM_DECODE_FLOORS = 3
# (sequences, tokens each, microbatches) of each train run; the prefill_32k
# length; the decode_32k batch and cache; long_500k's length; the tokens
# of the one-layer runs.
LM_TRAIN = {"starcoder2-3b": (8, 4096, 8), "mamba2-2.7b": (4, 4096, 1),
            "olmoe-1b-7b": (4, 4096, 4)}
LM_PREFILL_LONG = 32768
LM_DECODE_BATCH, LM_DECODE_CACHE = 16, 32768
LM_LONG = 524288
LM_ONE_LAYER_TOKENS = 2048
# The configs run at full width with the depth cut to one layer.
LM_ONE_LAYER = ("glm4-9b", "internlm2-20b", "command-r-35b",
                "deepseek-moe-16b", "pixtral-12b", "musicgen-large")


def _lm_batch(cfg, B, S, gen, dev):
    """A fixed random batch: tokens (or stub embeds) and next-token
    labels."""
    import torch
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"labels": toks[:, 1:].contiguous()}
    if cfg.frontend == "stub_embed":
        batch["embeds"] = torch.randn(B, S, cfg.d_model, generator=gen,
                                      device=dev, dtype=torch.bfloat16)
    else:
        batch["tokens"] = toks[:, :S].contiguous()
    return batch


def _lm_train(bundle, model, batch, n_mb, steps, tag):
    """``steps`` steps of make_lm_train_step on one fixed batch: losses,
    walls, peak memory above the start, tokens/s and the measured MFU (6 ×
    count_params × tokens over the wall, against the card's cited bf16
    peak). The moments are freed at the end."""
    import torch
    from repro_torch.configs import count_params
    from repro_torch.training import lm_train_state, make_lm_train_step
    cfg = bundle.cfg
    st = lm_train_state(model)
    step = make_lm_train_step(lambda m, b: bundle.loss(m, b),
                              num_microbatches=n_mb)
    tokens = batch["labels"].numel()
    n_params = count_params(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(steps):
        t = time.perf_counter()
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        mfu = 6 * n_params * tokens / walls[-1] / PEAK_FLOPS["bfloat16"]
        say(f"[{tag}] train step {i}: loss {losses[-1]:.5f}; wall "
            f"{walls[-1]:.3f} s; {tokens / walls[-1]:.0f} tokens/s; "
            f"measured MFU {mfu:.4f} (6 x {n_params / 1e9:.3f} B params x "
            f"{tokens} tokens / wall, against "
            f"{PEAK_FLOPS['bfloat16'] / 1e12:.1f} TFLOP/s bf16)")
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(all(math.isfinite(x) for x in losses),
          f"{tag}: train losses {losses}")
    steady = walls[1:] or walls
    wall = sum(steady) / len(steady)
    out = dict(losses=losses, walls_s=walls, tokens=tokens,
               microbatches=n_mb, params=n_params,
               peak_above_start_gb=peak, state_gb=base / 1e9,
               tokens_per_s=tokens / wall,
               mfu=6 * n_params * tokens / wall / PEAK_FLOPS["bfloat16"])
    say(f"[{tag}] train: {steps} steps of {batch['labels'].shape[0]} x "
        f"{batch['labels'].shape[1]} tokens as {n_mb} microbatch"
        f"{'es' if n_mb > 1 else ''}; losses "
        f"{[round(x, 5) for x in losses]}; steps 1.. {wall:.3f} s, "
        f"{out['tokens_per_s']:.0f} tokens/s, measured MFU {out['mfu']:.4f};"
        f" peak {peak:.2f} GB above the {base / 1e9:.2f} GB held before "
        f"the steps (params and AdamW moments; the fp32 accumulators "
        f"within the peak)")
    del st
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _lm_decode_check(bundle, model, prompt, tag):
    """Prefill ``prompt`` (B, S), take LM_STEPS greedy decode steps, then
    run one forward over the prompt and the generated tokens and hold each
    step's logits to that forward's at the same position (LM_DECODE_FLOORS,
    the same argmax)."""
    import torch
    from repro_torch.models import transformer as TF
    cfg = bundle.cfg
    B, S = prompt.shape
    n = LM_STEPS
    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = bundle.prefill(model, {"tokens": prompt},
                                       max_len=S + n)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        toks, got = [logits[:, -1].argmax(-1)], []
        t = time.perf_counter()
        for i in range(n):
            lg, cache = bundle.decode(model, toks[-1][:, None].int(), cache,
                                      S + i)
            got.append(lg[:, -1].float())
            toks.append(lg[:, -1].argmax(-1))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
        del cache
        t = time.perf_counter()
        full = torch.cat([prompt, torch.stack(toks[:n], 1).int()], 1)
        x = TF._inputs(model, cfg, {"tokens": full})
        pos = torch.arange(S + n, dtype=torch.int32,
                           device=x.device)[None].repeat(B, 1)
        hidden, _ = TF.lm_hidden(model, cfg, x, pos, remat=False)
        want = TF.lm_logits(model, cfg, hidden[:, S:S + n]).float()
        del hidden, x
        # bf16's own error on these tokens: the forward in fp32
        m32 = copy.deepcopy(model).float()
        x = TF._inputs(m32, cfg, {"tokens": full})
        hidden, _ = TF.lm_hidden(m32, cfg, x, pos, remat=False)
        want32 = TF.lm_logits(m32, cfg, hidden[:, S:S + n]).float()
        del hidden, x, m32
        _lm_free()
        forwards_s = time.perf_counter() - t
    got = torch.stack(got, 1)
    diff = float((got - want).abs().max())
    floor = float((want - want32).abs().max())
    off32 = float((got - want32).abs().max())
    scale = float(want.abs().max())
    tol = LM_DECODE_FLOORS * floor
    pick, best = got.argmax(-1), want.argmax(-1)
    exact = pick == best
    behind = want.max(-1).values - want.gather(-1, pick[..., None])[..., 0]
    agree = bool((exact | (behind <= tol)).all())
    ties = int((~exact).sum())
    top2 = want.topk(2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).min())
    say(f"[{tag}] prefill {B} x {S} tokens {prefill_s:.3f} s, then {n} "
        f"greedy decode steps {decode_s / n * 1e3:.2f} ms each; each "
        f"step's logits against a forward over the same {S + n} tokens: "
        f"max |diff| {diff:.5f}, limit {tol:.5f} ({LM_DECODE_FLOORS} x the "
        f"bf16 forward's distance {floor:.5f} from the fp32 forward; the "
        f"decode's own {off32:.5f}; largest |logit| {scale:.4f}); argmax "
        f"agrees "
        f"{agree}: {B * n - ties} of {B * n} steps the same token, {ties} "
        f"tied within the limit (smallest top-2 gap of the forward "
        f"{gap:.5f}); the bf16 and fp32 forwards {forwards_s:.2f} s")
    check(math.isfinite(diff) and diff <= tol and agree,
          f"{tag}: decode against the forward: max |diff| {diff} (limit "
          f"{tol}), argmax agrees {agree}")
    return dict(prefill_s=prefill_s, decode_ms=decode_s / n * 1e3,
                max_diff=diff, max_logit=scale, limit=tol, floor=floor,
                decode_from_fp32=off32, forwards_s=forwards_s,
                argmax_agrees=agree, ties=ties, min_top2_gap=gap)


def _lm_free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _lm_starcoder(gen, dev):
    """starcoder2-3b at full width and depth: train, the decode check, a
    prefill_32k prefill and decode_32k decode steps."""
    import torch
    from repro_torch.configs import count_params, get_arch
    from repro_torch.models.model_zoo import get_bundle
    tag = "lm starcoder2"
    cfg = get_arch("starcoder2-3b")
    bundle = get_bundle(cfg)
    t = time.perf_counter()
    model = bundle.init(gen, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    biases = sum(p.numel() for k, p in model.named_parameters()
                 if k.rsplit(".", 1)[-1] in ("bq", "bk", "bv", "bo", "b_in",
                                             "b_out"))
    say(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}, tied, biases, GELU (not cut):"
        f" {n / 1e9:.4f} B params ({count_params(cfg) / 1e9:.4f} B by "
        f"count_params, which leaves out the {biases} biases), drawn in "
        f"{time.perf_counter() - t:.2f} s")
    # count_params, the reference's analytic count, leaves out the biases
    check(n - biases == count_params(cfg), f"{tag}: {n} params, "
          f"{biases} of them biases, count_params {count_params(cfg)}")
    out = {}
    B, S, mb = LM_TRAIN[cfg.name]
    batch = _lm_batch(cfg, B, S, gen, dev)
    out["train"] = _lm_train(bundle, model, batch, mb, 3, tag)
    losses = out["train"]["losses"]
    check(losses[2] < losses[0], f"{tag}: the loss of step 3 {losses[2]} "
          f"is not below step 1's {losses[0]}")
    del batch
    prompt = torch.randint(0, cfg.vocab_size, (2, LM_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    out["decode_check"] = _lm_decode_check(bundle, model, prompt, tag)
    # prefill_32k: one sequence of 32768 tokens (its batch of 32 cut to 1)
    L = LM_PREFILL_LONG
    long = torch.randint(0, cfg.vocab_size, (1, L), generator=gen,
                         device=dev, dtype=torch.int32)
    _lm_free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    logits, cache = bundle.prefill(model, {"tokens": long})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(bool(torch.isfinite(logits).all()), f"{tag}: prefill_32k logits")
    out["prefill_32k"] = dict(s=wall, tokens_per_s=L / wall,
                              peak_above_params_gb=peak)
    say(f"[{tag}] prefill_32k (batch 32 cut to 1): 1 x {L} tokens in "
        f"{wall:.3f} s ({L / wall:.0f} tokens/s), peak {peak:.2f} GB "
        f"above the params (its cache "
        f"{sum(k.numel() * 2 * k.element_size() for k, _ in cache.kv.values()) / 1e9:.2f} GB)")
    del logits, cache, long
    _lm_free()
    # decode_32k: 16 sequences (its batch of 128 cut to 16) against a
    # cache of 32768 positions, filled with random K/V
    Bd, C = LM_DECODE_BATCH, LM_DECODE_CACHE
    cache = bundle.init_cache(Bd, C, device=dev)
    for k, v in cache.kv.values():
        k.normal_(generator=gen)
        v.normal_(generator=gen)
    cache_gb = sum(k.numel() * 2 * k.element_size()
                   for k, _ in cache.kv.values()) / 1e9
    tok = torch.randint(0, cfg.vocab_size, (Bd, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    bundle.decode(model, tok, cache, C - 17)             # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(16):
        lg, cache = bundle.decode(model, tok, cache, C - 16 + i)
        tok = lg[:, -1].argmax(-1)[:, None].int()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / 16 * 1e3
    check(bool(torch.isfinite(lg).all()), f"{tag}: decode_32k logits")
    out["decode_32k"] = dict(ms_per_step=ms, batch=Bd,
                             tokens_per_s=Bd / ms * 1e3, cache_gb=cache_gb)
    say(f"[{tag}] decode_32k (batch 128 cut to {Bd}): 16 steps at "
        f"positions {C - 16}.. against a {cache_gb:.2f} GB cache of {C} "
        f"positions: {ms:.2f} ms a step ({Bd / ms * 1e3:.0f} tokens/s, "
        f"batch {Bd})")
    del cache, lg, tok, model
    _lm_free()
    return out


def _lm_mamba(gen, dev):
    """mamba2-2.7b at full width and depth: train 3 steps on 4 x 4096, the
    decode check, decode steps at long_500k's batch of 1."""
    import torch
    from repro_torch.configs import count_params, get_arch
    from repro_torch.models.model_zoo import get_bundle
    tag = "lm mamba2"
    cfg = get_arch("mamba2-2.7b")
    bundle = get_bundle(cfg)
    model = bundle.init(gen, device=dev)
    n = sum(p.numel() for p in model.parameters())
    say(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"d_state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk} (not cut): "
        f"{n / 1e9:.3f} B params ({count_params(cfg) / 1e9:.3f} B by "
        f"count_params)")
    B, S, mb = LM_TRAIN[cfg.name]
    out = {"train": _lm_train(bundle, model, _lm_batch(cfg, B, S, gen, dev),
                              mb, 3, tag)}
    prompt = torch.randint(0, cfg.vocab_size, (2, LM_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    out["decode_check"] = _lm_decode_check(bundle, model, prompt, tag)
    # long_500k: batch 1, a decode step at position 524288 - 16 + i; the
    # state holds no KV (a zero state: the step's work does not depend on
    # the position)
    cache = bundle.init_cache(1, 1, device=dev)
    state_gb = sum(t.numel() * t.element_size() for st in cache.ssm.values()
                   for t in st.values()) / 1e9
    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    bundle.decode(model, tok, cache, LM_LONG - 17)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(16):
        lg, cache = bundle.decode(model, tok, cache, LM_LONG - 16 + i)
        tok = lg[:, -1].argmax(-1)[:, None].int()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / 16 * 1e3
    check(bool(torch.isfinite(lg).all()), f"{tag}: long_500k logits")
    out["long_500k"] = dict(ms_per_step=ms, state_gb=state_gb)
    say(f"[{tag}] long_500k (batch 1): 16 decode steps at positions "
        f"{LM_LONG - 16}..: {ms:.2f} ms a step; the state "
        f"{state_gb * 1e3:.1f} MB "
        f"(no KV)")
    del cache, lg, model
    _lm_free()
    return out


def _lm_olmoe(gen, dev):
    """olmoe-1b-7b at full width: the decode check at full depth with the
    reference test's capacity factor 8; 3 train steps with the depth cut
    to 4 layers, and the share of slots dropped at capacity factor 1.25."""
    import dataclasses
    import torch
    from repro_torch.configs import count_params, get_arch
    from repro_torch.models import moe as E
    from repro_torch.models.model_zoo import get_bundle
    tag = "lm olmoe"
    full = get_arch("olmoe-1b-7b")
    cfg = full.replace(moe=dataclasses.replace(full.moe,
                                               capacity_factor=8.0))
    bundle = get_bundle(cfg)
    model = bundle.init(gen, device=dev)
    say(f"[{tag}] {cfg.name}: {cfg.num_layers} layers (not cut), d "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}, d_expert {cfg.moe.d_expert}: "
        f"{count_params(cfg) / 1e9:.3f} B params "
        f"({count_params(cfg) * 2 / 1e9:.1f} GB bf16), "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B held; "
        f"serving at capacity factor 8 (the reference test's: no drops)")
    prompt = torch.randint(0, cfg.vocab_size, (2, LM_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    out = {"decode_check": _lm_decode_check(bundle, model, prompt, tag)}
    del model
    _lm_free()
    cut = full.replace(num_layers=4)
    bundle = get_bundle(cut)
    model = bundle.init(gen, device=dev)
    B, S, mb = LM_TRAIN[full.name]
    batch = _lm_batch(cut, B, S, gen, dev)
    with torch.no_grad(), E.dispatch_stats() as ds:
        bundle.loss(model, {k: v[:1] for k, v in batch.items()})
    say(f"[{tag}] train cut to 4 of 16 layers ({count_params(cut) / 1e9:.3f}"
        f" B params; 16 layers would hold ~16 B of params and moments a "
        f"parameter, ~110 GB), capacity factor "
        f"{cut.moe.capacity_factor}: a {S}-token sequence dispatches "
        f"{ds.slots} slots over its 4 layers, {ds.dropped} dropped "
        f"({ds.drop_share:.4f})")
    out["train"] = _lm_train(bundle, model, batch, mb, 3, tag)
    out["train"]["drop_share"] = ds.drop_share
    del model, batch
    _lm_free()
    return out


def _lm_one_layer(gen, dev):
    """The other configs at full width with the depth cut to one layer (one
    forward and backward at 1 x 2048: the loss and every gradient finite);
    jamba at reduced()."""
    import torch
    from repro_torch.configs import count_params, get_arch, reduced
    from repro_torch.models.model_zoo import get_bundle
    out = {}
    jamba = get_arch("jamba-1.5-large-398b")
    period = jamba.replace(num_layers=jamba.attn_every)
    say(f"[lm one-layer] jamba-1.5-large-398b runs at reduced(): one "
        f"hybrid period of {period.num_layers} layers at d "
        f"{jamba.d_model} holds {count_params(period) / 1e9:.1f} B params "
        f"by count_params, {count_params(period) * 2 / 1e9:.1f} GB in bf16")
    for name in LM_ONE_LAYER + ("jamba-1.5-large-398b",):
        cfg = (reduced(get_arch(name)) if name == "jamba-1.5-large-398b"
               else get_arch(name).replace(num_layers=1))
        bundle = get_bundle(cfg)
        t = time.perf_counter()
        model = bundle.init(gen, device=dev)
        batch = _lm_batch(cfg, 1, LM_ONE_LAYER_TOKENS, gen, dev)
        torch.cuda.reset_peak_memory_stats()
        loss = bundle.loss(model, batch)
        named = list(model.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        unused = [n for (n, _), g in zip(named, grads) if g is None]
        bad = [n for (n, _), g in zip(named, grads)
               if g is not None and not bool(torch.isfinite(g).all())]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        lv = float(loss.detach())
        peak = torch.cuda.max_memory_allocated() / 1e9
        say(f"[lm one-layer] {cfg.name}: {cfg.num_layers} layer(s), d "
            f"{cfg.d_model}, {count_params(cfg) / 1e9:.3f} B params, "
            f"{cfg.frontend}; 1 x {LM_ONE_LAYER_TOKENS} tokens forward + "
            f"backward: loss "
            f"{lv:.5f}, {len(named) - len(unused)} grads finite "
            f"{not bad}{f', unused {unused}' if unused else ''}; "
            f"{wall:.2f} s with the draw; peak {peak:.2f} GB")
        check(math.isfinite(lv) and not bad,
              f"{cfg.name}: loss {lv}, non-finite grads {bad}")
        check(unused == ([] if cfg.frontend == "token" else ["embed"]),
              f"{cfg.name}: no grad for {unused}")
        out[name] = dict(loss=lv, params=count_params(cfg), s=wall,
                         peak_gb=peak, unused=unused)
        del model, batch, loss, grads, named
        _lm_free()
    return out


def phase_lm():
    """The LM zoo on the card, bf16, device="cuda", random weights from
    SEED: starcoder2-3b at full width and depth (3 train steps on one batch
    of 8 x 4096 tokens as 8 microbatches; the prefill/decode check on 2 x
    4096 and 8 greedy steps; one prefill of 1 x 32768; 16 decode steps at
    batch 16 against a cache of 32768 positions); mamba2-2.7b at full width
    and depth (3 train steps on 4 x 4096; the check; decode at batch 1);
    olmoe-1b-7b at full width (the check at full depth, capacity factor 8;
    3 train steps cut to 4 layers); the other configs one layer deep at
    full width (jamba at reduced()). The fp32 products run with TF32 off."""
    import torch
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the LM's fp32 products need TF32 off")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    t0 = time.perf_counter()
    out = {"starcoder2-3b": _lm_starcoder(gen, dev),
           "mamba2-2.7b": _lm_mamba(gen, dev),
           "olmoe-1b-7b": _lm_olmoe(gen, dev),
           "one_layer": _lm_one_layer(gen, dev)}
    out["s"] = time.perf_counter() - t0
    say(f"[lm] phase lm {out['s']:.1f} s (budget {LM_BUDGET_S:.0f} s) on "
        f"{CARD.get('smi_line')}")
    out["card"] = CARD.get("smi_line")
    return out


# --------------------------------------------------------------------------
# phase 6h: the launch tooling (plans, the meta dry-run, the roofline)
# --------------------------------------------------------------------------

# (a) The production meshes' cells the child process runs on the fake
# backend: (arch, shape, multi_pod).
DRYRUN_CELLS = (("starcoder2-3b", "train_4k", False),
                ("hstu-large", "gr_train_2k", False),
                ("hstu-large", "gr_train_2k", True),
                # one multi-pod LM cell of each family whose heads split
                # over model (dense GQA, MoE, Mamba-2, the hybrid)
                ("glm4-9b", "prefill_32k", True),
                ("olmoe-1b-7b", "train_4k", True),
                ("mamba2-2.7b", "decode_32k", True),
                ("jamba-1.5-large-398b", "prefill_32k", True))
# (b) The world-1 cells held against the card: phase lm's model, one
# microbatch of 1 x 4096 tokens; phase engine's pack, 1 shard x 4 users x
# 2048 events, vocab 2^22, R 128 (the dry-run's segmented negatives).
DRYRUN_LM = ("starcoder2-3b", 1, 4096)
DRYRUN_GR = ("hstu-large", 4, 2048)
# predicted state bytes against torch.cuda.memory_allocated(): within 1%
DRYRUN_STATE_TOL = 0.01
DRYRUN_CHILD_TIMEOUT_S = 900


def _dryrun_summary(rec):
    """The numbers of a dry-run record the phase prints."""
    rl = rec["roofline"]
    out = {k: rec[k] for k in ("arch", "shape", "mesh", "chips",
                               "state_bytes_per_device", "t_build_s",
                               "t_step_s", "num_microbatches")}
    out |= {"flops": rec["totals"]["flops"], "bytes": rec["totals"]["bytes"],
            "coll_bytes": {k: v for k, v in
                           rec["totals"]["coll_bytes"].items() if v},
            "kernel_flops": rec["totals"]["kernel_flops"],
            "dominant": rl["dominant"], "compute_s": rl["compute_s"],
            "memory_s": rl["memory_s"], "collective_s": rl["collective_s"],
            "roofline_frac": rl["roofline_frac"],
            "model_flops": rl["model_flops"]}
    for k in ("pend_spec", "kernels", "worst_case"):
        if k in rec:
            out[k] = rec[k]
    return out


def dryrun_child():
    """Phase dryrun's part (a), in a process of its own on the fake
    backend (a one-process world of 512 ranks): both production meshes,
    the DRYRUN_CELLS on them, and the world-1 cells of part (b), all on
    ``meta``; one JSON result."""
    def body():
        from repro_torch.configs.shapes import ShapeConfig
        from repro_torch.launch import dryrun as DR
        from repro_torch.launch import mesh as M
        t0 = time.perf_counter()
        M.init_fake_world(512)
        meshes = {False: M.make_production_mesh(),
                  True: M.make_production_mesh(multi_pod=True)}
        out = {"meshes": {M.production_mesh_name(mp): {
            "shape": list(m.shape), "axes": list(m.mesh_dim_names),
            "device_type": m.device_type} for mp, m in meshes.items()},
            "cells": {}, "world1": {}}
        for arch, shape, mp in DRYRUN_CELLS:
            rec = DR.run_cell(arch, shape, mp, mesh=meshes[mp])
            summary = _dryrun_summary(rec) | {"ok": rec["ok"]}
            # the state bytes of DTensor's own local shards of the specs
            summary["local_state_bytes"] = DR.local_state_bytes(
                DR.build_cell(arch, shape, mp, mesh=meshes[mp]))
            out["cells"][f"{arch}__{shape}__{rec['mesh']}"] = summary
        one = M.device_mesh((1, 1))
        arch, B, S = DRYRUN_LM
        out["world1"]["lm"] = _dryrun_summary(DR.run_cell(
            arch, "lm_mb", mesh=one, mesh_name="card1x1",
            shape=ShapeConfig(f"lm_mb_{B}x{S}", S, B, "train")))
        arch, users, S = DRYRUN_GR
        out["world1"]["gr"] = _dryrun_summary(DR.run_cell(
            arch, "engine_pack", mesh=one, mesh_name="card1x1",
            shape=ShapeConfig(f"engine_pack_1x{users}x{S}", S, users,
                              "train")))
        out["s"] = time.perf_counter() - t0
        return out
    return _child_main(body)


def _start_child(fn):
    """``chip_smoke.<fn>()`` started in a process of its own; finish it
    with :func:`_finish_child`."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]; import chip_smoke as c; "
            f"sys.exit(c.{fn}())")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish_child(p, tag, timeout):
    """Wait for a :func:`_start_child` process (killed past ``timeout``),
    relay its lines, return its ``[child-result]``."""
    try:
        out, _ = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            out, _ = p.communicate()
    result = None
    for ln in out.splitlines():
        if ln.startswith("[child-result] "):
            result = json.loads(ln[len("[child-result] "):])
        elif not ln.startswith("[rank0]:W"):       # DTensor's advice
            say(ln)
    check(p.returncode == 0 and result is not None,
          f"{tag}: the child process exited {p.returncode}")
    return result


def phase_dryrun(child):
    """The launch tooling on the card. (a) The child's records: both
    production meshes built over a fake world, and per device the state
    bytes, FLOPs, bytes, collective bytes by kind and the dominant term of
    DRYRUN_CELLS. (b) On a one-rank mesh (NCCL at world 1, a (1, 1)
    DeviceMesh): starcoder2-3b at full width and depth as DTensors by the
    plan (partition.shard_model), its state (params and AdamW moments)
    against memory_allocated(), one 1 x 4096 microbatch's loss and grads
    under op_analysis: FLOPs equal to the dry-run's on meta, loss and
    grads bit for bit the plain LM's; hstu-large at phase engine's pack:
    the state against memory_allocated(), a training step (segmented
    negatives, the dry-run's path) under op_analysis with the kernels'
    live counts, its FLOPs at most the dry-run's worst case. The roofline
    terms beside the measured walls (reported, not held)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.core.sharding import shard_ctx
    from repro_torch.launch import mesh as M
    from repro_torch.launch import op_analysis as OA
    from repro_torch.launch import partition as PT
    from repro_torch.launch.dryrun import _sharded
    from repro_torch.models.model_zoo import get_bundle
    from repro_torch.training import gr_train_state, make_gr_step_fn
    from repro_torch.training.trainer import lm_train_state, to_device
    t0 = time.perf_counter()
    res = _finish_child(child, "dryrun (a)", DRYRUN_CHILD_TIMEOUT_S)
    say(f"[dryrun] (a) child {res['s']:.1f} s; meshes {res['meshes']}")
    for tag, r in res["cells"].items():
        say(f"[dryrun] (a) {tag} summary {json.dumps(r, default=str)}")
        check(r["ok"], f"{tag}: the dry-run record is not ok")
        check(r["state_bytes_per_device"] == r["local_state_bytes"],
              f"{tag}: state {r['state_bytes_per_device']} bytes a device, "
              f"DTensor's local shards {r['local_state_bytes']}")
        say(f"[dryrun] (a) {tag}: state {r['state_bytes_per_device'] / 1e9:.3f}"
            f" GB/device, {r['flops']:.4e} FLOPs, {r['bytes']:.4e} bytes, "
            f"collectives {r['coll_bytes']}, dominant {r['dominant']} "
            f"(compute {r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s,"
            f" collective {r['collective_s']:.4f} s, roofline_frac "
            f"{r['roofline_frac']:.4f}); step on meta {r['t_step_s']} s")
        if "pend_spec" in r:
            check("data" in r["pend_spec"], f"{tag}: the tau=1 carry is "
                  f"not sharded over the data axes")
    out = {"child": res, "card": CARD.get("smi_line")}
    dev = torch.device("cuda")
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{M.free_port()}", rank=0, world_size=1)
    try:
        mesh = M.device_mesh((1, 1), device="cuda")
        # -- starcoder2-3b, one microbatch ------------------------------
        arch, B, S = DRYRUN_LM
        w1 = res["world1"]["lm"]
        cfg = get_arch(arch)
        bundle = get_bundle(cfg)
        from repro_torch.configs.shapes import ShapeConfig
        plan = PT.make_plan(cfg, ShapeConfig("lm_mb", S, B, "train"), mesh)
        _lm_free()
        m0 = torch.cuda.memory_allocated()
        gen = torch.Generator(device=dev).manual_seed(SEED + 27)
        model = bundle.init(gen, device=dev)
        PT.shard_model(model, mesh, plan)
        st = lm_train_state(model, torch.float32)
        torch.cuda.synchronize()
        state_b = torch.cuda.memory_allocated() - m0
        rel = abs(state_b - w1["state_bytes_per_device"]) / state_b
        batch = _lm_batch(cfg, B, S, torch.Generator(device=dev)
                          .manual_seed(SEED + 28), dev)
        from torch.distributed.tensor import distribute_tensor
        bspec = PT.to_placements(mesh, (plan.rules["batch"], None))
        dbatch = {k: distribute_tensor(v, mesh, bspec)
                  for k, v in batch.items()}
        params = [p for _, p in model.named_parameters()]
        torch.cuda.synchronize()
        t = time.perf_counter()
        with OA.OpAnalysis() as an, _sharded(mesh, plan):
            loss = bundle.loss(model, dbatch, q_block=plan.q_block,
                               remat=plan.remat)
            grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t
        loss_s = loss.full_tensor()
        grads = [g.full_tensor() for g in grads]
        card_flops = an.totals.flops
        del st, an
        plain = bundle.init(torch.Generator(device=dev)
                            .manual_seed(SEED + 27), device=dev)
        pparams = [p for _, p in plain.named_parameters()]
        torch.cuda.synchronize()
        t = time.perf_counter()
        ploss = bundle.loss(plain, batch, q_block=plan.q_block,
                            remat=plan.remat)
        pgrads = torch.autograd.grad(ploss, pparams)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        same_loss = torch.equal(loss_s, ploss)
        diff = [n for (n, _), a, b in zip(plain.named_parameters(), grads,
                                          pgrads) if not torch.equal(a, b)]
        lm = dict(state_bytes=state_b,
                  predicted_state_bytes=w1["state_bytes_per_device"],
                  state_rel=rel, meta_flops=w1["flops"],
                  card_flops=card_flops, loss=float(ploss),
                  bitwise_loss=same_loss, grads_differing=diff,
                  sharded_s=sharded_s, plain_s=plain_s,
                  roofline={k: w1[k] for k in ("compute_s", "memory_s",
                                                "collective_s", "dominant",
                                                "roofline_frac")})
        say(f"[dryrun] (b) {arch} 1 x {S} on a (1, 1) mesh: state "
            f"{state_b / 1e9:.4f} GB allocated, {w1['state_bytes_per_device'] / 1e9:.4f} "
            f"GB predicted ({rel:.2e} apart); FLOPs on meta "
            f"{w1['flops']:.6e}, on the card {card_flops:.6e} (equal "
            f"{w1['flops'] == card_flops}); loss {float(ploss):.6f} bit for "
            f"bit the plain LM's {same_loss}, grads differing "
            f"{len(diff)} of {len(pparams)}; the microbatch's fwd+bwd as "
            f"DTensors {sharded_s:.2f} s (op_analysis on), plain {plain_s:.3f}"
            f" s; roofline compute {w1['compute_s']:.4f} s, memory "
            f"{w1['memory_s']:.4f} s, collective {w1['collective_s']:.4f} s,"
            f" dominant {w1['dominant']}, roofline_frac "
            f"{w1['roofline_frac']:.4f}")
        del model, plain, grads, pgrads, params, pparams, loss, ploss
        _lm_free()
        # -- hstu-large at the engine's pack ----------------------------
        arch, users, S = DRYRUN_GR
        w1 = res["world1"]["gr"]
        cfg = get_arch(arch)
        bundle = get_bundle(cfg)
        m0 = torch.cuda.memory_allocated()
        gen = torch.Generator(device=dev).manual_seed(SEED + 29)
        st = gr_train_state(bundle.init_dense(gen, device=dev),
                            bundle.init_table(gen, device=dev))
        torch.cuda.synchronize()
        state_b = torch.cuda.memory_allocated() - m0
        rel_gr = abs(state_b - w1["state_bytes_per_device"]) / state_b
        from repro_torch.kernels.jagged_attention import make_attn_fn
        plan = PT.make_plan(cfg, ShapeConfig("pack", S, users, "train"),
                            mesh)
        step = make_gr_step_fn(bundle, loss_kwargs=dict(
            neg_mode="segmented", neg_segment=plan.neg_segment,
            expansion=plan.neg_expansion, remat=plan.remat,
            attn_fn=make_attn_fn(max_row_len=cfg.max_seq_len)),
            semi_async=True)
        gbatch = to_device(_train_batches(cfg.vocab_size, 1)[0], dev)
        st, _ = step(st, gbatch)                     # warm: builds, plans
        torch.cuda.synchronize()
        t = time.perf_counter()
        with OA.OpAnalysis() as an:
            st, met = step(st, gbatch)
        torch.cuda.synchronize()
        gr_s = time.perf_counter() - t
        attn = [k for k in an.kernels if k["kernel"].startswith("attn_")]
        live = sum(k["live_pairs"] for k in attn)
        padded = sum(k["padded_pairs"] for k in attn)
        w_attn = sum(v["operations"] for k, v in w1["kernels"].items()
                     if k.startswith("attn_"))
        c_attn = sum(k["operations"] for k in attn)
        gr = dict(state_bytes=state_b,
                  predicted_state_bytes=w1["state_bytes_per_device"],
                  state_rel=rel_gr, meta_flops=w1["flops"],
                  card_flops=an.totals.flops, live_pairs=live,
                  padded_pairs=padded, attn_flops_card=c_attn,
                  attn_flops_meta=w_attn, step_s=gr_s,
                  loss=float(met["loss"]),
                  kernels_card=sorted({k["kernel"] for k in an.kernels}),
                  roofline={k: w1[k] for k in ("compute_s", "memory_s",
                                                "collective_s", "dominant",
                                                "roofline_frac")})
        say(f"[dryrun] (b) {arch} 1 x {users} x {S}, vocab "
            f"{cfg.vocab_size}: state {state_b / 1e9:.4f} GB allocated, "
            f"{w1['state_bytes_per_device'] / 1e9:.4f} GB predicted "
            f"({rel_gr:.2e} apart); a step's FLOPs on the card "
            f"{an.totals.flops:.6e} (the kernels' live counts: attention "
            f"{c_attn:.4e} at {live} of {padded} padded block pairs, a "
            f"share {live / max(padded, 1):.4f}), the dry-run's worst case "
            f"{w1['flops']:.6e} (attention {w_attn:.4e}); kernels "
            f"{gr['kernels_card']}; step {gr_s * 1e3:.1f} ms (op_analysis "
            f"on), loss {gr['loss']:.5f}; roofline compute "
            f"{w1['compute_s'] * 1e3:.3f} ms, memory "
            f"{w1['memory_s'] * 1e3:.3f} ms, dominant {w1['dominant']}, "
            f"roofline_frac {w1['roofline_frac']:.4f}")
        del st, an, step, gbatch
        _lm_free()
    finally:
        dist.destroy_process_group()
    out |= {"lm": lm, "gr": gr, "s": time.perf_counter() - t0}
    say(f"[dryrun] phase (b) and the wait for (a) {out['s']:.1f} s on "
        f"{CARD.get('smi_line')}")
    check(lm["state_rel"] <= DRYRUN_STATE_TOL,
          f"{DRYRUN_LM[0]}'s state bytes {lm['state_rel']:.3e} off the "
          f"prediction")
    check(gr["state_rel"] <= DRYRUN_STATE_TOL,
          f"{DRYRUN_GR[0]}'s state bytes {gr['state_rel']:.3e} off the "
          f"prediction")
    check(lm["meta_flops"] == lm["card_flops"],
          "the microbatch's FLOPs on meta and on the card differ")
    check(lm["bitwise_loss"] and not lm["grads_differing"],
          f"the world-1 sharded microbatch is not bit for bit the plain "
          f"LM's: {lm['grads_differing'][:4]}")
    check(gr["card_flops"] <= gr["meta_flops"],
          "the GR step's FLOPs on the card exceed the dry-run's worst case")
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
            ("sasrec-large", 4, "fused"),
            ("hstu-large", 4, "segmented"), ("hstu-large", 4, "baseline"),
            ("hstu-large", 4, "resilient"))
# the resilient run's flags; it is then resumed to CLI_RESUME_STEPS
CLI_RESILIENT = ["--ckpt-every", "2", "--keep-last-n", "2",
                 "--metrics-every", "2"]
CLI_RESUME_STEPS = 6


def phase_cli():
    """``python -m repro_torch.launch.train`` on the card, as a user runs
    it: hstu-large, fuxi-large and sasrec-large on the fused path,
    hstu-large with ``--neg-mode segmented`` and ``--neg-mode baseline``,
    and hstu-large with checkpoints and telemetry (``--ckpt-dir``, ``--ckpt-every``,
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

def _beside(background, foreground):
    """``background()`` on a thread beside ``foreground()``; returns the
    foreground's result and the wall of the two. Either's exception is
    raised once both have ended."""
    import threading
    box = {}

    def target():
        try:
            box["out"] = background()
        except BaseException as e:                   # noqa: BLE001 — re-raised
            box["err"] = e

    t0 = time.perf_counter()
    th = threading.Thread(target=target, name="beside")
    th.start()
    try:
        out = foreground()
    finally:
        th.join()
    if "err" in box:
        raise box["err"]
    return out, time.perf_counter() - t0


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

    dryrun_proc = None
    try:
        name, count, smi_line = phase_device()
        # phase lm runs none of the port's kernels: it uses the card while
        # nvcc builds them on the host's cores
        lm, pair_s = _beside(lambda: run("build", phase_build),
                             lambda: run("lm", phase_lm))
        # phase dryrun's part (a) runs on the host's CPU beside the card
        # phases, in a process of its own (the fake world of 512 ranks)
        dryrun_proc = _start_child("dryrun_child")
        attn = run("attn_kernels", phase_kernels)
        neg = run("neg_kernels", phase_neg_kernels)
        rs = run("runsum_kernel", phase_runsum_kernel)
        ws = run("wscatter_kernel", phase_wscatter_kernel)
        k9 = run("neg_logits_kernel", phase_neg_logits_kernel)
        k7 = run("gather_kernel", phase_gather_kernel)
        tuned = run("autotune", phase_autotune)
        acausal = run("acausal", phase_acausal)
        offload = run("offload", phase_offload)
        serve = run("serve", phase_serve, "hstu-large", "serve")
        serve_fuxi = run("serve_fuxi", phase_serve, "fuxi-large",
                         "serve_fuxi")
        stream = run("stream", phase_stream)
        per_step, train_prof = run("train", phase_train)
        alg, flat, engine_prof = run("engine", phase_engine, "hstu-large",
                                     "engine")
        f_alg, f_flat, f_prof = run("engine_fuxi", phase_engine,
                                    "fuxi-large", "engine_fuxi")
        s_alg, s_flat, s_out = run("engine_sasrec", phase_engine_sasrec)
        ablation, first_losses = run(
            "ablation", phase_ablation,
            max(r["peak_above_tables_gb"] for r in alg["steps"]))
        resilient = run("resilient", phase_resilient)
        cache = run("cache", phase_cache)
        hsp = run("hsp", phase_hsp)
        hsp_mesh = run("hsp_mesh", phase_hsp_mesh)
        elastic = run("elastic", phase_elastic)
        dryrun = run("dryrun", phase_dryrun, dryrun_proc)
        parity, parity_launches = run("parity", phase_parity)
        run("cli", phase_cli)
    except Failed as e:
        say(f"FAIL: {e}")
        return 1
    except Exception:                                # noqa: BLE001 — report
        traceback.print_exc()
        say("FAIL: exception (traceback above)")
        return 1
    finally:
        if dryrun_proc is not None and dryrun_proc.poll() is None:
            dryrun_proc.kill()
            dryrun_proc.wait()
    train_launches = {}
    for r in per_step:
        for k, v in r["launches"].items():
            train_launches[k] = train_launches.get(k, 0) + v
    say(f"[result] total {time.perf_counter() - t_start:.1f} s on "
        f"{smi_line}; phases {times}; rounds {json.dumps(serve[1])}; FuXi "
        f"rounds {json.dumps(serve_fuxi[1])}")
    say(f"[result] stream {json.dumps({k: v for k, v in stream.items() if k != 'stats'})}")
    say(f"[result] train steps {json.dumps(per_step)}")
    say(f"[result] engine {json.dumps([alg, flat, engine_prof])}")
    say(f"[result] engine_fuxi {json.dumps([f_alg, f_flat, f_prof])}")
    say(f"[result] engine_sasrec {json.dumps([s_alg, s_flat, s_out])}")
    say(f"[result] ablation {json.dumps([ablation, first_losses])}")
    say(f"[result] resilient {json.dumps(resilient)}")
    say(f"[result] cache {json.dumps(cache)}")
    say(f"[result] hsp {json.dumps(hsp)}")
    say(f"[result] hsp_mesh {json.dumps(hsp_mesh)}")
    say(f"[result] elastic {json.dumps(elastic)}")
    say(f"[result] offload {json.dumps(offload)}")
    say(f"[result] lm {json.dumps(lm)}")
    say(f"[result] autotune {json.dumps(tuned)}")
    say(f"[result] dryrun {json.dumps(dryrun)}")
    beside = times["build"] + times["lm"] - pair_s
    freed = min(BEFORE_RESILIENT_S) - times["resilient"]
    say(f"[result] room: phase lm {times['lm']} s (budget "
        f"{LM_BUDGET_S:.0f} s), run beside the build ({times['build']} s): "
        f"the two in {pair_s:.1f} s, {beside:.1f} s freed; phase resilient "
        f"{times['resilient']} s against "
        f"{' and '.join(map(str, BEFORE_RESILIENT_S))} s before: {freed:.1f} s "
        f"freed, of which the final states' CRC32s "
        f"{resilient['crc_freed_s']:.1f} s; freed in all "
        f"{beside + freed:.1f} s, less phase lm {beside + freed - times['lm']:.1f} s")

    def rank_launches(ranks, arms, kname):
        return sum(r[arm][sched]["launches"][kname] for r in ranks
                   for arm in arms for sched in ("algorithm1", "flat")
                   if sched in r[arm])
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
                   "engine_sasrec": s_alg["launches"][kname]
                   + s_flat["launches"][kname],
                   "ablation": sum(r["launches"][kname]
                                   for r in ablation.values()),
                   "resilient": resilient["launches"][kname],
                   "cache": cache["launches"][kname]
                   + cache["launches_flat"][kname],
                   "hsp": rank_launches(hsp["ranks"], ("hsp",), kname),
                   "hsp_mesh": rank_launches(hsp_mesh["ranks"],
                                             ("hsp", "global"), kname),
                   "hsp_mesh_share": sum(
                       run["launches"][kname] for r in hsp_mesh["ranks"]
                       for run in r["share"].values()),
                   "parity": parity_launches.get(kname, 0),
                   "acausal": acausal["launches"].get(kname, 0),
                   "offload": offload["launches"].get(kname, 0)}
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
        # the acausal instantiation (causal=False) at the long-tail pack,
        # bf16, and its time at the training pack and in fp32
        ac = acausal["results"].get((kname, "long_tail", "bfloat16"))
        if ac is not None:
            kernels[-1]["acausal"] = dict(
                {k: ac[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "max_abs_err", "tflops", "causal_ms")},
                train_pack_ms=acausal["results"][
                    (kname, "train_1x4x2048", "bfloat16")]["ms"],
                fp32_ms=acausal["results"][
                    (kname, "long_tail", "float32")]["ms"])
        # K9 over rows streamed from pinned host memory a segment at a time
        if kname.startswith("neg_logits_"):
            kind = kname.rsplit("_", 1)[1]
            kernels[-1]["offload"] = {
                "k9_summed_ms": offload[f"k9_{kind}_ms"],
                "wall_ms": offload["passes"][1][f"{kind}_s"] * 1e3,
                "hidden_share": offload[f"hidden_{kind}"]}
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
