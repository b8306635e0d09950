#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from anywhere: ``python3 chip_smoke.py``.

Phases, each printed on its own lines; any failure exits non-zero:

  1. device  — the card's name, count, power limit; no card is a failure.
  2. build   — nvcc builds every CUDA source of the port from this
               checkout (one nvcc per source, all started together).
  3. kernels — every kernel of the serving and training paths against its
               plain PyTorch version on the card, at the paths' shapes, with
               its time beside its bound: K1-fwd and K2 (attention forward
               and backward; H=8, D=128, block 128; bf16 and fp32; a
               long-tail pack of G=2 shards of 8192 tokens, and a pack with
               empty rows beside an all-padding shard), K3/K4 (the fused
               negative path; T=8192 tokens, R=128, d 1024, bf16 o, fp16
               shadow of 2^22 rows, invalid tokens, expansion 1 and 4) and
               K6 (the sorted run-sum; ~1.06 M rows of 1024 on a mix of run
               lengths).
  4. serve   — RecallEngine on full-width hstu-large (vocab 2^22, fp32
               master + fp16 shadow on the card, 16 layers, bf16) serves a
               cold, a pure-hit and an incremental round; the kernels'
               launch counts are zeroed just before and read just after.
  5. train   — make_gr_train_step on full-width hstu-large (16 layers,
               vocab 2^22; fp32 master, fp32 AdaGrad accumulator and fp16
               shadow on the card) over the port's GRLoader on synthetic
               KuaiRand (1 shard x 4 users x 2048 events, R=128): 3 sync
               steps, then 3 tau=1 steps, launch counts zeroed before and
               read after each step; then one profiled step.
  6. parity  — one training step at full width, 2 layers, vocab 2^18, with
               the kernels against the same step with the plain versions on
               the card, from the same init.
  7. result  — one JSON line of kernel numbers, the nvidia-smi line, and
               the final status line.
"""
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
# fp32 results summed in another order (K2's table grads, K4's dout, K6's
# totals): max abs error over the largest value
GRAD_TOL_FP32 = 1e-4
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
              "float32": 67e12}                      # H100 SXM, dense
PEAK_BYTES = 3.35e12


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[device] {name} x{count}; nvidia-smi: {smi_line}; torch "
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
    return info


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

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
            "empty_rows+all_padding": stack([sparse, [0, 0, 0]])}


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


def _attn_bound(plan, G, capp, H, D, itemsize, dtype_name):
    n_live = int(plan.n_live.sum())
    flops = 4 * 128 * 128 * D * H * n_live
    byts = (4 * G * capp * H * D * itemsize          # q, k, v read, out
            + plan.meta_i32.numel() * 4 + plan.meta_f32.numel() * 4
            + plan.q_wl.numel() * 4 + plan.q_rowptr.numel() * 4
            + (256 + 32) * H * 4)                    # bias tables
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes
            else "bytes", n_live, flops, byts)


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
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q, k, v = (torch.randn(G, cap, H, D, device=dev, generator=gen)
                       .to(dtype) for _ in range(3))
            args = (q, k, v, o_t, ts_t, rab, rab_cfg)
            before = ops.KERNEL_LAUNCHES["attn_fwd"]
            out = jagged_attention(*args, plan=plan)
            torch.cuda.synchronize()
            check(ops.KERNEL_LAUNCHES["attn_fwd"] == before + 1,
                  "the wrapper did not launch the kernel")
            plain = jagged_attention_ref(*args, plan=plan)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            rel = max_row_rel_err(out, plain)
            pf = plain.float()
            live = pf.norm(dim=-1) > 0
            rms = (pf.norm(dim=-1)[live] / math.sqrt(D)).median().item()
            pad = [out[g, int(offs[g, -1]):] for g in range(G)]
            pad_ok = all(int(torch.count_nonzero(p)) == 0 for p in pad)
            ms = timed_ms(lambda: jagged_attention(*args, plan=plan), 20)
            plain_ms = timed_ms(lambda: jagged_attention_ref(*args,
                                                             plan=plan), 3,
                                warmup=1)
            bound_ms, bound_by, n_live, flops, byts = _attn_bound(
                plan, G, cap, H, D, q.element_size(), dname)
            say(f"[kernels] attn_fwd {pack_name} {dname}: max_abs_err "
                f"{err:.3e} worst row relative {rel:.3e} on outputs of max "
                f"|plain| {pf.abs().max().item():.3e}, median row rms "
                f"{rms:.3e}; pad_zero {pad_ok} | kernel "
                f"{ms:.4f} ms  plain {plain_ms:.3f} ms  bound {bound_ms:.5f}"
                f" ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
                f"{byts / 1e6:.2f} MB, {n_live} live pairs) "
                f"-> {bound_ms / ms:.4f} of bound")
            check(torch.isfinite(out.float()).all().item(),
                  "non-finite kernel output")
            if dtype == torch.float32:
                check(err <= ABS_TOL_FP32, f"attn_fwd {pack_name} fp32: "
                      f"max_abs_err {err} > {ABS_TOL_FP32}")
            else:
                check(rel <= REL_TOL_BF16, f"attn_fwd {pack_name} bf16: "
                      f"row relative err {rel} > {REL_TOL_BF16}")
            check(pad_ok, "pad slots not zero")
            results[("attn_fwd", pack_name, dname)] = dict(
                max_abs_err=err, row_rel_err=rel, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)
            results[("attn_bwd", pack_name, dname)] = _check_attn_bwd(
                q, k, v, rab, plan, pack_name, dname, gen)
            del q, k, v, out, plain
    say("[kernels] no single PyTorch call computes K1-fwd or K2 "
        "(scaled_dot_product_attention has no SiLU weights, RAB or jagged "
        "rows): their library_ms is null")
    return results


def _rel_to_max(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def _check_attn_bwd(q, k, v, rab, plan, pack_name, dname, gen):
    """K2 (its wrapper launches the dk/dv kernel, the dq + RAB-partials
    kernel and the fixed-order partial sum) against its plain version on
    the forward check's inputs and a random cotangent."""
    import torch
    from repro_torch.kernels.jagged_attention import ops
    from repro_torch.kernels.jagged_attention.ref import (attention_bwd_plain,
                                                          max_row_rel_err)
    G, cap, H, D = q.shape
    dy = torch.randn(q.shape, device=q.device, generator=gen).to(q.dtype)
    p = ops._as_batched(plan)
    pt, tt = rab["pos_table"], rab["time_table"]
    kw = dict(scale=D ** -0.5, tb_denom=ops.time_bucket_denom(0.301),
              use_pos=True, use_time=True)
    args = (q, k, v, dy, pt, tt, p)
    before = ops.KERNEL_LAUNCHES["attn_bwd"]
    got = ops._launch_bwd(*args, **kw)
    again = ops._launch_bwd(*args, **kw)
    torch.cuda.synchronize()
    check(ops.KERNEL_LAUNCHES["attn_bwd"] == before + 2,
          "the K2 wrapper did not launch the kernels")
    want = attention_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = {}
    for name, a, b in zip(("dq", "dk", "dv", "dpt", "dtt"), got, want):
        check(torch.isfinite(a.float()).all().item(), f"K2 {name} non-finite")
        errs[name] = dict(max_abs=(a.float() - b.float()).abs().max().item(),
                          rel_to_max=_rel_to_max(a, b),
                          row_rel=(max_row_rel_err(a, b) if a.dim() == 4
                                   else None))
    ms = timed_ms(lambda: ops._launch_bwd(*args, **kw), 10)
    plain_ms = timed_ms(lambda: attention_bwd_plain(*args, **kw), 2,
                        warmup=1)
    # the work needs S, dP, dV, dK and dQ, 2·b²·D each per live pair and
    # head; the kernel's recomputation of S and dP in its second kernel is
    # its own choice and not counted
    n_live = int(plan.n_live.sum())
    flops = 10 * 128 * 128 * D * H * n_live
    byts = (7 * G * cap * H * D * q.element_size()   # q k v dy in, 3 out
            + p.meta_i32.numel() * 4 + p.meta_f32.numel() * 4
            + (p.q_wl.numel() + p.kv_wl.numel() + p.q_rowptr.numel()
               + p.kv_rowptr.numel()) * 4 + 2 * (256 + 32) * H * 4)
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops > t_bytes else "bytes"
    err = max(e["max_abs"] for e in errs.values())
    say(f"[kernels] attn_bwd {pack_name} {dname}: "
        + "; ".join(f"{n} max_abs {e['max_abs']:.3e} rel_to_max "
                    f"{e['rel_to_max']:.3e}"
                    + (f" row_rel {e['row_rel']:.3e}" if e["row_rel"]
                       is not None else "") for n, e in errs.items())
        + f"; bit-identical rerun {same} | kernel {ms:.4f} ms  plain "
        f"{plain_ms:.3f} ms  bound {bound_ms:.5f} ms by {bound_by} "
        f"({flops / 1e9:.2f} GFLOP, {byts / 1e6:.2f} MB, {n_live} live "
        f"pairs) -> {bound_ms / ms:.4f} of bound")
    check(same, "K2 differs between two runs on the same inputs")
    for name, e in errs.items():
        # fp32 (and the fp32 table grads): the same fp32 arithmetic summed
        # in another order, held to 1e-4 of the largest value; bf16 q/k/v
        # grads: one bf16 rounding of an fp32 sum, per (token, head) by
        # relative L2, as K1-fwd
        if e["row_rel"] is not None and dname == "bfloat16":
            check(e["row_rel"] <= REL_TOL_BF16,
                  f"K2 {pack_name} {dname} {name}: row relative "
                  f"{e['row_rel']} > {REL_TOL_BF16}")
        else:
            check(e["rel_to_max"] <= GRAD_TOL_FP32,
                  f"K2 {pack_name} {dname} {name}: {e['rel_to_max']} of "
                  f"max > {GRAD_TOL_FP32}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, errs=errs)


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
            f"{res['neg_bwd']['bound_ms']:.4f} ms ({bwd_bytes / 1e9:.3f} GB;"
            f" the kernel gathers the rows twice) -> "
            f"{res['neg_bwd']['bound_ms'] / bwd_ms:.3f} of bound")
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
    from repro_torch.data import SyntheticKuaiRand
    from repro_torch.kernels.jagged_lookup import ops as JL
    from repro_torch.kernels.jagged_lookup.ref import run_totals_plain
    dev = torch.device("cuda")
    T, R, D, V = 8192, 128, 1024, 2 ** 22
    rng = np.random.default_rng(SEED)
    zipf = SyntheticKuaiRand(num_items=V)._items(rng, 2 * T)
    ids = torch.cat([torch.from_numpy(zipf.astype(np.int32)),
                     torch.from_numpy(rng.integers(0, V, T * R,
                                                   dtype=np.int32)),
                     torch.full((64,), -1, dtype=torch.int32)]).to(dev)
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


def phase_serve():
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.embedding.tables import lookup
    from repro_torch.kernels.jagged_attention import ops
    from repro_torch.models import gr as GR
    from repro_torch.serving import RecallEngine, RequestScheduler

    dev = torch.device("cuda")
    cfg = get_arch("hstu-large")
    V, d = cfg.vocab_size, cfg.d_model
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = GR.GRModel(cfg, device=dev, generator=gen)
    master = torch.randn(V, d, device=dev, generator=gen) * 0.02
    kw = dict(num_shards=2, users_per_shard=8, tokens_per_shard=8192, k=100)
    eng = RecallEngine(cfg, model, master, device=dev, **kw)
    torch.cuda.synchronize()
    say(f"[serve] {cfg.name}: d={d} layers={cfg.num_layers} heads="
        f"{cfg.num_heads} qkv={cfg.qkv_dim} max_seq_len={cfg.max_seq_len} "
        f"vocab={V} dtype={cfg.dtype}; master {tuple(master.shape)} "
        f"{master.dtype} + shadow {eng.table.shadow.dtype} on the card; "
        f"set-up {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SEED)
    hist, rounds = _trace(rng, 40, V, cfg.max_seq_len)
    lens = np.array([len(hist[u][0]) for u in hist])
    say(f"[serve] trace: {len(hist)} users, history lengths min "
        f"{lens.min()} median {int(np.median(lens))} max {lens.max()}, "
        f"{lens.sum()} events")

    torch.cuda.reset_peak_memory_stats()
    for name in ops.KERNEL_LAUNCHES:           # counts of this run only
        ops.KERNEL_LAUNCHES[name] = 0
    out = {}
    per_round = []
    for rname, reqs in rounds:
        enc0 = eng.encoded_batches
        l0 = ops.KERNEL_LAUNCHES["attn_fwd"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n_enc = eng.encoded_batches - enc0
        n_l = ops.KERNEL_LAUNCHES["attn_fwd"] - l0
        hits = sum(r.cache_hit for r in res)
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_round.append(dict(round=rname, requests=len(reqs), hits=hits,
                              micro_batches=n_enc, launches=n_l,
                              wall_s=wall, peak_mem_gib=peak,
                              **{f"{k}_s": v for k, v in
                                 eng.last_step_s.items()}))
        say(f"[serve] round {rname}: {len(reqs)} requests, {hits} hits, "
            f"{n_enc} micro-batches, {n_l} attn_fwd launches, wall "
            f"{wall * 1e3:.1f} ms, phases "
            f"{ {k: round(v * 1e3, 1) for k, v in eng.last_step_s.items()} }"
            f" ms, peak device memory so far {peak:.2f} GiB")
        check(len(res) == len(reqs), "a request got no result")
        check(n_l == cfg.num_layers * n_enc,
              f"attn_fwd launched {n_l} times for {n_enc} micro-batches of "
              f"{cfg.num_layers} layers")
        for r in res:
            check(np.isfinite(r.user_emb).all(), "non-finite embedding")
            check(((r.item_ids >= 0) & (r.item_ids < V)).all(),
                  "top-k id out of range")
            check(np.isfinite(r.scores).all(), "non-finite score")
        out[rname] = {r.user: r for r in res}
    launches = dict(ops.KERNEL_LAUNCHES)
    check(launches["attn_fwd"] > 0, "the main path launched no attn_fwd")
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
    say(f"[serve] checks: embeddings finite, ids in [0, {V}), hits "
        f"bit-identical to cold, launches = layers x micro-batches; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

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
    say(f"[serve] micro-batch of {len(mb.slots)} users, {mb.num_tokens} "
        f"tokens. Per layer, kernel vs plain on the same layer inputs: "
        f"worst row relative {max(both.errs):.3e} (tol {REL_TOL_BF16}), by "
        f"layer "
        f"{[float(f'{e:.2e}') for e in both.errs]}")
    say(f"[serve] end to end through {cfg.num_layers} bf16 layers, kernel "
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
    return launches, per_round, _profile_encode(model, cfg, x, args, attn)


def _profile_encode(model, cfg, x, args, attn):
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
    say(f"[profile] one micro-batch encode: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}")
    for ms, n, key in rows[:8]:
        say(f"[profile]   {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    return {"wall_ms": wall, "busy_ms": busy,
            "top": [(r[2][:60], r[0], r[1]) for r in rows[:8]]}


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


def _train_batches(V, steps, users=64):
    """The port's GRLoader over the port's synthetic KuaiRand: 1 shard x 4
    users x 2048 events (cap 8192), R = 128 negatives per token."""
    from repro_torch.data import GRLoader, SyntheticKuaiRand
    gen = SyntheticKuaiRand(num_users=users, num_items=V, mean_len=1800,
                            sigma_len=0.6, max_len=4096, seed=SEED)
    seqs = {u: (d["item"], d["ts"]) for u, d in
            ((u, gen.interactions(u)) for u in range(users))}
    loader = GRLoader(seqs, num_devices=1, users_per_device=4,
                      max_seq_len=2048, num_negatives=128, num_items=V,
                      seed=SEED)
    return list(loader.batches(steps))


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
    L = cfg.num_layers
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
        want = {"attn_fwd": 2 * L, "attn_bwd": L, "neg_fwd": 1,
                "neg_bwd": 1, "runsum": 1}
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
        if e.device_type == DeviceType.CPU:      # host ops: their kernels
            continue                             # are listed on their own
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows


# --------------------------------------------------------------------------
# phase 6: one step, kernels against plain versions
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
    """One sync step's dense_fwd_bwd + table-grad pairs at full width, 2
    layers, vocab 2^18: kernels against plain versions on the card, same
    init, same batch."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training import gr_train_state, make_gr_stages, to_device
    from repro_torch.training.trainer import _table_grad_pairs
    dev = torch.device("cuda")
    cfg = get_arch("hstu-large").replace(num_layers=2, vocab_size=2 ** 18)
    V = cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    bundle = GRBundle(cfg)
    state = gr_train_state(bundle.init_dense(gen, device=dev),
                           bundle.init_table(gen, device=dev))
    batch = to_device(_train_batches(V, 1)[0], dev)
    st = make_gr_stages(
        lambda dd, t, bt, **kw: bundle.loss(dd, t, bt,
                                            neg_scatter_impl="two_pass",
                                            **kw),
        input_gather=bundle.input_gather, semi_async=False)

    def run():
        out = st.dense_fwd_bwd(state.dense, state.table, batch)
        ids, rows = _table_grad_pairs(*out.table_contribs.pop(), V)
        torch.cuda.synchronize()
        return out.loss.item(), out.grads_dense, ids, rows

    _zero_counts()
    kl, kg, kids, krows = run()
    counts = _read_counts()
    with _PlainVersions():
        _zero_counts()
        pl, pg, pids, prows = run()
        plain_counts = _read_counts()
    check(all(v > 0 for v in counts.values())
          and not any(plain_counts.values()),
          f"kernel run launched {counts}, plain run {plain_counts}")
    g_err = {n: _rel_to_max(kg[n], pg[n]) for n in kg}
    worst = max(g_err, key=g_err.get)
    ids_equal = torch.equal(kids, pids)
    r_err = _rel_to_max(krows, prows) if ids_equal else math.inf
    say(f"[parity] {cfg.name} x {cfg.num_layers} layers, vocab {V}, bf16: "
        f"loss kernels {kl:.6f} plain {pl:.6f} (|d| {abs(kl - pl):.2e}); "
        f"dense grads worst {worst} {g_err[worst]:.3e} of its max (median "
        f"over {len(g_err)} tensors "
        f"{sorted(g_err.values())[len(g_err) // 2]:.3e}); table-grad pairs "
        f"{kids.numel()} ids equal {ids_equal}, rows {r_err:.3e} of max")
    # bf16 activations: an attention output or weight that rounds the
    # other way moves by one bf16 ulp (2^-8 relative) and the loss and
    # grads carry it through 2 layers: loss to 1e-3 of itself, grads and
    # table rows to 5e-2 of their largest values
    check(abs(kl - pl) <= 1e-3 * abs(pl), "parity: loss")
    check(g_err[worst] <= 5e-2, f"parity: dense grad {worst}")
    check(ids_equal and r_err <= 5e-2, "parity: table-grad pairs")
    del state
    torch.cuda.empty_cache()
    return dict(loss=(kl, pl), grad_worst=(worst, g_err[worst]),
                rows=r_err)


# --------------------------------------------------------------------------

def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        say(f"FAIL: no src/repro_torch beside {Path(__file__).name}: run "
            f"this script from a checkout of the repository")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    times = {}

    def run(name, fn):
        t = time.perf_counter()
        out = fn()
        times[name] = round(time.perf_counter() - t, 1)
        return out

    try:
        name, count, smi_line = phase_device()
        run("build", phase_build)
        attn = run("attn_kernels", phase_kernels)
        neg = run("neg_kernels", phase_neg_kernels)
        rs = run("runsum_kernel", phase_runsum_kernel)
        serve_launches, per_round, serve_prof = run("serve", phase_serve)
        per_step, train_prof = run("train", phase_train)
        parity = run("parity", phase_parity)
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
        f"{times}; rounds {json.dumps(per_round)}")
    say(f"[result] train steps {json.dumps(per_step)}")
    main_attn = lambda k: attn[(k, "long_tail", "bfloat16")]  # noqa: E731
    rows = [("attn_fwd", "jagged_attn_fwd.cu",
             "src/repro/kernels/jagged_attention/kernel.py:384",
             main_attn("attn_fwd"), None),
            ("attn_bwd", "jagged_attn_bwd.cu",
             "src/repro/kernels/jagged_attention/kernel.py:781",
             main_attn("attn_bwd"), None),
            ("neg_fwd", "neg_fused.cu",
             "src/repro/kernels/neg_logits/fused.py:159", neg["neg_fwd"],
             None),
            ("neg_bwd", "neg_fused.cu",
             "src/repro/kernels/neg_logits/fused.py:279", neg["neg_bwd"],
             None),
            ("runsum", "runsum.cu",
             "src/repro/kernels/jagged_lookup/kernel.py:128", rs,
             rs["library_ms"])]
    kernels = []
    for kname, src, replaces, r, lib in rows:
        by_path = {"serve": serve_launches.get(kname, 0),
                   "train": train_launches.get(kname, 0)}
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": lib})
    say(json.dumps({"kernels": kernels}))
    say(smi_line)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
