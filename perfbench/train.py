"""A training cell: the program's ``GREngine`` over batches the benchmark
makes from the seed, its first steps held to the plain reference.

Set-up builds one engine over weights and a table the benchmark draws on
the card, runs its first ``checked_steps`` steps through ``GREngine.run``
(the window's own call and feed) while reading what the comparison needs
at each step's end, runs a few more steps to size the window, then the
window is one ``GREngine.run`` call of a whole number of steps. After the
window the program is freed and the reference trains the same first steps
from the same weights and batches.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from perfbench import common, weights
from perfbench.traffic import gen

#: The kernel libraries a training step loads: K1-fwd, K2, K3/K4, K5, K6.
LIBS = ("jagged_attn_fwd", "jagged_attn_bwd", "neg_fused", "wscatter",
        "runsum")
ADAM_B1 = 0.9
#: Steps after the checked ones that size the window.
SIZING_STEPS = 3
#: Faults a test or a control run plants in the program.
FAULTS = ("unchanged", "half_batch", "sparse_unchanged")


def arch_config(cfgj: Dict):
    """The program's ArchConfig of a configuration file."""
    import dataclasses
    from repro_torch.configs.base import ArchConfig, RABConfig
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in cfgj.items() if k in names and k != "rab"}
    kw.update(gr=True, rope_theta=0.0, rab=RABConfig(**cfgj["rab"]))
    return ArchConfig(**kw)


def half_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The batch with its second half of users left out (their tokens
    become padding)."""
    off = batch["offsets"].copy()
    users = int((np.diff(off[0]) > 0).sum())
    off[0, users // 2 + 1:] = off[0, users // 2]
    return {**batch, "offsets": off}


def step_lengths(mix: Dict) -> List[int]:
    """The token count of each user of a pack (every pack has the same)."""
    return [n - 1 for n in gen.pack_lengths(mix)]


class Program:
    """The engine and what its first steps gave the comparison."""

    def __init__(self, cfgj: Dict, mix: Dict, seed: int, device,
                 fault: Optional[str] = None):
        import torch
        from repro_torch.models import gr as GR
        from repro_torch.models.model_zoo import GRBundle
        from repro_torch.training import GREngine
        from repro_torch.training.trainer import gr_train_state
        if fault not in (None, *FAULTS):
            raise ValueError(f"fault {fault!r}")
        self.cfgj, self.mix, self.seed, self.fault = cfgj, mix, seed, fault
        self.cfg = arch_config(cfgj)
        self.base = 0
        self.ready: Dict[int, Dict[str, np.ndarray]] = {}
        self.dense0 = weights.make_dense(cfgj, seed, device)
        master = weights.make_table(cfgj, seed, device)
        model = GR.GRModel(self.cfg, device="meta").to_empty(device=device)
        model.load_state_dict(self.dense0)
        state = gr_train_state(model, master)
        lr = (0.0 if fault == "unchanged" else mix["lr_dense"],
              0.0 if fault in ("unchanged", "sparse_unchanged")
              else mix["lr_sparse"])
        self.engine = GREngine(GRBundle(self.cfg), self.batch, state=state,
                               schedule=mix["schedule"],
                               semi_async=mix["semi_async"], lr_dense=lr[0],
                               lr_sparse=lr[1])
        self.readings: Dict[str, Any] = {"loss": [], "grad": {},
                                         "change": {}}
        torch.cuda.synchronize() if master.is_cuda else None

    def make_batch(self, i: int) -> Dict[str, np.ndarray]:
        """Step i of the mix."""
        return gen.train_batch(self.mix, self.seed, i,
                               self.cfgj["vocab_size"],
                               self.cfgj["num_negatives"])

    def prefetch(self, steps: int) -> None:
        """Make the next ``steps`` steps' batches now, so that the feed
        only hands them over: the generator's host time stays out of the
        timed steps, as a loader working ahead keeps it."""
        self.ready = {self.base + j: self.make_batch(self.base + j)
                      for j in range(steps)}

    def batch(self, j: int) -> Dict[str, np.ndarray]:
        """The engine's feed: step base + j of the mix."""
        i = self.base + j
        b = self.ready.pop(i, None)
        if b is None:
            b = self.make_batch(i)
        return half_batch(b) if self.fault == "half_batch" else b

    def run(self, steps: int, callback: Optional[Callable] = None
            ) -> List[Dict]:
        eng = self.engine
        eng.step_callback = callback
        recs = eng.run(steps)
        eng.step_callback = None
        self.base += steps
        return recs

    def checked_run(self, steps: int) -> List[Dict]:
        """The first ``steps`` steps, reading at each step's end (the
        carry-convention state): the loss; after the first, every dense
        leaf's gradient from AdamW's first moment and the table's from the
        unique pairs it will land; after the last, every leaf's change."""
        import torch
        last = steps - 1

        def on_step(i, rec, state):
            r = self.readings
            r["loss"].append(float(rec["loss"]))
            if i == 0:
                for n, mu in state.dense_opt.mu.items():
                    r["grad"][n] = float(torch.linalg.vector_norm(
                        mu.float() / (1 - ADAM_B1)))
                r["grad"]["table"] = float(torch.linalg.vector_norm(
                    state.pending_rows))
            if i == last:
                for n, p in state.dense.named_parameters():
                    r["change"][n] = float(torch.linalg.vector_norm(
                        p.detach().float() - self.dense0[n].float()))
                r["change"]["table"] = weights.table_change_norm(
                    self.cfgj, self.seed, state.table.master)
        return self.run(steps, on_step)

    def free(self) -> None:
        import torch
        self.engine = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference_readings(cfgj: Dict, mix: Dict, seed: int, device,
                       precision: str = "fp32") -> Dict[str, Any]:
    """The reference's readings of the mix's first checked steps."""
    from perfbench.reference import gr as ref
    ref.no_tf32()
    steps = mix["checked_steps"]
    dense0 = weights.make_dense(cfgj, seed, device)
    master = weights.make_table(cfgj, seed, device)
    batches = [gen.train_batch(mix, seed, i, cfgj["vocab_size"],
                               cfgj["num_negatives"]) for i in range(steps)]
    out = ref.train_readings(
        cfgj, dense0, master, batches, lr_dense=mix["lr_dense"],
        lr_sparse=mix["lr_sparse"], precision=precision,
        table_change=lambda m: weights.table_change_norm(cfgj, seed, m))
    del master, dense0
    return out


#: The numbers :func:`compare` gives.
NUMBERS = ("loss_gap_first", "loss_gap", "grad_gap", "grad_gap_median",
           "table_grad_gap", "change_gap", "change_gap_median",
           "table_change_gap")


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The readings of the program (or the control) against the
    reference's. Gaps of norms are taken leaf by leaf against max(the
    leaf's reference norm, the median leaf's): ``grad_gap`` the worst leaf
    of the first gradient, ``grad_gap_median`` its median leaf and
    ``table_grad_gap`` the table's (the unique rows K5 gives the landing);
    ``change_gap`` the worst and ``change_gap_median`` the median leaf of
    the change after the checked steps, leaves whose reference gradient is
    below a thousandth of the median leaf's left out, and
    ``table_change_gap`` the table's (what the row-sparse AdaGrad landed);
    ``loss_gap_first`` the first step's loss and ``loss_gap`` the worst
    step's (relative). The limits file says which of them a run
    compares."""
    if len(prog["loss"]) != len(ref["loss"]):
        return {k: math.inf for k in NUMBERS}
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    grad = common.leaf_gaps(prog["grad"], ref["grad"])
    change = common.leaf_gaps(prog["change"], ref["change"],
                              common.quiet_leaves(ref["grad"]))
    return {"loss_gap_first": loss[0], "loss_gap": max(loss),
            "grad_gap": common.worst_leaf_gap(grad),
            "grad_gap_median": common.median_leaf_gap(grad),
            "table_grad_gap": grad["table"],
            "change_gap": common.worst_leaf_gap(change),
            "change_gap_median": common.median_leaf_gap(change),
            "table_change_gap": change["table"]}


def run_cell(workload: Dict, cfgj: Dict, mix: Dict, seed: int,
             seconds: float, trace: bool, t_start: float, device,
             fault: Optional[str] = None) -> Dict[str, Any]:
    """One run of a training cell → the result line's fields."""
    import torch
    from repro_torch.kernels import _build
    on_card = device.type == "cuda"
    if on_card:
        _build.build_all(LIBS)
    prog = Program(cfgj, mix, seed, device, fault=fault)
    prog.checked_run(mix["checked_steps"])
    if on_card:
        torch.cuda.synchronize()
    prog.prefetch(SIZING_STEPS)
    t = time.perf_counter()
    prog.run(SIZING_STEPS)
    if on_card:
        torch.cuda.synchronize()
    per_step = (time.perf_counter() - t) / SIZING_STEPS
    n = max(2, int(seconds / per_step))
    prog.prefetch(n)
    prof = None
    callback = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, schedule
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=max(0, n // 2 - 2), warmup=1,
                                         active=2, repeat=1))
        prof.__enter__()
        callback = lambda i, rec, state: prof.step()      # noqa: E731
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    first = prog.base
    recs = prog.run(n, callback)
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    tokens = sum(r["tokens"] for r in recs)
    bad = sum(not math.isfinite(r["loss"]) for r in recs)
    metrics = {"train_tokens_per_s": tokens / window_s, "setup_s": setup_s}
    device_extra: Dict[str, Any] = {}
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    ctx = None
    if trace:
        from perfbench.trace import Trace
        tr = Trace(prof)
        ctx = dict(kind="train", cfgj=cfgj, mix=mix, seed=seed,
                   device=device, trace=tr, events=prog.engine.events,
                   steps=n, window_s=window_s, records=recs,
                   lengths=step_lengths(mix), prog=prog,
                   batch=prog.make_batch(first + n - 1))
        device_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    readings = prog.readings
    return dict(metrics=metrics, ctx=ctx, peak=peak, attempted=n, failed=bad,
                device_extra=device_extra, window_checks={
                    "nonfinite_window_losses": float(bad)},
                finish=lambda: _finish(prog, cfgj, mix, seed, device,
                                       readings))


def _finish(prog: Program, cfgj, mix, seed, device, readings
            ) -> Dict[str, float]:
    """After the window and the per-layer readers: free the program, run
    the reference, compare."""
    prog.free()
    ref = reference_readings(cfgj, mix, seed, device)
    return compare(readings, ref)
