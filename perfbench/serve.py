"""A serving cell: the program's ``StreamingRecallEngine`` under open-loop
traffic at the mix's fixed rate, its answers held to the plain reference.

Set-up draws the weights and the table on the card, builds the engine,
warms every step entry the traffic uses, and serves the mix's resident
users once (their slots and caches filled, as a running service has
them). The window then offers Poisson arrivals for ``--seconds``: new
users with a whole history, pure hits, appends of one event and bursts
of appends, each request timed on the host's clock from when it was due
to when its top-k reached the host; a client whose user was evicted
resends the whole history at once. Requests due in the window that have
no answer a grace period after its close are failed.

After the window the engine is freed, and the reference encodes a sample
of the answered requests from the histories they were answered on, scores
every item and finds how far the served items lie below its own k-th best.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np

from perfbench import weights
from perfbench.traffic import gen

LIBS = ("jagged_attn_fwd",)
#: Seconds after the window's close that answers to its requests may take.
GRACE_S = 5.0
#: Faults a test or a control run plants in the program.
FAULTS = ("altered_answer",)
#: Seconds of the open loop the traced run profiles, mid-window.
PROFILED_S = 1.0


class Client:
    """The users' side: every user's whole history as sent, and a record
    of every request due in the window."""

    def __init__(self, mix: Dict, vocab: int):
        self.mix, self.V = mix, vocab
        self.S = mix["max_seq_len"]
        self.items: Dict[int, List[np.ndarray]] = {}
        self.ts: Dict[int, List[np.ndarray]] = {}
        self.count: Dict[int, int] = {}
        self.users: List[int] = []          # known, not given up
        self.next_user = 0
        self.reqs: List[Dict[str, Any]] = []
        self.by_rid: Dict[int, Dict[str, Any]] = {}
        #: each user's accepted requests that brought events
        self.events: Dict[int, List[Dict[str, Any]]] = {}

    def history(self, u: int, upto: Optional[int] = None):
        """The last S events of user u's first ``upto`` events."""
        it = np.concatenate(self.items[u])[:upto]
        tt = np.concatenate(self.ts[u])[:upto]
        return it[-self.S:], tt[-self.S:]

    def add(self, u: int, it: np.ndarray, tt: np.ndarray) -> None:
        self.items.setdefault(u, []).append(it.astype(np.int32))
        self.ts.setdefault(u, []).append(tt.astype(np.int32))
        self.count[u] = self.count.get(u, 0) + len(it)

    def new_user(self, rng, n: int) -> int:
        u = self.next_user
        self.next_user += 1
        it, tt = gen.user_history(rng, n, self.V, self.mix["items"]["zipf_a"])
        self.add(u, it, tt)
        return u

    def submit(self, eng, u: int, it, tt, due: float, kind: str) -> None:
        """One request; a ``resend_full`` is answered by resending the
        whole history at once, as the same request."""
        if len(it):
            self.add(u, it, tt)
        a = eng.submit(u, it, tt, now=due)
        resent = False
        if a.outcome == "resend_full":
            resent = True
            a = eng.submit(u, *self.history(u), now=due)
        r = {"user": u, "due": due, "kind": kind, "rid": a.rid,
             "outcome": a.outcome, "resent": resent, "upto": self.count[u],
             "done": math.nan, "ids": None, "seq": len(self.reqs)}
        self.reqs.append(r)
        if a.accepted:
            self.by_rid[a.rid] = r
            if len(it) or resent:
                self.events.setdefault(u, []).append(r)
        elif eng.buffer.slot_of(u) is None and u in self.users:
            self.users.remove(u)        # shed while not resident: given up

    def answered(self, results, now: float) -> None:
        for res in results:
            r = self.by_rid.get(res.rid)
            if r is not None and math.isnan(r["done"]):
                r["done"] = now
                r["ids"] = res.item_ids

    def checkable(self) -> List[Dict[str, Any]]:
        """Answered requests whose history is unambiguous: no later request
        of the user brought events before their answer came, so the answer
        was computed on the first ``upto`` events."""
        return [r for r in self.reqs if r["ids"] is not None and not any(
            e["seq"] > r["seq"] and e["due"] <= r["done"]
            for e in self.events.get(r["user"], []))]


def build(cfgj: Dict, mix: Dict, seed: int, device, client: Client):
    """The engine over the benchmark's weights and table, its steps warmed,
    the resident users served once."""
    import torch
    from perfbench.train import arch_config
    from repro_torch.models import gr as GR
    from repro_torch.serving import StreamingRecallEngine
    cfg = arch_config(cfgj)
    dense0 = weights.make_dense(cfgj, seed, device)
    model = GR.GRModel(cfg, device="meta").to_empty(device=device)
    model.load_state_dict(dense0)
    model.requires_grad_(False)
    master = weights.make_table(cfgj, seed, device)
    eng = StreamingRecallEngine(cfg, model, master, device=device,
                                max_users=mix["slots"],
                                max_rows_per_tick=mix["rows_per_tick"],
                                k=mix["k"])
    eng.warmup(q_caps=tuple(mix["warm_q_caps"]))
    reqs = []
    for j, n in enumerate(gen.warm_lengths(mix)):
        u = client.new_user(gen.rng_for(seed, 1 << 22, j), n)
        client.users.append(u)
        reqs.append((u, *client.history(u)))
    eng.serve(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return eng, model


def open_loop(eng, client: Client, mix: Dict, seed: int, rate: float,
              seconds: float, on_tick=None) -> Dict[str, Any]:
    """The window: arrivals at ``rate`` for ``seconds``, then up to
    GRACE_S for the answers. → the window's record."""
    m = dict(mix, rate_per_s=rate)
    t_rel, kinds, new_lens = gen.arrivals(m, seed, seconds)
    first = len(client.reqs)
    t0 = time.monotonic() + 0.01
    i, n, j_new = 0, len(t_rel), 0
    ticks = 0
    while True:
        now = time.monotonic()
        while i < n and t0 + t_rel[i] <= now:
            due = t0 + float(t_rel[i])
            rng = gen.rng_for(seed, 1 << 23, i)
            kind = kinds[i]
            if kind == "new":
                u = client.next_user
                client.next_user += 1
                it, tt = gen.user_history(rng, new_lens[j_new], client.V,
                                          mix["items"]["zipf_a"])
                j_new += 1
                client.users.append(u)
                client.submit(eng, u, it, tt, due, "new")
            elif client.users:
                u = client.users[int(rng.integers(len(client.users)))]
                reps = 0 if kind == "hit" else (
                    mix["burst"] if kind == "burst" else 1)
                if reps == 0:
                    client.submit(eng, u, np.zeros(0, np.int32),
                                  np.zeros(0, np.int32), due, kind)
                for _ in range(reps):
                    last = int(client.ts[u][-1][-1])
                    it = gen.zipf_items(rng, 1, client.V,
                                        mix["items"]["zipf_a"])
                    tt = np.array([last + int(rng.integers(1, 3600))],
                                  np.int32)
                    if u in client.users:
                        client.submit(eng, u, it, tt, due, kind)
            i += 1
        if eng.pending:
            res = eng.tick()
            client.answered(res, time.monotonic())
            ticks += 1
            if on_tick is not None:
                on_tick(now - t0)
        elif i < n:
            time.sleep(max(0.0, t0 + t_rel[i] - time.monotonic()))
        else:
            break
        if now > t0 + seconds + GRACE_S:
            break
    reqs = client.reqs[first:]
    lat = [r["done"] - r["due"] for r in reqs]
    done = [x for x in lat if math.isfinite(x)]
    span = (max(r["done"] for r in reqs if math.isfinite(r["done"]))
            - t0) if done else math.inf
    return {"offered_per_s": rate, "arrivals": n, "requests": len(reqs),
            "answered": len(done), "failed": len(reqs) - len(done),
            "sustained_per_s": len(done) / span if done else 0.0,
            "p95_ms": 1e3 * percentile(lat, 95),
            "p50_ms": 1e3 * percentile(lat, 50), "ticks": ticks,
            "outcomes": {k: sum(r["outcome"] == k for r in reqs)
                         for k in ("accepted", "shed_queue", "shed_slots",
                                   "resend_full")},
            "resends": sum(r["resent"] for r in reqs)}


def percentile(lat: List[float], q: float) -> float:
    """The q-th percentile (nearest rank) of all latencies, a missing
    answer counted as infinite."""
    if not lat:
        return math.inf
    xs = sorted(x if math.isfinite(x) else math.inf for x in lat)
    k = max(0, math.ceil(q / 100 * len(xs)) - 1)
    return xs[k]


def check_sample(client: Client, mix: Dict, seed: int) -> List[Dict]:
    """The checked requests: drawn from the seed among the checkable ones,
    with the one on the longest history among them."""
    cand = client.checkable()
    if not cand:
        return []
    longest = max(cand, key=lambda r: min(r["upto"], client.S))
    rest = [r for r in cand if r is not longest]
    rng = gen.rng_for(seed, 1 << 24)
    k = min(mix["checked_requests"] - 1, len(rest))
    return [longest] + [rest[j] for j in sorted(rng.choice(len(rest), k,
                                                            replace=False))]


def served_gaps(cfgj: Dict, client: Client, sample: List[Dict], seed: int,
                device, precision: str = "fp32",
                answers: Optional[List[np.ndarray]] = None) -> List[float]:
    """For each checked request the widest gap by which a served item's
    reference score lies below the reference's k-th best score, in units
    of the spread (std) of the reference's scores over all items. With
    ``answers``, those are judged in place of the served ones."""
    import torch
    from perfbench.reference import gr as ref
    ref.no_tf32()
    if not sample:
        return []
    dense0 = weights.make_dense(cfgj, seed, device)
    p = {n: t.float() for n, t in dense0.items()}
    master = weights.make_table(cfgj, seed, device)
    embs = []
    for r in sample:
        it, tt = client.history(r["user"], r["upto"])
        embs.append(ref.user_embedding(
            p, cfgj, master, torch.as_tensor(it.astype(np.int64),
                                             device=device),
            torch.as_tensor(tt.astype(np.int64), device=device)))
    emb = torch.stack(embs)
    V, k = cfgj["vocab_size"], len(sample[0]["ids"])
    sc = torch.empty((len(sample), V), dtype=torch.float32, device=device)
    step = 1 << 18
    for lo in range(0, V, step):
        rows = master[lo:lo + step].to(torch.float16)
        sc[:, lo:lo + step] = ref.scores(emb, rows, "fp32").T
    del master
    kth = torch.topk(sc, k, dim=1).values[:, -1]
    sd = sc.std(dim=1)
    out = []
    for j, r in enumerate(sample):
        ids = r["ids"] if answers is None else answers[j]
        ids = np.asarray(ids, np.int64)
        if (len(ids) != k or len(set(ids.tolist())) != k
                or ids.min() < 0 or ids.max() >= V):
            out.append(math.inf)
            continue
        s = sc[j, torch.as_tensor(ids, device=device)]
        out.append(float(torch.clamp(kth[j] - s.min(), min=0) / sd[j]))
    return out


def control_answers(cfgj: Dict, client: Client, sample: List[Dict],
                    seed: int, device) -> List[np.ndarray]:
    """The control's answers: the reference's encode and scoring in float8
    put in the program's place, its top k of every item."""
    import torch
    from perfbench.reference import gr as ref
    dense0 = weights.make_dense(cfgj, seed, device)
    p = {n: t.float() for n, t in dense0.items()}
    master = weights.make_table(cfgj, seed, device)
    out = []
    for r in sample:
        it, tt = client.history(r["user"], r["upto"])
        e = ref.user_embedding(
            p, cfgj, master, torch.as_tensor(it.astype(np.int64),
                                             device=device),
            torch.as_tensor(tt.astype(np.int64), device=device), "fp8")
        best = []
        for lo in range(0, cfgj["vocab_size"], 1 << 18):
            rows = master[lo:lo + (1 << 18)].to(torch.float16)
            v, i = torch.topk(ref.scores(e[None], rows, "fp8")[:, 0],
                              len(r["ids"]))
            best.append((v, i + lo))
        v = torch.cat([b[0] for b in best])
        i = torch.cat([b[1] for b in best])
        out.append(i[torch.topk(v, len(r["ids"])).indices].cpu().numpy())
    return out


def alter_answers(eng, V: int) -> None:
    """Plant the fault ``altered_answer``: every tick's first answer has
    its best item replaced where the tick produces it."""
    tick = eng.tick

    def altered(**kw):
        res = tick(**kw)
        if res:
            res[0].item_ids = res[0].item_ids.copy()
            res[0].item_ids[0] = (int(res[0].item_ids[0]) + V // 2) % V
        return res
    eng.tick = altered


def run_cell(workload: Dict, cfgj: Dict, mix: Dict, seed: int,
             seconds: float, trace: bool, t_start: float, device,
             fault: Optional[str] = None) -> Dict[str, Any]:
    """One run of a serving cell → the result line's fields."""
    import torch
    from repro_torch.kernels import _build
    on_card = device.type == "cuda"
    if on_card:
        _build.build_all(LIBS)
    client = Client(mix, cfgj["vocab_size"])
    eng, model = build(cfgj, mix, seed, device, client)
    if fault == "altered_answer":
        alter_answers(eng, cfgj["vocab_size"])
    prof, tr = None, None
    state = {"on": False, "done": False}

    def on_tick(t):
        if not trace or state["done"]:
            return
        if not state["on"] and t >= seconds / 2 - PROFILED_S / 2:
            torch.cuda.synchronize()
            prof.__enter__()
            state["on"] = True
        elif state["on"] and t >= seconds / 2 + PROFILED_S / 2:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            state["on"], state["done"] = False, True

    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    setup_s = time.perf_counter() - t_start
    out0 = dict(eng.sched.outcomes)
    rec = open_loop(eng, client, mix, seed, mix["rate_per_s"], seconds,
                    on_tick)
    if state["on"]:
        prof.__exit__(None, None, None)
        state["done"] = True
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    metrics = {"serve_p95_ms": rec["p95_ms"], "setup_s": setup_s}
    ctx, device_extra = None, {}
    if trace and state["done"]:
        from perfbench.trace import Trace
        tr = Trace(prof)
        device_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        ctx = dict(kind="serve", cfgj=cfgj, mix=mix, seed=seed,
                   device=device, trace=tr, engine=eng, record=rec,
                   outcomes={k: eng.sched.outcomes[k] - out0.get(k, 0)
                             for k in out0}, client=client)
    holder = [eng, model]
    del eng, model
    return dict(metrics=metrics, ctx=ctx, peak=peak,
                attempted=rec["requests"], failed=rec["failed"],
                device_extra=device_extra, window_checks={},
                finish=lambda: _finish(holder, cfgj, mix, seed, device,
                                       client))


def _finish(holder, cfgj, mix, seed, device, client) -> Dict[str, float]:
    """After the window and the per-layer readers: free the engine (the
    caller dropped the readers' context), judge the sample."""
    import torch
    holder.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = check_sample(client, mix, seed)
    gaps = served_gaps(cfgj, client, sample, seed, device)
    return {"served_gap": max(gaps) if gaps else math.inf,
            "checked_requests_missing": float(
                max(0, min(mix["checked_requests"],
                           len(client.checkable())) - len(gaps)))}
