"""The plain reference of the GR training step and of the serving encode:
HSTU (arXiv:2402.17152) and FuXi-alpha (arXiv:2502.03036) blocks, the
sampled-softmax recall loss over uniform negatives, AdamW on the dense
leaves and row-sparse AdaGrad on the item table, with the one-step-stale
table read of the tau = 1 schedule.

Plain PyTorch in float32 with TF32 off, one user row at a time for the
attention, no kernel, no cache, no batching tricks; it imports nothing of
the program. ``precision="fp8"`` is the control: every product's operands
rounded to float8 (e4m3 forward, e5m2 backward, each tensor scaled to its
largest value), the step below the bfloat16 the configurations state.

Departures from a textbook block, each the configuration's: the attention
weights are divided by the query's position + 1 (the count of keys it
sees); the negatives' rows are read at float16 (the table's shadow); the
positive and input rows at float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor


# --------------------------------------------------------------------------
# precision
# --------------------------------------------------------------------------

def _round8(x: Tensor, dtype) -> Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.finfo(dtype).max / torch.clamp(amax, min=1e-30)
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _QDQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


def operand_fn(precision: str) -> Callable[[Tensor], Tensor]:
    """What every product's operands go through: nothing in fp32, the
    float8 round trip in the control."""
    if precision == "fp32":
        return lambda x: x
    if precision == "fp8":
        return _QDQ.apply
    raise ValueError(f"precision {precision!r}")


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------

def _layer_norm(x: Tensor, eps: float, w=None, b=None) -> Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y if w is None else y * w + b


def _silu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(x)


class _Gather(torch.autograd.Function):
    """table[idx] for a flat index with many repeats of few rows. The
    backward sums each row's grads in float64 in index order, through a
    sort made in the forward (the indexing backward's own scatter is slow
    on millions of repeats of a few hundred rows)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(torch.argsort(idx, stable=True),
                              torch.bincount(idx, minlength=table.shape[0]))
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        order, counts = ctx.saved_tensors
        # (H, N) rows: a scan along the innermost dimension runs in parallel
        gs = g[order].double().t().contiguous()
        cs = torch.cat([gs.new_zeros((gs.shape[0], 1)), gs.cumsum(1)], 1)
        ends = torch.cumsum(counts, 0)
        return (cs[:, ends] - cs[:, ends - counts]).t().float(), None


def _bias(p: Dict[str, Tensor], pre: str, cfg: Dict, ts: Tensor) -> Tensor:
    """(H, n, n) relative bias of one row of n events."""
    n = ts.shape[0]
    rab = cfg["rab"]
    i = torch.arange(n, device=ts.device)
    rel = (i[:, None] - i[None, :]).clamp(0, rab["num_pos_buckets"] - 1)
    out = _Gather.apply(p[pre + "rab.pos_table"], rel.reshape(-1))
    dt = (ts[:, None] - ts[None, :]).abs().float()
    if cfg["gr_block"] == "fuxi":
        sigma = torch.exp(p[pre + "rab.time_log_sigma"])
        rho = torch.sigmoid(p[pre + "rab.time_rho"]) * 1.5 + 0.25
        z = (dt.reshape(-1, 1) + 1e-6) / sigma
        out = out + p[pre + "rab.time_amp"] * torch.exp(-torch.pow(z, rho))
    else:
        b = torch.floor(torch.log10(1.0 + dt) / rab["time_bucket_scale"])
        b = b.long().clamp(0, rab["num_time_buckets"] - 1)
        out = out + _Gather.apply(p[pre + "rab.time_table"], b.reshape(-1))
    return out.view(n, n, -1).permute(2, 0, 1)


def _attention(p, pre, cfg, q, k, v, ts, qd) -> Tensor:
    """One row: q, k, v (n, H, D) → (n, H·D); causal SiLU weights over
    the query's position + 1."""
    n, H, D = q.shape
    s = torch.einsum("qhd,khd->hqk", qd(q), qd(k)) / math.sqrt(D)
    s = s + _bias(p, pre, cfg, ts)
    i = torch.arange(n, device=q.device)
    keep = (i[:, None] >= i[None, :]).float() / (i[:, None] + 1).float()
    a = _silu(s) * keep
    return torch.einsum("hqk,khd->qhd", qd(a), qd(v)).reshape(n, H * D)


def block(p: Dict[str, Tensor], l: int, cfg: Dict, x: Tensor,
          rows: Sequence[Tuple[int, int]], ts: Tensor, qd) -> Tensor:
    """Layer l over the packed valid tokens x (T, d); ``rows`` the (start,
    length) of each user, ``ts`` (T,) their timestamps."""
    pre = f"blocks.{l}."
    H = cfg["num_heads"]
    D = cfg.get("qkv_dim") or cfg["head_dim"]
    eps = cfg["norm_eps"]
    h = _layer_norm(x, eps, p[pre + "ln_w"], p[pre + "ln_b"])
    uvqk = _silu(qd(h) @ qd(p[pre + "w_uvqk"]))
    u, v, q, k = torch.split(uvqk, [H * D] * 4, dim=-1)
    y = torch.cat([_attention(p, pre, cfg, q[a:a + n].reshape(n, H, D),
                              k[a:a + n].reshape(n, H, D),
                              v[a:a + n].reshape(n, H, D), ts[a:a + n], qd)
                   for a, n in rows])
    x = x + qd(_layer_norm(y, eps) * u) @ qd(p[pre + "w_o"])
    if cfg["gr_block"] == "fuxi":
        h = _layer_norm(x, eps, p[pre + "ffn_ln_w"], p[pre + "ffn_ln_b"])
        ff = _silu(qd(h) @ qd(p[pre + "ffn_w_gate"])) * (
            qd(h) @ qd(p[pre + "ffn_w_in"]))
        x = x + qd(ff) @ qd(p[pre + "ffn_w_out"])
    return x


def stack(p: Dict[str, Tensor], cfg: Dict, x: Tensor,
          rows: Sequence[Tuple[int, int]], ts: Tensor, qd,
          remat: bool = False) -> Tensor:
    """Every layer, then the final affine norm. ``remat``: each layer under
    a checkpoint (only its input is kept for the backward)."""
    for l in range(cfg["num_layers"]):
        if remat:
            x = checkpoint(block, p, l, cfg, x, rows, ts, qd,
                           use_reentrant=False)
        else:
            x = block(p, l, cfg, x, rows, ts, qd)
    return _layer_norm(x, cfg["norm_eps"], p["out_ln_w"], p["out_ln_b"])


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def unpack(batch: Dict, device) -> Dict[str, Tensor]:
    """A packed (1, cap) batch → its valid tokens and user rows."""
    off = [int(v) for v in batch["offsets"][0]]
    rows, last = [], 0
    for o in off[1:]:
        if o > last:
            rows.append((last, o - last))
        last = max(last, o)
    T = last
    t = lambda a: torch.as_tensor(a[0, :T].astype("int64"), device=device)
    return {"rows": rows, "ids": t(batch["ids"]), "labels": t(batch["labels"]),
            "ts": t(batch["timestamps"]),
            "neg": torch.as_tensor(batch["neg_ids"][0, :T].astype("int64"),
                                   device=device)}


class TableState:
    """The full fp32 master and AdaGrad accumulator of the reference."""

    def __init__(self, master: Tensor):
        self.master = master
        self.accum = torch.zeros_like(master)

    def adagrad(self, ids: Tensor, g: Tensor, lr: float, eps: float = 1e-10,
                chunk: int = 1 << 17):
        for lo in range(0, ids.numel(), chunk):
            i, gc = ids[lo:lo + chunk], g[lo:lo + chunk]
            s = self.accum[i] + gc * gc
            self.master[i] = self.master[i] - lr * gc * torch.rsqrt(s + eps)
            self.accum[i] = s


def loss_and_grads(o: Tensor, tb: Dict[str, Tensor], master: Tensor,
                   qd, chunk: int = 512
                   ) -> Tuple[float, Tensor, Tensor, Tensor, Tensor]:
    """Eq. 2 over the valid tokens, its value and its grads: (loss, d o
    (T, d), the label rows' grads (T, d), the unique ids the table grad
    touches and their summed rows from the negatives). Negative rows are
    read at float16."""
    T, d = o.shape
    neg = tb["neg"]
    R = neg.shape[1]
    pos_rows = master[tb["labels"]]
    uniq, inv = torch.unique(neg.reshape(-1), return_inverse=True)
    inv = inv.view(T, R)
    neg_grad = torch.zeros((uniq.numel(), d), dtype=torch.float32,
                           device=o.device)
    do = torch.empty_like(o)
    dpos = torch.empty_like(o)
    total = 0.0
    for lo in range(0, T, chunk):
        hi = min(lo + chunk, T)
        oc = o[lo:hi]
        nr = master[neg[lo:hi]].to(torch.float16).float()      # (c, R, d)
        pr = pos_rows[lo:hi]
        oq = qd(oc)
        pl = (oq * qd(pr)).sum(-1)
        nl = torch.einsum("td,trd->tr", oq, qd(nr))
        allc = torch.cat([pl[:, None], nl], dim=1)
        lse = torch.logsumexp(allc, dim=1)
        total += float((lse - pl).sum())
        sm = torch.softmax(allc, dim=1) / T
        gp = sm[:, 0] - 1.0 / T
        gn = sm[:, 1:]
        do[lo:hi] = gp[:, None] * pr + torch.einsum("tr,trd->td", gn, nr)
        dpos[lo:hi] = gp[:, None] * oc
        neg_grad.index_add_(0, inv[lo:hi].reshape(-1),
                            (gn[:, :, None] * oc[:, None, :]).reshape(-1, d))
        del nr
    return total / T, do, dpos, uniq, neg_grad


def unique_pairs(ids: Sequence[Tensor], rows: Sequence[Tensor]
                 ) -> Tuple[Tensor, Tensor]:
    allid = torch.cat(list(ids))
    u, inv = torch.unique(allid, return_inverse=True)
    out = torch.zeros((u.numel(), rows[0].shape[1]), dtype=torch.float32,
                      device=allid.device)
    out.index_add_(0, inv, torch.cat(list(rows)))
    return u, out


def train_readings(cfg: Dict, dense0: Dict[str, Tensor], master: Tensor,
                   batches: List[Dict], *, lr_dense: float, lr_sparse: float,
                   precision: str = "fp32", table_change=None,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                   ) -> Dict:
    """The reference's readings over len(batches) tau = 1 steps from
    ``dense0`` and ``master`` (trained in place): each step's loss, every
    leaf's first gradient (the table's as its summed unique rows), and
    every leaf's change after the last step, the table's by
    ``table_change(master)``."""
    dev = master.device
    qd = operand_fn(precision)
    p = {n: t.detach().float().clone().requires_grad_() for n, t in
         dense0.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    tbl = TableState(master)
    pend: Optional[Tuple[Tensor, Tensor]] = None
    out = {"loss": [], "grad": {}, "change": {}}
    for step, batch in enumerate(batches):
        tb = unpack(batch, dev)
        x = master[tb["ids"]].clone().requires_grad_()         # stale read
        if pend is not None:
            tbl.adagrad(*pend, lr=lr_sparse)
        h = stack(p, cfg, x, tb["rows"], tb["ts"], qd, remat=True)
        loss, do, dpos, nid, nrows = loss_and_grads(h.detach(), tb, master,
                                                    qd)
        h.backward(do)
        pend = unique_pairs([nid, tb["ids"], tb["labels"]],
                            [nrows, x.grad, dpos])
        c = step + 1
        with torch.no_grad():
            for n, t in p.items():
                g = t.grad
                if step == 0:
                    out["grad"][n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(b1).add_((1 - b1) * g)
                v[n].mul_(b2).add_((1 - b2) * g * g)
                upd = lr_dense * (m[n] / (1 - b1 ** c)) / (
                    torch.sqrt(v[n] / (1 - b2 ** c)) + eps)
                t.sub_(upd)
                t.grad = None
        if step == 0:
            out["grad"]["table"] = float(torch.linalg.vector_norm(pend[1]))
        out["loss"].append(loss)
        del h, do, dpos, x
    with torch.no_grad():
        for n, t in p.items():
            out["change"][n] = float(torch.linalg.vector_norm(
                t - dense0[n].float()))
    if table_change is not None:
        out["change"]["table"] = table_change(master)
    return out


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

@torch.no_grad()
def user_embedding(p: Dict[str, Tensor], cfg: Dict, master: Tensor,
                   items: Tensor, ts: Tensor, precision: str = "fp32"
                   ) -> Tensor:
    """The hidden state at the last event of one history (d,)."""
    qd = operand_fn(precision)
    x = master[items]
    ts = ts - ts[0]
    h = stack(p, cfg, x, [(0, items.numel())], ts, qd)
    return h[-1]


@torch.no_grad()
def scores(emb: Tensor, shadow_rows: Tensor, precision: str = "fp32"
           ) -> Tensor:
    """(rows, B) scores of B embeddings (B, d) against fp16 rows."""
    qd = operand_fn(precision)
    return qd(shadow_rows.float()) @ qd(emb.float()).T
