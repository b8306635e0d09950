"""neg_roofline.train: the least time of the fused negative loss forward
and backward for the work a trained batch needs (``work/flops.py``: its
real tokens, R negatives each, each distinct row read once at fp16), over
the time of ``fused_recall_lse`` forward + backward at that public entry
with the table gradient left in the factored form K5 takes, in %. Timed
one call at a time by CUDA events on the window's last batch's negatives,
over the program's fp16 shadow, with o and the positive logits drawn from
the seed."""
LAYER = "negative loss"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    if ctx["device"].type != "cuda":
        return None
    import torch
    from perfbench import timing
    from perfbench.work import flops
    from repro_torch.kernels.neg_logits import (TableGradSink,
                                                fused_recall_lse)
    cfg, b, dev = ctx["cfgj"], ctx["batch"], ctx["device"]
    table = ctx["prog"].engine.state.table
    T = int(b["offsets"][0, -1])
    d, R = cfg["d_model"], cfg["num_negatives"]
    ids = torch.as_tensor(b["neg_ids"][0, :T], device=dev)
    g = torch.Generator(device=dev).manual_seed(ctx["seed"] % (1 << 61))
    o = (torch.randn((T, d), generator=g, device=dev) * 0.03).to(
        torch.bfloat16).requires_grad_()
    pos = torch.randn((T,), generator=g, device=dev)

    def call():
        lse = fused_recall_lse(o, pos, table.master, ids,
                               gather_table=table.shadow,
                               scatter_impl="fused",
                               table_grad_pairs=TableGradSink(0))
        lse.sum().backward()

    secs = timing.median_seconds(call)
    uniq = int(torch.unique(ids).numel())
    ops, byts = flops.neg_work(T, R, d, uniq)
    return 100.0 * flops.bound(ops, byts, "float16")[0] / secs
