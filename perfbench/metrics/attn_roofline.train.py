"""attn_roofline.train: the least time of the attention's forward and
backward for the work a trained batch needs (``work/flops.py``: the causal
pairs of its lengths, its real tokens' q, k, v, dy and outputs, the bias
tables), over the time of ``jagged_attention`` forward + backward at that
public entry, in %. Timed one call at a time by CUDA events on the
offsets and timestamps of the window's last batch, with q, k, v and dy of
the layer's shapes drawn from the seed and the first layer's bias leaves;
so it reads the same work whatever kernel implements the entry."""
LAYER = "attention"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    if ctx["device"].type != "cuda":
        return None
    import torch
    from perfbench import timing
    from perfbench.work import flops
    from repro_torch.kernels.jagged_attention import (build_attn_plan,
                                                      jagged_attention)
    from repro_torch.configs.base import RABConfig
    cfg, b, dev = ctx["cfgj"], ctx["batch"], ctx["device"]
    H, D = cfg["num_heads"], cfg.get("qkv_dim") or cfg["head_dim"]
    cap = b["ids"].shape[1]
    g = torch.Generator(device=dev).manual_seed(ctx["seed"] % (1 << 61))
    q, k, v, dy = (torch.randn((1, cap, H, D), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    rab = {n.split(".")[-1]: t.detach().clone().requires_grad_()
           for n, t in ctx["prog"].dense0.items()
           if n.startswith("blocks.0.rab.")}
    mode = "functional" if cfg["gr_block"] == "fuxi" else "bucket"
    off = torch.as_tensor(b["offsets"], device=dev)
    ts = torch.as_tensor(b["timestamps"], device=dev)
    plan = build_attn_plan(off, ts, cap, block=128,
                           max_row_len=cfg["max_seq_len"])
    rc = RABConfig(**cfg["rab"])

    def call():
        y = jagged_attention(q, k, v, off, ts, rab, rc, time_mode=mode,
                             plan=plan, max_row_len=cfg["max_seq_len"])
        y.backward(dy)

    secs = timing.median_seconds(call)
    lens = ctx["lengths"]
    lo = 0.0
    for work in (flops.attn_fwd_work(lens, H, D, 2, mode),
                 flops.attn_bwd_work(lens, H, D, 2, mode)):
        lo += flops.bound(work[0], work[1], "bfloat16", work[2])[0]
    return 100.0 * lo / secs
