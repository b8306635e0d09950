"""attn_roofline.serve: the least time of the serving attention for the
work it needs (``work/flops.py``), over the time of the program's entries
for it, in %: a cold encode's ``jagged_attention`` forward over a tick of
the tick's row count (each row one pack, the resident users' history
lengths) and a warm tick's ``pointwise_attention_append`` of one event on
each of those users' cached keys (the first layer's caches). One call at a
time by CUDA events; q, k, v of the layer's shapes drawn from the seed."""
LAYER = "attention"
UNIT = "%"
MOVES = "serve_p95_ms"


def read(ctx):
    if ctx["device"].type != "cuda":
        return None
    import torch
    from perfbench import timing
    from perfbench.work import flops
    from repro_torch.configs.base import RABConfig
    from repro_torch.kernels.jagged_attention import jagged_attention
    from repro_torch.kernels.jagged_attention.ops import position_ninv
    from repro_torch.models.hstu import pointwise_attention_append
    eng, cfg, mix, dev = ctx["engine"], ctx["cfgj"], ctx["mix"], ctx["device"]
    H, D = cfg["num_heads"], cfg.get("qkv_dim") or cfg["head_dim"]
    R, S = mix["rows_per_tick"], mix["max_seq_len"]
    buf = eng.buffer
    slots = [s for s in (buf.slot_of(u) for u in ctx["client"].users)
             if s is not None and 2 <= int(buf.enc_len[s]) <= S - 2][:R]
    if len(slots) < R:
        return None
    lens = [int(buf.enc_len[s]) for s in slots]
    g = torch.Generator(device=dev).manual_seed(ctx["seed"] % (1 << 61))
    q, k, v = (torch.randn((R, S, H, D), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    off = torch.tensor([[0, n] for n in lens], dtype=torch.int32, device=dev)
    ts = buf.timestamps[torch.tensor(slots, device=dev).long()].contiguous()
    rab = {n: t for n, t in eng.model.blocks[0].rab.items()}
    rc = RABConfig(**cfg["rab"])
    with torch.no_grad():
        cold = timing.median_seconds(lambda: jagged_attention(
            q, k, v, off, ts, rab, rc, max_row_len=S))
        rows = torch.tensor(slots, dtype=torch.int32, device=dev)
        pref = torch.tensor([n - 1 for n in lens], dtype=torch.int32,
                            device=dev)
        total = torch.tensor(lens, dtype=torch.int32, device=dev)
        qa = torch.randn((R, 2, H, D), generator=g, device=dev).to(
            torch.bfloat16)
        cap = buf.kv_k.shape[2]
        tsa = torch.cat([ts, ts.new_zeros((R, cap - ts.shape[1]))], 1) \
            if ts.shape[1] < cap else ts
        ninv = position_ninv(cap, dev)
        warm = timing.median_seconds(lambda: pointwise_attention_append(
            qa, buf.kv_k[0], buf.kv_v[0], rows, tsa.contiguous(), pref,
            total, ninv, rab, rc))
    lo = 0.0
    w = flops.attn_fwd_work(lens, H, D, 2, "bucket")
    lo += flops.bound(w[0], w[1], "bfloat16", w[2])[0]
    w = flops.append_work([n - 1 for n in lens], lens, H, D, 2)
    lo += flops.bound(w[0], w[1], "bfloat16", w[2])[0]
    return 100.0 * lo / (cold + warm)
