"""retrieval_roofline.serve: the least time of one rank batch of the
tick's full row count over the whole fp16 table (``work/flops.py``: 2·d a
query and row; the table read once), over the time of the engine's rank
step for that many resident slots (the step its ticks run, a captured
graph on the card), one call at a time by CUDA events, in %."""
LAYER = "retrieval"
UNIT = "%"
MOVES = "serve_p95_ms"


def read(ctx):
    if ctx["device"].type != "cuda":
        return None
    import torch
    from perfbench import timing
    from perfbench.work import flops
    eng, cfg, mix = ctx["engine"], ctx["cfgj"], ctx["mix"]
    B = mix["rows_per_tick"]
    slots = [s for s in (eng.buffer.slot_of(u) for u in ctx["client"].users)
             if s is not None][:B]
    if len(slots) < B:
        return None
    rows = torch.tensor(slots, dtype=torch.int32, device=ctx["device"])
    fn = eng._rank_fn(B)
    secs = timing.median_seconds(lambda: fn(rows))
    ops, byts = flops.retrieval_work(B, cfg["vocab_size"], cfg["d_model"],
                                     mix["k"])
    return 100.0 * flops.bound(ops, byts, "float16")[0] / secs
