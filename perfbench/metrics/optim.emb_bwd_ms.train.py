"""optim.emb_bwd_ms.train: host-busy milliseconds a step of the engine's
emb_bwd stage (the device sort of the table-grad slots, K5's run-sums,
AdamW and the row-sparse AdaGrad landing), from ``GREngine.events`` over
the traced window."""
LAYER = "sparse grads and optimizers"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    from repro_torch.core.pipeline import timeline_report
    tl = timeline_report(ctx["events"])
    s = tl.get("stage_s", {}).get("emb_bwd") if tl else None
    return None if not s else 1e3 * s / ctx["steps"]
