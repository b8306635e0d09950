"""engine.free_share.train: the share of the traced window in which no
stage of Algorithm 1 was computing, from the engine's own stage events
(``GREngine.events`` through ``timeline_report``), in %."""
LAYER = "engine, host stages"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    from repro_torch.core.pipeline import timeline_report
    tl = timeline_report(ctx["events"])
    return 100.0 * tl["free_ratio"] if tl else None
