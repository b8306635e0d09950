"""device.idle_share.serve: the share of a profiled one-second stretch in
the middle of the open loop in which no operation ran on the card
(``torch.profiler``, CUDA activity), in %."""
LAYER = "device"
UNIT = "%"
MOVES = "serve_p95_ms"


def read(ctx):
    tr = ctx["trace"]
    if tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
