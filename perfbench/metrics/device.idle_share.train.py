"""device.idle_share.train: the share of the profiled steady steps in
which no operation ran on the card (``torch.profiler``, CUDA activity), in
%."""
LAYER = "device"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    tr = ctx["trace"]
    if tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
