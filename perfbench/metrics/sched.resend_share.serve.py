"""sched.resend_share.serve: the share of the window's requests the
engine answered ``resend_full`` (the user's slot was evicted, so the
client resent the whole history: a wasted cold encode), from the
scheduler's outcome counters, in %."""
LAYER = "admission and slots"
UNIT = "%"
MOVES = "serve_p95_ms"


def read(ctx):
    n = ctx["record"]["requests"]
    return 100.0 * ctx["outcomes"]["resend_full"] / n if n else None
