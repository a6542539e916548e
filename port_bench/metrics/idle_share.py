"""idle_share: the share of the traced stretch (a few blocks after the
capture) in which no operation ran on the device: 1 - busy / window from
the profiler's timeline. Moves epoch_ms."""


def read(ctx):
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
