"""The device's idle share over the profiled window: 1 - busy / window, in %."""


def idle_pct(ctx):
    p = ctx.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
