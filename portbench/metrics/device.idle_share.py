"""device.idle_share: the share of the traced window in which no kernel,
copy or set ran on the card, in %: 100 * (1 - busy / window)."""


def read(ctx):
    t = ctx.trace
    if t["window_s"] <= 0 or not t["n_device_events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
