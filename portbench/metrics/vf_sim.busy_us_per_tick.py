"""vf_sim.busy_us_per_tick: the card's busy time in the traced window (the
union of kernel, copy and set intervals) per control tick of the swarm
flying on its vision front-end, in microseconds (a tick steps every quad
of a job once)."""


def read(ctx):
    t = ctx.trace
    if not ctx.frames or not t["n_device_events"]:
        return None
    quads = ctx._batches[0]["x_m"].shape[0]
    return 1e6 * t["busy_s"] / (ctx.frames / quads)
