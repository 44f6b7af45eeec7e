"""vf_sim.launches_per_tick: kernel launches the host issued in the traced
window (cudaLaunchKernel and cuLaunchKernel records) per control tick of
the swarm flying on its vision front-end (a tick steps every quad of a job
once: the window's quad-ticks over the batch)."""


def read(ctx):
    if not ctx.frames or not ctx.trace["launches"]:
        return None
    quads = ctx._batches[0]["x_m"].shape[0]
    return ctx.trace["launches"] / (ctx.frames / quads)
