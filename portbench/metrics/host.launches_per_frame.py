"""host.launches_per_frame: kernel launches the host issued in the traced
window (cudaLaunchKernel and cuLaunchKernel records) per flight-frame
the window replayed."""


def read(ctx):
    if not ctx.frames:
        return None
    return ctx.trace["launches"] / ctx.frames
