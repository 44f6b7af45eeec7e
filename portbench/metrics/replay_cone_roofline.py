"""replay_cone_roofline: the least time the card's peaks allow for the
hybrid update the traced jobs' inputs require (metrics/work.py::hybrid),
over the device time of csrc/replay_cone.cu's hybrid kernel in the
trace, in %."""

from portbench.devtrace import kernel_seconds
from portbench.metrics.work import least_seconds

KERNEL = "replay_cone_kernel<true>"


def read(ctx):
    t = kernel_seconds(ctx.trace, KERNEL)
    if t <= 0:
        return None
    return 100.0 * least_seconds(ctx.work("hybrid")) / t
