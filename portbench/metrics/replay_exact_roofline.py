"""replay_exact_roofline: the least time the card's peaks allow for the
exact update the traced jobs' inputs require (metrics/work.py::exact),
over the device time of the replay entry of csrc/replay_exact.cu in the
trace, in %."""

from portbench.devtrace import kernel_seconds
from portbench.metrics.work import least_seconds

KERNEL = "replay_exact_kernel<false>"


def read(ctx):
    t = kernel_seconds(ctx.trace, KERNEL)
    if t <= 0:
        return None
    return 100.0 * least_seconds(ctx.work("exact")) / t
