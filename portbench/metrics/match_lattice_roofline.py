"""match_lattice_roofline: the least time the card's peaks allow for the
lattice lookups the traced jobs' matches require (metrics/work.py::
lattice), over the device time of csrc/match_lattice.cu's kernel in the
trace, summed over its pass-1 and loop launches, in %."""

from portbench.devtrace import kernel_seconds
from portbench.metrics.work import least_seconds

KERNEL = "match_lattice_kernel"


def read(ctx):
    t = kernel_seconds(ctx.trace, KERNEL)
    if t <= 0:
        return None
    return 100.0 * least_seconds(ctx.work("lattice")) / t
