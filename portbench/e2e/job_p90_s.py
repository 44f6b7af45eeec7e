"""job_p90_s: the 90th percentile (linear between order statistics) of
the wall seconds of every job completed in the window, each from its
start to its synchronize."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.job_seconds), 90))
