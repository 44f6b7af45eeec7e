"""setup_s: seconds from the process's start to the window's start:
imports, the kernels' build or load, the traffic, the copy to the card
and the warm-up job."""


def read(run):
    return run.setup_s
