"""frames_per_s: flight-frames of every job completed in the window over
the seconds from the window's start to the last completion."""


def read(run):
    return run.frames_done / run.window_s
