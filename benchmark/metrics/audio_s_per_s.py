"""Seconds of audio in every job completed in the window, over the window."""


def read(run, name):
    return sum(s for _a, _b, s in run.jobs) / run.window_s
