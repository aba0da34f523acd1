"""95th percentile of every window job's time, from when it was due (in a
closed loop its submission) to its outputs on the host."""

import numpy as np


def read(run, name):
    return float(np.percentile([(b - a) * 1e3 for a, b, _s in run.jobs], 95))
