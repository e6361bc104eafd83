"""The 95th percentile (numpy's, linear) of the host wall of every solve in
the window, failed ones included: from the call to a
``torch.cuda.synchronize()`` after its result."""

import numpy as np


def read(run):
    walls = [s.wall_s for s in run.solves]
    return float(np.percentile(walls, 95)) * 1e3 if walls else None
