"""95th percentile of the window's batch times, call to numpy results (host clock)."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.batch_s) * 1e3, 95)) if run.batch_s else None
