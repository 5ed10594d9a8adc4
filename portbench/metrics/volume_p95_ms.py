"""The 95th percentile of every volume's time in the window, from the
call to its FeatureSet on the host (numpy's linear percentile)."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.latencies_s), 95)) * 1e3
