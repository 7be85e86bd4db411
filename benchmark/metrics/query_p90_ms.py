"""query_p90_ms: 90th percentile (linear between ranks) of the wall of one
locus query, over every query of the measured window (some hundreds, so
tens lie beyond it)."""
import numpy as np


def read(run):
    return 1e3 * float(np.percentile(run.walls, 90))
