"""query_p50_ms: median wall of one locus query (one ``scan`` call), over
every query of the measured window."""
import numpy as np


def read(run):
    return 1e3 * float(np.percentile(run.walls, 50))
