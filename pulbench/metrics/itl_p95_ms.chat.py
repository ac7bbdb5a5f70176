"""itl_p95_ms.chat: the 95th percentile over every gap between two
consecutive output tokens of one request inside the window, in ms (host
clock). A per-layer metric where the card is idle most of the window: the
host paces this tail."""
import numpy as np


def read(run):
    if not run.itl_s:
        return None
    return float(np.percentile(np.asarray(run.itl_s), 95)) * 1e3
