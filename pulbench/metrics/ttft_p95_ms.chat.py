"""ttft_p95_ms.chat: the 95th percentile over the window's requests of the
time from ``submit`` to the end of the step that emitted the first token,
in ms (host clock; a request that failed or never got its first token
counts as infinitely late). A per-layer metric where the card is idle
most of the window: the host paces this tail."""
import math

import numpy as np


def read(run):
    if not run.ttft_s:
        return None
    v = float(np.percentile(np.asarray(run.ttft_s), 95)) * 1e3
    return v if math.isfinite(v) else None
