"""request_p95_ms: the 95th percentile of every request's latency in the
window, from when it was due (its samples in pinned host memory) until its
outputs are in pinned host memory, on the host clock."""

import numpy as np


def read(ctx):
    lat = ctx.records.latencies
    return float(np.percentile(np.asarray(lat), 95.0)) * 1e3 if lat else None
