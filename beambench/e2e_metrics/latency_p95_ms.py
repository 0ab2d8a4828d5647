"""95th percentile, over every block due in the window, of the time from
its due time to its drain (nearest rank).  A block dropped or never drained
counts as beyond any limit: where the percentile falls on one, the value
is 1e12 ms."""

import math


def read(run, out):
    lat = sorted(out.latencies_ms())
    if not lat:
        return None
    v = lat[math.ceil(0.95 * len(lat)) - 1]
    return v if math.isfinite(v) else 1e12
