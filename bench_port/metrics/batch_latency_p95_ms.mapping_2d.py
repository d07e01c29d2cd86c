"""batch_latency_p95_ms.mapping_2d: the 95th percentile (nearest rank) of
the traced calls' latencies, each on the host clock from the call's entry
to the end of the synchronise that ends it: what a 2D mapping stage that
waits on each batch feels, under the profiler."""

import math


def read(run):
    s = sorted(run["call_host_s"] or ())
    if not s:
        return None
    return 1000.0 * s[math.ceil(0.95 * len(s)) - 1]
