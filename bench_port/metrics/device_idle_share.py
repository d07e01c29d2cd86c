"""device_idle_share: the share of the traced window that no device
operation covers (the union of the trace's kernel, copy and set
intervals)."""

from bench_port import tracing


def read(run):
    tr = run["trace"]
    if tr is None or not tr["device"]:
        return None
    lo, hi = tr["window"]
    return 1.0 - tracing.busy_ns(tr) / (hi - lo)
