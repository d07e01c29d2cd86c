"""nn_matched_roofline: kernel 4 (``csrc/nn_matched.cu``, the body
``nn_items_kernel<D, Q, payload, no prune>``) against its bound: the
problem's bytes over every launch of the traced calls (the valid source
points as queries, the valid destination points with the 4-lane plane
payload [n, c] as the db), over the card's bandwidth, as a share of the
kernel's device time in the trace."""

import re

from bench_port import counts, tracing

KERNEL = re.compile(r"nn_items_kernel<\s*3\s*,\s*\d+\s*,\s*true\s*,\s*false")
PAYLOAD = 4


def read(run):
    tr, n = run["trace"], (run["launches"] or {}).get("nn_matched", 0)
    if tr is None or not n or run["peaks"] is None:
        return None
    ns, hits = tracing.device_time_ns(tr, KERNEL.search)
    if hits != n or not ns:
        return None
    per_launch = counts.nn_bytes(int(run["valid_src"].sum()),
                                 int(run["valid_dst"].sum()), 3, PAYLOAD)
    bound_s = n * per_launch / run["peaks"]["hbm_bytes_per_s"]
    return 100.0 * bound_s / (ns / 1e9)
