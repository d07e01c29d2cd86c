"""nn_pairs_roofline: kernel 8 (``csrc/nn_pairs.cu``, the body
``nn_items_kernel<D, Q, payload, prune>``) against its bound, on the
batched p2l call's warm searches: the problem's bytes over every launch
of the traced calls (the valid source points as queries, the valid
destination points with the 4-lane plane payload [n, c] as the db), over
the card's bandwidth, as a share of the kernel's device time in the
trace.  Nothing to read where the program runs no kernel 8 at D 3."""

import re

from bench_port import counts, tracing

KERNEL = re.compile(r"nn_items_kernel<\s*3\s*,\s*\d+\s*,\s*true\s*,\s*true")
PAYLOAD = 4


def read(run):
    tr, n = run["trace"], (run["launches"] or {}).get("nn_pairs", 0)
    if tr is None or not n or run["peaks"] is None:
        return None
    ns, hits = tracing.device_time_ns(tr, KERNEL.search)
    if hits != n or not ns:
        return None
    per_launch = counts.nn_bytes(int(run["valid_src"].sum()),
                                 int(run["valid_dst"].sum()), 3, PAYLOAD)
    bound_s = n * per_launch / run["peaks"]["hbm_bytes_per_s"]
    return 100.0 * bound_s / (ns / 1e9)
