"""icp2d_frame_pairs_roofline: kernel 10 (``csrc/icp2d_frame_pairs.cu``
on ``frame_cluster.cuh``'s ``frame_kernel``) against its bound: the
problem's bytes (every pair's valid points, warm start and answer) over
every launch of the traced calls, over the card's bandwidth, as a share of
the kernel's device time in the trace."""

import re

from bench_port import counts, tracing

KERNEL = re.compile(r"frame_kernel<")


def read(run):
    lc = run["launches"] or {}
    n = lc.get("icp2d_frame_pairs", 0)
    if run["trace"] is None or not n or lc.get("icp2d_frame", 0) \
            or run["peaks"] is None:
        return None
    ns, hits = tracing.device_time_ns(run["trace"], KERNEL.search)
    if hits != n or not ns:
        return None
    per_launch = counts.icp2d_pairs_bytes(int(run["valid_src"].sum()),
                                          int(run["valid_dst"].sum()),
                                          run["work_per_call"])
    bound_s = n * per_launch / run["peaks"]["hbm_bytes_per_s"]
    return 100.0 * bound_s / (ns / 1e9)
