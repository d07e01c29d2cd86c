"""device_idle_share.inner_loop: the window's idle time whose innermost open
span is ``icp.inner_loop`` (``ops/align3d._loop_torch``, the plain batched
IRLS loop with its ``done`` reads), over the window."""

from bench_port import spans


def read(run):
    return spans.idle_share(run, "icp.inner_loop")
