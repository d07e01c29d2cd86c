"""device_idle_share.outer_loop: the window's idle time whose innermost open
span is ``icp.outer_iter`` (``models/icp2d._outer_fixed_point``: an outer
iteration's step and its exit read, less its child spans), over the window."""

from bench_port import spans


def read(run):
    return spans.idle_share(run, "icp.outer_iter")
