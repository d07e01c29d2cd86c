"""device_idle_share.prepare: the window's idle time whose innermost open span
is ``icp.prepare`` (``models/icp2d._prepare``: the inputs' moves, scaling
and broadcast), over the window."""

from bench_port import spans


def read(run):
    return spans.idle_share(run, "icp.prepare")
