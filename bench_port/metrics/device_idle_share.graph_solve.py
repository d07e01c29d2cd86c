"""device_idle_share.graph_solve: the window's idle time whose innermost
open span is ``icp.graph_solve`` (``models/pose_graph``: the gauge prior,
the linear solve and the retraction), over the window."""

from bench_port import spans


def read(run):
    return spans.idle_share(run, "icp.graph_solve")
