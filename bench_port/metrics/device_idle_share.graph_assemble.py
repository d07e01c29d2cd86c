"""device_idle_share.graph_assemble: the window's idle time whose innermost
open span is ``icp.graph_assemble`` (``models/pose_graph``: the dense H and
b, or b and the preconditioner on the CG route), over the window."""

from bench_port import spans


def read(run):
    return spans.idle_share(run, "icp.graph_assemble")
