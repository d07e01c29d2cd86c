"""device_idle_share.graph_linearize: the window's idle time whose innermost
open span is ``icp.graph_linearize`` (``models/pose_graph``: the residuals,
Jacobians and weights of each Gauss-Newton iteration), over the window."""

from bench_port import spans


def read(run):
    return spans.idle_share(run, "icp.graph_linearize")
