"""host_syncs_per_call.graph_solve: ``host_syncs_per_call``'s runtime events
whose start lies with ``icp.graph_solve`` (``models/pose_graph``: the gauge
prior, the linear solve and the retraction) the innermost open span, per
traced call."""

from bench_port import spans


def read(run):
    return spans.syncs_per_call(run, "icp.graph_solve")
