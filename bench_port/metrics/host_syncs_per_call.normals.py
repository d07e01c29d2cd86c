"""host_syncs_per_call.normals: ``host_syncs_per_call``'s runtime events whose
start lies with ``icp.normals`` (``models/icp_p2l``'s normals estimate) the
innermost open span, per traced call."""

from bench_port import spans


def read(run):
    return spans.syncs_per_call(run, "icp.normals")
