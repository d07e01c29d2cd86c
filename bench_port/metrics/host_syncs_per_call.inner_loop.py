"""host_syncs_per_call.inner_loop: ``host_syncs_per_call``'s runtime events
whose start lies with ``icp.inner_loop`` (``ops/align3d._loop_torch``) the
innermost open span, per traced call."""

from bench_port import spans


def read(run):
    return spans.syncs_per_call(run, "icp.inner_loop")
