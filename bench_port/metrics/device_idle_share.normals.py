"""device_idle_share.normals: the window's idle time whose innermost open span
is ``icp.normals`` (``models/icp_p2l`` around the call's normals estimate),
over the window."""

from bench_port import spans


def read(run):
    return spans.idle_share(run, "icp.normals")
