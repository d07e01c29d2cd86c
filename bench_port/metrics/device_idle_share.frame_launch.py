"""device_idle_share.frame_launch: the window's idle time whose innermost open
span is ``icp.frame_launch`` (``ops/align2d_cuda.icp2d_frame_raw``: the
arguments' staging, the pair-frame kernel's launch and its status check),
over the window."""

from bench_port import spans


def read(run):
    return spans.idle_share(run, "icp.frame_launch")
