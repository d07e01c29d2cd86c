"""device_idle_share.outside_program: the window's idle time under no ``icp.``
span of the program (the harness's loop, its synchronise and the wake-up
after it), over the window."""

from bench_port import spans


def read(run):
    return spans.idle_share(run, spans.OUTSIDE)
