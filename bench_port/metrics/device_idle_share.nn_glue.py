"""device_idle_share.nn_glue: the window's idle time whose innermost open span
is ``icp.nn`` (``models/icp_p2l``'s outer step around
``nearest_neighbor_matched``: the NN's host glue and its kernel's launch),
over the window."""

from bench_port import spans


def read(run):
    return spans.idle_share(run, "icp.nn")
