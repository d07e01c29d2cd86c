"""setup_s: seconds from the harness's start to the end of the warm-up:
imports, the kernels' build and load, the data, the warm-up calls."""


def read(run):
    return run["setup_s"]
