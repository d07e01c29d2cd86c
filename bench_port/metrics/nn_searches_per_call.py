"""nn_searches_per_call: launches of the port's nearest-neighbour kernels
(its own counter, ``ops/cuda_build.LAUNCHES``) per traced call."""


def read(run):
    if run["launches"] is None:
        return None
    n = sum(run["launches"].get(k, 0) for k in run["nn_kernels"])
    return n / run["calls"] if n else None
