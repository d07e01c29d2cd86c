"""host_syncs_per_call: the host's blocking waits on the device per traced
call, from the profiler's CUDA runtime events (stream, device and event
synchronises and synchronous copies: every read of a device value to the
host takes one), less the harness's own synchronise that ends each call."""

from bench_port import tracing

SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")


def read(run):
    if run["trace"] is None:
        return None
    n = tracing.host_count(run["trace"], SYNCS)
    if n < run["calls"]:  # the trace holds no runtime events
        return None
    return (n - run["calls"]) / run["calls"]
