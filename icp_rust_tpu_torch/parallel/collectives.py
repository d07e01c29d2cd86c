"""The collectives of the sharded solvers (``ops/collectives``, where the
solvers under ``ops/`` and ``models/`` reach them), exported here with the
rest of ``parallel/``."""

from icp_rust_tpu_torch.ops.collectives import CALLS, P2P_THROUGH_HOST, \
    all_gather_tiled, psum, ring_shift, transport

__all__ = ["CALLS", "P2P_THROUGH_HOST", "all_gather_tiled", "psum",
           "ring_shift", "transport"]
