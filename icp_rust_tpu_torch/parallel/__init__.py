"""Multi-rank parallelism on ``torch.distributed`` (JAX package
``icp_rust_tpu/parallel``).

The scaling axes of the domain:

- the pair axis ("dp"): data parallelism over scan pairs;
- the point axis ("sp"): each rank holds a slice of both clouds; JtJ and
  Jtr accumulate locally and all-reduce, and the correspondence search
  over the sharded destination is a ring pass carrying a running (best
  distance, best index): ring attention with an argmin in place of the
  softmax accumulation.

``mesh`` builds the process group and the named mesh, ``collectives``
holds the three collectives, ``ring_nn`` the ring search, ``sharded`` the
sharded ICP drivers and ``batched_icp2d``, ``dist_graph`` the
edge-sharded pose graph (``models/graph_schur.optimize_schur`` takes a
mesh too) and ``dryrun`` the spawner of a world of ranks and the
multi-rank dry run.
"""

from icp_rust_tpu_torch.parallel.dist_graph import optimize_distributed
from icp_rust_tpu_torch.parallel.mesh import initialize_distributed, \
    make_mesh
from icp_rust_tpu_torch.parallel.ring_nn import ring_nearest_neighbor, \
    ring_nearest_neighbor_matched
from icp_rust_tpu_torch.parallel.sharded import batched_icp2d, \
    dp_sp_icp2d, dp_sp_icp3d_planar, dp_sp_icp_p2l, \
    sharded_estimate_transform, sharded_icp2d

__all__ = [
    "batched_icp2d",
    "dp_sp_icp2d",
    "dp_sp_icp3d_planar",
    "dp_sp_icp_p2l",
    "initialize_distributed",
    "make_mesh",
    "optimize_distributed",
    "ring_nearest_neighbor",
    "ring_nearest_neighbor_matched",
    "sharded_estimate_transform",
    "sharded_icp2d",
]
