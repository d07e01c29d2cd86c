"""Multi-pair ICP.  Counterpart of icp_rust_tpu/parallel: so far the
pair-axis batch on one card (``sharded.batched_icp2d``); data parallelism
over several cards, point-sharded solves and the ring NN wait for
``torch.distributed``."""

from icp_rust_tpu_torch.parallel.sharded import batched_icp2d

__all__ = ["batched_icp2d"]
