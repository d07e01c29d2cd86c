"""Multi-pair ICP on one card (counterpart of
icp_rust_tpu/parallel/sharded.py's ``batched_icp2d`` without a mesh).

``batched_icp2d`` aligns B scan pairs in one call: everything, the warm
starts included, carries a leading pair axis.  ``icp2d`` takes the batch
natively, so the whole batch is one lockstep loop: per outer iteration one
pair-grid NN launch for all pairs (``nn_pairs`` on the cold iteration,
``nn_pairs_list`` on every warm one) and one ``irls_loop_batched`` launch;
with ``frame_backend="pairs"`` it is one ``icp2d_frame_pairs`` launch.
"""

from __future__ import annotations

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.models.icp2d import icp2d


def batched_icp2d(src, dst, src_mask, dst_mask,
                  initial_transform: RigidTransform2, config: ICPConfig,
                  mesh=None, device="cuda") -> RigidTransform2:
    """Multi-pair 2D ICP: src (B, N, 2), dst (B, M, 2), masks (B, N) and
    (B, M), warm starts (B,)-batched.  Returns the (B,)-batched transforms.
    Runs on ``device`` ("cuda" unless the caller asks for the CPU)."""
    if mesh is not None:
        raise NotImplementedError(
            "pair-axis data parallelism over several cards (the JAX "
            "package's mesh argument) waits for the torch.distributed port; "
            "pass mesh=None")
    return icp2d(src, dst, src_mask, dst_mask, initial_transform, config,
                 device=device)
