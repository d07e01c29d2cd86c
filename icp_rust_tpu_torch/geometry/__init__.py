"""Batched Lie-group geometry: SO(2), SE(2) and the rigid 2D transform."""

from icp_rust_tpu_torch.geometry import se2, so2
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2

__all__ = ["so2", "se2", "RigidTransform2"]
