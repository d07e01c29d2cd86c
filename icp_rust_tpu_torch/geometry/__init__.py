"""Batched Lie-group geometry: SO(2), SE(2), SO(3), SE(3) and the rigid 2D
and 3D transforms."""

from icp_rust_tpu_torch.geometry import se2, se3, so2, so3
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3

__all__ = ["so2", "se2", "so3", "se3", "RigidTransform2", "RigidTransform3"]
