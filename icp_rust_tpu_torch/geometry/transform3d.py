"""Rigid 3D transform, batched; the SE(3) counterpart of
``RigidTransform2`` (JAX package ``geometry/transform3d.py``).

``apply(p) = R p + t``; ``inverse`` = (R^T, -R^T t); ``compose(a, b) =
(Ra Rb, Ra tb + ta)`` (apply b first).  The 3x3 contractions are einsums;
on the card they must run in full float32, which the entry points check.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from icp_rust_tpu_torch.geometry import se3, so3


@dataclasses.dataclass(frozen=True)
class RigidTransform3:
    rot: Tensor  # (..., 3, 3)
    t: Tensor    # (..., 3)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32,
                 device=None) -> "RigidTransform3":
        return RigidTransform3(
            rot=so3.identity(batch_shape, dtype, device),
            t=torch.zeros((*batch_shape, 3), dtype=dtype, device=device),
        )

    @staticmethod
    def from_twist(param: Tensor) -> "RigidTransform3":
        rot, t = se3.calc_rt(param)
        return RigidTransform3(rot=rot, t=t)

    @staticmethod
    def from_rt(rot: Tensor, t: Tensor) -> "RigidTransform3":
        return RigidTransform3(rot=rot, t=t)

    def log(self) -> Tensor:
        return se3.log_rt(self.rot, self.t)

    def apply(self, p: Tensor) -> Tensor:
        """Transform one point (..., 3) per batch lane."""
        return torch.einsum("...ij,...j->...i", self.rot, p) + self.t

    def apply_points(self, pts: Tensor) -> Tensor:
        """Transform a point cloud (..., N, 3) by a (...)-batched transform."""
        return (torch.einsum("...ij,...nj->...ni", self.rot, pts)
                + self.t[..., None, :])

    def inverse(self) -> "RigidTransform3":
        rt = self.rot.transpose(-1, -2)
        return RigidTransform3(
            rot=rt, t=-torch.einsum("...ij,...j->...i", rt, self.t))

    def compose(self, rhs: "RigidTransform3") -> "RigidTransform3":
        """self @ rhs (apply rhs first)."""
        return RigidTransform3(
            rot=torch.einsum("...ij,...jk->...ik", self.rot, rhs.rot),
            t=torch.einsum("...ij,...j->...i", self.rot, rhs.t) + self.t,
        )

    def __matmul__(self, rhs: "RigidTransform3") -> "RigidTransform3":
        return self.compose(rhs)

    def astype(self, dtype) -> "RigidTransform3":
        return RigidTransform3(self.rot.to(dtype), self.t.to(dtype))

    def to(self, device) -> "RigidTransform3":
        return RigidTransform3(self.rot.to(device), self.t.to(device))

    @property
    def dtype(self):
        return self.t.dtype

    @property
    def device(self):
        return self.t.device

    @property
    def batch_shape(self):
        return self.t.shape[:-1]
