"""Rigid 2D transform, batched.

Behavioral parity with reference src/transform.rs:
- ``from_twist`` goes through the SE(2) exponential, so the 3-vector
  parameter is a twist, not (x, y, theta) (src/transform.rs:13-16).
- ``apply(p) = R p + t`` (src/transform.rs:22-24).
- ``inverse``: (R^T, -R^T t) (src/transform.rs:26-32).
- ``compose(a, b) = (Ra Rb, Ra tb + ta)`` (src/transform.rs:42-51).

The 2x2 contractions are einsums; on the card they must run in full
float32 (``torch.backends.cuda.matmul.allow_tf32`` False), which the
entry points check.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from icp_rust_tpu_torch.geometry import se2, so2


@dataclasses.dataclass(frozen=True)
class RigidTransform2:
    rot: Tensor  # (..., 2, 2)
    t: Tensor    # (..., 2)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32,
                 device=None) -> "RigidTransform2":
        return RigidTransform2(
            rot=so2.identity(batch_shape, dtype, device),
            t=torch.zeros((*batch_shape, 2), dtype=dtype, device=device),
        )

    @staticmethod
    def from_twist(param: Tensor) -> "RigidTransform2":
        rot, t = se2.calc_rt(param)
        return RigidTransform2(rot=rot, t=t)

    def apply_points(self, pts: Tensor) -> Tensor:
        """Transform a point cloud (..., N, 2) by a (...)-batched transform."""
        return (torch.einsum("...ij,...nj->...ni", self.rot, pts)
                + self.t[..., None, :])

    def inverse(self) -> "RigidTransform2":
        rt = self.rot.transpose(-1, -2)
        return RigidTransform2(
            rot=rt, t=-torch.einsum("...ij,...j->...i", rt, self.t))

    def compose(self, rhs: "RigidTransform2") -> "RigidTransform2":
        """self @ rhs (apply rhs first). Ref src/transform.rs:42-51."""
        return RigidTransform2(
            rot=torch.einsum("...ij,...jk->...ik", self.rot, rhs.rot),
            t=torch.einsum("...ij,...j->...i", self.rot, rhs.t) + self.t,
        )

    def __matmul__(self, rhs: "RigidTransform2") -> "RigidTransform2":
        return self.compose(rhs)

    def astype(self, dtype) -> "RigidTransform2":
        return RigidTransform2(self.rot.to(dtype), self.t.to(dtype))

    def to(self, device) -> "RigidTransform2":
        return RigidTransform2(self.rot.to(device), self.t.to(device))

    @property
    def dtype(self):
        return self.t.dtype

    @property
    def device(self):
        return self.t.device
