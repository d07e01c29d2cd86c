"""SO(2): planar rotations, batched.

Behavioral parity with reference src/so2.rs:
- ``exp(theta)`` builds the 2x2 rotation matrix (src/so2.rs:23-31).
- ``log(R) = atan2(R[1,0], R[0,0])`` (src/so2.rs:19-21).

Rotations are plain ``(..., 2, 2)`` tensors.
"""

from __future__ import annotations

import torch
from torch import Tensor


def exp(theta: Tensor) -> Tensor:
    """Rotation matrix of angle ``theta``; shape (...,) -> (..., 2, 2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    row0 = torch.stack([c, -s], dim=-1)
    row1 = torch.stack([s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def log(rot: Tensor) -> Tensor:
    """Angle of a rotation matrix; shape (..., 2, 2) -> (...,)."""
    return torch.atan2(rot[..., 1, 0], rot[..., 0, 0])


def identity(batch_shape=(), dtype=torch.float32, device=None) -> Tensor:
    eye = torch.eye(2, dtype=dtype, device=device)
    return eye.expand(*batch_shape, 2, 2).clone()
