"""SO(3): spatial rotations, batched.

Counterpart of the JAX package's ``geometry/so3.py`` (the reference optimizes
SE(2) only; SO(3)/SE(3) serve the point-to-plane config, BASELINE.json
configs[1]).  exp/log use ``torch.where`` small-angle Taylor branches below
``eps**0.25``, as the SE(2) module does.  Rotations are plain ``(..., 3, 3)``
tensors.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor


def _small(dtype) -> float:
    return float(torch.finfo(dtype).eps) ** 0.25


def hat(w: Tensor) -> Tensor:
    """(..., 3) -> skew-symmetric (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(m: Tensor) -> Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def exp(w: Tensor) -> Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < _small(w.dtype)
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe = torch.sqrt(safe2)
    # A = sin(t)/t, B = (1-cos(t))/t^2 with Taylor fallbacks.
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe)) / safe2)
    k = hat(w)
    k2 = torch.einsum("...ij,...jk->...ik", k, k)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * k + b[..., None, None] * k2


def log(rot: Tensor) -> Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3).

    Three regimes: generic (theta/(2 sin theta) * vee(R - R^T)),
    small-angle Taylor, and near-pi (axis from the diagonal of R + I, sign
    from the skew part)."""
    tr = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.acos(cos_t)
    skew = vee(rot - rot.transpose(-1, -2))  # = 2 sin(theta) * axis

    small = theta < _small(rot.dtype)
    near_pi = theta > math.pi - 1e-3
    sin_t = torch.sin(theta)
    safe_sin = torch.where(small | near_pi, torch.ones_like(sin_t), sin_t)
    generic = (theta / (2.0 * safe_sin))[..., None] * skew
    # Taylor branch: theta^2 from 3 - tr (polynomial in rot), never from
    # arccos, whose derivative is infinite at the identity.
    t2 = torch.clamp(3.0 - tr, min=0.0)
    taylor = 0.5 * (1.0 + t2[..., None] / 12.0) * skew

    # Near pi: axis_i^2 = (R_ii + 1) / 2, relative signs from the symmetric
    # off-diagonals anchored on the largest component.
    diag = torch.stack([rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]],
                       dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    sym01 = rot[..., 0, 1] + rot[..., 1, 0]
    sym02 = rot[..., 0, 2] + rot[..., 2, 0]
    sym12 = rot[..., 1, 2] + rot[..., 2, 1]
    imax = torch.argmax(axis_abs, dim=-1)
    sx, sy, sz = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
    ax0 = torch.stack([sx, torch.copysign(sy, sym01),
                       torch.copysign(sz, sym02)], -1)
    ax1 = torch.stack([torch.copysign(sx, sym01), sy,
                       torch.copysign(sz, sym12)], -1)
    ax2 = torch.stack([torch.copysign(sx, sym02),
                       torch.copysign(sy, sym12), sz], -1)
    axis_pi = torch.where((imax == 0)[..., None], ax0,
                          torch.where((imax == 1)[..., None], ax1, ax2))
    # The overall sign from the skew part (zero exactly at pi, where the
    # sign is a gauge choice).
    dot = torch.sum(axis_pi * skew, dim=-1, keepdim=True)
    axis_pi = torch.where(dot < 0, -axis_pi, axis_pi)
    pi_branch = theta[..., None] * axis_pi

    out = torch.where(small[..., None], taylor, generic)
    return torch.where(near_pi[..., None], pi_branch, out)


def identity(batch_shape=(), dtype=torch.float32, device=None) -> Tensor:
    eye = torch.eye(3, dtype=dtype, device=device)
    return eye.expand(*batch_shape, 3, 3).clone()
