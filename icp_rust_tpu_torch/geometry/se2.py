"""SE(2): planar rigid motions as twists, batched.

Behavioral parity with reference src/se2.rs:

- ``calc_rt(param)``: exponential map of the twist ``(vx, vy, theta)`` into
  (rotation, translation) (src/se2.rs:21-41).  The V-matrix coefficients
  A = sin(t)/t and B = (1-cos(t))/t use Taylor forms below ``eps**0.25``,
  which subsumes the reference's exact ``theta == 0`` branch.
- ``exp(param)`` assembles the 3x3 homogeneous matrix (src/se2.rs:43-52).
- ``log(M)`` inverts it (src/se2.rs:54-77) with the single stable formula
  V^-1 = [[a, b], [-b, a]], b = theta/2, a = (theta/2) cot(theta/2).
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.geometry import so2


def _small_angle_threshold(dtype) -> float:
    # eps**0.25: ~1.9e-2 for f32, ~1.2e-4 for f64.
    return float(torch.finfo(dtype).eps) ** 0.25


def _v_coeffs(theta: Tensor):
    """A = sin(t)/t and B = (1-cos(t))/t with small-angle Taylor fallback."""
    small = torch.abs(theta) < _small_angle_threshold(theta.dtype)
    # Guard the divisor so the unselected branch never produces inf/nan.
    safe = torch.where(small, torch.ones_like(theta), theta)
    t2 = theta * theta
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, theta / 2.0 - t2 * theta / 24.0,
                    (1.0 - torch.cos(safe)) / safe)
    return a, b


def calc_rt(param: Tensor):
    """Twist (..., 3) = (vx, vy, theta) -> (rot (..., 2, 2), t (..., 2))."""
    if param.shape[-1] != 3:
        raise ValueError(
            f"SE(2) twist must have trailing dim 3, got shape "
            f"{tuple(param.shape)}")
    vx, vy, theta = param[..., 0], param[..., 1], param[..., 2]
    rot = so2.exp(theta)
    a, b = _v_coeffs(theta)
    t = torch.stack([a * vx - b * vy, b * vx + a * vy], dim=-1)
    return rot, t


def exp(param: Tensor) -> Tensor:
    """Twist (..., 3) -> homogeneous matrix (..., 3, 3)."""
    rot, t = calc_rt(param)
    m = torch.zeros((*param.shape[:-1], 3, 3), dtype=param.dtype,
                    device=param.device)
    m[..., :2, :2] = rot
    m[..., :2, 2] = t
    m[..., 2, 2] = 1.0
    return m


def get_rt(matrix: Tensor):
    """Split homogeneous (..., 3, 3) -> (rot, t)."""
    return matrix[..., :2, :2], matrix[..., :2, 2]


def log(matrix: Tensor) -> Tensor:
    """Homogeneous (..., 3, 3) -> twist (..., 3)."""
    return log_rt(*get_rt(matrix))


def log_rt(rot: Tensor, t: Tensor) -> Tensor:
    """(rot (..., 2, 2), t (..., 2)) -> twist (..., 3), without building the
    3x3 (no in-place writes, so it runs under ``torch.func`` transforms)."""
    theta = so2.log(rot)
    small = torch.abs(theta) < _small_angle_threshold(rot.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    one_m_cos = 1.0 - torch.cos(safe)
    # Avoid 0/0 in the unselected branch when theta is exactly 0.
    one_m_cos = torch.where(one_m_cos == 0.0, torch.ones_like(one_m_cos),
                            one_m_cos)
    a = torch.where(small, 1.0 - theta * theta / 12.0,
                    0.5 * safe * torch.sin(safe) / one_m_cos)
    b = 0.5 * theta
    ux = a * t[..., 0] + b * t[..., 1]
    uy = -b * t[..., 0] + a * t[..., 1]
    return torch.stack([ux, uy, theta], dim=-1)
