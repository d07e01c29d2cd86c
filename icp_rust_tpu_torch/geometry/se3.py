"""SE(3): rigid spatial motions as twists (v, w), batched.

Counterpart of the JAX package's ``geometry/se3.py``.  Twist layout:
param[..., :3] = v (translational part, through the V matrix),
param[..., 3:] = w (rotation axis-angle), the SE(2) module's "translation
goes through V" convention (reference src/transform.rs:13-16).
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.geometry import so3


def _small(dtype) -> float:
    return float(torch.finfo(dtype).eps) ** 0.25


def _matvec(m: Tensor, v: Tensor) -> Tensor:
    return torch.einsum("...ij,...j->...i", m, v)


def _k_and_k2(w: Tensor):
    k = so3.hat(w)
    return k, torch.einsum("...ij,...jk->...ik", k, k)


def _v_matrix(w: Tensor) -> Tensor:
    """Left Jacobian V: t = V v in exp.  V = I + B K + C K^2."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < _small(w.dtype)
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe = torch.sqrt(safe2)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe)) / safe2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (safe - torch.sin(safe)) / (safe2 * safe))
    k, k2 = _k_and_k2(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + b[..., None, None] * k + c[..., None, None] * k2


def _v_inverse(w: Tensor) -> Tensor:
    """V^-1 = I - K/2 + D K^2, D = (1 - A/(2B)) / theta^2."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < _small(w.dtype)
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe = torch.sqrt(safe2)
    a = torch.sin(safe) / safe
    b = (1.0 - torch.cos(safe)) / safe2
    d_generic = (1.0 - a / (2.0 * b)) / safe2
    d = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, d_generic)
    k, k2 = _k_and_k2(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - 0.5 * k + d[..., None, None] * k2


def calc_rt(param: Tensor):
    """Twist (..., 6) -> (rot (..., 3, 3), t (..., 3))."""
    if param.shape[-1] != 6:
        raise ValueError(
            f"SE(3) twist must have trailing dim 6, got shape "
            f"{tuple(param.shape)}")
    v, w = param[..., :3], param[..., 3:]
    return so3.exp(w), _matvec(_v_matrix(w), v)


def exp(param: Tensor) -> Tensor:
    """Twist (..., 6) -> homogeneous (..., 4, 4)."""
    rot, t = calc_rt(param)
    m = torch.zeros((*param.shape[:-1], 4, 4), dtype=param.dtype,
                    device=param.device)
    m[..., :3, :3] = rot
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def log_rt(rot: Tensor, t: Tensor) -> Tensor:
    """(rot, t) -> twist (..., 6) without building the 4x4."""
    w = so3.log(rot)
    return torch.cat([_matvec(_v_inverse(w), t), w], dim=-1)


def log(matrix: Tensor) -> Tensor:
    """Homogeneous (..., 4, 4) -> twist (..., 6)."""
    return log_rt(matrix[..., :3, :3], matrix[..., :3, 3])
