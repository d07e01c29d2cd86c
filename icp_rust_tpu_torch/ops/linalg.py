"""Closed-form 3x3 linear solves, batched.

Behavioral parity with reference src/linalg.rs:3-29: adjugate/determinant
inverse whose only rank guard is the determinant test, ``det == 0.0``
exactly by default (src/linalg.rs:18), or ``|det| > det_rel_eps *
max|m|^3`` when ``det_rel_eps > 0``.  Cofactor expressions keep the
reference's operation order.  Option returns become an ``ok`` flag.
"""

from __future__ import annotations

import torch
from torch import Tensor


def det3x3(m: Tensor) -> Tensor:
    """Determinant with the reference's exact expansion (src/linalg.rs:15-17)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return (
        m00 * (m22 * m11 - m21 * m12)
        - m10 * (m22 * m01 - m21 * m02)
        + m20 * (m12 * m01 - m11 * m02)
    )


def adjugate3x3(m: Tensor) -> Tensor:
    """Adjugate with the reference's cofactor layout (src/linalg.rs:22-27)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    row0 = torch.stack(
        [m22 * m11 - m21 * m12, -(m22 * m01 - m21 * m02),
         m12 * m01 - m11 * m02], dim=-1)
    row1 = torch.stack(
        [-(m22 * m10 - m20 * m12), m22 * m00 - m20 * m02,
         -(m12 * m00 - m10 * m02)], dim=-1)
    row2 = torch.stack(
        [m21 * m10 - m20 * m11, -(m21 * m00 - m20 * m01),
         m11 * m00 - m10 * m01], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def inverse3x3(m: Tensor, det_rel_eps: float = 0.0):
    """Batched closed-form inverse; returns (inv, ok).  inv is zeros where
    not ok."""
    det = det3x3(m)
    if det_rel_eps > 0.0:
        scale = torch.amax(torch.abs(m), dim=(-1, -2))
        ok = torch.abs(det) > det_rel_eps * scale ** 3
    else:
        ok = det != 0.0
    safe_det = torch.where(ok, det, torch.ones_like(det))
    inv = adjugate3x3(m) / safe_det[..., None, None]
    return torch.where(ok[..., None, None], inv, torch.zeros_like(inv)), ok


def solve3x3(a: Tensor, b: Tensor, det_rel_eps: float = 0.0):
    """Solve a x = b via the adjugate inverse; returns (x, ok)."""
    inv, ok = inverse3x3(a, det_rel_eps)
    x = torch.einsum("...ij,...j->...i", inv, b)
    return x, ok
