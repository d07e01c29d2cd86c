"""Closed-form 3x3 linear algebra, batched.

Behavioral parity with reference src/linalg.rs:3-29: adjugate/determinant
inverse whose only rank guard is the determinant test, ``det == 0.0``
exactly by default (src/linalg.rs:18), or ``|det| > det_rel_eps *
max|m|^3`` when ``det_rel_eps > 0``.  Cofactor expressions keep the
reference's operation order.  Option returns become an ``ok`` flag.

``sym3x3_eigh_smallest`` is the closed-form symmetric 3x3 eigensolver of
the normals (no ``torch.linalg.eigh``).
"""

from __future__ import annotations

import math

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


def sym3x3_eigh_smallest(cov: Tensor):
    """Eigenvalues (ascending) and the SMALLEST-eigenvalue eigenvector of a
    symmetric 3x3 (batched), in closed form (Eberly's trigonometric
    solution, the JAX package's op order).  The eigenvector is the largest
    cross product of two rows of (A - lambda_0 I); for (near-)repeated
    smallest eigenvalues the direction is ill-defined and callers gate on
    the eigenvalue ratios (the normals' planarity gate does).

    cov: (..., 3, 3) symmetric.  Returns (evals (..., 3) ascending, v0
    (..., 3) unit; [0, 0, 1] where fully degenerate)."""
    a00 = cov[..., 0, 0]
    a11 = cov[..., 1, 1]
    a22 = cov[..., 2, 2]
    a01 = cov[..., 0, 1]
    a02 = cov[..., 0, 2]
    a12 = cov[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    b00 = a00 - q
    b11 = a11 - q
    b22 = a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    tiny = torch.finfo(cov.dtype).tiny
    safe_p = torch.clamp(p, min=tiny)
    # det(A - qI) / 2
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    # p == 0 means A = qI (isotropic or zero): detb / (2 p^3) is 0/0
    # there; any r gives the right answer since all eigenvalues equal q.
    p3 = safe_p ** 3
    iso = p3 <= tiny
    one = torch.ones_like(detb)
    r = torch.clamp(torch.where(iso, one, detb)
                    / torch.where(iso, one, 2.0 * p3), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam2 = q + 2.0 * p * torch.cos(phi)
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam1 = 3.0 * q - lam0 - lam2
    evals = torch.stack([lam0, lam1, lam2], dim=-1)

    # Eigenvector of lam0: the largest-norm cross product of two rows of
    # (A - lam0 I) spans its null space.
    r0 = torch.stack([a00 - lam0, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam0, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam0], dim=-1)
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    norm = torch.sqrt(torch.sum(best * best, dim=-1, keepdim=True))
    fallback = torch.zeros_like(best)
    fallback[..., 2] = 1.0
    v0 = torch.where(norm > tiny, best / torch.clamp(norm, min=tiny),
                     fallback)
    return evals, v0
