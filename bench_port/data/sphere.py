"""The sphere pose graph (sphere2500's shape: g2o's sphere, Kummerle et
al., ICRA 2011), generated from the configuration's seed in place of the
absent ``.g2o`` file.

Poses k = 0..P-1 of ``rings`` rings of ``poses_per_ring`` on a sphere of
``radius_m``, in g2o's construction: pose k, at place n = k mod
``poses_per_ring`` in its ring, turns Rz(-pi + 2 pi n / poses_per_ring)
Ry(-pi/2 + (k + 1) pi / P) and sits at that rotation times (radius, 0, 0).
Edges: the odometry chain (k, k + 1), then one closure (k - poses_per_ring,
k) from each pose of rings 1.. to the pose below it in the ring before.
Each measurement is the true relative pose z_ij = T_i^-1 T_j times
Exp(noise), the noise twist (v, w) drawn N(0, sigma_t^2) on v and N(0,
sigma_r^2) on w; every edge's information is diag(1/sigma_t^2 x 3,
1/sigma_r^2 x 3).  The initial guess is the noisy odometry chain
integrated from the true pose 0.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference.icp import exp_se3


def _turn(axis: int, a: np.ndarray) -> np.ndarray:
    """Rotations (K, 3, 3) by angles ``a`` about coordinate ``axis``."""
    c, s = np.cos(a), np.sin(a)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    rot = np.tile(np.eye(3), (len(a), 1, 1))
    rot[:, i, i], rot[:, i, j], rot[:, j, i], rot[:, j, j] = c, -s, s, c
    return rot


def make(spec: dict, seed: int) -> dict:
    """The graph as float64 numpy arrays: true poses ``gt_rot`` (P, 3, 3),
    ``gt_t`` (P, 3); ``edge_i``, ``edge_j`` (E,); measurements
    ``meas_rot``, ``meas_t``; ``info`` (E, 6, 6); the initial guess
    ``guess_rot``, ``guess_t``."""
    rings, per_ring = spec["rings"], spec["poses_per_ring"]
    p = rings * per_ring
    k = np.arange(p)
    gt_rot = _turn(2, -np.pi + 2 * np.pi * (k % per_ring) / per_ring) \
        @ _turn(1, -np.pi / 2 + (k + 1) * np.pi / p)
    gt_t = gt_rot[:, :, 0] * spec["radius_m"]
    chain, below = np.arange(p - 1), np.arange(per_ring, p)
    ei = np.concatenate([chain, below - per_ring])
    ej = np.concatenate([chain + 1, below])
    ri_t = gt_rot[ei].transpose(0, 2, 1)
    true_rot = ri_t @ gt_rot[ej]
    true_t = np.einsum("eab,eb->ea", ri_t, gt_t[ej] - gt_t[ei])
    sigma = np.repeat([spec["sigma_t_m"], spec["sigma_r_rad"]], 3)
    noise = np.random.default_rng(seed).normal(0, 1, (len(ei), 6)) * sigma
    n_rot, n_t = (x.numpy() for x in exp_se3(torch.as_tensor(noise)))
    meas_rot = true_rot @ n_rot
    meas_t = np.einsum("eab,eb->ea", true_rot, n_t) + true_t
    guess_rot, guess_t = np.empty_like(gt_rot), np.empty_like(gt_t)
    guess_rot[0], guess_t[0] = gt_rot[0], gt_t[0]
    for q in range(p - 1):   # edge q is the chain's (q, q + 1)
        guess_t[q + 1] = guess_rot[q] @ meas_t[q] + guess_t[q]
        guess_rot[q + 1] = guess_rot[q] @ meas_rot[q]
    info = np.tile(np.diag(1 / sigma ** 2), (len(ei), 1, 1))
    return dict(gt_rot=gt_rot, gt_t=gt_t, edge_i=ei, edge_j=ej,
                meas_rot=meas_rot, meas_t=meas_t, info=info,
                guess_rot=guess_rot, guess_t=guess_t)
