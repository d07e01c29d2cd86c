"""The general generator of pair traffic: which frames of the
configuration's sequence a call aligns, from which warm starts, in which
order.  It reads the traffic's parameters alone, so a mix of pairs is a
data file:

- ``pairs``: ``{"gap": g}``, every pair (k, k + g) of the sequence
  (default 1: every consecutive pair);
- ``warm_start``: ``{"from": "identity"}``, or ``{"from": "truth",
  "perturb_m": a, "perturb_rad": b, "perturb_seed": n}``: each pair's true
  relative pose, its translation moved by up to ``a`` m along each axis of
  the plane of motion and its rotation turned about z by up to ``b`` rad,
  uniformly, drawn from ``perturb_seed``;
- ``shuffle_points``: the run's seed orders each frame's valid points;
- ``shuffle_pairs``: the run's seed orders the pairs of the batch.

The run's seed only orders: every seed sends the same pairs from the same
warm starts.  A pair (i, j) maps frame i onto frame j; its ground truth is
the frames' true poses composed, P_j^-1 P_i.
"""

from __future__ import annotations

import numpy as np
import torch


def relative_truth(data: dict, pairs: np.ndarray):
    """Each pair's true transform of frame i onto frame j, float64:
    (rot (P, D, D), t (P, D))."""
    r, t = data["pose_rot"], data["pose_t"]
    ri, rj = r[pairs[:, 0]], r[pairs[:, 1]]
    rot = np.einsum("pki,pkj->pij", rj, ri)
    dt = t[pairs[:, 0]] - t[pairs[:, 1]]
    return rot, np.einsum("pki,pk->pi", rj, dt)


def _turn_about_z(angle: np.ndarray, dim: int) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    rot = np.tile(np.eye(dim), (len(angle), 1, 1))
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = c, -s, s, c
    return rot


def warm_starts(spec: dict, gt_rot: np.ndarray, gt_t: np.ndarray):
    p, dim = gt_t.shape
    kind = spec.get("from", "identity")
    if kind == "identity":
        return np.tile(np.eye(dim), (p, 1, 1)), np.zeros((p, dim))
    if kind != "truth":
        raise ValueError(f"unknown warm start {kind!r}")
    rng = np.random.default_rng(spec["perturb_seed"])
    dt = np.zeros((p, dim))
    dt[:, :2] = rng.uniform(-1, 1, (p, 2)) * spec["perturb_m"]
    turn = _turn_about_z(rng.uniform(-1, 1, p) * spec["perturb_rad"], dim)
    return turn @ gt_rot, gt_t + dt


def make(data: dict, traffic: dict, seed: int) -> dict:
    """The run's pairs: pairs (P, 2) long, warm starts rot0 (P, D, D) and
    t0 (P, D) and ground truth gt_rot, gt_t (float64), ``work`` (pairs a
    call) and the ``context`` the metric readers take (each pair's valid
    source and destination points).  Shuffles ``data``'s points in place
    where the traffic asks."""
    rng = np.random.default_rng(seed % (1 << 64))
    if traffic.get("shuffle_points"):
        pts = data["points"]
        for f, n in enumerate(data["mask"].sum(-1)):
            pts[f, :n] = pts[f, rng.permutation(n)]
    spec = traffic.get("pairs", {})
    gap = spec.get("gap", 1)
    first = np.arange(data["points"].shape[0] - gap)
    pairs = np.stack([first, first + gap], -1)
    gt_rot, gt_t = relative_truth(data, pairs)
    rot0, t0 = warm_starts(traffic.get("warm_start", {}), gt_rot, gt_t)
    if traffic.get("shuffle_pairs"):
        order = rng.permutation(len(pairs))
        pairs, gt_rot, gt_t = pairs[order], gt_rot[order], gt_t[order]
        rot0, t0 = rot0[order], t0[order]
    mask = data["mask"]
    f64 = torch.float64
    return dict(pairs=torch.as_tensor(pairs),
                rot0=torch.as_tensor(rot0, dtype=f64),
                t0=torch.as_tensor(t0, dtype=f64),
                gt_rot=torch.as_tensor(gt_rot, dtype=f64),
                gt_t=torch.as_tensor(gt_t, dtype=f64),
                work=len(pairs),
                context=dict(valid_src=mask[pairs[:, 0]].sum(-1),
                             valid_dst=mask[pairs[:, 1]].sum(-1)))
