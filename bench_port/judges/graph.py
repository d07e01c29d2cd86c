"""The judge of pose-graph traffic: every distinct answer of the window
against the plain reference that the traffic names
(``reference/<name>.py``, with ``solve`` and ``step``), and the control,
that reference in the program's place.

Two numbers, each with the cell's limit (``cells/<workload>.json``):
``gap``, the largest over poses of |t - t_ref| (m) and the angle of
R^T R_ref (rad), against the reference's own answer from the same initial
guess; ``step``, the norm of the reference's next Gauss-Newton step from
the answer.  An answer that fails fails every call that gave it, each
with all of the graph's edges.  The error to the true poses (ATE, the
root mean square of |t - t_true|) is printed, not judged."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from bench_port.inputs.graph import EDGE_KEYS

# Distinct answers judged at most: the most frequent, then a sample drawn
# from the seed.  The assembly's atomic adds in no fixed order make each
# call's answer differ in the last bits.
MAX_ANSWERS = 3


def reference(traffic: dict):
    return importlib.import_module(
        f"bench_port.reference.{traffic['reference']}")


def graph_on(inputs: dict, dtype, device) -> dict:
    """The run's edges on ``device``, the measurements in ``dtype``."""
    return {k: (v.to(device) if v.dtype == torch.int64
                else v.to(device=device, dtype=dtype))
            for k, v in ((k, inputs[k]) for k in EDGE_KEYS)}


def unique_answers(rot, t):
    """(rot (U, P, 3, 3), t (U, P, 3), calls that gave each) of the distinct
    answers over the calls, by their bits."""
    c = t.shape[0]
    rows = torch.cat([rot.reshape(c, -1), t.reshape(c, -1)], -1)
    u, inv, n = torch.unique(rows.contiguous().view(torch.int64), dim=0,
                             return_inverse=True, return_counts=True)
    first = [int(torch.nonzero(inv == k)[0, 0]) for k in range(len(u))]
    return rot[first], t[first], n.cpu()


def capped(n_calls, seed: int):
    """The answers judged, as indices: all, or the most frequent and a
    sample of the rest drawn from the seed."""
    if len(n_calls) <= MAX_ANSWERS:
        return np.arange(len(n_calls))
    top = int(torch.argmax(n_calls))
    rest = np.delete(np.arange(len(n_calls)), top)
    pick = np.random.default_rng(seed % (1 << 64)).choice(
        rest, MAX_ANSWERS - 1, replace=False)
    return np.sort(np.concatenate([[top], pick]))


def judge(answers, data, inputs: dict, ctx: dict, seed: int, device):
    """(checks, failed edges counted over the calls, information)."""
    cfg, lim = ctx["config"]["graph"], ctx["limits"]["limits"]
    ref = reference(ctx["traffic"])
    f64 = torch.float64
    rot, t, n_calls = unique_answers(*answers)
    keep = capped(n_calls, seed)
    graph = graph_on(inputs, f64, device)
    r_ref, t_ref = ref.solve(graph, inputs["rot0"].to(device),
                             inputs["t0"].to(device), cfg)
    k = ref.robust_k(cfg)
    gt_t = inputs["gt_t"].to(device)

    def ate(tt):
        return float(torch.sqrt(((tt.to(device, f64) - gt_t) ** 2)
                                .sum(-1).mean()))

    gaps, steps, ates = [], [], []
    for a in keep:
        ra, ta = rot[a].to(device, f64), t[a].to(device, f64)
        gaps.append(float(torch.maximum(
            torch.linalg.vector_norm(ta - t_ref, dim=-1),
            ref.angle(ra.transpose(-1, -2) @ r_ref)).max()))
        steps.append(float(torch.linalg.vector_norm(
            ref.step(ra, ta, graph, k))))
        ates.append(ate(ta))
    gaps, steps = np.array(gaps), np.array(steps)
    bad = ~(gaps <= lim["gap"]) | ~(steps <= lim["step"])
    checks = {"gap": {"value": float(gaps.max()), "limit": lim["gap"]},
              "step": {"value": float(steps.max()), "limit": lim["step"]}}
    info = dict(answers=len(n_calls), answers_judged=len(keep),
                ate_rmse_m=max(ates), ate_rmse_m_reference=ate(t_ref),
                ate_rmse_m_guess=ate(inputs["t0"]))
    failed = int(n_calls[torch.as_tensor(keep)][torch.as_tensor(bad)].sum())
    return checks, failed * inputs["work"], info


def control(data, inputs: dict, ctx: dict, dtype, device):
    """The reference in the program's place, computed in ``dtype`` (float32,
    the precision below the configuration's float64: ``control.py --dtype
    float32``): its answer as one call's, (rot (1, P, 3, 3), t (1, P, 3))
    in float64."""
    graph = graph_on(inputs, dtype, device)
    r, t = reference(ctx["traffic"]).solve(
        graph, inputs["rot0"].to(device, dtype),
        inputs["t0"].to(device, dtype), ctx["config"]["graph"])
    return r.double()[None], t.double()[None]
