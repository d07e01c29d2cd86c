"""The judge of pair traffic: every distinct answer of the window against
the plain reference that the traffic names (``reference/<name>.py``, with
``solve`` and ``steps``), and the control, that reference in the
program's place.

Two numbers, each with the cell's limit (``cells/<workload>.json``):
``step``, the norm of the reference's next update at the answer, on every
answer judged; ``gap``, the answer against the reference's own answer from
the same warm start, on ``gap_pairs`` pairs drawn from the seed.  The
distance to the ground truth is printed, not judged."""

from __future__ import annotations

import importlib

import numpy as np
import torch

# Distinct answers judged a pair at most: each pair's most frequent answer,
# then a sample drawn from the seed.  A program that repeats itself gives
# one a pair.
MAX_ANSWERS_PER_PAIR = 4


def reference(traffic: dict):
    return importlib.import_module(
        f"bench_port.reference.{traffic['reference']}")


def unique_answers(rot, t):
    """The distinct answers of each pair over the calls: (pair index per
    answer, rot, t, calls that gave it)."""
    c, p = t.shape[:2]
    rows = torch.cat([rot.flatten(2), t], -1).contiguous()
    bits = rows.view(torch.int32)
    if bool((bits == bits[:1]).all()):
        return (torch.arange(p), rot[0], t[0],
                torch.full((p,), c, dtype=torch.long))
    which, ans, cnt = [], [], []
    for i in range(p):
        u, n = torch.unique(bits[:, i], dim=0, return_counts=True)
        which += [i] * len(u)
        ans.append(u.view(torch.float32))
        cnt.append(n)
    ans = torch.cat(ans)
    d = t.shape[-1]
    return (torch.tensor(which), ans[:, :d * d].reshape(-1, d, d),
            ans[:, d * d:], torch.cat(cnt).cpu())


def capped(which, n_calls, n_pairs: int, seed: int):
    """The answers judged, as indices: all of them, or where there are more
    than ``MAX_ANSWERS_PER_PAIR`` a pair on average, each pair's most
    frequent answer and a sample of the rest drawn from the seed."""
    cap = MAX_ANSWERS_PER_PAIR * n_pairs
    if len(which) <= cap:
        return torch.arange(len(which))
    first = torch.zeros(len(which), dtype=torch.bool)
    for i in range(n_pairs):
        idx = torch.nonzero(which == i)[:, 0]
        first[idx[torch.argmax(n_calls[idx])]] = True
    rest = np.flatnonzero(~first.numpy())
    pick = np.random.default_rng(seed % (1 << 64)).choice(
        rest, cap - int(first.sum()), replace=False)
    first[torch.as_tensor(pick)] = True
    return torch.nonzero(first)[:, 0]


def judge(answers, data, inputs: dict, ctx: dict, seed: int, device):
    """(checks, failed answers counted by the calls that gave them,
    information)."""
    cfg, lim = ctx["config"], ctx["limits"]
    ref = reference(ctx["traffic"])
    pairs, rot0, t0 = inputs["pairs"], inputs["rot0"], inputs["t0"]
    which, rot, t, n_calls = unique_answers(*answers)
    keep = capped(which, n_calls, len(pairs), seed)
    which, rot, t, n_calls = which[keep], rot[keep], t[keep], n_calls[keep]
    f64 = torch.float64
    step = ref.steps(data, pairs, which, rot, t, cfg["icp"],
                     cfg.get("normals", {}), device).cpu()
    n_gap = min(lim["gap_pairs"], len(pairs))
    sample = np.sort(np.random.default_rng(seed % (1 << 64)).choice(
        len(pairs), n_gap, replace=False))
    r_ref, t_ref = ref.solve(data, pairs[sample], rot0[sample], t0[sample],
                             cfg["icp"], cfg.get("normals", {}), f64, device)
    slot = torch.full((len(pairs),), -1, dtype=torch.long)
    slot[torch.as_tensor(sample)] = torch.arange(n_gap)
    s = slot[which]
    on = s >= 0
    gap = torch.full((len(which),), float("nan"), dtype=f64)
    gap[on] = torch.maximum(
        torch.linalg.norm(t[on].cpu().to(f64) - t_ref.cpu()[s[on]], dim=-1),
        (rot[on].cpu().to(f64) - r_ref.cpu()[s[on]]).abs().amax((-1, -2)))
    ate = torch.linalg.norm(t.cpu().to(f64) - inputs["gt_t"][which], dim=-1)
    bad = ~(step <= lim["limits"]["step"])
    bad |= on & ~(gap <= lim["limits"]["gap"])
    checks = {"gap": {"value": float(gap[on].max()),
                      "limit": lim["limits"]["gap"]},
              "step": {"value": float(step.max()),
                       "limit": lim["limits"]["step"]}}
    info = dict(answers=len(which), pairs_compared=n_gap,
                ground_truth_t_err_max_m=float(ate.max()))
    return checks, int(n_calls[bad].sum()), info


def control(data, inputs: dict, ctx: dict, dtype, device):
    """The reference in the program's place, computed in ``dtype``: its
    answers as one call's, (rot (1, P, D, D), t (1, P, D)) in float32."""
    cfg = ctx["config"]
    r, t = reference(ctx["traffic"]).solve(
        data, inputs["pairs"], inputs["rot0"], inputs["t0"], cfg["icp"],
        cfg.get("normals", {}), dtype, device)
    return r.float()[None], t.float()[None]
