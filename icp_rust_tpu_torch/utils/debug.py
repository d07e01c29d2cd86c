"""Numeric-safety and drift-gate utilities (JAX package
``utils/debug.py``).

- ``assert_all_finite``: scan every leaf of a tree of tensors and arrays
  (``torch.utils._pytree``; a dataclass such as ``RigidTransform2`` is
  opened into its fields) and raise on NaN/Inf.
- ``checked``: wrap a function so its outputs are scanned on the way out
  (one host sync).
- ``drift_gate``: run the same computation under a fast config and the
  float64 reference config and raise if the first result drifts apart.
- ``deterministic_repeat``: run a function again and raise unless every
  output is bitwise the same.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _leaves(tree) -> list:
    """Leaves of ``tree`` as host numpy arrays, dataclasses opened."""
    out = []
    for leaf in pytree.tree_leaves(tree):
        if dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            out += _leaves([getattr(leaf, f.name)
                            for f in dataclasses.fields(leaf)])
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf.detach().cpu().numpy())
        else:
            out.append(np.asarray(leaf))
    return out


def assert_all_finite(tree, name: str = "value") -> None:
    """Raise FloatingPointError if any floating leaf holds NaN/Inf."""
    for i, arr in enumerate(_leaves(tree)):
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad} non-finite element(s) "
                f"(shape {arr.shape}, dtype {arr.dtype})")


def checked(fn: Callable) -> Callable:
    """Return a wrapper that runs ``fn`` and raises on non-finite outputs
    (the check reads the outputs back to the host: one sync)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_all_finite(out, name=getattr(fn, "__name__", "output"))
        return out

    return wrapper


def drift_gate(run: Callable[[object], tuple], config_fast, config_ref,
               atol: float, name: str = "drift") -> float:
    """Run ``run(config)`` under the fast config and the float64 reference
    config; raise AssertionError unless the first returned value agrees
    within ``atol``, and return the largest absolute drift."""
    fast = _leaves(run(config_fast)[0])[0].astype(np.float64)
    ref = _leaves(run(config_ref)[0])[0].astype(np.float64)
    drift = float(np.max(np.abs(fast - ref)))
    if drift > atol:
        raise AssertionError(
            f"{name}: f32-vs-f64 drift {drift:.3e} exceeds atol {atol:.3e}")
    return drift


def deterministic_repeat(fn: Callable, *args, repeats: int = 3):
    """Run ``fn(*args)`` ``repeats`` times and raise AssertionError unless
    every output leaf is bitwise identical (NaN equal to NaN); returns the
    first run's leaves as host arrays."""
    first = _leaves(fn(*args))
    for _ in range(repeats - 1):
        again = _leaves(fn(*args))
        if len(again) != len(first) or not all(
                a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
                for a, b in zip(first, again)):
            raise AssertionError("nondeterministic output detected")
    return first
