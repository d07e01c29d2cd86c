"""Profiling and numeric-debug hooks (JAX package ``utils/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` capture of the enclosed block
  (host activity, plus the card's when one is present), written into
  ``log_dir`` as a Chrome trace (``*.pt.trace.json``; open it in
  ui.perfetto.dev or chrome://tracing).
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``), and an NVTX range on the card.
- ``debug_mode()``: raise on NaN, the counterpart of ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function, \
    tensorboard_trace_handler
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed block into ``log_dir``; yields the
    ``torch.profiler.profile`` (its ``key_averages()`` sum by op and
    kernel).  Kernels launched through ctypes appear under their own
    names: the profiler records every launch on the card."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """A named region in profiler timelines (and NVTX on the card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class _NanCheck(TorchDispatchMode):
    """Raise FloatingPointError when an op returns a NaN float tensor."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in pytree.tree_leaves(out):
            if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                    and bool(torch.isnan(leaf).any())):
                raise FloatingPointError(
                    f"debug_mode: {func} returned NaN (shape "
                    f"{tuple(leaf.shape)}, dtype {leaf.dtype})")
        return out


@contextlib.contextmanager
def debug_mode():
    """NaN checking for every torch op in the scope (one host sync per op;
    debugging only); the previous dispatch state returns on exit.

    It checks NaN, not inf, as ``jax_debug_nans`` does: the ICP path
    carries +inf sentinels on purpose (masked points, unreached bounds).
    A CUDA kernel launched through ctypes is not a torch op: its outputs
    are checked where a torch op reads them."""
    with _NanCheck():
        yield
