"""Profiling and numeric-debug hooks (JAX package ``utils/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` capture of the enclosed block
  (host activity, plus the card's when one is present), written into
  ``log_dir`` as a Chrome trace (``*.pt.trace.json``; open it in
  ui.perfetto.dev or chrome://tracing).
- ``annotate(name)``: a named range of the host in that trace while a
  profiler records; otherwise nothing beyond one check of the profiler's
  flag.
- ``debug_mode()``: raise on NaN, the counterpart of ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile, \
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


_NO_RANGE = contextlib.nullcontext()


def annotate(name: str):
    """A named range of the calling thread in the profiler's timeline, on
    the profiler's clock that its device events share, while a torch
    profiler records; else a shared no-op context, so a span on a hot path
    costs one flag check when nothing records.  Ranges nest: a range's
    parent is the innermost one open around it.

    The range is a ``RecordFunction`` of function scope (the profiler's
    host event, as an op's): ``record_function``'s user scope would also
    lay a ``gpu_user_annotation`` over the device timeline from the first
    to the last kernel the range launches, which a trace reader takes for
    device work."""
    if torch.autograd.profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _NO_RANGE


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
