"""Checkpoint / resume for sequence processing (JAX package
``utils/checkpoint.py``).

The odometry/SLAM state is a flat dict of arrays (transforms, trajectory,
frame cursor) saved as an atomic npz every K frames and at phase
boundaries; resume = reload + seek.  Rerunning from the last checkpoint
reproduces the run bitwise (the engine is deterministic given its
(src, transform) state).  Tensors, on any device, are copied to host
numpy arrays before saving.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def _host(value) -> np.ndarray:
    """A numpy array of ``value``; a tensor is detached and moved to the
    CPU first."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def save_state(path: str, state: Dict[str, Any]) -> None:
    """state: flat dict of name -> array, tensor or scalar."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: _host(v) for k, v in state.items()})
    os.replace(tmp, path)


def load_state(path: str) -> Dict[str, np.ndarray] | None:
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class SequenceCheckpointer:
    """Every-K-frames checkpointing of an odometry/SLAM state dict."""

    def __init__(self, path: str, every: int = 10):
        self.path = path
        self.every = every

    def maybe_save(self, frame: int, state: Dict[str, Any]) -> bool:
        if frame % self.every != 0:
            return False
        self.save(frame, state)
        return True

    def save(self, frame: int, state: Dict[str, Any]) -> None:
        """Unconditional save: phase boundaries (odometry chain done, loop
        edges verified, graph solved) checkpoint whatever the every-K
        cadence."""
        state = dict(state)
        state["frame_cursor"] = np.asarray(frame)
        save_state(self.path, state)

    def restore(self) -> Dict[str, np.ndarray] | None:
        return load_state(self.path)
