"""ctypes bindings for the native C++ scan loader
(``native/src/scan_loader.cpp``; the JAX package's ``native/loader.py``
counterpart).

Loads a whole directory of 2D scans in the reference's text format
(``NNN.txt``, one "x y" pair a line; examples/scan2d.rs:10-34) into one
padded (F, pad, 2) float32 block and an (F, pad) bool mask in a single
native call: the layout the device upload wants.  The library is built
with g++ at first use (``native/build.py``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from icp_rust_tpu_torch.native import build


def _load():
    lib = build.load("scan_loader")
    # Declared on every call: cheap, and idempotent.
    lib.scan2d_open.restype = ctypes.c_void_p
    lib.scan2d_open.argtypes = [ctypes.c_char_p]
    lib.scan2d_num_frames.restype = ctypes.c_int64
    lib.scan2d_num_frames.argtypes = [ctypes.c_void_p]
    lib.scan2d_max_points.restype = ctypes.c_int64
    lib.scan2d_max_points.argtypes = [ctypes.c_void_p]
    lib.scan2d_fill.restype = None
    lib.scan2d_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
    lib.scan2d_close.restype = None
    lib.scan2d_close.argtypes = [ctypes.c_void_p]
    return lib


def load_scan2d_padded(directory: str, limit: int | None = None,
                       pad_multiple: int = 128
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Load the ``*.txt`` frames of ``directory`` in name order, padded to
    a multiple of ``pad_multiple``.  Returns (points (F, pad, 2) float32,
    mask (F, pad) bool)."""
    lib = _load()
    names = sorted(f for f in os.listdir(directory) if f.endswith(".txt"))
    if limit is not None:
        names = names[:limit]
    joined = "\n".join(os.path.join(directory, n) for n in names)
    handle = lib.scan2d_open(joined.encode())
    if not handle:
        raise IOError(f"native loader failed on {directory}")
    try:
        f = lib.scan2d_num_frames(handle)
        mx = lib.scan2d_max_points(handle)
        pad = -(-int(mx) // pad_multiple) * pad_multiple
        pts = np.empty((f, pad, 2), dtype=np.float32)
        mask = np.empty((f, pad), dtype=np.uint8)
        lib.scan2d_fill(
            handle, pad,
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    finally:
        lib.scan2d_close(handle)
    return pts, mask.astype(bool)
