"""ctypes bindings for the native C++ oracle (``native/src/icp_oracle.cpp``,
the JAX package's ``native/oracle.py`` counterpart): the reference crate's
``estimate_transform``, ``Icp2d``/``Icp3d::estimate`` and the
examples' odometry loops in float64, with a KD-tree 1-NN.  The library is
built with g++ at first use (``native/build.py``).  A transform travels
as six doubles, ``[r00, r01, r10, r11, tx, ty]``.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from icp_rust_tpu_torch.native import build

def _load():
    lib = build.load("icp_oracle")
    # Declared on every call: cheap, and idempotent.
    dp = ctypes.POINTER(ctypes.c_double)
    lib.estimate_transform_c.argtypes = [dp, dp, ctypes.c_int64, dp]
    lib.estimate_transform_c.restype = None
    for name in ("icp2d_estimate", "icp3d_estimate"):
        fn = getattr(lib, name)
        fn.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int64, dp,
                       ctypes.c_int64, dp]
        fn.restype = None
    return lib


def available() -> bool:
    """True when the library builds and loads here."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _points(x, dim: int) -> np.ndarray:
    """``x`` as a C-contiguous float64 (N, dim) array, checked before its
    pointer goes to C."""
    a = np.ascontiguousarray(x, dtype=np.float64)
    if a.ndim != 2 or a.shape[1] != dim:
        raise ValueError(f"expected an (N, {dim}) array, got {a.shape}")
    return a


def _rt(x) -> np.ndarray:
    a = np.ascontiguousarray(x, dtype=np.float64)
    if a.shape != (6,):
        raise ValueError(f"expected six doubles, got {a.shape}")
    return a


IDENTITY_RT = np.array([1.0, 0.0, 0.0, 1.0, 0.0, 0.0])


def rt_to_matrices(rt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return rt[:4].reshape(2, 2), rt[4:6]


def estimate_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    lib = _load()
    src = _points(src, 2)
    dst = _points(dst, 2)
    if len(dst) != len(src):
        raise ValueError("src and dst must pair up point by point")
    out = np.empty(6)
    lib.estimate_transform_c(_ptr(src), _ptr(dst), len(src), _ptr(out))
    return out


def icp2d_estimate(
    src: np.ndarray, dst: np.ndarray, init_rt: np.ndarray = IDENTITY_RT,
    max_iter: int = 20,
) -> np.ndarray:
    lib = _load()
    src = _points(src, 2)
    dst = _points(dst, 2)
    init = _rt(init_rt)
    out = np.empty(6)
    lib.icp2d_estimate(
        _ptr(src), len(src), _ptr(dst), len(dst), _ptr(init), max_iter,
        _ptr(out),
    )
    return out


def icp3d_estimate(
    src: np.ndarray, dst: np.ndarray, init_rt: np.ndarray = IDENTITY_RT,
    max_iter: int = 20,
) -> np.ndarray:
    lib = _load()
    src = _points(src, 3)
    dst = _points(dst, 3)
    init = _rt(init_rt)
    out = np.empty(6)
    lib.icp3d_estimate(
        _ptr(src), len(src), _ptr(dst), len(dst), _ptr(init), max_iter,
        _ptr(out),
    )
    return out


def _inverse_t(rt: np.ndarray) -> np.ndarray:
    rot, t = rt_to_matrices(rt)
    return -(rot.T @ t)


def run_odometry2d(frames: List[np.ndarray], max_iter: int = 20):
    """reference examples/scan2d.rs flow on the native oracle."""
    src = np.ascontiguousarray(frames[0], dtype=np.float64)
    rt = IDENTITY_RT.copy()
    rts, path = [], []
    for dst in frames[1:]:
        rt = icp2d_estimate(src, dst, rt, max_iter)
        rts.append(rt)
        path.append(_inverse_t(rt))
    return rts, np.asarray(path)


def run_odometry3d(frames: List[np.ndarray], max_iter: int = 20):
    src = np.ascontiguousarray(frames[0], dtype=np.float64)
    rt = IDENTITY_RT.copy()
    rts, path = [], []
    for dst in frames[1:]:
        rt = icp3d_estimate(src, dst, rt, max_iter)
        rts.append(rt)
        path.append(_inverse_t(rt))
    return rts, np.asarray(path)
