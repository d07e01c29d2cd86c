"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` at first use into a shared library with
a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v --fmad=false -o lib<name>-<hash>.so

No ``-use_fast_math``: ``sinf``/``cosf``/``sqrtf`` and division keep their
IEEE semantics.  ``--fmad=false`` keeps every multiply and add rounded on
its own, as the plain PyTorch versions' elementwise ops are: nn_list is
compared with its plain version bitwise, and the solver kernels then differ
from theirs only in the order of their sums.  The library name carries a
hash of the sources and flags, so an edited kernel is rebuilt and a stale
one never loads.  The build directory is ``icp_rust_tpu_torch/_build/``
(listed in ``.gitignore``).

``LAUNCHES`` counts the launches of each kernel: every wrapper adds one
right where it launches its kernel, and nowhere else.

``launcher(name)`` is the one place that knows each library's C
interface: every pointer and the stream go as ``c_void_p``, every int as
``c_int``, every float as ``c_float``, and each entry point returns
``cudaGetLastError()`` as an int.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

SOURCES = ("nn_list", "irls_loop", "icp2d_frame", "nn_pairs",
           "nn_pairs_list", "irls_loop_batched", "icp2d_frame_pairs",
           "p2l_loop", "p2l_stats", "nn_sweep", "nn_matched",
           "nn_pruned", "gn_stats", "gn_stats_batched")
# Every header is hashed into every library's name, so an edited header
# rebuilds whatever includes it.
HEADERS = ("irls.cuh", "frame.cuh", "nn_pairs.cuh", "p2l.cuh",
           "nn_sweep.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--fmad=false")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> (C entry point, argument types); see csrc/<name>.cu.
_SIGNATURES = {
    # query, dbf_cm, lists, cnt, dist, idx, pay; n_tiles, q_tile, d_dim,
    # f_dim, m_pad, cap; stream
    "nn_list": ("nn_list_launch", [_P] * 7 + [_I] * 6 + [_P]),
    # sx, sy, dx, dy, mask; n; scratch, out; solver params; stream
    "irls_loop": ("irls_loop_launch",
                  [_P] * 5 + [_I] + [_P] * 2 + [_F] * 5 + [_I] + [_F] * 2
                  + [_P]),
    # src, smask, dst; n, m; t0, out; solver params; outer_iters, stream
    "icp2d_frame": ("icp2d_frame_launch",
                    [_P] * 3 + [_I] * 2 + [_P] * 2 + [_F] * 5 + [_I]
                    + [_F] * 2 + [_I, _P]),
    # query, dbf_cm, qbox, cbox, qbound, dist, idx, pay; b, qp, q_sub,
    # d_dim, f_dim, m_pad; stream
    "nn_pairs": ("nn_pairs_launch", [_P] * 8 + [_I] * 6 + [_P]),
    # query, dbf_cm, lists, cnt, dist, idx, pay; b, qp, q_sub, d_dim,
    # f_dim, m_pad, cap; stream
    "nn_pairs_list": ("nn_pairs_list_launch", [_P] * 7 + [_I] * 7 + [_P]),
    # sx, sy, dx, dy, mask; b, n; scratch, out; solver params; stream
    "irls_loop_batched": ("irls_loop_batched_launch",
                          [_P] * 5 + [_I] * 2 + [_P] * 2 + [_F] * 5 + [_I]
                          + [_F] * 2 + [_P]),
    # src, smask, dst; b, n, m; t0, out; solver params; outer_iters, stream
    "icp2d_frame_pairs": ("icp2d_frame_pairs_launch",
                          [_P] * 3 + [_I] * 3 + [_P] * 2 + [_F] * 5 + [_I]
                          + [_F] * 2 + [_I, _P]),
    # sx sy sz dx dy dz nx ny nz mask; n; scratch, out; huber_k, k2, two_k,
    # tol_d2; max_iter; s2, small_angle; stream
    "p2l_loop": ("p2l_loop_launch",
                 [_P] * 10 + [_I] + [_P] * 2 + [_F] * 4 + [_I] + [_F] * 2
                 + [_P]),
    # sx sy sz dx dy dz nx ny nz mask; n; rt, scratch, out; huber_k, k2,
    # two_k; stream
    "p2l_stats": ("p2l_stats_launch",
                  [_P] * 10 + [_I] + [_P] * 3 + [_F] * 3 + [_P]),
    # query, db_cm, dist, idx; b, qp, d_dim, m_pad; stream
    "nn_sweep": ("nn_sweep_launch", [_P] * 4 + [_I] * 4 + [_P]),
    # query, dbf_cm, dist, idx, pay; b, qp, d_dim, f_dim, m_pad; stream
    "nn_matched": ("nn_matched_launch", [_P] * 5 + [_I] * 5 + [_P]),
    # query, dbf_cm, qbox, bbox, qb_tile, dist, idx, pay; qp, q_tile,
    # db_tile, d_dim, f_dim, m_pad; stream
    "nn_pruned": ("nn_pruned_launch", [_P] * 8 + [_I] * 6 + [_P]),
    # sx, sy, dx, dy, mask; n; rt, scratch, out; huber_k, k2, two_k; stream
    "gn_stats": ("gn_stats_launch",
                 [_P] * 5 + [_I] + [_P] * 3 + [_F] * 3 + [_P]),
    # sx, sy, dx, dy, mask; b, n; rt, scratch, out; huber_k, k2, two_k;
    # stream
    "gn_stats_batched": ("gn_stats_batched_launch",
                         [_P] * 5 + [_I] * 2 + [_P] * 3 + [_F] * 3 + [_P]),
}

LAUNCHES = {name: 0 for name in SOURCES}

_launchers: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from csrc/ at first "
        "use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / src).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    return [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together.  Returns
    {name: ptxas report} for the sources compiled by this call."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def launcher(name: str):
    """The C entry point of one kernel's library, built and loaded at
    first use, with its argument and return types declared."""
    fn = _launchers.get(name)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        entry, argtypes = _SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _launchers[name] = fn
    return fn


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")
