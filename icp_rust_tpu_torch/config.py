"""Frozen configuration for the PyTorch/CUDA ICP engine.

The reference has no config system: every parameter is a hard-coded
constant.  ``REFERENCE_CONFIG`` reproduces it exactly:

- ``huber_k = 1.345``                 (reference src/lib.rs:32)
- ``mad_scale = 1.482602218505602``   (reference src/stats.rs:42, 1/PPF(0.75))
- ``inner_max_iter = 200``            (reference src/lib.rs:61)
- ``inner_delta_sq_tol = 1e-6``       (reference src/lib.rs:60,71)
- ``outer_iters = 20``                (reference examples/scan2d.rs:88)

Engine fields (no reference counterpart):

- ``point_scale``: coordinates are divided by this before the solve and the
  result is rescaled back (exact: Huber's k is co-scaled).
- ``compute_dtype``: ``torch.float32`` on the card, ``torch.float64`` for
  the CPU parity path.
- ``det_rel_eps``: relative singularity threshold of the 3x3 solve; 0.0 is
  the reference's exact ``det == 0`` test.
- ``nn_backend`` / ``align_backend``: ``"auto"`` | ``"torch"`` | ``"cuda"``.
  ``"torch"`` is the plain tensor path on any device; ``"cuda"`` the
  hand-written kernels (their plain versions on a CPU tensor); ``"auto"``
  takes the kernels for float32 and the plain path for float64.
- ``frame_backend``: ``"auto"`` runs a whole unbatched ``icp2d`` call as
  one kernel launch for scans of at most ``frame_kernel_max`` points;
  ``"pairs"`` forces the whole-frame kernels, the single-frame one for an
  unbatched call and the pair-frame one (one block per pair, each pair to
  its own fixed point) for a batch; ``"off"`` disables both.  ``"auto"``
  never takes the pair-frame kernel, as on the TPU.
- ``nn_method``: ``"direct"`` | ``"mxu"`` (``ops/nn.py``); the whole-frame
  kernels ignore it, as on the TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

BACKENDS = ("auto", "torch", "cuda")
FRAME_BACKENDS = ("auto", "off", "pairs")
NN_METHODS = ("direct", "mxu")


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    # Robust loss (reference src/lib.rs:32, src/huber.rs:6-26).
    huber_k: float = 1.345
    # MAD -> sigma conversion, 1/PPF(0.75) (reference src/stats.rs:42).
    mad_scale: float = 1.482602218505602

    # Inner Gauss-Newton loop (reference src/lib.rs:59-84).
    inner_max_iter: int = 200
    inner_delta_sq_tol: float = 1e-6

    # Outer ICP loop (reference src/lib.rs:105-130; examples use 20).
    outer_iters: int = 20

    compute_dtype: Any = torch.float32
    point_scale: float = 1.0
    det_rel_eps: float = 0.0
    # Pad point clouds to multiples of this.
    pad_multiple: int = 128
    nn_backend: str = "auto"
    # Distance evaluation: "direct" (exact per-coordinate differences) |
    # "mxu" (|q|^2 + |d|^2 - 2 q.d, the cross term a float32 matmul; on
    # "auto" it takes the plain sweep, see ops/nn.py).
    nn_method: str = "direct"
    # Query tile of the survivor-list kernel and db tile of the plain sweep;
    # the db is padded to a multiple of nn_dst_tile.
    nn_query_tile: int = 256
    nn_dst_tile: int = 2048
    # Spatial pre-sort: "auto" (Morton whenever the survivor-list kernel
    # serves the search) | "azimuth" | "morton" | "none".
    nn_sort: str = "auto"
    align_backend: str = "auto"
    frame_backend: str = "auto"
    frame_kernel_max: int = 1536

    def __post_init__(self):
        for name in ("nn_backend", "align_backend"):
            if getattr(self, name) not in BACKENDS:
                raise ValueError(
                    f"{name} must be one of {BACKENDS}, got "
                    f"{getattr(self, name)!r}")
        if self.frame_backend not in FRAME_BACKENDS:
            raise ValueError(
                f"frame_backend must be one of {FRAME_BACKENDS}, got "
                f"{self.frame_backend!r}")
        if self.nn_method not in NN_METHODS:
            raise ValueError(f"nn_method must be one of {NN_METHODS}, got "
                             f"{self.nn_method!r}")

    def with_(self, **kwargs) -> "ICPConfig":
        return dataclasses.replace(self, **kwargs)


# Exact reference parameters, float64 (reference is f64 throughout).
REFERENCE_CONFIG = ICPConfig(compute_dtype=torch.float64)


def resolve_device(device, dtype) -> torch.device:
    """The device an entry point runs on.  "cuda" needs a card: without
    one this raises (it never carries on on the CPU; pass device="cpu"
    for that).  The card runs float32 only: the float64 reference-parity
    config is a CPU path, as it is on the TPU.  On the card the geometry's
    float32 einsums must not run in TF32, which keeps about three decimal
    digits and makes the trajectory drift (the H100 analogue of the TPU's
    one-pass bf16 matmul)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dtype != torch.float32:
            raise ValueError(
                f"compute_dtype {dtype} does not run on the card; the "
                "float64 reference-parity config runs with device='cpu'")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 is True: the ICP "
                "geometry needs full float32 matmuls")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
