"""icp_rust_tpu_torch: the ICP engine in PyTorch, with CUDA kernels for
NVIDIA Hopper (H100).

A port of ``icp_rust_tpu`` (JAX/Pallas on a TPU), which stays the
reference: module names match it (``config``, ``geometry``, ``ops``,
``models``, ``utils``), and each part is held against its counterpart by
the tests in ``tests/test_torch_*.py``.  This package imports torch,
numpy and scipy (the numpy oracle) only; ``h5py`` and ``matplotlib`` are
imported where the HDF5 reader and the plots need them.

The kernels (``csrc/*.cu``) are built by ``nvcc`` at first use
(``ops/cuda_build.py``); importing the package needs neither a card nor
the CUDA toolkit.  Entry points (``models.icp2d.icp2d``,
``icp3d_planar``, ``models.odometry.run_odometry_fused``,
``run_odometry_device``; the CLI, ``python -m icp_rust_tpu_torch.cli``)
run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from icp_rust_tpu_torch.config import ICPConfig, REFERENCE_CONFIG

__all__ = ["ICPConfig", "REFERENCE_CONFIG", "__version__"]
