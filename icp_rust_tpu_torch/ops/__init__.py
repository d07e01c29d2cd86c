"""Robust statistics, Gauss-Newton solver, nearest-neighbor search and
the CUDA kernels under them."""
