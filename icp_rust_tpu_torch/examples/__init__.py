"""Demos of the reference examples' flows on the port (the counterparts of
the repository's ``examples/scan2d.py`` and ``scan3d.py``):
``python -m icp_rust_tpu_torch.examples.scan2d`` and ``.scan3d``."""
