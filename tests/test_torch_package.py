"""Rules of the PyTorch/CUDA port (icp_rust_tpu_torch): it imports neither
JAX nor the JAX package, imports with no card and no CUDA toolkit, and its
entry points never carry on on the CPU unless asked to.  Also checks
convert.py, which carries the JAX package's config and transforms over."""

import ast
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.config import ICPConfig as JaxConfig
from icp_rust_tpu.config import REFERENCE_CONFIG as JAX_REFERENCE
from icp_rust_tpu_torch import convert
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models import icp2d as m_icp
from icp_rust_tpu_torch.models.icp_p2l import icp_point_to_plane
from icp_rust_tpu_torch.models.odometry import run_odometry_fused, \
    run_odometry_p2l_fused
from icp_rust_tpu_torch.models.slam import run_slam2d, run_slam3d
from icp_rust_tpu_torch.models.submap import run_submap_odometry
from icp_rust_tpu_torch.ops import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "icp_rust_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "icp_rust_tpu" or name.startswith("icp_rust_tpu."))


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


@pytest.mark.parametrize("name,want", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", False),
    ("icp_rust_tpu", True), ("icp_rust_tpu.ops.nn", True),
    ("icp_rust_tpu_torch", False), ("icp_rust_tpu_torch.ops", False),
])
def test_forbidden_import_names(name, want):
    assert _forbidden(name) is want


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import icp_rust_tpu_torch\n"
        "import icp_rust_tpu_torch.convert, icp_rust_tpu_torch.models.odometry\n"
        "import icp_rust_tpu_torch.ops.nn_cuda, icp_rust_tpu_torch.ops.align2d_cuda\n"
        "import icp_rust_tpu_torch.ops.align3d_cuda, icp_rust_tpu_torch.ops.normals\n"
        "import icp_rust_tpu_torch.models.icp_p2l, icp_rust_tpu_torch.geometry\n"
        "import icp_rust_tpu_torch.utils.io, icp_rust_tpu_torch.ops.nn_sweep_cuda\n"
        "import icp_rust_tpu_torch.models.slam, icp_rust_tpu_torch.models.pose_graph\n"
        "import icp_rust_tpu_torch.utils.checkpoint\n"
        "import icp_rust_tpu_torch.models.submap, icp_rust_tpu_torch.ops.voxel\n"
        "import icp_rust_tpu_torch.ops.voxel_hash, icp_rust_tpu_torch.utils.metrics\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'icp_rust_tpu' or m.startswith('icp_rust_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is moot")


def _pair3d(n=256):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, (n, 3))
    return pts, np.ones(n, bool)


@pytest.mark.parametrize("entry", ["icp2d", "icp3d_planar", "odometry",
                                   "icp_point_to_plane", "odometry_p2l",
                                   "slam2d", "slam3d", "submap"])
def test_entry_points_raise_without_a_card(entry):
    _no_card()
    pts, mask = _pair3d()
    t0 = RigidTransform2.identity(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "icp2d":
            m_icp.icp2d(pts[:, :2], pts[:, :2], mask, mask, t0)
        elif entry == "icp3d_planar":
            m_icp.icp3d_planar(pts, pts, mask, mask, t0)
        elif entry == "icp_point_to_plane":
            icp_point_to_plane(pts, pts, mask, mask, RigidTransform3.identity())
        elif entry == "odometry_p2l":
            run_odometry_p2l_fused(np.stack([pts, pts]),
                                   np.stack([mask, mask]))
        elif entry == "slam2d":
            run_slam2d([pts[:, :2], pts[:, :2]])
        elif entry == "slam3d":
            run_slam3d([pts, pts])
        elif entry == "submap":
            run_submap_odometry(np.stack([pts, pts]), np.stack([mask, mask]))
        else:
            run_odometry_fused(np.stack([pts, pts]), np.stack([mask, mask]))


def test_entry_point_runs_on_cpu_when_asked():
    pts, mask = _pair3d()
    t0 = RigidTransform2.identity(dtype=torch.float32)
    cfg = ICPConfig(nn_backend="torch", align_backend="torch")
    t = m_icp.icp3d_planar(pts, pts, mask, mask, t0, cfg, device="cpu")
    assert t.rot.device.type == "cpu"
    # A perfect fit is degenerate (sigma 0): the warm start comes back.
    assert torch.equal(t.rot, torch.eye(2))


def test_chip_smoke_fails_without_a_card():
    _no_card()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_build_needs_no_toolkit_until_launch():
    # The sources are hashed without nvcc; nothing is compiled on import.
    # Every TPU kernel has its counterpart: 14 sources.
    assert len(cuda_build.SOURCES) == 14
    for name in cuda_build.SOURCES:
        path = cuda_build._lib_path(name)
        assert path.parent == cuda_build.BUILD_DIR
        assert os.path.exists(cuda_build.CSRC / f"{name}.cu")
    assert set(cuda_build.LAUNCHES) == set(cuda_build.SOURCES)


@pytest.mark.parametrize("backend,want", [
    ("auto", "auto"), ("xla", "torch"), ("pallas", "cuda")])
def test_config_from_fields_maps_backends(backend, want):
    jcfg = JaxConfig(nn_backend=backend, align_backend=backend,
                     compute_dtype=jnp.float32, point_scale=2.5)
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    assert cfg.nn_backend == want and cfg.align_backend == want
    assert cfg.compute_dtype == torch.float32
    assert cfg.point_scale == 2.5
    assert cfg.frame_kernel_max == 1536


def test_config_from_fields_reference_config():
    cfg = convert.config_from_fields(dataclasses.asdict(JAX_REFERENCE))
    assert cfg.compute_dtype == torch.float64
    for f in ("huber_k", "mad_scale", "inner_max_iter", "inner_delta_sq_tol",
              "outer_iters", "det_rel_eps", "nn_query_tile", "nn_dst_tile"):
        assert getattr(cfg, f) == getattr(REFERENCE_CONFIG, f)
    assert convert.config_from_fields(
        {"frame_backend": "pairs"}).frame_backend == "pairs"
    with pytest.raises(ValueError):
        convert.config_from_fields({"frame_backend": "bogus"})


def test_transform_from_numpy_keeps_dtype():
    rot = np.eye(2)
    t = convert.transform_from_numpy(rot, np.array([1.0, 2.0]))
    assert t.dtype == torch.float64 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.t.numpy(), [1.0, 2.0])


def test_float64_never_reaches_the_card():
    from icp_rust_tpu_torch.config import resolve_device

    assert resolve_device("cpu", torch.float64).type == "cpu"
    with pytest.raises(ValueError, match="float64"):
        resolve_device("cuda", torch.float64)
    pts, mask = _pair3d()
    with pytest.raises(ValueError, match="float64"):
        run_odometry_fused(np.stack([pts, pts]), np.stack([mask, mask]),
                           REFERENCE_CONFIG)
