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
from icp_rust_tpu_torch.models.odometry import run_odometry, \
    run_odometry_device, run_odometry_fused, run_odometry_p2l, \
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


# The drivers' stack points one way: entries, then models/driver, then
# ops/ (the NN route and index, the solvers), the kernel wrappers and
# csrc/; geometry/ and utils/ sit under all of them.
_LOWER = ("ops", "geometry", "utils")
_UPPER = ("icp_rust_tpu_torch.models", "icp_rust_tpu_torch.parallel")


def _under(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


def _layer_violations(layer: str, source: str) -> list:
    """Imports of a module in package directory ``layer`` that break the
    layering, function-level ones included: from ops/, geometry/ or
    utils/, anything of models/ or parallel/; from anywhere, a
    ``_``-prefixed name of models/."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            pairs = [(a.name, None) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            pairs = [(node.module or "", a.name) for a in node.names]
        else:
            continue
        for mod, name in pairs:
            full = mod if name is None else f"{mod}.{name}"
            upward = layer in _LOWER and any(
                _under(n, u) for n in (mod, full) for u in _UPPER)
            private = (name is not None and name.startswith("_")
                       and _under(mod, "icp_rust_tpu_torch.models"))
            if upward or private:
                bad.append(f"{node.lineno} {full}")
    return bad


def test_layers_import_one_way():
    bad = []
    for path in _port_files():
        layer = os.path.relpath(path, PKG).split(os.sep)[0]
        with open(path) as f:
            bad += [f"{path}:{v}" for v in _layer_violations(layer, f.read())]
    assert not bad, bad


@pytest.mark.parametrize("layer,source,want", [
    ("ops", "def f():\n    from icp_rust_tpu_torch.models import icp2d\n",
     True),
    ("utils", "from icp_rust_tpu_torch import parallel\n", True),
    ("geometry", "import icp_rust_tpu_torch.models.driver\n", True),
    ("parallel", "from icp_rust_tpu_torch.models.icp2d import _icp_loop\n",
     True),
    ("models", "from icp_rust_tpu_torch.models.driver import prepare\n",
     False),
    ("ops", "from icp_rust_tpu_torch.ops.nn_cuda import _SENTINEL\n", False),
])
def test_layer_rule_flags_upward_and_private_imports(layer, source, want):
    assert bool(_layer_violations(layer, source)) is want


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
        "import icp_rust_tpu_torch.cli, icp_rust_tpu_torch.models.graph_schur\n"
        "import icp_rust_tpu_torch.utils.debug, icp_rust_tpu_torch.utils.profiling\n"
        "import icp_rust_tpu_torch.utils.oracle_np, icp_rust_tpu_torch.native.oracle\n"
        "import icp_rust_tpu_torch.native.loader, icp_rust_tpu_torch.examples.scan2d\n"
        "import icp_rust_tpu_torch.examples.scan3d\n"
        "import icp_rust_tpu_torch.parallel.mesh, icp_rust_tpu_torch.parallel.collectives\n"
        "import icp_rust_tpu_torch.ops.collectives\n"
        "import icp_rust_tpu_torch.parallel.ring_nn, icp_rust_tpu_torch.parallel.sharded\n"
        "import icp_rust_tpu_torch.parallel.dist_graph, icp_rust_tpu_torch.parallel.dryrun\n"
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
                                   "slam2d", "slam3d", "submap",
                                   "run_odometry", "odometry_device",
                                   "odometry_p2l_device"])
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
        elif entry == "run_odometry":
            run_odometry([pts, pts])
        elif entry == "odometry_device":
            run_odometry_device(np.stack([pts, pts]), np.stack([mask, mask]))
        elif entry == "odometry_p2l_device":
            run_odometry_p2l(np.stack([pts, pts]), np.stack([mask, mask]))
        else:
            run_odometry_fused(np.stack([pts, pts]), np.stack([mask, mask]))


@pytest.fixture
def cuda_mesh_without_card(tmp_path):
    """A one-rank mesh that says "cuda" on a machine without a card: a
    one-rank gloo world in this process and a CPU mesh whose device type
    is set to "cuda" (make_mesh itself refuses to build one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _no_card()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rv",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "sp"))
        mesh._device_type = "cuda"
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("entry", [
    "sharded_estimate_transform", "sharded_icp2d", "dp_sp_icp2d",
    "dp_sp_icp3d_planar", "dp_sp_icp_p2l", "batched_icp2d",
    "optimize_distributed", "optimize_schur"])
def test_sharded_entry_points_raise_without_a_card(entry,
                                                   cuda_mesh_without_card):
    from icp_rust_tpu_torch.models import pose_graph as pg
    from icp_rust_tpu_torch.models.graph_schur import optimize_schur
    from icp_rust_tpu_torch.parallel import dist_graph, sharded

    mesh = cuda_mesh_without_card
    pts, mask = _pair3d(64)
    cfg = ICPConfig()
    b3, bm = np.stack([pts, pts]), np.stack([mask, mask])
    t2 = RigidTransform2.identity((2,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "sharded_estimate_transform":
            sharded.sharded_estimate_transform(pts[:, :2], pts[:, :2], mask,
                                               cfg, mesh)
        elif entry == "sharded_icp2d":
            sharded.sharded_icp2d(pts[:, :2], pts[:, :2], mask, mask,
                                  RigidTransform2.identity(), cfg, mesh)
        elif entry in ("dp_sp_icp2d", "batched_icp2d"):
            getattr(sharded, entry)(b3[..., :2], b3[..., :2], bm, bm, t2,
                                    cfg, mesh=mesh)
        elif entry == "dp_sp_icp3d_planar":
            sharded.dp_sp_icp3d_planar(b3, b3, bm, bm, t2, cfg, mesh)
        elif entry == "dp_sp_icp_p2l":
            sharded.dp_sp_icp_p2l(b3, b3, bm, bm,
                                  RigidTransform3.identity((2,)), cfg, mesh)
        else:
            graph = pg.odometry_chain_graph(RigidTransform2.from_twist(
                torch.tensor([[1.0, 0.0, 0.1]] * 4, dtype=torch.float64)))
            if entry == "optimize_distributed":
                dist_graph.optimize_distributed(graph, mesh, iters=1)
            else:
                optimize_schur(graph, iters=1, mesh=mesh)


def test_make_mesh_and_spawn_raise_without_a_card():
    """``make_mesh``, ``spawn``, ``dryrun_programs`` and
    ``dryrun_multichip`` with their default device type, and a world of
    ranks asked for on the card."""
    _no_card()
    from icp_rust_tpu_torch.parallel import dryrun, make_mesh

    for call in (make_mesh, dryrun.dryrun_multichip, dryrun.dryrun_programs,
                 lambda: dryrun.spawn(print, 1),
                 lambda: dryrun.dryrun_multichip(4, "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


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


def _scan_dir(tmp_path, n=3):
    rng = np.random.default_rng(0)
    for k in range(n):
        np.savetxt(tmp_path / f"{k:03d}.txt", rng.uniform(-3, 3, (64, 2)))
    return str(tmp_path)


@pytest.mark.parametrize("argv", [
    ["odometry2d", "--f32"], ["odometry2d", "--f32", "--device", "cuda"],
    ["slam", "--f32"]])
def test_cli_and_examples_raise_without_a_card(tmp_path, argv):
    """The CLI's float32 runs and the examples default to the card."""
    _no_card()
    from icp_rust_tpu_torch import cli
    from icp_rust_tpu_torch.examples import scan2d, scan3d

    scans = _scan_dir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([*argv, "--scans", scans])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scan2d.main(["--scans", scans])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scan3d.main(["--frames", "2"])


@pytest.mark.parametrize("argv", [
    ["odometry2d", "--scans", "."], ["odometry3d", "--hdf5", "x.hdf5"],
    ["slam", "--scans", "."], ["slam3d", "--hdf5", "x.hdf5"]])
def test_cli_without_device_refuses_float64_on_the_card(argv):
    """Every command runs on the card unless given ``--device cpu``, and
    there takes float32 only: without ``--f32`` it exits with guidance
    before it reads a scan."""
    _no_card()
    from icp_rust_tpu_torch import cli

    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(argv)


def test_cli_needs_neither_h5py_nor_matplotlib():
    """``import icp_rust_tpu_torch.cli`` (and the modules it drives) with
    h5py and matplotlib unimportable; the plot helper then skips."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "import icp_rust_tpu_torch.cli as cli\n"
        "import icp_rust_tpu_torch.utils.io, icp_rust_tpu_torch.examples.scan2d\n"
        "import icp_rust_tpu_torch.models.odometry, icp_rust_tpu_torch.models.slam\n"
        "cli._plot(np.zeros((2, 2)), 'never.png')\n"
        "try:\n"
        "    icp_rust_tpu_torch.utils.io.load_scans3d_hdf5('x.hdf5')\n"
        "except ImportError:\n"
        "    print('h5py needed only to read HDF5')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "skipping plot" in proc.stderr
    assert "h5py needed only to read HDF5" in proc.stdout
