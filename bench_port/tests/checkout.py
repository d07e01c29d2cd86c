"""A temporary checkout for the CPU tests: a copy of this folder, a
BENCHMARK.json of tiny cells, and the port beside them, so that a run finds
everything by name and writes only inside it."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
REPO = PKG.parent

VLP16 = json.loads((PKG / "configs" / "vlp16-28800.json").read_text())
SCAN2D = json.loads((PKG / "configs" / "scan2d-768.json").read_text())
TINY_CONFIGS = {
    "vlp16-tiny": dict(VLP16, data={"seed": 0, "frames": 4, "pad_to": 1792,
                                    "point_stride": 16}),
    "scan2d-tiny": dict(SCAN2D, data=dict(SCAN2D["data"], scans=8,
                                          pad_to=128, rays=96,
                                          min_points=60, max_points=100)),
}
TINY_CELLS = {"vlp16-tiny-p2l": ("vlp16-tiny", "mapping-p2l"),
              "scan2d-tiny-pairs": ("scan2d-tiny", "mapping-pairs")}


def make(tmp: Path, extra=None) -> Path:
    """A checkout at ``tmp``: this folder copied, the tiny configurations
    and cells added, BENCHMARK.json naming them (and ``extra``: a function
    of (root, spec) that adds more), the port linked in."""
    root = tmp / "checkout"
    shutil.copytree(PKG, root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "icp_rust_tpu_torch").symlink_to(REPO / "icp_rust_tpu_torch")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in TINY_CONFIGS.items():
        (root / "bench_port" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        spec["configs"].append(dict(spec["configs"][0], name=name,
                                    file=f"bench_port/configs/{name}.json"))
    for traffic in ("mapping-p2l", "mapping-pairs"):
        t = json.loads((PKG / "traffic" / f"{traffic}.json").read_text())
        (root / "bench_port" / "traffic" / f"{traffic}-tiny.json").write_text(
            json.dumps(dict(t, warmup_calls=1, trace_calls=2)))
    for name, (cfg, traffic) in TINY_CELLS.items():
        real = "vlp16-mapping-p2l" if traffic == "mapping-p2l" \
            else "scan2d-mapping-pairs"
        lim = json.loads((PKG / "cells" / f"{real}.json").read_text())
        lim["gap_pairs"] = 2
        (root / "bench_port" / "cells" / f"{name}.json").write_text(
            json.dumps(lim))
        spec["workloads"].append(dict(name=name, config=cfg,
                                      traffic=f"{traffic}-tiny", chips=1,
                                      why="tiny CPU rehearsal"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    if extra is not None:
        extra(root, spec)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def env(tmp: Path) -> dict:
    """The run's environment: its own HOME, cache and temporary
    directories under ``tmp``, one intra-op thread."""
    e = dict(os.environ)
    for var in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        d = tmp / var.lower()
        d.mkdir(exist_ok=True)
        e[var] = str(d)
    e["OMP_NUM_THREADS"] = "2"
    e.pop("PYTHONPATH", None)
    return e


def run_python(root: Path, tmp: Path, code: str, timeout: float = 300):
    """``code`` in a fresh interpreter at ``root`` with its bench_port
    first on the path; returns the completed process."""
    prog = f"import sys; sys.path.insert(0, {str(root)!r})\n" + code
    return subprocess.run([sys.executable, "-c", prog], cwd=root,
                          env=env(tmp), capture_output=True, text=True,
                          timeout=timeout)


def rehearse(root: Path, tmp: Path, workload: str, trace: int = 0,
             wrap: str = "None", seed: int = 2**31 + 7, seconds: float = 0.5):
    """One CPU run of ``workload`` (the chip check skipped); ``wrap``:
    Python source of a function that wraps the entry's call.  Returns the
    result dict (raises with the run's output on a failure)."""
    code = (f"import json\nfrom bench_port import harness\n"
            f"wrap = {wrap}\n"
            f"r = harness.run({workload!r}, {seed}, {seconds}, {bool(trace)},"
            f" device='cpu', wrap=wrap)\nprint(json.dumps(r))\n")
    p = run_python(root, tmp, code)
    if p.returncode != 0:
        raise AssertionError(f"run failed:\n{p.stdout[-4000:]}\n"
                             f"{p.stderr[-8000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])
