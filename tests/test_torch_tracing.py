"""The port's spans (``utils/profiling.annotate``) and the benchmark's
readers of them (``bench_port/spans.py``, ``bench_port/metrics/``), on the
CPU.

- A traced batched ``icp_point_to_plane`` opens exactly the ``icp.`` spans
  its CPU route reaches, nested as the driver nests them: one
  ``icp.outer_iter`` an outer iteration, each ``icp.nn`` and
  ``icp.inner_loop`` inside one.  They are host events of function scope,
  not user annotations, so the profiler lays no range of theirs over the
  device timeline.
- With no profiler recording, ``annotate`` builds no range.
- The readers on hand-made traces: a gap is cut at the spans' edges and
  goes to the innermost span open there, or to ``outside_program`` where
  none is; the idle parts sum to ``device_idle_share``'s reading and the
  sync parts to ``host_syncs_per_call``'s count.
- ``tracing.collect`` on a stub profile: it keeps kernels and host events,
  drops the harness's own device-side ranges and finds the window.
"""

import math

import numpy as np
import pytest
import torch

from bench_port import spans, tracing
from bench_port.harness import load_reader
from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models.icp_p2l import icp_point_to_plane
from icp_rust_tpu_torch.utils import profiling

P2L_CPU_SPANS = {"icp.icp_point_to_plane", "icp.prepare", "icp.normals",
                 "icp.outer_iter", "icp.nn", "icp.inner_loop"}
IDLE_PARTS = ("outer_loop", "nn_glue", "inner_loop", "normals", "prepare",
              "frame_launch", "outside_program")


def _box_pairs(b=2, n_per_face=48, seed=0):
    """B pairs of points on three faces of a box, each dst the src turned
    a little about z and moved, as float32 tensors with masks."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for i in range(b):
        u = rng.uniform(0, 2, (n_per_face, 2))
        z = np.zeros(n_per_face)
        pts = np.concatenate([np.column_stack([z, u]),
                              np.column_stack([u[:, :1], z, u[:, 1:]]),
                              np.column_stack([u, z])])
        a = 0.02 * (1 + i)
        rot = np.array([[math.cos(a), -math.sin(a), 0],
                        [math.sin(a), math.cos(a), 0], [0, 0, 1]])
        src.append(pts)
        dst.append(pts @ rot.T + [0.03, -0.02, 0.01])
    src = torch.tensor(np.stack(src), dtype=torch.float32)
    dst = torch.tensor(np.stack(dst), dtype=torch.float32)
    mask = torch.ones(src.shape[:2], dtype=torch.bool)
    return src, dst, mask


def _events(prof):
    """(name, start ns, end ns, is a user annotation) of the profile's host
    events."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def test_traced_p2l_opens_the_cpu_routes_spans_nested(tmp_path):
    src, dst, mask = _box_pairs()
    t0 = RigidTransform3.identity((src.shape[0],))
    with profiling.trace(str(tmp_path)) as prof:
        _, stats = icp_point_to_plane(src, dst, mask, mask, t0, ICPConfig(),
                                      normals_voxel_size=0.5,
                                      return_stats=True, device="cpu")
    ev = [e for e in _events(prof) if e[0].startswith("icp.")]
    assert {e[0] for e in ev} == P2L_CPU_SPANS
    assert not any(e[3] for e in ev)
    outer = [e for e in ev if e[0] == "icp.outer_iter"]
    assert len(outer) == int(stats.outer_iters[0])
    for e in ev:
        if e[0] in ("icp.nn", "icp.inner_loop"):
            assert sum(o[1] <= e[1] and e[2] <= o[2] for o in outer) == 1
    (entry,) = [e for e in ev if e[0] == "icp.icp_point_to_plane"]
    assert all(entry[1] <= e[1] and e[2] <= entry[2] for e in ev)


def test_annotate_builds_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    with profiling.annotate("icp.x"):
        with profiling.annotate("icp.y"):
            pass
    src, dst, mask = _box_pairs(b=1, n_per_face=24)
    icp_point_to_plane(src, dst, mask, mask, RigidTransform3.identity((1,)),
                       ICPConfig(outer_iters=2), normals_voxel_size=0.5,
                       device="cpu")


def _trace(device, host, window=(0, 100)):
    return dict(device=[("k", s, e - s) for s, e in device],
                host=[(n, s, e - s) for n, s, e in host], window=window)


def _run(trace, calls=1):
    return dict(trace=trace, calls=calls)


def _parts(run):
    return {p: load_reader(f"device_idle_share.{p}")(run)
            for p in IDLE_PARTS}


@pytest.mark.parametrize("case", ["siblings", "child", "outside"])
def test_idle_goes_to_the_innermost_span(case):
    # Device busy over [0, 40) and [60, 100): one gap, [40, 60).
    busy = [(0, 40), (60, 100)]
    host = {
        "siblings": [("icp.prepare", 30, 50), ("icp.frame_launch", 50, 70)],
        "child": [("icp.outer_iter", 0, 100), ("icp.nn", 40, 60)],
        "outside": [("icp.prepare", 0, 30), ("icp.frame_launch", 70, 90)],
    }[case]
    got = _parts(_run(_trace(busy, host)))
    want = {"siblings": {"prepare": 0.1, "frame_launch": 0.1,
                         "outside_program": 0.0},
            "child": {"nn_glue": 0.2, "outer_loop": 0.0,
                      "outside_program": 0.0},
            "outside": {"prepare": 0.0, "frame_launch": 0.0,
                        "outside_program": 0.2}}[case]
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-15), k
    for k, v in got.items():
        if k != "outside_program" and k not in want:
            assert v is None   # the span is not in the trace


def _nested_trace():
    """Two calls of a p2l-shaped span tree over a device timeline with
    gaps everywhere, and synchronises under each span and outside."""
    host, busy = [], []
    for c, lo in enumerate((1000, 5000)):
        host += [("bench_port.call", lo, lo + 3000),
                 ("icp.icp_point_to_plane", lo + 10, lo + 2900),
                 ("icp.prepare", lo + 20, lo + 120),
                 ("icp.normals", lo + 200, lo + 700)]
        for k in range(3):
            o = lo + 800 + 600 * k
            host += [("icp.outer_iter", o, o + 550),
                     ("icp.nn", o + 30, o + 130),
                     ("icp.inner_loop", o + 200, o + 500)]
        host += [("cudaStreamSynchronize", t, t + 5) for t in
                 (lo + 50, lo + 300, lo + 310, lo + 850, lo + 900,
                  lo + 1450, lo + 2400, lo + 2950)]
        host += [("cudaLaunchKernel", lo + 400, lo + 404)]
        busy += [(t, t + 37) for t in range(lo, lo + 3000, 61 + 7 * c)]
    return _trace(busy, host, window=(900, 8200))


def test_idle_parts_sum_to_the_idle_share():
    run = _run(_nested_trace(), calls=2)
    parts = _parts(run)
    assert parts["prepare"] > 0 and parts["frame_launch"] is None
    ps = spans.pieces(run["trace"])
    entry = spans.idle_ns(run["trace"], ps).get("icp.icp_point_to_plane", 0)
    lo, hi = run["trace"]["window"]
    total = sum(v for v in parts.values() if v is not None) \
        + entry / (hi - lo)
    assert math.isclose(total, load_reader("device_idle_share")(run),
                        rel_tol=0, abs_tol=1e-12)


def test_sync_parts_sum_to_the_sync_count():
    run = _run(_nested_trace(), calls=2)
    inner = load_reader("host_syncs_per_call.inner_loop")(run)
    normals = load_reader("host_syncs_per_call.normals")(run)
    assert (inner, normals) == (1.0, 2.0)
    acc = spans.syncs(run["trace"], spans.pieces(run["trace"]))
    assert acc[spans.OUTSIDE] == 2   # the harness's one a call, at +2950
    rest = sum(acc.values()) / 2 - inner - normals - 1
    assert inner + normals + rest == pytest.approx(
        load_reader("host_syncs_per_call")(run), abs=1e-12)


def test_readers_find_nothing_without_spans_or_device_events():
    tr = _trace([(0, 40)], [("cudaStreamSynchronize", 50, 55)])
    for p in IDLE_PARTS:
        assert load_reader(f"device_idle_share.{p}")(_run(tr)) is None
    assert load_reader("host_syncs_per_call.inner_loop")(_run(tr)) is None
    cpu = _trace([], [("icp.inner_loop", 10, 90)])
    assert load_reader("device_idle_share.inner_loop")(_run(cpu)) is None
    assert load_reader("device_idle_share.outside_program")(
        dict(trace=None, calls=1)) is None


class _Ev:
    def __init__(self, name, start, dur, dev, user):
        self._v = (name, start, dur, dev, user)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_collect_keeps_kernels_and_host_and_drops_the_harness_ranges():
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    evs = [_Ev(tracing.WINDOW, 100, 900, cpu, True),
           _Ev(tracing.CALL, 110, 800, cpu, True),
           _Ev(tracing.CALL, 150, 500, cuda, True),
           _Ev("icp.icp2d", 120, 700, cpu, False),
           _Ev("frame_kernel<256>", 150, 500, cuda, False)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return evs

    tr = tracing.collect(Prof)
    assert tr["window"] == (100, 1000)
    assert tr["device"] == [("frame_kernel<256>", 150, 500)]
    assert [h[0] for h in tr["host"]] == [tracing.WINDOW, tracing.CALL,
                                          "icp.icp2d"]
