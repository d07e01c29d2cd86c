"""The port's benchmark harness: one cell of ``BENCHMARK.json`` per run.

A cell names a configuration and a traffic mix; the harness finds each by
its name, in files of their own under this folder:

- ``configs/<config>.json``: the deployment (its data ``generator`` under
  ``data/`` and that generator's sizes, the ICP settings, the normals);
- ``traffic/<traffic>.json``: the mix: the ``inputs`` generator under
  ``inputs/`` that reads its parameters (pairs, warm starts, order), the
  ``entry`` under ``entries/`` that drives the program, the ``judge``
  under ``judges/`` and the plain ``reference`` under ``reference/`` that
  check it, the program's route, warm-up and traced calls;
- ``cells/<workload>.json``: the limits of the numbers that decide
  ``correct``, and how many answers the reference works out again;
- ``metrics/<metric>.py``: a ``read(run)`` per metric, returning a number
  or None where it finds nothing to read.

A run makes its inputs from the seed, warms up, drives the entry in a
closed loop for ``--seconds`` (``--trace 1``: the traffic's traced calls
under ``torch.profiler``), then judges every answer the window produced
with the plain reference and prints the result as its last line.  The
harness knows no unit of work: the inputs generator says how much work a
call does (``work``), the entry what a call returns, the judge what is
right.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from bench_port import counts, tracing

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "icp_rust_tpu")


def err(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(kind: str, name: str) -> dict:
    return json.loads((PKG / kind / f"{name}.json").read_text())


def load_reader(name: str):
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + "".join(c if c.isalnum() else "_"
                                       for c in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(workload: str) -> dict:
    """The cell's entries of BENCHMARK.json and its files."""
    spec = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or workload in m["workloads"]]
    return dict(cell=cell, config=load_json("configs", cell["config"]),
                traffic=load_json("traffic", cell["traffic"]),
                limits=load_json("cells", workload),
                end_to_end=mine(spec["end_to_end"]),
                per_layer=mine(spec["per_layer"]))


def make_inputs(ctx: dict, seed: int):
    """The configuration's sequence, made by its generator from the
    configuration's own seed (the recorded sequence of the deployment), and
    the traffic's inputs, made by its generator from the run's seed.
    Returns (data, inputs)."""
    cfg, traffic = ctx["config"], ctx["traffic"]
    gen = importlib.import_module(f"bench_port.data.{cfg['generator']}")
    data = gen.make(cfg["data"], cfg["data"]["seed"])
    mix = importlib.import_module(f"bench_port.inputs.{traffic['inputs']}")
    return data, mix.make(data, traffic, seed)


def load_judge(ctx: dict):
    return importlib.import_module(
        f"bench_port.judges.{ctx['traffic']['judge']}")


def _sync(cuda: bool) -> None:
    if cuda:
        import torch

        torch.cuda.synchronize()


def closed_loop(call, st, seconds: float, cuda: bool):
    """One caller, each call sent as soon as the last one's synchronise
    returns, until ``seconds`` have passed; every call that started inside
    the window is timed whole, on the host clock from its entry to the end
    of its synchronise."""
    outs, host_s = [], []
    t0 = time.perf_counter()
    deadline, h1 = t0 + seconds, t0
    while not outs or h1 < deadline:
        h0 = time.perf_counter()
        outs.append(call(st))
        _sync(cuda)
        h1 = time.perf_counter()
        host_s.append(h1 - h0)
    return outs, dict(window_s=h1 - t0, call_host_s=host_s, trace=None)


def traced_window(call, st, n_calls: int, cuda: bool):
    """``n_calls`` calls under torch.profiler, inside a window span, each
    in a call span and timed as ``closed_loop`` times it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    outs, host_s = [], []
    with profile(activities=acts) as prof:
        with record_function(tracing.WINDOW):
            for _ in range(n_calls):
                with record_function(tracing.CALL):
                    h0 = time.perf_counter()
                    outs.append(call(st))
                    _sync(cuda)
                    host_s.append(time.perf_counter() - h0)
    trace = tracing.collect(prof)
    lo, hi = trace["window"]
    return outs, dict(window_s=(hi - lo) / 1e9, call_host_s=host_s,
                      trace=trace)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", wrap=None, t_start: float | None = None):
    """One run of a cell; returns the result dict (``checks`` last).
    ``device="cpu"`` rehearses it without a card (tests only); ``wrap``
    wraps the entry's call (tests only)."""
    t_start = time.perf_counter() if t_start is None else t_start
    ctx = resolve(workload)
    import torch

    cuda = device == "cuda"
    chips = ctx["cell"]["chips"]
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < chips):
        err(f"{workload} needs {chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        raise SystemExit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        torch.set_num_threads(1)
    cfg, traffic = ctx["config"], ctx["traffic"]
    entry = importlib.import_module(f"bench_port.entries.{traffic['entry']}")
    if cuda:
        entry.build()
    t_load = time.perf_counter()
    data, inp = make_inputs(ctx, seed)
    st = entry.prepare(data, inp, cfg, traffic, device)
    _sync(cuda)
    t_data = time.perf_counter()
    call = entry.call if wrap is None else wrap(entry.call)
    for _ in range(traffic["warmup_calls"]):
        call(st)
        _sync(cuda)
    t_warm = time.perf_counter()
    err(f"# setup: import and load {t_load - t_start:.4f} s, data "
        f"{t_data - t_load:.4f} s, warm-up {t_warm - t_data:.4f} s")

    entry.reset_counts()
    if trace:
        outs, win = traced_window(call, st, traffic["trace_calls"], cuda)
    else:
        outs, win = closed_loop(call, st, seconds, cuda)
    launches = entry.counts()
    mem = int(torch.cuda.max_memory_allocated()) if cuda else 0
    calls = len(outs)
    answers = entry.answers(outs)
    del outs, st
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks, failed, info = load_judge(ctx).judge(answers, data, inp, ctx,
                                                 seed, device)
    info["judge_s"] = round(time.perf_counter() - t_judge, 3)
    per_call = {k: v / calls for k, v in launches.items() if v}
    host = win["call_host_s"]
    err(f"# window: {calls} calls of {inp['work']} in "
        f"{win['window_s']:.6f} s (call s: first {host[0]:.6f}, median "
        f"{float(np.median(host)):.6f}, max {max(host):.6f}); launches a "
        f"call {per_call}; {info}")

    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    run_ctx = dict(win, **inp["context"], **getattr(entry, "CONTEXT", {}),
                   setup_s=t_warm - t_start, calls=calls,
                   work_per_call=inp["work"], launches=launches,
                   peaks=counts.peaks(name))
    metrics = {}
    for m in ctx["per_layer" if trace else "end_to_end"]:
        value = load_reader(m["name"])(run_ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": chips if cuda else 0, "memory_peak_bytes": mem}
    result = {"correct": failed == 0, "attempted": calls * inp["work"],
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        tr = win["trace"]
        dev["busy_s"] = tracing.busy_ns(tr) / 1e9
        dev["window_s"] = win["window_s"]
        result["breakdown"] = {"device_ops": tracing.device_ops(tr),
                               "idle_gaps": tracing.idle_gaps(tr)}
    result["checks"] = checks
    return result


def main(argv, t_start: float, device: str = "cuda") -> int:
    """One run from the command line; prints its result as the last line
    of standard output.  Refuses to print one (exit code 3) where JAX or
    the JAX package is loaded in this process once the run, its judge and
    its metric readers are done.  ``device="cpu"``: tests only."""
    ap = argparse.ArgumentParser(description="Run one cell of the port's "
                                 "benchmark (BENCHMARK.json).")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    result = run(a.workload, a.seed, a.seconds, bool(a.trace),
                 device=device, t_start=t_start)
    found = forbidden_modules()
    if found:
        err(f"the run loaded {found}: the benchmark may not load JAX or the "
            "JAX package")
        return 3
    for k, v in result["checks"].items():
        err(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
