"""Readings that the limits of ``correct`` are set from, for one cell, in
one process:

    python3 bench_port/control.py --workload <cell> --seeds <n> ... \
        --control-seeds <n> ... [--dtype bfloat16]

For each ``--seeds`` seed: the program's answers (one call at the cell's
sizes, after the traffic's warm-up) judged as a run judges them, the lower
readings.  For each ``--control-seeds`` seed: the control, the plain
reference put in the program's place and computed in ``--dtype`` (the
precision below the configuration's float32), judged the same way, the
upper readings.  One JSON line a seed, then a summary line: each number's
largest program reading and smallest control reading.  Needs a CUDA card,
as a run does.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from bench_port import harness  # noqa: E402


def readings(workload: str, seeds, control_seeds, dtype: str,
             device: str = "cuda", gap_pairs: int | None = None) -> dict:
    import torch

    ctx = harness.resolve(workload)
    if gap_pairs is not None:
        ctx["limits"]["gap_pairs"] = gap_pairs
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("control.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic = ctx["traffic"]
    judge = harness.load_judge(ctx)
    entry = None
    out = {"program": [], "control": []}
    for kind, seed in ([("program", s) for s in seeds]
                       + [("control", s) for s in control_seeds]):
        t = time.perf_counter()
        data, inp = harness.make_inputs(ctx, seed)
        if kind == "program":
            if entry is None:
                entry = importlib.import_module(
                    f"bench_port.entries.{traffic['entry']}")
                if device == "cuda":
                    entry.build()
            st = entry.prepare(data, inp, ctx["config"], traffic, device)
            for _ in range(traffic["warmup_calls"]):
                entry.call(st)
            answers = entry.answers([entry.call(st)])
            del st
        else:
            answers = judge.control(data, inp, ctx, getattr(torch, dtype),
                                    device)
        checks, failed, info = judge.judge(answers, data, inp, ctx, seed,
                                           device)
        row = dict(kind=kind, seed=seed, seconds=time.perf_counter() - t,
                   failed=failed, **{k: v["value"] for k, v in
                                     checks.items()}, **info)
        print(json.dumps(row), flush=True)
        out[kind].append(row)
    names = list(ctx["limits"]["limits"])
    out["summary"] = {
        n: {"program_max": max((r[n] for r in out["program"]), default=None),
            "control_min": min((r[n] for r in out["control"]), default=None),
            "limit": ctx["limits"]["limits"][n]} for n in names}
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--gap-pairs", type=int, default=None,
                    help="compare this many pairs with the reference's "
                    "answers (default: the cell's)")
    a = ap.parse_args(argv)
    out = readings(a.workload, a.seeds, a.control_seeds, a.dtype,
                   gap_pairs=a.gap_pairs)
    print(json.dumps({"summary": out["summary"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
