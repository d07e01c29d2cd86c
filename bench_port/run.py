"""Run one cell of the port's benchmark and print its result as the last
line of standard output:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, this folder and the
port (``icp_rust_tpu_torch``).  Needs a CUDA card; the kernels build into
the port's ``_build/`` at first use, other caches go to ``.bench_cache/``.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
# One process with one intra-op thread: the program's host work is
# launches and reads, and idle worker threads only contend for the shared
# host's cores.
os.environ["OMP_NUM_THREADS"] = "1"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)

from bench_port import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
