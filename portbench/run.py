"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  BENCHMARK.json names the cells; see
portbench/harness.py for what a run does.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[0] = ROOT      # the package root, not portbench/ itself
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
