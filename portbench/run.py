"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see portbench/README.md). It exits with 2, and
prints no result, when there are fewer CUDA cards than the cell asks for,
and with 3 when a module of JAX or the JAX package is loaded once the window
has closed.
"""
import time

T_START = time.time()  # set-up is counted from process start

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Caches of the program's libraries stay at fixed paths inside the checkout.
KERNEL_CACHE = os.path.join(ROOT, ".portbench_cache", "torch_kernels")
os.makedirs(KERNEL_CACHE, exist_ok=True)
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", KERNEL_CACHE)
sys.path.insert(0, ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
