"""Run one benchmark cell of the PyTorch/CUDA port on this machine's cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result object; the compared numbers
and their limits are the last lines of standard error. Without enough CUDA
devices it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# kernel caches at fixed paths inside the checkout (the port builds its own
# CUDA libraries into its package's _build/; these cover any other build tool)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, os.path.join(ROOT, ".portbench_cache", sub))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
