"""The compared numbers of many seeds in one process, for setting a cell's
limits: the program's readings (the lower reading is their largest) and,
with ``--control``, the control's (the upper reading is their smallest).
Not run by the benchmark's own runs.

    python3 portbench/tools/readings.py --workload <cell> --seeds 1,2,3 --seconds 6 [--control]

One JSON line a seed on standard output.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--control", action="store_true")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    for seed in [int(s) for s in a.seeds.split(",")]:
        r = harness.run_cell(a.workload, seed, a.seconds, False, time.perf_counter(),
                             control=a.control, report=lambda *x, **k: None)
        print(json.dumps(dict(workload=a.workload, seed=seed, control=a.control,
                              checks=r["checks"], metrics=r["metrics"],
                              memory_peak_bytes=r["device"]["memory_peak_bytes"])), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
