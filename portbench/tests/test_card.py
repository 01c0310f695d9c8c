"""Card tests: each cell's control at the cell's own size, on three seeds,
comes out not correct (tagging: the port with its int8 path on; CCIP: the
plain forward with its block linears in fp8 e4m3 in the port's place). About
3 minutes on an H100."""

import time

import pytest

from portbench import harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()["workloads"]])
def test_control_is_not_correct(card, cell, seed):
    r = harness.run_cell(cell, seed, 3.0, False, time.perf_counter(), control=True,
                         report=lambda *a, **k: None)
    assert not r["correct"], r["checks"]
