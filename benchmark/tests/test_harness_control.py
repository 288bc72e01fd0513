"""The comparison that decides `correct` fails its control and every fault
a cell can have, here at a small size on the CPU (where the port and the
reference agree bit for bit); on a card, the control at the cell's own size."""

import time

import pytest
import torch

from benchmark import manifest
from benchmark.faults import FAULTS
from benchmark.harness import run_cell
from benchmark.tests.common import tiny_run

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]
ROLLOUT = [c for c in CELLS if manifest.load_cell(c).loop == "rollout"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = tiny_run(cell, system="control")
    assert r["correct"] is False
    assert any(n["value"] > n["limit"] for n in r["check"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_is_not_correct(cell, fault):
    r = tiny_run(cell, fault=FAULTS[fault])
    assert r["correct"] is False, r["check"]


def test_the_port_at_a_small_size_reads_nought_where_the_code_is_the_same():
    r = tiny_run(ROLLOUT[0])  # on the CPU the port runs the plain versions the reference copies
    assert all(n["value"] == 0.0 for n in r["check"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = manifest.load_cell(cell)
    seconds = None if c.loop == "train" else 10.0
    r = run_cell(c, 20260001, seconds, False, "cuda", time.perf_counter(), system="control")
    assert r["correct"] is False
