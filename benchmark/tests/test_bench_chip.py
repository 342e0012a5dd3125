"""On the chip, at the cells' own size: the control fails a check of
each cell. Skips without a CUDA device."""

import pytest

from benchmark import control
from benchmark.harness import cells
from conftest import ROOT


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["hifigan.interactive",
                                      "vocos.interactive",
                                      "hifigan.serve_b16"])
def test_control_fails_at_full_size(cuda_device, workload):
    cell = cells.load(ROOT, workload)
    r = control.readings(cell, 2 ** 31 + 3, cuda_device)
    assert any(r[k] > cell.limits[k] for k in cell.limits), r
