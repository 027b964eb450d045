"""The reference against the port's plain CPU path, at a few columns and
steps of each configuration and mix: the program and the reference are
handed the same inputs, and every state field and exchange flux agrees bit
for bit (the reference follows every column, so that the CPU's vector
loops split both batches alike)."""

import pytest
import torch

from portbench.tests import _util

from portbench import check  # noqa: E402

CELLS = ["global-july-windows", "utqiagvik-spring-windows",
         "utqiagvik-coupled"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    from portbench import drive as drive_mod
    cell = _util.small_cell(name)
    d = drive_mod.DRIVES[cell.traffic["entry"]](
        cell.config, cell.traffic, 2**40 + 3, torch.device("cpu"), ncol=24,
        compare_columns=24)
    d.setup()
    d.measure(0.0)
    d.measure(0.0)
    read = check.readings(d)
    assert read["values"]["state_gap"] == 0.0
    if "flux_gap" in read["values"]:
        assert read["values"]["flux_gap"] == 0.0
    # the stretches: from the cold start, and the last steps
    assert [s[0] for s in check.stretches(d)][0] == 0
    assert len(check.stretches(d)) == 2


def test_gap_arithmetic():
    import numpy as np
    b = np.array([1.0, -4.0, 1e36, np.nan])
    assert check.field_gap(b.copy(), b) == 0.0
    a = b.copy()
    a[0] += 1e-3
    assert check.field_gap(a, b) == pytest.approx(1e-3 / 4.0)
    a = b.copy()
    a[2] = 0.0                       # a sentinel on one side only
    assert check.field_gap(a, b) == float("inf")
    a = b.copy()
    a[3] = 0.0                       # a NaN on one side only
    assert check.field_gap(a, b) == float("inf")
    assert check.field_gap(np.zeros(3), np.zeros(3)) == 0.0
    assert check.field_gap(np.array([1e-300]), np.zeros(1)) == float("inf")
