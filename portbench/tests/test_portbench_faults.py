"""``correct`` comes out false when the timed path is broken underneath:
the harness's run (``run.run_cell``), past its look for a card, on the
CPU at a few columns, with a fault planted in the port's step; and the
control (the reference in float32 in the program's place) fails the
limits the configuration's float64 holds.  The sound program passes."""

import pytest
import torch

from portbench.tests import _util

CELLS = ["global-july-windows", "utqiagvik-spring-windows",
         "utqiagvik-coupled"]
NCOL = 24


def _run(name, seed=2**40 + 11):
    run = _util.run_module()
    cell = _util.small_cell(name)
    return run.run_cell(cell, seed, 0.0, False, torch.device("cpu"),
                        ncol=NCOL, compare_columns=NCOL)


def _unchanged(new, old, d):
    return old, d


def _half(new, old, d):
    # half of the batch left out: its columns keep the state they had
    n = old.snl.shape[0] // 2
    return type(new)(*(torch.cat([a[:n], b[n:]])
                       for a, b in zip(new, old))), d


def _altered(new, old, d):
    # an answer altered where it is produced: the soil temperatures (some
    # 3 K) and the heat fluxes handed back, by one part in a hundred
    return (new._replace(t_soisno=new.t_soisno * (1.0 + 1e-2)),
            d._replace(eflx_sh_tot=d.eflx_sh_tot * (1.0 + 1e-2)))


FAULTS = {"unchanged": _unchanged, "half_batch": _half,
          "altered": _altered}


@pytest.fixture
def planted(monkeypatch):
    """Plant a fault in the port's step: ``fault(new, old, diags)``."""
    import elmkernels_torch.driver.step as step_mod
    advance = step_mod.advance

    def plant(fault):
        def broken(*args, **kw):
            new, d = advance(*args, **kw)
            return fault(new, args[5], d)
        monkeypatch.setattr(step_mod, "advance", broken)
    return plant


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_makes_it_incorrect(name, fault, planted):
    planted(FAULTS[fault])
    res = _run(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    # the cell's own calls and windows, at 128 columns: the float32
    # reference in the program's place breaks a limit
    from portbench import check, drive as drive_mod, manifest
    cell = manifest.Cell(manifest.load(), name)
    d = drive_mod.DRIVES[cell.traffic["entry"]](
        cell.config, cell.traffic, 2**40 + 13, torch.device("cpu"),
        ncol=128, compare_columns=128)
    d.setup()
    for _ in range(12 if hasattr(d, "host") else 1):
        d.measure(0.0)
    values = check.readings(d, torch.float32)["control"]
    ok, checks = check.judge(values, {k: cell.limits[k] for k in values})
    assert not ok, checks
