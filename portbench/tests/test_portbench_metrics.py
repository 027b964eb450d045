"""The per-layer readers' arithmetic on a canned trace record, and the
end-to-end statistics."""

import math

import pytest

from portbench.tests import _util

from portbench import drive, trace  # noqa: E402  (after _util's path)


def _record():
    # a window of 100 us; device busy over [10, 30], [20, 40] and [60, 70]
    # (union 40 us); a graph launch, a kernel launch, two copies, a fill
    # and other host work; two steps
    return dict(
        window=[0.0, 100.0], steps=2,
        device=[["canopy_kernel", 10.0, 30.0],
                ["Memcpy HtoD (Pinned -> Device)", 20.0, 40.0],
                ["Memcpy DtoH (Device -> Pageable)", 60.0, 70.0],
                ["snow_kernel", 150.0, 160.0]],
        host=[[trace.RANGE, 0.0, 100.0], ["cudaGraphLaunch", 5.0, 6.0],
              ["cudaLaunchKernel", 7.0, 8.0], ["cudaMemcpyAsync", 9.0, 9.5],
              ["cudaMemcpyAsync", 44.0, 45.0], ["cudaMemsetAsync", 46.0, 47.0],
              ["aten::add", 41.0, 59.0], ["cudaLaunchKernel", 120.0, 121.0],
              ["cudaStreamSynchronize", 70.0, 100.0]],
        measured=dict(steps=4, cpu_s=0.014, coupled_step_ms_mean=120.5))


BOUNDS = dict(k2=5e-3, k5=2e-3)


def _read(name, rec):
    """The reader as the harness calls it, a kernel's bound of one launch
    in ``bound_ms`` where the metric names one."""
    from portbench import manifest
    cell = manifest.Cell(manifest.load(), "global-july-windows"
                         if name.endswith(".loop") else "utqiagvik-coupled")
    mod = cell.module("metrics", name)
    kernel = getattr(mod, "ROOFLINE", None)
    return mod.read(rec if kernel is None
                    else dict(rec, bound_ms=BOUNDS[kernel]))


def test_busy_union_and_idle_share():
    rec = _record()
    assert trace.busy_us(rec) == pytest.approx(40.0)
    assert trace.idle_share(rec) == pytest.approx(60.0)
    assert _read("device_idle_share.loop", rec) == pytest.approx(60.0)
    assert _read("device_idle_share.coupled", rec) == pytest.approx(60.0)


def test_launches_copies_and_device_ms():
    rec = _record()
    # graph launch, kernel launch, two copies and a fill inside the window;
    # the launch at 120 us is outside it
    assert trace.issues(rec) == 5
    assert _read("host_launches_per_step.loop", rec) == pytest.approx(2.5)
    assert _read("host_launches_per_step.coupled", rec) == pytest.approx(2.5)
    assert _read("copy_ms_per_step.coupled", rec) == pytest.approx(
        (20.0 + 10.0) / 1e3 / 2)
    assert _read("step_device_ms.loop", rec) == pytest.approx(
        (20.0 + 20.0 + 10.0 + 10.0) / 1e3 / 2)
    assert _read("host_cpu_ms_per_step.loop", rec) == pytest.approx(3.5)
    assert _read("coupled_step_ms_mean.coupled", rec) == 120.5


def test_roofline_shares_and_silence():
    rec = _record()
    assert _read("k2_roofline_share.loop", rec) == pytest.approx(
        100.0 * 5e-3 / 20e-3)
    assert _read("k5_roofline_share.loop", rec) == pytest.approx(
        100.0 * 2e-3 / 10e-3)
    rec["device"] = [d for d in rec["device"] if d[0] != "canopy_kernel"]
    # a kernel that is off the path leaves its share silent, never 0
    assert _read("k2_roofline_share.loop", rec) is None
    empty = dict(rec, device=[])
    assert _read("device_idle_share.loop", empty) is None
    assert _read("step_device_ms.loop", empty) is None


def test_breakdown():
    rec = _record()
    top = trace.top_device_ops(rec, 2)
    assert [n for n, _ in top] == ["canopy_kernel",
                                   "Memcpy HtoD (Pinned -> Device)"]
    gaps = dict(trace.idle_gaps(rec))
    # each idle gap goes to the shortest host event around its middle:
    # [0, 10] to the graph launch, [40, 60] to the torch operation,
    # [70, 100] to the wait
    assert gaps["cudaGraphLaunch"] == pytest.approx(10e-6)
    assert gaps["aten::add"] == pytest.approx(20e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)


def test_p95_over_every_step():
    # 100 steps, 10 of them slow: the 95th percentile lies among the slow
    times = [0.1] * 90 + [0.5] * 10
    assert drive.p95(times) == pytest.approx(0.5)
    assert drive.p95([0.2]) == 0.2
    # every step counts: one slow step more moves it
    assert drive.p95([0.1] * 95 + [0.9] * 5) > drive.p95([0.1] * 96
                                                        + [0.9] * 4)


def test_rate_over_the_whole_window():
    class Fake(drive.WindowsDrive):
        def __init__(self):
            self.ncol, self.steps_done, self.device = 1000, 0, None
            self.call_steps = 48

        def call(self):
            import time
            time.sleep(0.02)
            self.steps_done += self.call_steps

        def snow(self):
            return {}

    import torch
    f = Fake()
    f.device = torch.device("cpu")
    m = f.measure(0.05)
    # the window ends at the first call boundary after 0.05 s, and the rate
    # is every column-step over all of its time
    assert m["steps"] % 48 == 0 and m["steps"] >= 3 * 48
    assert m["column_steps_per_s"] == pytest.approx(
        1000 * m["steps"] / m["wall_s"])
    assert m["wall_s"] >= 0.05


def test_a_listed_metric_that_reads_nothing_is_an_error():
    import types
    from portbench import manifest
    run = _util.run_module()
    cell = manifest.Cell(manifest.load(), "global-july-windows")
    drive_ = types.SimpleNamespace(files={}, ncol=24)
    empty = dict(_record(), device=[])
    with pytest.raises(run.MissingReading, match="step_device_ms.loop"):
        run.per_layer(cell, drive_, empty["measured"], empty,
                      dict(steps=2))
    # a metric that lists no cells, and so is not listed for this one, is
    # left out
    cell.per_layer = [{k: v for k, v in m.items() if k != "workloads"}
                      for m in cell.per_layer
                      if m["name"] == "step_device_ms.loop"]
    assert run.per_layer(cell, drive_, empty["measured"], empty,
                         dict(steps=2)) == {}


def test_contract_limits_follow_the_guard_formula():
    run = _util.run_module()
    spec = {"base": 2.5e-5, "column_steps": 393216}
    assert run.contract_limit(spec, 393216) == pytest.approx(2.5e-5)
    # 262,144 columns x 48 steps: 4.68e-5, the port's errsol_bound
    assert run.contract_limit(spec, 262144 * 48) == pytest.approx(
        2.5e-5 * math.sqrt(1.0 + 5.0 / 2.0))
    # a plain number is the limit; fewer column-steps than the
    # calibration's keep the base
    assert run.contract_limit(1e-8, 10**9) == 1e-8
    assert run.contract_limit(spec, 1000) == 2.5e-5
