"""Drive ``coupled``: one closed-loop caller of
``MinimalInterface.advance_with_forcing``, which builds each step's
forcing on the host, hands it in and waits for the exchange fluxes
before it sends the next step."""

from __future__ import annotations

import statistics
import time

import numpy as np
from torch.profiler import record_function

from portbench import inputs
from portbench.drive import Drive, model_kw, p95, sync


class CoupledDrive(Drive):
    """One caller in a closed loop over
    ``MinimalInterface.advance_with_forcing``."""

    def build(self) -> None:
        if self.mesh is not None:
            raise ValueError("the coupled drive runs on one card")
        from elmkernels_torch.driver.interface import (HostForcing,
                                                       HostPhenology,
                                                       MinimalInterface)
        self.HostForcing, self.HostPhenology = HostForcing, HostPhenology
        kw = model_kw(self.cfg, self.files, self.device, self.kinds)
        kw.update(self.cfg["site"])
        self.iface = MinimalInterface(self.ncol, model_kw=kw).setup()
        self.keep = int(self.traffic["compare"]["steps"])
        self.start_check = (0, int(self.traffic["warmup_steps"]))

    @property
    def state(self):
        return self.iface.model.state

    @state.setter
    def state(self, value) -> None:
        self.iface.model.state = value

    def warm_up(self) -> None:
        self.host = inputs.HostForcing(self.ncol, self.seed)
        self.forcing_s: list[float] = []    # each step's forcing build
        self.fluxes: dict[int, dict] = {}
        self.nonfinite = 0
        for _ in range(self.start_check[1]):
            self.step()
        self.fluxes.clear()
        self.nonfinite = 0

    def step(self) -> float:
        """One coupled step, timed from the host's first work on its forcing
        to the exchange fluxes back on the host; the state before it and
        its fluxes are kept for the comparison's last steps."""
        t0 = time.perf_counter()
        date = self.date_at(self.steps_done)
        with record_function("portbench.host_forcing"):
            atm, phen = self.host.step(date, self.dtime)
        self.forcing_s.append(time.perf_counter() - t0)
        with record_function("portbench.advance_with_forcing"):
            ex = self.iface.advance_with_forcing(
                date, self.dtime, self.HostForcing(**atm),
                self.HostPhenology(**phen))
        took = time.perf_counter() - t0
        k = self.steps_done
        self.steps_done += 1
        with record_function("portbench.keep"):
            self.fluxes[k] = {f: np.asarray(v)[self.cols]
                              for f, v in zip(ex._fields, ex)}
            # a NaN or an infinity anywhere makes the sum not finite
            self.nonfinite += int(not all(np.isfinite(np.add.reduce(
                v, axis=None)) for v in ex))
            self._snap(self.state)
        first = self.steps_done - self.keep
        self.snaps = {s: v for s, v in self.snaps.items()
                      if s >= first or s == self.start_check[1]}
        self.fluxes = {s: v for s, v in self.fluxes.items() if s >= first}
        return took

    def measure(self, seconds: float) -> dict:
        sync(self.device)
        n0 = self.steps_done
        self.nonfinite = 0
        self.forcing_s = []
        times = []
        cpu0, t0 = time.process_time(), time.perf_counter()
        while True:
            times.append(self.step())
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        steps = self.steps_done - n0
        ms = [1e3 * t for t in times]
        slow = sorted(range(len(ms)), key=ms.__getitem__)[-10:]
        return dict(steps=steps, wall_s=wall,
                    cpu_s=time.process_time() - cpu0, step_s=times,
                    coupled_steps_per_s=steps / wall,
                    coupled_step_ms_p95=p95(ms),
                    coupled_step_ms_mean=sum(ms) / len(ms),
                    coupled_step_ms_p50=statistics.median(ms),
                    forcing_ms_mean=1e3 * sum(self.forcing_s) / len(ms),
                    slowest=[[i, ms[i]] for i in reversed(slow)])

    def traced(self) -> dict:
        n = int(self.traffic["traced_steps"])
        for _ in range(n):
            self.step()
        return dict(steps=n)

    def release(self) -> None:
        del self.iface, self.cold


DRIVE = CoupledDrive
