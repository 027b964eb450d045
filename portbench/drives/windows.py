"""Drive ``windows``: the production loop,
``Model.run_windows(series=True)``, called again and again,
``call_steps`` steps to a call in windows of ``window`` steps, until the
measured window has passed.  Over ranks (a ``group``) the window runs in
lockstep with the other ranks."""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.drive import Drive, _date, build_model, sync


def _text(date) -> str:
    """``YYYY-MM-DD HH:MM`` of a date."""
    y, m, d = date.date()
    return (f"{y:04d}-{m:02d}-{d:02d} {date.sec // 3600:02d}:"
            f"{date.sec % 3600 // 60:02d}")


class WindowsDrive(Drive):
    """``Model.run_windows(series=True)``: ``call_steps`` steps a call, in
    windows of ``window`` steps."""

    def build(self) -> None:
        self.call_steps = int(self.traffic["call_steps"])
        self.window = int(self.traffic["window"])
        self.model = build_model(self.cfg, self.files, self.ncol,
                                 self.device, self.kinds, self.mesh)
        self.start_check = (0, self.window)
        # the last moment the inputs cover (None: no end)
        ends = [_date(k.horizon(self.cfg)) for k in self.kinds.values()
                if hasattr(k, "horizon")]
        self.horizon = min(ends) if ends else None

    @property
    def state(self):
        return self.model.state

    @state.setter
    def state(self, value) -> None:
        self.model.state = value

    def warm_up(self) -> None:
        self.diags = []
        self.call()                      # warms every shape the window uses
        self.diags.clear()

    def _window_done(self, date, state, d) -> None:
        self.steps_done += self.window
        # the start of the comparison, and the state the last window
        # ended with; the first window after the cold start is kept too
        keep = {self.window, self.steps_done - self.window}
        with record_function("portbench.keep"):
            self._snap(state)
        self.snaps = {k: v for k, v in self.snaps.items()
                      if k in keep or k == self.steps_done}

    def call(self):
        """One call of the loop; returns its [call_steps] diagnostics."""
        with record_function("portbench.run_windows"):
            d = self.model.run_windows(
                self.date_at(self.steps_done), self.call_steps,
                window=self.window, series=True,
                callback=self._window_done)
        self.diags.append(d)
        return d

    def fits(self) -> bool:
        """Whether one more call, and the traced call after it, end
        within what the inputs cover."""
        return (self.horizon is None or self.date_at(
            self.steps_done + 2 * self.call_steps) <= self.horizon)

    def measure(self, seconds: float) -> dict:
        """Calls until ``seconds`` have passed; the window ends at the first
        call boundary after that, once the card has finished, or before a
        call that would, with the traced call after it, run past the end
        of the inputs (``ended`` says which).  Over ranks the window starts
        at a barrier, rank 0 decides at each call boundary whether it has
        passed, so that every rank makes the same calls, and it ends at a
        barrier once every card has finished; the rate is the whole grid's
        on rank 0's clock."""
        snow0 = self.snow()
        sync(self.device)
        if self.group is not None:
            self.group.barrier()
        n0 = self.steps_done
        cpu0, t0 = time.process_time(), time.perf_counter()
        calls, ended = [], "seconds"
        while True:
            if not self.fits():
                if not calls:
                    raise ValueError(
                        f"the inputs end at {_text(self.horizon)}, before "
                        f"the window's first call")
                ended = f"the inputs end at {_text(self.horizon)}"
                break
            a = time.perf_counter()
            self.call()
            calls.append(time.perf_counter() - a)
            done = time.perf_counter() - t0 >= seconds
            if self.group is not None:
                done = self.group.decide(done)
            if done:
                break
        sync(self.device)
        if self.group is not None:
            self.group.barrier()
        wall = time.perf_counter() - t0
        steps = self.steps_done - n0
        return dict(steps=steps, wall_s=wall, calls_s=calls,
                    cpu_s=time.process_time() - cpu0,
                    column_steps_per_s=self.grid_ncol * steps / wall,
                    snow=[snow0, self.snow()], ended=ended,
                    dates=[_text(self.date_at(n0)),
                           _text(self.date_at(self.steps_done))])

    def traced(self) -> dict:
        """One more call, for the profiler: its steps, the snow at its
        start, and its diagnostics ({field: [steps] numpy array}), which
        the rooflines count from."""
        snow = self.snow()
        d = self.call()
        return dict(steps=self.call_steps, snow=snow,
                    diags={k: v.double().cpu().numpy()
                           for k, v in zip(d._fields, d)})

    def conservation(self) -> dict:
        """The window's conservation errors, the largest over every column
        at each step: {name: [steps] numpy array}."""
        return {k: torch.cat([getattr(x, k) for x in self.diags])
                .double().cpu().numpy()
                for k in ("errh2o_led_max", "errlon_max", "errsol_max")}

    def diag_rows(self) -> np.ndarray:
        """Every domain diagnostic of the window's calls, [steps, fields]
        float64."""
        return torch.stack([torch.cat([getattr(x, k) for x in self.diags])
                            .double() for k in self.diags[0]._fields],
                           dim=1).cpu().numpy()

    def release(self) -> None:
        del self.model, self.cold


DRIVE = WindowsDrive
