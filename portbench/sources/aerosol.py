"""Input kind ``aerosol``: a monthly aerosol-deposition climatology of the
grid (the eleven species over (12, gridcell),
``synthetic.write_aerosol_deposition``), which the program reads through
``Model(aerosol_path=...)`` and the reference through its copy of the
reference's ``AerosolDataManager``, over the compared columns."""

from __future__ import annotations

ROLE = "aerosol"


def write(cfg: dict, ncol: int, files: dict) -> dict:
    from portbench import inputs, synthetic
    return dict(aerosol=inputs.ensure(
        inputs.grid_dir(cfg, ncol) / "aerosoldep.nc",
        lambda p: synthetic.write_aerosol_deposition(p, ncol)))


def model_kw(cfg: dict, files: dict) -> dict:
    return dict(aerosol_path=files["aerosol"])


class Columns:
    """The whole grid's deposition rates, cut to ``cols``."""

    def __init__(self, path: str, ncol: int, cols):
        from portbench.reference.elm.data.aerosol_data import \
            AerosolDataManager
        self.manager = AerosolDataManager(path, ncol)
        self.cols = cols

    def rates(self, date) -> dict:
        return {k: v[self.cols] for k, v in self.manager.rates(date).items()}


def reference(cfg: dict, files: dict, cols, grid: dict) -> Columns:
    return Columns(files["aerosol"], cfg["ncol"], cols)
