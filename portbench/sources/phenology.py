"""Input kind ``phenology``: a monthly phenology file of the grid
(MONTHLY_LAI/SAI/HEIGHT_TOP/HEIGHT_BOT over (12, pft, gridcell),
``synthetic.write_phenology``), which the program reads through
``Model(phenology_path=...)`` and the reference through its copy of the
reference's ``PhenologyDataManager``, over the compared columns."""

from __future__ import annotations

import numpy as np

ROLE = "phenology"


def write(cfg: dict, ncol: int, files: dict) -> dict:
    from portbench import inputs, synthetic
    return dict(phenology=inputs.ensure(
        inputs.grid_dir(cfg, ncol) / "phenology.nc",
        lambda p: synthetic.write_phenology(p, ncol)))


def model_kw(cfg: dict, files: dict) -> dict:
    return dict(phenology_path=files["phenology"])


class Columns:
    """The phenology of the grid's ``ncol`` columns, each step's window
    cut to ``cols``."""

    def __init__(self, path: str, ncol: int, cols, vtype):
        from portbench.reference.elm.data.phenology_data import \
            PhenologyDataManager
        self.manager = PhenologyDataManager(
            path, ncol, np.broadcast_to(np.asarray(vtype, np.int64),
                                        (ncol,)).astype(np.int32))
        self.cols = cols

    def window(self, date):
        ph = self.manager.window(date)
        return ph._replace(**{k: getattr(ph, k)[:, self.cols]
                              for k in ("mlai", "msai", "mhtop", "mhbot")})


def reference(cfg: dict, files: dict, cols, grid: dict) -> Columns:
    return Columns(files["phenology"], cfg["ncol"], cols, grid["vtype"])
