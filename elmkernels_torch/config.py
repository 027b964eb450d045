"""Runtime configuration of a run.

Counterpart of ``elmkernels_tpu/config.py``.  The reference's
configuration is static and scattered (CMake options, ``constexpr``
ELMconfig/ELMdims in ``elm_constants.h:10-15``, values hardwired in
``elm_kokkos_interface.cc:40-99`` / ``kokkos_driver.cc:37-42``).  Here
every run-level knob lives in one dataclass, loaded from JSON (or YAML,
where PyYAML is installed) and overridden from the command line.

Against the JAX package's: ``platform`` is ``device`` (``None`` is the
first CUDA device, ``"cpu"`` the plain PyTorch path), ``f64`` selects the
model's dtype, and ``pft_path``/``snicar_path`` have no default (the port
knows no reference data directory; ``elmkernels_torch.data.synthetic``
writes synthetic files).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any


@dataclasses.dataclass
class RunConfig:
    """One simulation run (the reference's ELMInterface ctor + main())."""
    # problem size / time stepping (kokkos_driver.cc:37-42)
    ncol: int = 1
    dtime: float = 1800.0
    nsteps: int = 100
    start_year: int = 1985
    start_doy: int = 181          # 0-based day of year (no-leap calendar)
    start_sec: int = 43200
    # surface (elm_kokkos_interface.cc:58-99)
    vtype: int = 12
    lat_deg: float = 71.323
    lon_deg: float = 203.3886
    # clm_params and snicar_optics NetCDFs; the model needs both
    pft_path: str | None = None
    snicar_path: str | None = None
    # snicar_drdt snow-aging tables; required by elm_correct_snow_aging
    snow_aging_path: str | None = None
    # surfdata NetCDF of a heterogeneous per-column grid
    # (Model.from_surfdata); vtype/lat_deg/lon_deg are then unused
    surfdata_path: str | None = None
    # month-per-file NetCDF forcing basename ("<basename>YYYY-MM.nc");
    # None selects the synthetic forcing
    forcing_basename: str | None = None
    # surfdata NetCDF with monthly phenology; None selects the synthetic
    phenology_path: str | None = None
    # float64 model (False: float32 throughout, the JAX package's
    # all-float32 mode)
    f64: bool = True
    # ELM's snow grain aging; False is reference-exact
    elm_correct_snow_aging: bool = False
    # ELM's surface-energy-balance linearization; False is reference-exact
    elm_correct_seb: bool = False
    # the production flags (float32 radiative solvers, warm-started
    # solvers, float32 canopy-loop interior); False is reference-exact
    mixed_radiation: bool = True
    warm_start: bool = True
    mixed_canopy: bool = True
    # the JAX package's packed scan carry: not ported, refused when set
    packed_carry: bool = False
    # torch device: None is the first CUDA device, "cpu" the plain path
    device: str | None = None
    # conservation guard thresholds (None disables a check)
    errh2o_max: float | None = 0.1    # mm/step
    errh2osno_max: float | None = 1e-6
    # bounds the mixed-radiation contract (errsol ~1e-6 W/m2); a pure-f64
    # run (mixed_radiation=False) closes to 1e-13
    errsol_max: float | None = 1e-5
    # outputs
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0         # steps; 0 = only explicit saves
    metrics_path: str | None = None   # JSONL per-step metrics
    # NetCDF history output (utils/history.py): file stem, flush window,
    # comma-separated diagnostic/state field names
    history_path: str | None = None
    history_every: int = 48
    history_fields: str = "t_grnd,eflx_sh_tot,eflx_lh_tot,fsa,h2osno"

    def make_model(self):
        import torch
        from elmkernels_torch.driver.model import Model
        if self.packed_carry:
            raise NotImplementedError(
                "packed_carry is not ported to elmkernels_torch yet; run "
                "with packed_carry=false")
        kw: dict[str, Any] = dict(
            dtime=self.dtime, pft_path=self.pft_path,
            snicar_path=self.snicar_path,
            snow_aging_path=self.snow_aging_path,
            forcing_basename=self.forcing_basename,
            phenology_path=self.phenology_path,
            elm_correct_snow_aging=self.elm_correct_snow_aging,
            elm_correct_seb=self.elm_correct_seb,
            mixed_radiation=self.mixed_radiation,
            warm_start=self.warm_start, mixed_canopy=self.mixed_canopy,
            device=self.device,
            dtype=torch.float64 if self.f64 else torch.float32)
        if self.surfdata_path is not None:
            return Model.from_surfdata(self.surfdata_path, self.ncol, **kw)
        return Model(ncol=self.ncol, vtype=self.vtype,
                     lat_deg=self.lat_deg, lon_deg=self.lon_deg, **kw)

    def start_date(self):
        from elmkernels_torch.utils.dates import Date
        return Date(self.start_year, self.start_doy, self.start_sec)

    # ---- serialization -----------------------------------------------------
    @classmethod
    def from_file(cls, path) -> "RunConfig":
        """Load from JSON, or YAML by extension; unknown keys raise."""
        path = pathlib.Path(path)
        text = path.read_text()
        if path.suffix in (".yaml", ".yml"):
            import yaml
            data = yaml.safe_load(text)
        else:
            data = json.loads(text)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "RunConfig":
        fields = {f.name: f for f in dataclasses.fields(cls)}
        unknown = set(data) - set(fields)
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}; "
                             f"known: {sorted(fields)}")
        for k, v in data.items():
            tname = fields[k].type
            tname = tname if isinstance(tname, str) else tname.__name__
            base = tname.split("|")[0].strip()
            ok = {"int": lambda x: isinstance(x, int)
                  and not isinstance(x, bool),
                  "float": lambda x: isinstance(x, (int, float))
                  and not isinstance(x, bool),
                  "bool": lambda x: isinstance(x, bool),
                  "str": lambda x: isinstance(x, str)}.get(base)
            if v is not None and ok is not None and not ok(v):
                raise ValueError(
                    f"config key {k!r} expects {tname}, got {v!r}")
        return cls(**data)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.to_dict(), indent=2)
                                      + "\n")

    # ---- CLI ----------------------------------------------------------------
    @classmethod
    def add_cli_args(cls, parser) -> None:
        """Register every field as ``--name`` (bool fields take 0/1)."""
        for f in dataclasses.fields(cls):
            tname = f.type if isinstance(f.type, str) else f.type.__name__
            if tname.startswith("bool"):
                def conv(s):
                    return s not in ("0", "false", "False")
            elif tname.startswith("int"):
                conv = int
            elif tname.startswith("float"):
                conv = float
            else:
                conv = str
            parser.add_argument(f"--{f.name}", type=conv, default=None,
                                help=f"(default: {f.default})")

    @classmethod
    def from_cli(cls, argv=None) -> "RunConfig":
        """``--config file.json`` base + per-field overrides."""
        import argparse
        parser = argparse.ArgumentParser()
        parser.add_argument("--config", default=None,
                            help="JSON/YAML config file")
        cls.add_cli_args(parser)
        ns = parser.parse_args(argv)
        cfg = cls.from_file(ns.config) if ns.config else cls()
        for f in dataclasses.fields(cls):
            v = getattr(ns, f.name)
            if v is not None:
                setattr(cfg, f.name, v)
        return cfg
