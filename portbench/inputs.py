"""What a run makes from its configuration, its traffic mix and its seed:
the input files (once per checkout, at fixed paths), the columns the
reference follows, the edits to the cold-start state, and the host
forcing of a coupled caller.  The program and the reference are handed the
same of each.  Numpy and plain PyTorch only; the snowpack is laid out by
the reference's own copy of the reference model's initialisation."""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
# generated inputs, at one fixed place in the checkout (listed in
# .gitignore): a cell's later runs read what its first run wrote
INPUT_DIR = ROOT / "build" / "portbench"


def _ensure(path: pathlib.Path, write) -> str:
    """``path``, written by ``write(file)`` first if it is missing: the
    file appears whole (written aside, then renamed)."""
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        write(tmp)
        os.replace(tmp, path)
    return str(path)


def files_of(cfg: dict, ncol: int | None = None) -> dict:
    """The parameter and input files of a configuration (``ncol`` columns
    of its grid; default the configuration's own), written if missing."""
    from portbench import synthetic
    ncol = cfg["ncol"] if ncol is None else ncol
    par = INPUT_DIR / "params"
    out = dict(pft=_ensure(par / "clm_params.nc", synthetic.write_clm_params),
               snicar=_ensure(par / "snicar_optics.nc",
                              synthetic.write_snicar_optics))
    if cfg["grid"] == "global":
        d = INPUT_DIR / f"global_{ncol}"
        out["surfdata"] = _ensure(
            d / "surfdata.nc",
            lambda p: synthetic.write_global_surfdata(p, ncol))
        if cfg["inputs"].get("phenology"):
            out["phenology"] = _ensure(
                d / "phenology.nc",
                lambda p: synthetic.write_phenology(p, ncol))
        if cfg["inputs"].get("aerosol"):
            out["aerosol"] = _ensure(
                d / "aerosoldep.nc",
                lambda p: synthetic.write_aerosol_deposition(p, ncol))
    return out


def rng(seed: int, stream: str) -> np.random.Generator:
    """The generator of one named stream of a run's seed: the streams are
    independent of one another, and the same seed gives the same draws."""
    tag = int.from_bytes(stream.encode(), "little")
    return np.random.Generator(np.random.PCG64([seed & (2**64 - 1), tag]))


def compared_columns(ncol: int, count: int, seed: int) -> np.ndarray:
    """The ``count`` columns the reference follows, drawn from the seed,
    sorted (every column when ``count`` >= ``ncol``)."""
    if count >= ncol:
        return np.arange(ncol, dtype=np.int64)
    pick = rng(seed, "columns").choice(ncol, size=count, replace=False)
    return np.sort(pick).astype(np.int64)


def state_edits(spec: dict, ncol: int, seed: int) -> dict:
    """The traffic mix's edits to the cold start, drawn from the seed:
    [ncol] numpy arrays.  Every seed draws the same sizes from the same
    ranges."""
    r = rng(seed, "state")
    out = {}
    lo, hi = spec["soil_t_offset_k"]
    out["soil_dt"] = r.uniform(lo, hi, ncol)
    snow = spec.get("snowpack")
    if snow:
        out["snow_depth"] = r.uniform(*snow["depth_m"], ncol)
        out["t_snow"] = r.uniform(*snow["t_snow_k"], ncol)
        out["t_soil"] = r.uniform(*snow["t_soil_k"], ncol)
    return out


def apply_edits(state, edits: dict, cols=None):
    """``state`` (a ``ModelState`` of the program or of the reference,
    which share their field names) with the edits applied, in its own
    dtype and device; ``cols`` picks the edits' rows of a state that holds
    only those columns.  A snowpack is laid out by the reference model's
    depth ladder: 1-5 layers at 250 kg/m3, the soil beneath frozen."""
    from portbench.reference.elm import constants as c
    from portbench.reference.elm.physics import init_state as ini
    from portbench.reference.elm.physics.math_utils import take_layer
    t = state.t_soisno
    dt, dev = t.dtype, t.device

    def col(name):
        a = edits[name] if cols is None else edits[name][cols]
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dt,
                               device=dev)
    ns = c.NLEVSNO
    t_soisno = t.clone()
    liq, ice = state.h2osoi_liq.clone(), state.h2osoi_ice.clone()
    kw = {}
    if "snow_depth" in edits:
        depth = col("snow_depth")
        lay = ini.init_snow_layers(depth, lakpoi=False)
        active = (torch.arange(ns, device=dev)[None, :]
                  >= (ns - lay.snl)[:, None])
        dz, z, zi = state.dz.clone(), state.z.clone(), state.zi.clone()
        dz[:, :ns], z[:, :ns], zi[:, :ns + 1] = lay.dz, lay.z, lay.zi
        ice[:, :ns] = torch.where(active, lay.dz * 250.0, 0.0)
        liq[:, :ns] = 0.0
        h2osno = ice[:, :ns].sum(dim=1)
        frac_sno, snw_rds = ini.init_snow_state(
            c.LandType(ltype=c.ISTSOIL, ctype=1, vtype=0), lay.snl, depth,
            h2osno)
        t_soisno[:, :ns] = torch.where(active, col("t_snow")[:, None], 0.0)
        # frozen soil: every soil layer at the column's temperature, its
        # water all ice
        t_soisno[:, ns:] = col("t_soil")[:, None] + 0.0 * t[:, ns:]
        ice[:, ns:] = ice[:, ns:] + liq[:, ns:]
        liq[:, ns:] = 0.0
        kw.update(snl=lay.snl, snow_depth=depth, h2osno=h2osno,
                  int_snow=h2osno.clone(), frac_sno=frac_sno,
                  frac_sno_eff=frac_sno.clone(), snw_rds=snw_rds, dz=dz,
                  z=z, zi=zi)
    snl = kw.get("snl", state.snl)
    t_soisno[:, ns:] = t_soisno[:, ns:] + col("soil_dt")[:, None]
    kw.update(t_soisno=t_soisno, h2osoi_liq=liq, h2osoi_ice=ice,
              t_grnd=take_layer(t_soisno, ns - snl))
    return state._replace(**kw)


class HostForcing:
    """A coupled caller's forcing and phenology, step by step: the
    analytic seasonal and diurnal cycles of the reference's synthetic
    forcing with per-column offsets drawn from the seed (air temperature,
    humidity, wind, cloud, the phase of the rain events, leaf area), in
    float64 on the host.  A step costs a few array operations a field, as
    a host model's copy of its own interpolated fields would."""

    def __init__(self, ncol: int, seed: int):
        r = rng(seed, "host_forcing")
        self.dtemp = r.uniform(-2.0, 2.0, ncol)
        self.dflds = 4.0 * self.dtemp
        self.qfac = r.uniform(0.8, 1.1, ncol)
        self.wfac = r.uniform(0.7, 1.3, ncol)
        self.cloud = r.uniform(0.6, 1.0, ncol)
        # rain in two of every seven thirds of a day, each column from its
        # own third: the rates of each third of the cycle
        phase = r.integers(0, 7, ncol)
        self.prec = np.where((phase[None, :] + np.arange(7)[:, None]) % 7
                             < 2, 2.5e-5, 0.0)
        self.lai0 = r.uniform(0.8, 1.2, ncol)
        self.zbot = np.full(ncol, 30.0)

    def step(self, date, dtime: float, cols=None):
        """(forcing, phenology) of the step from ``date``: dicts of [ncol]
        arrays keyed as ``HostForcing``/``HostPhenology``; ``cols`` picks
        columns."""
        sel = slice(None) if cols is None else cols
        n = len(self.dtemp[sel])
        tmid = ((date.year * 365.0 + date.doy) * 86400.0 + date.sec
                + 0.5 * dtime)
        doy = (tmid / 86400.0) % 365.0
        hour = (tmid / 3600.0) % 24.0
        air = (278.0 - 12.0 * np.cos(2.0 * np.pi * doy / 365.0)
               + 6.0 * np.sin(2.0 * np.pi * (hour - 9.0) / 24.0))
        sun = max(0.0, np.sin(np.pi * (hour - 6.0) / 12.0))
        green = max(0.0, np.cos(2.0 * np.pi * (doy / 30.4 - 6.5) / 12.0))
        atm = dict(
            atm_tbot=air + self.dtemp[sel],
            atm_pbot=np.full(n, 98000.0 + 500.0 * np.sin(
                2.0 * np.pi * doy / 29.0)),
            atm_qbot=max(1.0e-4, 0.004 + 0.003 * np.sin(
                2.0 * np.pi * doy / 365.0)) * self.qfac[sel],
            atm_flds=(220.0 + 60.0 * np.cos(2.0 * np.pi * (doy - 200.0)
                                            / 365.0)) + self.dflds[sel],
            atm_fsds=600.0 * sun * (0.6 + 0.4 * np.sin(
                2.0 * np.pi * doy / 365.0)) * self.cloud[sel],
            atm_prec=self.prec[int(np.floor(doy * 3.0)) % 7][sel],
            atm_wind=(3.0 + 2.0 * np.sin(2.0 * np.pi * doy / 13.0))
            * self.wfac[sel],
            atm_zbot=self.zbot[sel])
        phen = dict(lai=(1.0 + 2.0 * green) * self.lai0[sel],
                    sai=np.full(n, 0.3 + 0.2 * green),
                    htop=np.full(n, 0.5), hbot=np.full(n, 0.01))
        return atm, phen
