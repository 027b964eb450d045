"""The input files each configuration writes, at 24 columns of its grid:
byte for byte the files, at the same paths, that the harness wrote before
its inputs became kinds of their own (``sources/``), pinned by their
SHA-256; and the month files of ``sources/forcing.py``: their layout, the
local solar time of their sun, and the end of what they cover."""

import hashlib
import json
import pathlib

import numpy as np
import pytest

from portbench.tests import _util

from portbench import inputs, manifest  # noqa: E402

PARAMS = {
    "params/clm_params.nc":
        "d0d87d4195f1eab8f1cd1a2f7710f5685cd67c6977246a90b6009da925451178",
    "params/snicar_optics.nc":
        "20a6aef33f485f8b2c7f28589f784c4fea13a46876dd929a06ae14b67808725f"}
GLOBAL = dict(PARAMS, **{
    "global_24/surfdata.nc":
        "3318d8726284dc1d436464d454dd321ead4277afa512e545b82a2685393937cd",
    "global_24/phenology.nc":
        "1013ff8c0c55d884d211f60542c7b4d580bf59cba4784b367f46d35679c890a8",
    "global_24/aerosoldep.nc":
        "2c519f8e584d11993914dfea078f5bc4c5bda4e761b33275d46854d704bdf42e"})
BEFORE = {"global-r05-262k": GLOBAL, "utqiagvik-site-262k": PARAMS,
          "global-r025-1m-4rank": GLOBAL}


def _config(name: str) -> dict:
    return json.loads((_util.ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())


def _written(files: dict, root: pathlib.Path) -> dict:
    return {str(pathlib.Path(p).relative_to(root)):
            hashlib.sha256(pathlib.Path(p).read_bytes()).hexdigest()
            for p in files.values()}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_inputs_are_written_as_before(name, tmp_path, monkeypatch):
    monkeypatch.setattr(inputs, "INPUT_DIR", tmp_path)
    cfg = _config(name)
    files = inputs.files_of(cfg, manifest.kinds_of(cfg), 24)
    assert _written(files, tmp_path) == BEFORE[name]


def test_month_files(tmp_path, monkeypatch):
    from portbench.reference.elm.data.netcdf import mapped
    from portbench.sources import forcing
    monkeypatch.setattr(inputs, "INPUT_DIR", tmp_path)
    cfg = _config("global-r05-262k-gswp3")
    files = inputs.files_of(cfg, manifest.kinds_of(cfg), 24)
    # the global grid's files as before, and five month files beside them
    base = pathlib.Path(files.pop("forcing"))
    assert _written(files, tmp_path) == GLOBAL
    names = sorted(p.name for p in base.parent.iterdir())
    assert names == [f"clmforc.GSWP3.c2011.0.5x0.5.1985-{m:02d}.nc"
                     for m in range(7, 12)]

    def read(f):
        return ({k: (v.dimensions, v.data.dtype.str, v.shape)
                 for k, v in f.variables.items()},
                np.array(f.variables["DTIME"].data),
                np.array(f.variables["FSDS"].data).reshape(248, -1))
    layout, dtime, fsds = mapped(f"{base}1985-07.nc", read)
    assert layout["DTIME"] == (("DTIME",), ">f8", (248,))
    for k in forcing.VARS:
        assert layout[k] == (("DTIME", "lat", "lon"), ">f4", (248, 1, 24))
    np.testing.assert_array_equal(dtime, np.arange(248) * 0.125)
    # the sun at each cell's local solar time: dark where it is night
    lon = mapped(files["surfdata"], lambda f: np.array(
        f.variables["LONGXY"].data, np.float64))
    hour = (dtime[:, None] * 24.0 + lon[None, :] / 15.0) % 24.0
    assert (fsds[(hour < 6.0) | (hour > 18.0)] == 0.0).all()
    assert (fsds[(hour > 7.0) & (hour < 17.0)] > 0.0).all()
    # at 06:00 UTC the sun has risen east of the prime meridian only
    assert fsds[2, 0] == 0.0 and (fsds[2, 1:] > 0.0).all()
    # the last step that the files can force ends at the last sample
    assert forcing.horizon(cfg) == "1985-11-30 21:00"
    assert forcing.grid_shape(cfg["inputs"]["forcing"], 262144) == (512, 512)
    assert forcing.grid_shape(cfg["inputs"]["forcing"], 4096) == (8, 512)
