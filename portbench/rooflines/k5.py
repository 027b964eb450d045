"""K5, the snow-hydrology block (``ops/snow.py`` +
``csrc/snow_hydrology.cu``), one launch a step.

Bytes: its [ncol] inputs (26 at most: 15 fields and 11 deposition rates)
read once where they vary by column; every row of t, ice, liq and dz,
which it copies through; z and zi from the top soil position down; the 5
snow positions of the grain radius and the six aerosol masses and of
``imelt``; ``snl``, ``do_capsnow`` and the land-type masks where they vary;
at each active layer that melts one of ``swe_old``/``frac_iceold``; with
ELM's aging the refreezing rates of the active layers after the block and
the tables; its outputs once (11 [ncol] fields, the layers, the grain
radius and the species).  Operations: 1,600 a column.  Its work depends on
the data: the melting layers are counted where the caller knows them, and
given as 0 (fewer bytes than the kernel moves) where it does not."""

from portbench.rooflines.peaks import ms

COLUMN_FLOPS = 1600
OUT_FIELDS = 11
SPECIES = 6


def bound(ncol: int, dtype: str, column_fields: int = 26, nlevtot: int = 20,
          nlevsno: int = 5, capsnow_per_column: bool = True,
          land_masks_per_column: int = 0, melting_layers: int = 0,
          aging_rows: int = 0, table_elements: int = 0):
    item = 8 if dtype == "float64" else 4
    rows = 4 * nlevtot + (nlevtot - nlevsno) + (nlevtot + 1 - nlevsno)
    rows += (1 + SPECIES) * nlevsno
    per_col = item * (column_fields + rows) + 8 * (1 + nlevsno)
    per_col += 8 * bool(capsnow_per_column) + land_masks_per_column
    nbytes = ncol * per_col + item * (melting_layers + aging_rows
                                      + table_elements)
    nbytes += ncol * (8 + item * (OUT_FIELDS + 6 * nlevtot + 1
                                  + nlevsno * (1 + 2 * SPECIES)))
    return ms(nbytes, ncol * COLUMN_FLOPS, dtype)


def launch_ms(run: dict):
    """The bound of one launch in the traced call, in ms, on the cell's
    shapes.  The snow at the call's start (``traced["snow"]``) bounds the
    one term that depends on the data: a melting layer is an active one,
    but which melt is decided inside the step, so they count 0 here and
    the bound is low by at most ``layers`` elements (a share of it the
    harness prints)."""
    traced = run["traced"]
    if "snow" not in traced:
        return None
    return max(bound(run["ncol"], run["config"]["dtype"]))
