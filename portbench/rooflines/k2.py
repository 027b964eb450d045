"""K2, the canopy stability loop (``ops/canopy.py`` +
``csrc/canopy_stability.cu``), one launch a step.

Bytes: each [ncol] input read once (its 56 fields, 2 layers of
``t_soisno``, the traits that differ between columns, the ci carry of both
leaves where warm started), each of its 29 outputs and the counts written
once, plus the integer and mask bytes of a column.  Operations: 415 a pass
a column commits, 180 a vegetated column's recompute, 70 a ci evaluation.
A count the run cannot see from outside the step (vegetated columns, the
starting evaluations of each pass) may be given as 0: the bound then
counts less than the kernel does, never more."""

from portbench.rooflines.peaks import ms

IN_FIELDS = 56
OUT_FIELDS = 29
PASS_FLOPS = 415
FINAL_FLOPS = 180
CI_FUNC_FLOPS = 70


def bound(ncol: int, dtype: str, varying_traits: int, warm: bool,
          passes: float, vegetated: float = 0, ci_evals: float = 0):
    """(bytes ms, operations ms) of one launch over ``ncol`` columns in
    ``dtype``; ``passes`` the passes the columns commit in all,
    ``ci_evals`` the ci evaluations of the day leaves."""
    item = 8 if dtype == "float64" else 4
    values = IN_FIELDS + 2 + varying_traits + 2 * bool(warm) + OUT_FIELDS + 2
    nbytes = ncol * (values * item + 4 + 1 + 4 + 2 * 4)
    ops = (passes * PASS_FLOPS + vegetated * FINAL_FLOPS
           + ci_evals * CI_FUNC_FLOPS)
    return ms(nbytes, ops, dtype)


def varying_traits(cfg: dict, files: dict) -> int:
    """The traits K2 reads that differ between the grid's columns."""
    import numpy as np
    import torch

    from portbench.reference.columns import grid_fields
    from portbench.reference.elm.data import params as params_mod
    vt = np.asarray(grid_fields(cfg, files)["vtype"], np.int64)
    if vt.ndim == 0:
        return 0
    p = params_mod.gather_pft_psn(params_mod.load_pft_table(files["pft"]),
                                  vt, torch.float64)
    return sum(1 for v in p if v.ndim and bool((v != v[0]).any()))


def launch_ms(run: dict):
    """The bound of one launch in the traced call, in ms: the cell's
    shapes and traits, and the canopy passes and ci evaluations a launch
    that the call's diagnostics report (their means over the columns,
    step by step); vegetated columns are not seen and count 0."""
    cfg, n, traced = run["config"], run["ncol"], run["traced"]
    diags = traced.get("diags")
    if not diags or "niters_canopy_mean" not in diags:
        return None
    dtype = "float32" if cfg["flags"]["mixed_canopy"] else cfg["dtype"]
    launches = traced["steps"]
    return max(bound(
        n, dtype, varying_traits(dict(cfg, ncol=n), run["files"]),
        cfg["flags"]["warm_start"],
        passes=float(diags["niters_canopy_mean"].sum()) * n / launches,
        ci_evals=float(diags["niters_ci_mean"].sum()) * n / launches))
