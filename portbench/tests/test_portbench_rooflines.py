"""The kernels' operation and byte counts of ``portbench/rooflines``
against ``chip_smoke.py``'s formulas, on calls the port makes on the CPU
(the plain versions of K2 and K5 take the kernels' arguments) at a few
columns of each configuration."""

import json

import pytest
import torch

from portbench.tests import _util

import chip_smoke  # noqa: E402
from portbench.rooflines import k2, k5  # noqa: E402


def _calls(config: str, traffic: str, ncol: int = 24, steps: int = 2):
    """The keyword arguments and results of the plain K2 and K5 calls of
    ``steps`` steps of the port on the CPU."""
    import elmkernels_torch.physics.canopy_fluxes as cfx
    import elmkernels_torch.physics.snow_hydrology as sh
    from portbench import drive, inputs
    cfg = json.loads((_util.ROOT / "portbench" / "configs"
                      / f"{config}.json").read_text())
    tr = json.loads((_util.ROOT / "portbench" / "traffic"
                     / f"{traffic}.json").read_text())
    files = inputs.files_of(cfg, ncol)
    model = drive.build_model(cfg, files, ncol, torch.device("cpu"))
    model.state = inputs.apply_edits(
        model.state, inputs.state_edits(tr["state"], ncol, 7))
    seen = {"k2": [], "k5": []}
    plain2, plain5 = (cfx.stability_iteration_plain,
                      sh.snow_hydrology_block_plain)

    def k2_call(**kw):
        out = plain2(**kw)
        seen["k2"].append((kw, out))
        return out

    def k5_call(**kw):
        out = plain5(**kw)
        seen["k5"].append((kw, out))
        return out
    cfx.stability_iteration_plain, sh.snow_hydrology_block_plain = (
        k2_call, k5_call)
    try:
        date = drive._date(tr["start"])
        date.increment_seconds(12 * 3600)      # noon: day leaves
        for _ in range(steps):
            model.advance(date)
            date.increment_seconds(int(cfg["dtime"]))
    finally:
        cfx.stability_iteration_plain, sh.snow_hydrology_block_plain = (
            plain2, plain5)
    return cfg, files, seen


CASES = [("global-r05-262k", "july-windows"),
         ("utqiagvik-site-262k", "spring-snowpack-windows")]


@pytest.mark.parametrize("config,traffic", CASES)
def test_k2_counts_match_chip_smoke(config, traffic):
    cfg, files, seen = _calls(config, traffic)
    assert seen["k2"]
    for kw, out in seen["k2"]:
        n = kw["t_grnd"].shape[0]
        dtype = str(kw["t_grnd"].dtype).replace("torch.", "")
        itlef = out.itlef.long()
        day = sum((kw[k].reshape(n, -1)[:, 0] > 0).long()
                  for k in ("parsun_z", "parsha_z"))
        evals = 2 * int((itlef * day).sum()) + int(out.psn_iters.long().sum())
        varying = sum(1 for v in kw["p"]
                      if v.ndim and bool((v != v.reshape(-1)[0]).any()))
        mine = k2.bound(n, dtype, varying, kw["warm_start"],
                        passes=int(itlef.sum()),
                        vegetated=int((kw["frac_veg_nosno"] != 0).sum()),
                        ci_evals=evals)
        assert mine == pytest.approx(chip_smoke.k2_bound(kw, out),
                                     rel=1e-12)
        # the harness counts the traits of the whole grid: at these
        # columns, the same
        assert k2.varying_traits(dict(cfg, ncol=n), files) == varying
        # what the harness sees from outside the step (passes and the
        # ci iterations, no vegetated count) bounds no more than that
        outside = k2.bound(n, dtype, varying, kw["warm_start"],
                           passes=int(itlef.sum()),
                           ci_evals=int(out.psn_iters.long().sum()))
        assert outside[0] == mine[0] and outside[1] <= mine[1]


@pytest.mark.parametrize("config,traffic", CASES)
def test_k5_counts_match_chip_smoke(config, traffic):
    _, _, seen = _calls(config, traffic)
    assert seen["k5"]
    for kw, out in seen["k5"]:
        n = kw["t_soisno"].shape[0]
        dtype = str(kw["t_soisno"].dtype).replace("torch.", "")
        k = chip_smoke.k5_bound(kw, out)
        ns = 5
        active = (torch.arange(ns)[None, :] >= (ns - kw["snl"])[:, None])
        melting = int((active & (kw["imelt"][:, :ns] == 1)).sum())
        mine = k5.bound(n, dtype, melting_layers=melting)
        assert mine == pytest.approx(k, rel=1e-12)
        # without the melting layers, which the harness cannot see, the
        # bound counts less, and by at most one element a snow layer
        assert k5.bound(n, dtype)[0] <= k[0]
        layers = int(kw["snl"].sum())
        assert k5.bound(n, dtype, melting_layers=layers)[0] >= k[0]


def test_launch_ms_from_the_traced_call():
    import numpy as np
    from portbench import inputs
    cfg = json.loads((_util.ROOT / "portbench" / "configs"
                      / "global-r05-262k.json").read_text())
    files = inputs.files_of(cfg, 24)
    # two traced steps: 3 and 5 canopy passes a column, 1 ci evaluation
    diags = dict(niters_canopy_mean=np.array([3.0, 5.0]),
                 niters_ci_mean=np.array([1.0, 1.0]))
    run = dict(config=cfg, files=files, ncol=24, measured={},
               traced=dict(steps=2, diags=diags, snow=dict(layers=0)))
    varying = k2.varying_traits(dict(cfg, ncol=24), files)
    assert k2.launch_ms(run) == max(k2.bound(
        24, "float32", varying, True, passes=4.0 * 24, ci_evals=24.0))
    assert k5.launch_ms(run) == max(k5.bound(24, "float64"))
    # nothing to count from: no bound
    bare = dict(run, traced=dict(steps=2))
    assert k2.launch_ms(bare) is None and k5.launch_ms(bare) is None

