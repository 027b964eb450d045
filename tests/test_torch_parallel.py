"""The port's column sharding against the JAX package and against its own
unsharded runs, on the CPU.

- ``utils/domain.py`` and ``parallel/reductions.py`` equal the JAX
  package's functions on every tested input.
- Ranks run as subprocesses (``tests/torch_parallel_worker.py``) over a
  gloo group on ``tcp://127.0.0.1``, each test on a free port of its own.
  Each rank builds only its block of columns and starts from the
  unsharded initial state cut by ``shard_state``.  Its final block must
  equal the unsharded port run (one more subprocess) bit for bit; under
  the exact flags
  (``mixed_radiation``, ``warm_start`` and ``mixed_canopy`` off) it must
  also equal the JAX package's unsharded run at rtol 1e-10.  The global
  diagnostics must equal the unsharded reductions: maxima exactly, means
  at rtol 1e-12.
- These mirror ``tests/test_multihost.py``: the two-process step, the
  four-process uneven series from shared month files (21 columns at
  offset 2 of a (7, 4) grid, blocks of 6, 6, 6 and 3 with no pad) and the
  two-process series from shared files; and
  ``tests/test_infrastructure.py``'s partition and reduction checks.

On the CPU, PyTorch's vectorised elementwise kernels compute the elements
of a SIMD body and those of the scalar tail with different functions
(SLEEF's and libm's ``pow``/``exp``, one ulp apart at times), so a
column's last bit depends on its position in the batch: 6 columns alone
and the same 6 inside 21 then differ (``pow`` in the canopy fluxes, after
7 steps of the four-rank case).  The subprocesses therefore run ATen's
scalar CPU capability (``ATEN_CPU_CAPABILITY=default``), where both paths
are libm's.  On the card every element runs the same code, and
``chip_smoke.py`` holds the ranks' blocks to the unsharded run bit for
bit there with its kernels.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from elmkernels_torch import parallel
from elmkernels_torch.data import synthetic
from elmkernels_torch.driver.model import Model as TModel
from elmkernels_torch.utils import domain as tdomain
from elmkernels_torch.utils.dates import Date as TDate
from elmkernels_tpu.parallel import reductions as jred
from elmkernels_tpu.utils import domain as jdomain
from elmkernels_tpu.utils.dates import Date as JDate

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).resolve().parent / "torch_parallel_worker.py"
TIMEOUT_S = 300
EXACT = dict(mixed_radiation=False, warm_start=False, mixed_canopy=False)
# the JAX multihost test's series start: crosses July into August
SERIES_START = (1985, 211, 21 * 3600)
STEP_START = (1985, 181, 6 * 3600)
MEAN_RTOL = 1e-12


# ---- pure functions against the JAX package ---------------------------------

@pytest.mark.parametrize("nprocs", list(range(1, 17)) + [24, 36, 97, 128])
def test_square_numprocs_matches_jax(nprocs):
    assert tdomain.square_numprocs(nprocs) == jdomain.square_numprocs(nprocs)


@pytest.mark.parametrize("grid,nprocs", [((7, 9), 6), ((7, 4), 4),
                                         ((4, 2), 2), ((64, 128), 8),
                                         ((5, 3), 7), ((1, 1), 1),
                                         ((360, 720), 12), ((3, 11), 9)])
def test_domain_decomposition_matches_jax(grid, nprocs):
    seen = set()
    for r in range(nprocs):
        t = tdomain.create_domain_decomposition_2d(grid, nprocs, r)
        j = jdomain.create_domain_decomposition_2d(grid, nprocs, r)
        assert (t.n_global, t.start, t.n_local, t.ncells) == \
            (j.n_global, j.start, j.n_local, j.ncells)
        seen |= {(t.start[0] + i, t.start[1] + k)
                 for i in range(t.n_local[0]) for k in range(t.n_local[1])}
    assert len(seen) == grid[0] * grid[1]


@pytest.mark.parametrize("ncol,nranks", [(8, 2), (21, 4), (21, 8), (5, 4),
                                         (1, 1), (8192, 3), (262144, 7),
                                         (7, 7), (100, 16)])
def test_column_blocks_match_jax(ncol, nranks):
    """The same ceil-rule blocks; the port's ranks take the real columns
    of each (lo, hi) and refuse an empty range instead of padding."""
    blocks, block = tdomain.column_blocks(ncol, nranks)
    assert (blocks, block) == jdomain.column_blocks(ncol, nranks)
    for r, (lo, hi) in enumerate(blocks):
        if hi > lo:
            assert tdomain.rank_block(ncol, nranks, r) == (lo, hi)
        else:
            with pytest.raises(ValueError, match=f"ncol={ncol} over "
                               f"{nranks} ranks"):
                tdomain.rank_block(ncol, nranks, r)


def test_column_mesh_refuses_an_empty_block(monkeypatch):
    """5 columns over 4 ranks: ceil-rule blocks of 2 leave rank 3 none."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 3)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    with pytest.raises(ValueError, match="ncol=5 over 4 ranks"):
        parallel.column_mesh(5, group=object(), device="cpu")


@pytest.mark.parametrize("seed,shape", [(0, (64,)), (1, (1000,)),
                                        (2, (37, 5))])
def test_min_max_sum_and_mean_match_jax(seed, shape):
    x = np.random.default_rng(seed).normal(280.0, 15.0, shape)
    for tf, jf in ((parallel.min_max_sum, jred.min_max_sum),
                   (parallel.min_max_mean, jred.min_max_mean)):
        t, j = tf(torch.as_tensor(x)), jf(jax.numpy.asarray(x))
        for a, b in zip(t, j):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-14)


def test_shard_helpers_cut_columns_and_keep_tables():
    """shard_state/shard_params/shard_forcing as the JAX package places
    them: per-column arrays cut (forcing brackets on axis 1), tables and
    scalars whole."""
    mesh = parallel.ColumnMesh(group=None, rank=1, nranks=3, ncol_global=7,
                               col0_global=2, lo=3, hi=6,
                               device=torch.device("cpu"))
    assert (mesh.ncol, mesh.col0) == (3, 5)
    col = np.arange(7.0)
    table = np.arange(11 * 31 * 8.0).reshape(11, 31, 8)
    st = parallel.shard_state(mesh, (torch.as_tensor(col),
                                     torch.arange(14).reshape(7, 2)))
    assert st[0].tolist() == [3.0, 4.0, 5.0]
    assert st[1].tolist() == [[6, 7], [8, 9], [10, 11]]
    pr = parallel.shard_params(mesh, (col, table, np.float64(2.5)))
    assert pr[0].tolist() == [3.0, 4.0, 5.0]
    assert torch.equal(pr[1], torch.as_tensor(table))
    assert float(pr[2]) == 2.5
    fo = parallel.shard_forcing(mesh, (0.25, np.stack([col, col + 10]),
                                       col, np.ones((11, 7))))
    assert fo[0] == 0.25
    assert fo[1].tolist() == [[3.0, 4.0, 5.0], [13.0, 14.0, 15.0]]
    assert fo[2].tolist() == [3.0, 4.0, 5.0] and fo[3].shape == (11, 3)
    with pytest.raises(ValueError, match="7 columns"):
        parallel.shard_state(mesh, (torch.zeros(6),))


# ---- ranks in subprocesses ----------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp_path, nranks: int, spec: dict, oracle: bool = True):
    """Run ``nranks`` workers on one gloo group, and with ``oracle`` the
    unsharded run beside them; returns each rank's results and the
    unsharded run's (or None)."""
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    out = tmp_path / "out"
    out.mkdir()
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", ATEN_CPU_CAPABILITY="default")
    runs = [(nranks, r) for r in range(nranks)] + ([(0, 0)] if oracle
                                                   else [])
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(port), str(n), str(r),
         str(spec_path), str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for n, r in runs]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (n, r), p, log in zip(runs, procs, logs):
        name = r if n else "unsharded"
        assert p.returncode == 0 and f"rank {name}: OK" in log, \
            f"rank {name} failed:\n{log}"
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(nranks)]
    return ranks, (torch.load(out / "unsharded.pt", weights_only=False)
                   if oracle else None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tp.write_files(tmp_path_factory.mktemp("torch_parallel"))


def _spec(files, tmp_path, ncol, col0=0, **kw):
    """A worker spec, with the unsharded model's initial state saved for
    the ranks to cut."""
    flags = kw.pop("flags", {})
    model = TModel(ncol=ncol, col0=col0, pft_path=files[0],
                   snicar_path=files[1], device="cpu",
                   forcing_basename=kw.get("forcing_basename"), **flags)
    torch.save(model.state._asdict(), tmp_path / "initial.pt")
    return dict(ncol=ncol, col0=col0, pft_path=files[0],
                snicar_path=files[1], flags=flags,
                initial_state=str(tmp_path / "initial.pt"), **kw)


def _assert_blocks_equal(ranks, state):
    covered = 0
    for r, res in enumerate(ranks):
        assert res["cold_start_same"], f"rank {r}'s own cold start differs"
        lo, hi = res["lo"], res["hi"]
        covered += hi - lo
        for k in state._fields:
            assert torch.equal(getattr(res["state"], k),
                               getattr(state, k)[lo:hi]), (r, k)
    assert covered == state.t_grnd.shape[0]


def _assert_diags_global(got, want):
    """Maxima exactly, means at rtol 1e-12."""
    for k in want._fields:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k.endswith("_mean"):
            torch.testing.assert_close(a, b, rtol=MEAN_RTOL, atol=0,
                                       msg=k)
        else:
            assert torch.equal(a, b), (k, a, b)


def test_two_ranks_one_step(files, tmp_path):
    spec = _spec(files, tmp_path, 8, scenario="step",
                 start=list(STEP_START))
    ranks, one = _launch(tmp_path, 2, spec)
    _assert_blocks_equal(ranks, one["state"])
    for res in ranks:
        assert (res["lo"], res["hi"]) in ((0, 4), (4, 8))
        _assert_diags_global(res["diags"], one["diags"])
        for k in ("errsol", "t_grnd"):     # min, max, sum or mean
            assert float(res[k].min) == float(one[k].min), k
            assert float(res[k].max) == float(one[k].max), k
            torch.testing.assert_close(res[k].sum, one[k].sum,
                                       rtol=MEAN_RTOL, atol=0)
        assert float(res["errsol"].max) < 1e-4


SERIES = {
    # name: (ranks, ncol, col0, (nlat, nlon), flags)
    "one rank": (1, 8, 0, (4, 2), {}),
    "two ranks, shared files": (2, 8, 0, (4, 2), {}),
    "four ranks, uneven, exact flags": (4, 21, 2, (7, 4), EXACT),
}


@pytest.mark.parametrize("case", list(SERIES))
def test_series_from_shared_files(files, tmp_path, case):
    """8 steps of run_windows(series=True, window=4) from month files that
    every rank reads by hyperslab: each block bit for bit the unsharded
    run's, the window diagnostics and metrics records the domain's, each
    rank's checkpoint restored bit for bit and refused unsharded."""
    nranks, ncol, col0, (nlat, nlon), flags = SERIES[case]
    base = str(tmp_path / "forc_")
    synthetic.write_forcing_months(base, 1985, 7, 2, nlat, nlon)
    spec = _spec(files, tmp_path, ncol, col0, scenario="series",
                 start=list(SERIES_START), nsteps=8, window=4,
                 forcing_basename=base, flags=flags)
    ranks, one = _launch(tmp_path, nranks, spec)
    records = one["records"]
    _assert_blocks_equal(ranks, one["state"])
    for r, res in enumerate(ranks):
        _assert_diags_global(res["diags"], one["diags"])
        assert res["checkpoint_equal"], r
        assert "written for block" in res["checkpoint_refused"], r
        for got, rec in zip(res["records"], records):
            for k, v in rec.items():
                if k.endswith("_mean"):
                    assert got[k] == pytest.approx(v, rel=MEAN_RTOL), k
                elif k != "ts":
                    assert got[k] == v, k
        # every forcing read is a hyperslab of this rank's lat rows
        c0, c1 = col0 + res["lo"], col0 + res["hi"]
        rows = (c1 - 1) // nlon - c0 // nlon + 1
        assert res["reads"]
        for name, start, count in res["reads"]:
            assert start is not None and count[1] <= rows, (name, count)
    if nranks == 4:
        assert [(r["lo"], r["hi"]) for r in ranks] == \
            [(0, 6), (6, 12), (12, 18), (18, 21)]
    lines = (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2        # rank 0 writes, once a window
    if flags == EXACT:
        jm = tp.jax_model(files, ncol, col0=col0, forcing_basename=base,
                          **flags)
        jm.run(JDate(*SERIES_START), 8)
        for res in ranks:
            lo, hi = res["lo"], res["hi"]
            for k in one["state"]._fields:
                np.testing.assert_allclose(
                    tp.as_numpy(getattr(res["state"], k)),
                    np.asarray(getattr(jm.state, k))[lo:hi],
                    rtol=tp.RTOL, atol=tp.ATOL, err_msg=k)


def test_clock_spans_ranks(files, tmp_path):
    spec = _spec(files, tmp_path, 4, scenario="clock",
                 start=list(STEP_START))
    ranks, _ = _launch(tmp_path, 2, spec, oracle=False)
    local = [r["local"] for r in ranks]
    for res in ranks:
        lo, hi, mean = res["min_max_mean"]
        assert (lo, hi) == (min(local), max(local))
        assert mean == pytest.approx(sum(local) / 2, rel=1e-12)
    assert local[1] > local[0]


def test_guard_trips_and_rolls_back_every_rank(files, tmp_path):
    """A NaN on one rank's column trips the guard on both ranks (it decides
    on the global maxima), and each rolls its own block back to the last
    validated window."""
    spec = _spec(files, tmp_path, 6, scenario="guard",
                 start=list(STEP_START), window=2, bad_rank=1)
    ranks, _ = _launch(tmp_path, 2, spec, oracle=False)
    from elmkernels_torch.utils.checkpoint import PRIMARY_VARS
    for r, res in enumerate(ranks):
        assert res["first"], r
        second = res["second"]
        assert not second["ok"] and second["can_roll_back"], (r, second)
        assert "non-finite t_grnd" in second["reasons"], (r, second)
        for k in PRIMARY_VARS:
            assert torch.equal(getattr(res["restored"], k),
                               getattr(res["validated"], k)), (r, k)
