"""The packed state carry (``elmkernels_torch/utils/packing.py``,
``Model(packed_carry=True)``): one ``[ncol, K]`` buffer per dtype, the
state's fields views into them, the device loops' results bit for bit
those of the unpacked loops (atol 0 on the state and the diagnostics: the
eager loop has no fusion to give them slack), against the JAX package's
packed model at the step's parity tolerance, through ``RunConfig`` and
the bench twin, and over two gloo ranks.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel as tpar
import torch_parity as tp
from elmkernels_torch import constants as c
from elmkernels_torch import config as tconfig
from elmkernels_torch.data.state import cold_start
from elmkernels_torch.physics import init_state as ini
from elmkernels_torch.utils import checkpoint
from elmkernels_torch.utils.dates import Date as TDate
from elmkernels_torch.utils.packing import (PackedCarry, pack_tree,
                                            template_of, unpack_tree)
from elmkernels_tpu.data.state import ModelState as JState
from elmkernels_tpu.utils import packing as jpacking
from elmkernels_tpu.utils.dates import Date as JDate

torch.set_num_threads(1)

EXACT = dict(mixed_radiation=False, warm_start=False, mixed_canopy=False)
# a winter morning: sun up, snow on the ground
WINTER = (1985, 1, 10, 10 * 3600)
NCOL = 37       # past AVX-512's 16-double loop body, with a tail


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tp.write_files(tmp_path_factory.mktemp("torch_packing"))


def snowy(model):
    """The model's cold start with a snow pack of 0-5 layers: the
    reference's ``init_snow_layers`` ladder on depths 0 to 0.5 m, 250
    kg/m3 of ice in each active layer at 265 K."""
    st = model.state
    n, ns = model.ncol, c.NLEVSNO
    depth = torch.tensor([0.0, 0.05, 0.12, 0.3, 0.5] * n,
                         dtype=st.dz.dtype)[:n]
    lay = ini.init_snow_layers(depth, False)
    act = torch.arange(ns)[None, :] >= (ns - lay.snl)[:, None]

    def snow_rows(full, rows):
        out = full.clone()
        out[:, :ns] = torch.where(act, rows, 0.0)
        return out
    ice = snow_rows(st.h2osoi_ice, 250.0 * lay.dz)
    h2osno = ice[:, :ns].sum(1)
    frac, rds = ini.init_snow_state(model.land, lay.snl, depth, h2osno)
    return st._replace(
        snl=lay.snl, snow_depth=depth, h2osno=h2osno,
        dz=snow_rows(st.dz, lay.dz), z=snow_rows(st.z, lay.z),
        zi=snow_rows(st.zi, lay.zi[:, :ns]), h2osoi_ice=ice,
        t_soisno=snow_rows(st.t_soisno, torch.full_like(lay.dz, 265.0)),
        frac_sno=frac, frac_sno_eff=frac, snw_rds=rds,
        t_grnd=torch.full_like(st.t_grnd, 265.0))


def _shares_storage(t, buf) -> bool:
    return t.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()


def test_pack_unpack_round_trip_as_views():
    st = cold_start(5)
    bufs = pack_tree(st)
    # one float64 buffer, one int64 buffer (snl), in dtype-name order
    assert [b.dtype for b in bufs] == [torch.float64, torch.int64]
    assert all(b.shape[0] == 5 and b.is_contiguous() for b in bufs)
    back = unpack_tree(bufs, template_of(st), type(st))
    for name, a, b in zip(st._fields, st, back):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
        buf = bufs[0] if b.dtype == torch.float64 else bufs[1]
        assert _shares_storage(b, buf), name    # a view, not a copy
    # the same buffers as the JAX package's pack_tree of the same state
    jbufs = jpacking.pack_tree(JState(*(jnp.asarray(a.numpy()) for a in st)))
    assert len(jbufs) == 2
    np.testing.assert_array_equal(bufs[0].numpy(), np.asarray(jbufs[0]))
    np.testing.assert_array_equal(bufs[1].numpy(), np.asarray(jbufs[1]))
    # a write through the buffer shows in the view: the first float64
    # field, snow_depth, is the float64 buffer's column 0
    assert st._fields[:2] == ("snl", "snow_depth")
    bufs[0][:, 0] = 1.5
    assert bool((back.snow_depth == 1.5).all())


def test_update_copies_and_reads_aliased_fields_first():
    """A step output whose field is another slot's view is read before
    the slots are written; a passed-through slot is not copied."""
    st = cold_start(3)
    carry = PackedCarry(st)
    s = carry.state
    i, j = st._fields.index("t_grnd"), st._fields.index("t_veg")
    new = s._replace(t_grnd=s.t_veg, t_veg=s.t_grnd + 1.0)
    want_grnd, want_veg = s.t_veg.clone(), s.t_grnd + 1.0
    assert carry.nbytes_per_step(new) == 2 * 3 * 8
    carry.update(new)
    assert torch.equal(carry.state[i], want_grnd)
    assert torch.equal(carry.state[j], want_veg)
    assert carry.state is s and _shares_storage(carry.state[i],
                                                carry.buffers[0])
    with pytest.raises(ValueError, match="does not fit"):
        carry.update(s._replace(t_grnd=torch.zeros(4, dtype=torch.float64)))


def _run(model, loop, start, nsteps):
    date = TDate.from_ymd(*start)
    if loop == "run_windows":
        return model.run_windows(date, nsteps, window=3, series=True)
    if loop == "run_windows_stack":
        return model.run_windows(date, nsteps, window=3)
    return getattr(model, loop)(date, nsteps)


@pytest.mark.parametrize("loop", ["run_scan", "run_scan_series",
                                  "run_windows", "run_windows_stack"])
def test_packed_loops_equal_unpacked(files, loop):
    """6 winter steps with snow layers, production flags: every state
    field and every diagnostic equal at atol 0; the carry keeps its
    buffers through the loop and the next one."""
    a = tp.torch_model(files, NCOL)
    b = tp.torch_model(files, NCOL, packed_carry=True)
    a.state, b.state = snowy(a), snowy(b)
    assert int(a.state.snl.max()) == 5
    da = _run(a, loop, WINTER, 6)
    db = _run(b, loop, WINTER, 6)
    for k, x, y in zip(a.state._fields, a.state, b.state):
        assert x.dtype == y.dtype and torch.equal(x, y), k
    for k, x, y in zip(da._fields, da, db):
        assert torch.equal(x, y), k
    bufs = b._carry.buffers
    assert all(_shares_storage(t, bufs[0] if t.is_floating_point()
                               else bufs[1]) for t in b.state)
    # the next loop runs in the same buffers
    ptrs = [t.data_ptr() for t in bufs]
    later = (1985, 1, 10, 13 * 3600)
    _run(a, loop, later, 3)
    _run(b, loop, later, 3)
    assert [t.data_ptr() for t in b._carry.buffers] == ptrs
    for k, x, y in zip(a.state._fields, a.state, b.state):
        assert torch.equal(x, y), k


def test_state_set_from_outside_is_copied_into_the_carry(files):
    """A state assigned after a packed loop (a restore, a rollback) is
    copied into the same buffers; the next loop equals an unpacked one."""
    a = tp.torch_model(files, 8)
    b = tp.torch_model(files, 8, packed_carry=True)
    a.state, b.state = snowy(a), snowy(b)
    b.run_scan(TDate.from_ymd(*WINTER), 2)
    ptrs = [t.data_ptr() for t in b._carry.buffers]
    b.state = a.state._replace(t_grnd=a.state.t_grnd.clone())
    a.run_scan_series(TDate.from_ymd(*WINTER), 3)
    b.run_scan_series(TDate.from_ymd(*WINTER), 3)
    assert [t.data_ptr() for t in b._carry.buffers] == ptrs
    for k, x, y in zip(a.state._fields, a.state, b.state):
        assert torch.equal(x, y), k


def test_checkpoint_of_a_packed_state_holds_fields_alone(files, tmp_path):
    m = tp.torch_model(files, 6, packed_carry=True)
    m.run_scan(TDate.from_ymd(*WINTER), 1)
    checkpoint.save(tmp_path / "ck.pt", m.state)
    raw = torch.load(tmp_path / "ck.pt", weights_only=True)
    for k, v in zip(m.state._fields, m.state):
        t = raw[k]
        assert torch.equal(t, v), k
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    back = checkpoint.restore(tmp_path / "ck.pt", device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(back, m.state))


def test_packed_run_matches_jax_packed_model(files):
    """The port's packed run_scan_series against the JAX package's
    Model(packed_carry=True), exact flags, from the same snowy state:
    rtol 1e-10 and equal iteration counts."""
    n = 4
    tm = tp.torch_model(files, n, packed_carry=True, **EXACT)
    tm.state = snowy(tm)
    jm = tp.jax_model(files, n, packed_carry=True, **EXACT)
    with jax.default_device(jax.devices("cpu")[0]):
        jm.state = JState(*(jnp.asarray(a.numpy().astype(np.int32))
                            if k == "snl" else jnp.asarray(a.numpy())
                            for k, a in zip(tm.state._fields, tm.state)))
        jd = jm.run_scan_series(JDate.from_ymd(*WINTER), 3)
    td = tm.run_scan_series(TDate.from_ymd(*WINTER), 3)
    tp.assert_close(tp.nt_numpy(jm.state),
                    {k: v.numpy() for k, v in tm.state._asdict().items()})
    for k in ("niters_canopy_max", "niters_ci_mean"):
        np.testing.assert_array_equal(np.asarray(getattr(jd, k)),
                                      getattr(td, k).numpy(), k)
    for k in ("errsol_max", "errh2o_led_max", "fsa_mean", "t_ref2m_mean"):
        tp.assert_close(np.asarray(getattr(jd, k)), getattr(td, k).numpy(),
                        path=k)


def test_run_config_packed_builds_and_runs(files):
    cfg = tconfig.RunConfig(ncol=3, packed_carry=True, device="cpu",
                            pft_path=files[0], snicar_path=files[1])
    m = cfg.make_model()
    assert m.packed_carry is True
    d = m.run_scan(cfg.start_date(), 2)
    assert bool(torch.isfinite(d.errsol_max).all())
    assert m._carry is not None and m.state is m._carry.state
    assert tconfig.RunConfig.from_dict(
        json.loads(json.dumps(cfg.to_dict()))).packed_carry is True


def test_bench_twin_packed_on_cpu():
    import test_torch_entry_points as tep
    res = tep._run("elmkernels_torch.bench", dict(
        tep.TINY, BENCH_PACKED="1", BENCH_SCAN="1", BENCH_STEPS="1"))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["value"] > 0
    assert "packed-carry" in res.stderr


def test_sharded_packed_equals_unpacked(files, tmp_path):
    """run_windows(series=True) over 2 gloo ranks with the packed carry:
    each rank's block equals the unpacked unsharded run bit for bit, and
    its window diagnostics the domain's."""
    common = dict(scenario="series", start=list(tpar.SERIES_START),
                  nsteps=8, window=4)
    (tmp_path / "packed").mkdir()
    (tmp_path / "plain").mkdir()
    spec = tpar._spec(files, tmp_path / "packed", 8,
                      flags={"packed_carry": True}, **common)
    ranks, packed_one = tpar._launch(tmp_path / "packed", 2, spec)
    spec = tpar._spec(files, tmp_path / "plain", 8, **common)
    _, plain_one = tpar._launch(tmp_path / "plain", 0, spec)
    tpar._assert_blocks_equal(ranks, plain_one["state"])
    tpar._assert_blocks_equal(ranks, packed_one["state"])
    for res in ranks:
        tpar._assert_diags_global(res["diags"], plain_one["diags"])
        assert res["checkpoint_equal"]
