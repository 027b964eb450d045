"""The port's two solvers against the JAX package's, on the CPU: the plain
versions of the ci root solve (``ci_hybrid_solve``'s yardstick) and of the
pentadiagonal solve (``pdma_solve``'s).  The CUDA kernels themselves are
held against these plain versions on the card (``test_torch_kernels.py``
and ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elmkernels_tpu.physics import photosynthesis as jpsn
from elmkernels_tpu.physics import soil_temperature as jst
from elmkernels_torch.ops import testing
from elmkernels_torch.physics import photosynthesis as tpsn
from elmkernels_torch.physics import soil_temperature as tst

torch.set_num_threads(1)

N_LEAVES = 4096


def _jax_solve(x0, env, mode, enabled):
    z = jnp.zeros(x0.shape[0])
    out0 = jpsn.PsnOut(z, z, z, z, z, z)
    jenv = jpsn.CiEnv(**{k: jnp.asarray(v) for k, v in env.items()})
    with jax.default_device(jax.devices("cpu")[0]):
        ci, out, it = jpsn.hybrid_solve(jnp.asarray(x0), jenv, mode,
                                        jnp.asarray(enabled), out0)
    return np.asarray(ci), out, np.asarray(it)


def _port_inputs(x0, env, enabled):
    return (torch.tensor(x0), tpsn.CiEnv(**{k: torch.tensor(v)
                                            for k, v in env.items()}),
            torch.tensor(enabled))


@pytest.mark.parametrize("mode", ["c3", "c4", "mixed"])
def test_ci_solve_plain_matches_jax(mode, monkeypatch):
    # the well-conditioned leaves (no dry-air share): overflow comes from
    # the leaves whose residual is NaN
    x0, env, enabled = testing.ci_problem(N_LEAVES, 11, mode, dry_share=0.0)
    jci, jout, jit = _jax_solve(x0, env, mode, enabled)
    tx0, tenv, ten = _port_inputs(x0, env, enabled)
    tci, tout, tit = tpsn.hybrid_solve_plain(tx0, tenv, mode, ten)

    np.testing.assert_array_equal(tit.numpy(), jit)
    np.testing.assert_allclose(tci.numpy(), jci, rtol=1e-10, atol=0,
                               equal_nan=True)
    for name in tpsn.PsnOut._fields:
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-10, atol=1e-12, equal_nan=True,
                                   err_msg=name)

    # the inputs reach all three exits: secant convergence, Brent (the
    # leaves whose root moves when Brent may not iterate), and overflow
    overflow = tit.numpy() > tpsn.SECANT_ITMAX
    monkeypatch.setattr(tpsn, "BRENT_ITMAX", 0)
    ci_nobrent = tpsn.hybrid_solve_plain(tx0, tenv, mode, ten)[0].numpy()
    brent = ~np.isclose(ci_nobrent, tci.numpy(), rtol=0, atol=0,
                        equal_nan=True)
    secant = enabled & ~overflow & ~brent & (tit.numpy() > 0)
    assert overflow.sum() >= 1 and brent.sum() >= 10 and secant.sum() >= 500


def test_ci_solve_dry_leaves_agree_to_roundoff_amplification():
    """Dry-air leaves near the compensation point crawl 10-40 secant steps
    on a nearly flat residual, which amplifies last-bit differences (XLA's
    CPU code rounds differently from PyTorch's per-op kernels): the
    iteration counts agree exactly, the roots to 1e-4 relative (4e-5 is
    the widest gap seen on these 4096 leaves)."""
    x0, env, enabled = testing.ci_problem(N_LEAVES, 11, "c3",
                                          dry_share=1.0)
    jci, _, jit = _jax_solve(x0, env, "c3", enabled)
    tx0, tenv, ten = _port_inputs(x0, env, enabled)
    tci, _, tit = tpsn.hybrid_solve_plain(tx0, tenv, "c3", ten)
    np.testing.assert_array_equal(tit.numpy(), jit)
    assert (tit.numpy() > tpsn.SECANT_ITMAX).sum() >= 1  # finite overflow
    np.testing.assert_allclose(tci.numpy(), jci, rtol=1e-4, atol=0,
                               equal_nan=True)


def test_hybrid_solve_dispatches_plain_on_cpu():
    x0, env, en = testing.ci_problem_tensors(64, 3, "c3", torch.float64,
                                             "cpu")
    a = tpsn.hybrid_solve(x0, env, "c3", en)
    b = tpsn.hybrid_solve_plain(x0, env, "c3", en)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0, equal_nan=True)


def test_pdma_plain_matches_jax():
    lhs, rhs = testing.pdma_problem(96, 5)
    with jax.default_device(jax.devices("cpu")[0]):
        jx = np.asarray(jst.pdma_solve(jnp.asarray(lhs), jnp.asarray(rhs)))
    tx = tst.pdma_solve_plain(torch.tensor(lhs), torch.tensor(rhs)).numpy()
    np.testing.assert_allclose(tx, jx, rtol=1e-12, atol=0)
    # identity-padded snow rows solve to 0
    pad = np.arange(96) % 6
    assert np.all(tx[np.arange(21)[None, :] < pad[:, None]] == 0.0)
    # and the solution solves the dense system
    dense = np.zeros((96, 21, 21))
    for band, off in enumerate((2, 1, 0, -1, -2)):
        for r in range(21):
            if 0 <= r + off < 21:
                dense[:, r, r + off] = lhs[:, r, band]
    np.testing.assert_allclose(np.einsum("nij,nj->ni", dense, tx), rhs,
                               rtol=0, atol=1e-9)
