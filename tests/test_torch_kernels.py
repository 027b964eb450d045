"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card.  The
module imports neither JAX nor the JAX package, so that it runs on a
machine that has only PyTorch; there, from the root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels.py
"""

import pytest
import torch

from elmkernels_torch.ops import testing
from elmkernels_torch.physics import photosynthesis as tpsn
from elmkernels_torch.physics import soil_temperature as tst

N = 4096


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels run only "
                    "there; chip_smoke.py runs these comparisons too)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,dtype", [("c3", torch.float64),
                                        ("c4", torch.float64),
                                        ("mixed", torch.float64),
                                        ("c3", torch.float32)])
def test_ci_kernel_matches_plain(card, mode, dtype):
    from elmkernels_torch.ops.ci_solver import ci_hybrid_solve
    x0, env, en = testing.ci_problem_tensors(N, 11, mode, dtype, card)
    ck, ok, ik = ci_hybrid_solve(x0, env, mode, en)
    cp, op, ip = tpsn.hybrid_solve_plain(x0, env, mode, en)
    torch.testing.assert_close(ik, ip, rtol=0, atol=0)
    torch.testing.assert_close(ck, cp, rtol=1e-12, atol=0, equal_nan=True)
    for a, b in zip(ok, op):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_pdma_kernel_matches_plain(card):
    from elmkernels_torch.ops.pdma import pdma_solve
    lhs, rhs = testing.pdma_problem(N, 5)
    lhs, rhs = torch.tensor(lhs, device=card), torch.tensor(rhs, device=card)
    torch.testing.assert_close(pdma_solve(lhs, rhs),
                               tst.pdma_solve_plain(lhs, rhs), rtol=1e-12,
                               atol=0)
