"""Parser for the reference's golden regression-test files.

Counterpart of ``elmkernels_tpu/utils/golden.py``: the same parse and the
same nan/inf rules, kept here so that the port reads the fixtures without
the JAX package.

The reference test suite drives each physics group with paired text files
``<Module>_{IN,OUT}.txt`` holding one ``NSTEP n`` block per timestep, each
block a sequence of ``name v1 v2 ...`` lines (reference:
``src/utils/read_test_input.hh:27-101``).  This module parses those files
into ``{name: np.ndarray}`` dicts, the comparison uses nan-aware relative
tolerance like the reference's ``IsAlmostEqual`` (``read_test_input.hh:17-24``)
but *asserts* instead of printing.
"""

from __future__ import annotations

import re

import numpy as np

_NSTEP_RE = re.compile(r"^NSTEP\s+(\d+)\s*$")


def _parse_token(tok: str) -> float:
    t = tok.lower()
    if t == "nan":
        return float("nan")
    return float(tok)


class GoldenFile:
    """All NSTEP blocks of one golden file, parsed eagerly.

    ``blocks[t]`` maps variable name -> float64 ndarray (scalars have
    shape ``()``, layer variables shape ``(nlev,)``).
    """

    def __init__(self, path: str):
        self.path = path
        self.blocks: dict[int, dict[str, np.ndarray]] = {}
        current: dict[str, np.ndarray] | None = None
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                m = _NSTEP_RE.match(line)
                if m:
                    current = {}
                    self.blocks[int(m.group(1))] = current
                    continue
                if current is None:
                    continue
                parts = line.split()
                name, vals = parts[0], parts[1:]
                arr = np.array([_parse_token(v) for v in vals], dtype=np.float64)
                if arr.size == 1:
                    arr = arr.reshape(())
                current[name] = arr

    @property
    def steps(self) -> list[int]:
        return sorted(self.blocks)

    def state(self, t: int) -> dict[str, np.ndarray]:
        return self.blocks[t]


def compare(name: str, got, want: np.ndarray, rtol: float = 1e-10,
            atol: float = 1e-12, errors: list | None = None) -> None:
    """nan/inf-aware comparison of a computed value against golden data.

    Mirrors the semantics of the reference's ``compareOutput`` +
    ``IsAlmostEqual`` but with collectable failures: if ``errors`` is given,
    mismatches are appended instead of raising so a test can report every
    bad variable in a step at once.
    """
    got = np.asarray(got, dtype=np.float64).reshape(np.shape(want))
    want = np.asarray(want, dtype=np.float64)
    # nan == nan; inf/spval == inf/spval at same sign
    both_nan = np.isnan(got) & np.isnan(want)
    ok = both_nan | np.isclose(got, want, rtol=rtol, atol=atol)
    if not np.all(ok):
        bad = np.argwhere(~ok)
        msgs = []
        for idx in bad[:5]:
            i = tuple(idx)
            msgs.append(f"  [{i}] got={got[i]!r} want={want[i]!r}")
        msg = f"{name}: {bad.shape[0]} mismatches\n" + "\n".join(msgs)
        if errors is not None:
            errors.append(msg)
        else:
            raise AssertionError(msg)
