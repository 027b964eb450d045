"""With an int ``ltype`` and ``elm_correct_snow_aging`` off, the port's
step is the one it was before the per-column landunit path existed: every
``ltype_mask`` call returns a Python bool (each landunit branch folds on
the host and launches nothing for the untaken side), one step dispatches
the same number of aten ops, and six steps give the same state and
diagnostics bit for bit.  The op counts and hashes below were taken from
the port before that change, by this file's ``_int_drive``.
"""

import collections
import hashlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_parity as tp
from elmkernels_torch import constants as tc
from elmkernels_torch.physics import math_utils
from elmkernels_torch.utils.dates import Date as TDate

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    # the step makes its constant tables at first use, and the counts below
    # were taken in a fresh process: start from no table, whatever test ran
    # before in this one
    math_utils._CONSTANTS.clear()
    return tp.write_files(tmp_path_factory.mktemp("torch_int_path"))


# _int_drive's aten op counts of one step and sha256 of the state and
# diagnostics after six steps, taken from the port before the per-column
# path existed
INT_PATH = {
    "summer": (30690, "41b0d9639db420911fd0755ca6e13c95"
                      "aef66ff2d9a923805c024694da240a7d"),
    "winter": (52271, "5b3764a391b1fc3ae3ac7a4bcf8481db"
                      "2d8c9e9df203ac4eaba26665e9f7a4a8"),
    "ice": (13933, "e459962809a5ad3bb9f4d5993e7aaaac"
                   "744350869d13f6df23cf5e79075b97f2"),
    "wetland": (13999, "486ed50561663a37c9fd5ab153576bf8"
                      "ce87cce9ff6ea3c7443bf84035e3e887"),
}
INT_DRIVES = {"summer": (7, 22, {}), "winter": (1, 0, {}),
              "ice": (7, 22, dict(ltype=tc.ISTICE, vtype=0)),
              "wetland": (1, 0, dict(ltype=tc.ISTWET, vtype=0))}


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _int_drive(files, label):
    """(aten ops of the first step, sha256 of state and diagnostics after
    six steps) of a four-column port model with the production flags."""
    month, skip, kw = INT_DRIVES[label]
    m = tp.torch_model(files[:2], 4, lat_deg=np.array([71.3, 65.0, 40.0,
                                                       -10.0]), **kw)
    start = TDate.from_ymd(1985, month, 1)
    start.increment_seconds(1800 * skip)
    f, ph = m.step_inputs(start)
    with _OpCount() as ops:
        m._step(f, ph)
    m2 = tp.torch_model(files[:2], 4, lat_deg=np.array([71.3, 65.0, 40.0,
                                                        -10.0]), **kw)
    diags = m2.run(start, 6)
    h = hashlib.sha256()
    for nt in (m2.state, diags):
        for k in nt._fields:
            h.update(k.encode())
            h.update(getattr(nt, k).numpy().tobytes())
    return sum(ops.n.values()), h.hexdigest()


@pytest.mark.parametrize("label", list(INT_DRIVES))
def test_int_path_is_untouched(files, label, monkeypatch):
    masks = []

    def spy(land, *types):
        out = orig(land, *types)
        masks.append(type(out))
        return out
    orig = tc.ltype_mask
    monkeypatch.setattr(tc, "ltype_mask", spy)
    n_ops, digest = _int_drive(files, label)
    assert masks and set(masks) == {bool}
    want_ops, want_digest = INT_PATH[label]
    assert (n_ops, digest) == (want_ops, want_digest)
