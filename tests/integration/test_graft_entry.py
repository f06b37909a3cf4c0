"""Driver entry points: single-chip jit compile + multi-chip DP dry run
(the same paths the external driver exercises)."""

import os
import sys

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = np.asarray(jax.jit(fn)(*args))
    assert out.ndim == 3 and out.shape[-1] == 2
    assert np.isfinite(out).all()


def test_dryrun_multichip_8():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)
