import importlib.util
import os

import jax
import numpy as np


def _load_entry():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_compiles_and_runs():
    mod = _load_entry()
    fn, args = mod.entry()
    win, energy, converged, nres = jax.jit(fn)(*args)
    jax.block_until_ready(win)
    assert np.isfinite(float(energy))
    assert int(nres) > 0


def test_dryrun_multichip_8():
    mod = _load_entry()
    mod.dryrun_multichip(8)


def test_dryrun_multichip_2():
    mod = _load_entry()
    mod.dryrun_multichip(2)
