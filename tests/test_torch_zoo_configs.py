"""The port's small names of the model zoo against the reference's:

* the ten ``configs/<arch>.py`` shims: ``CONFIG`` and ``CONFIG_REDUCED``
  equal the reference's field by field;
* ``configs/shapes.py`` (and ``configs.SHAPES``): the four input shapes;
* ``data/synthetic.py::quadratics``: A, c and x* bitwise the reference's
  numpy arrays.
"""

import dataclasses
import importlib
import pkgutil

import numpy as np
import pytest

import repro.configs as j_configs
from repro.data import quadratics as j_quadratics
from repro_torch.configs import SHAPES
from repro_torch.data import quadratics

SHIMS = sorted(m.name for m in pkgutil.iter_modules(j_configs.__path__)
               if m.name not in ("base", "registry", "shapes"))


def test_there_are_ten_shims():
    assert len(SHIMS) == 10


@pytest.mark.parametrize("name", SHIMS)
def test_shim_equals_the_references(name):
    mine = importlib.import_module(f"repro_torch.configs.{name}")
    theirs = importlib.import_module(f"repro.configs.{name}")
    for attr in ("CONFIG", "CONFIG_REDUCED"):
        assert dataclasses.asdict(getattr(mine, attr)) == dataclasses.asdict(getattr(theirs, attr))


def test_shapes_equal_the_references():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_configs.SHAPES.items()}


@pytest.mark.parametrize("kw", ({}, {"n_clients": 5, "dim": 3, "hetero": 0.5, "seed": 7}))
def test_quadratics_are_the_references(kw):
    for got, want in zip(quadratics(**kw), j_quadratics(**kw)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
