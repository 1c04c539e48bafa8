"""Port parity: every erf/exp implementation of sgrt_tpu_torch.ops.approx
against sgrt_tpu.ops.approx on a seeded grid of float32 inputs.

Both sides evaluate the same float32 formulas; the tolerances are a few
float32 ulps of the outputs (|erf| <= 1, so 3e-7 absolute; exp relative),
from library erf/exp implementations that round differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.ops import approx as ja
from sgrt_tpu_torch.ops import approx as ta


def _grid(lo, hi, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([np.linspace(lo, hi, 2001), rng.uniform(lo, hi, 2000),
                        [0.0, -0.0, 1e-30, -1e-30]])
    return x.astype(np.float32)


def test_registries_have_the_same_names():
    assert set(ta.ERF_IMPLS) == set(ja.ERF_IMPLS)
    assert set(ta.EXP_IMPLS) == set(ja.EXP_IMPLS)
    assert set(ta.ERF_AND_GAUSS_IMPLS) == set(ja.ERF_AND_GAUSS_IMPLS)


@pytest.mark.parametrize("name", sorted(ja.ERF_IMPLS))
def test_erf_impl_matches(name):
    x = _grid(-6.0, 6.0, 1)
    j = np.asarray(ja.ERF_IMPLS[name](jnp.asarray(x)))
    t = ta.ERF_IMPLS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=3e-7)


@pytest.mark.parametrize("name", sorted(ja.EXP_IMPLS))
def test_exp_impl_matches(name):
    x = _grid(-90.0, 20.0, 2)
    j = np.asarray(ja.EXP_IMPLS[name](jnp.asarray(x)))
    t = ta.EXP_IMPLS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-37)


@pytest.mark.parametrize("name", sorted(ja.ERF_AND_GAUSS_IMPLS))
def test_erf_and_gauss_impl_matches(name):
    x = _grid(-5.0, 5.0, 3)
    je, jgau = ja.ERF_AND_GAUSS_IMPLS[name](jnp.asarray(x))
    te, tgau = ta.ERF_AND_GAUSS_IMPLS[name](torch.from_numpy(x))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=3e-7)
    np.testing.assert_allclose(tgau.numpy(), np.asarray(jgau), rtol=1e-6, atol=1e-37)


def test_spline_fits_are_copies():
    """The spline coefficient tables are fitted anew in the port; they must
    come out identical to the JAX package's."""
    for name in ("_ERF_COEF", "_ERF_FULL_COEF", "_EXP_COEF"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name))


def test_as5_accuracy_contract():
    x = _grid(-6.0, 6.0, 4)
    ref = torch.erf(torch.from_numpy(x).double()).numpy()
    assert np.max(np.abs(ta.erf_as5(torch.from_numpy(x)).numpy() - ref)) < 5e-7
    assert np.max(np.abs(ta.erf_as3(torch.from_numpy(x)).numpy() - ref)) < 3e-5
