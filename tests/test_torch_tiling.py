"""Port parity: tiling and culling of sgrt_tpu_torch against sgrt_tpu.

Counts and indices must be equal. The one allowed difference: a (tile,
Gaussian) pair whose membership margin (bound - |center - mu'| on the
tighter axis) lies within 1e-6 of zero may fall on either side, because
the two packages round the projection differently. The test finds such
pairs, requires every disagreement to be one of them, and reports them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.models.gaussians import make_scene
from sgrt_tpu.ops import tiling as jt
from sgrt_tpu.ops.frame import orbit_camera as j_orbit_camera
from sgrt_tpu_torch.models.gaussians import scene_from_numpy
from sgrt_tpu_torch.ops import tiling as tt
from sgrt_tpu_torch.ops.frame import orbit_camera as t_orbit_camera

MARGIN = 1e-6


def _scene_np(n=300, seed=7):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    mu[:8, 2] = -4.5  # a few behind the camera: culled
    return dict(mu=mu, sigma=rng.uniform(0.02, 0.3, n).astype(np.float32),
                magnitude=rng.uniform(0.2, 2.0, n).astype(np.float32),
                albedo=rng.uniform(0, 1, (n, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def scenes():
    s = _scene_np()
    return make_scene(**s), scene_from_numpy(**s, device="cpu")


def _margins(js, view, tiles, mode):
    """float64 membership margin of every (tile, Gaussian) pair from the
    JAX projection."""
    f = None if mode == "reference" else 1.0
    mu2, sig_p, valid = (np.asarray(a, np.float64)
                         for a in jt.project_gaussians(js, view, f))
    tx, ty = jt.as_grid(tiles)
    c = np.asarray(jt.tile_centers((tx, ty)), np.float64)
    m = np.full((tx * ty, mu2.shape[0]), np.inf)
    for ax, half in ((0, 1.0 / tx), (1, 1.0 / ty)):
        bound = half + 3.3 * sig_p[None, :]
        if mode == "reference":
            bound = bound + np.abs(c[:, ax])[:, None]
        with np.errstate(invalid="ignore"):
            m = np.minimum(m, bound - np.abs(c[:, ax][:, None] - mu2[None, :, ax]))
    return np.where(valid[None, :] > 0, m, -np.inf)


@pytest.mark.parametrize("angle,tiles,mode", [
    (0.0, 4, "tight"), (23.0, (8, 4), "tight"), (130.0, (4, 8), "tight"),
    (23.0, 4, "reference"),
])
def test_membership_matches(scenes, angle, tiles, mode):
    js, ts = scenes
    jv = j_orbit_camera(angle, -4.0, 1.0, 8, 8).view_matrix
    tv = t_orbit_camera(angle, -4.0, 1.0, 8, 8, device="cpu").view_matrix
    jm = np.asarray(jt.tile_membership(js, jv, tiles, mode=mode))
    tm = tt.tile_membership(ts, tv, tiles, mode=mode).numpy()
    near = np.abs(_margins(js, jv, tiles, mode)) < MARGIN
    diff = jm != tm
    assert not np.any(diff & ~near), "membership differs away from the 3.3-sigma bound"
    print(f"{int(near.sum())} pairs within {MARGIN} of the bound, "
          f"{int(diff.sum())} of them classified differently")
    assert tm.sum() > 0


@pytest.mark.parametrize("angle,tiles,capacity", [
    (0.0, 4, 64), (23.0, (8, 4), 48), (200.0, 4, 400), (60.0, (4, 8), 8),
])
def test_tile_indices_match(scenes, angle, tiles, capacity):
    js, ts = scenes
    jv = j_orbit_camera(angle, -4.0, 1.0, 8, 8).view_matrix
    tv = t_orbit_camera(angle, -4.0, 1.0, 8, 8, device="cpu").view_matrix
    ji, jc = (np.asarray(a) for a in jt.tile_indices(js, jv, tiles, capacity))
    ti, tc = tt.tile_indices(ts, tv, tiles, capacity)
    assert ti.dtype == torch.int32 and ti.shape == ji.shape
    diff = (np.asarray(jt.tile_membership(js, jv, tiles))
            != tt.tile_membership(ts, tv, tiles).numpy())
    near = np.abs(_margins(js, jv, tiles, "tight")) < MARGIN
    assert not np.any(diff & ~near)
    same = ~diff.any(axis=1)   # tiles with no borderline disagreement
    np.testing.assert_array_equal(tc.numpy()[same], jc[same])
    np.testing.assert_array_equal(ti.numpy()[same], ji[same])
    print(f"{int((~same).sum())} tiles differ by a borderline pair")


@pytest.mark.parametrize("capacity", [1, 5, 30, 45])
def test_compact_rows_matches(capacity):
    rng = np.random.default_rng(capacity)
    member = rng.uniform(size=(6, 30)) < 0.4
    member[0] = False
    member[1] = True
    j = np.asarray(jt.compact_rows(jnp.asarray(member), capacity, 30))
    t = tt.compact_rows(torch.from_numpy(member), capacity, 30).numpy()
    np.testing.assert_array_equal(t, j)


def test_gather_tiles_matches(scenes):
    js, ts = scenes
    rng = np.random.default_rng(5)
    idx = rng.integers(0, js.n + 1, (4, 16)).astype(np.int32)
    idx[:, -3:] = js.n   # dummy rows
    jg = jt.gather_tiles(js, jnp.asarray(idx))
    tg = tt.gather_tiles(ts, torch.from_numpy(idx))
    for f in ("mu", "sigma", "magnitude", "albedo"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)))
    assert (tg.sigma[:, -3:] == 1).all() and (tg.magnitude[:, -3:] == 0).all()


def test_tile_centers_and_max_count_match(scenes):
    js, ts = scenes
    for tiles in (3, (8, 2)):
        np.testing.assert_array_equal(tt.tile_centers(tiles, device="cpu").numpy(),
                                      np.asarray(jt.tile_centers(tiles)))
    jv = j_orbit_camera(10.0, -4.0, 1.0, 8, 8).view_matrix
    tv = t_orbit_camera(10.0, -4.0, 1.0, 8, 8, device="cpu").view_matrix
    assert tt.max_tile_count(ts, tv, 4) == jt.max_tile_count(js, jv, 4)


def test_projection_matches(scenes):
    js, ts = scenes
    jv = j_orbit_camera(33.0, -4.0, 1.0, 8, 8).view_matrix
    tv = t_orbit_camera(33.0, -4.0, 1.0, 8, 8, device="cpu").view_matrix
    for f in (None, 1.0, 2.5):
        jm, js_p, jvalid = (np.asarray(a) for a in jt.project_gaussians(js, jv, f))
        tm, ts_p, tvalid = (a.numpy() for a in tt.project_gaussians(ts, tv, f))
        np.testing.assert_array_equal(tvalid, jvalid)
        assert not tvalid[:8].any()
        np.testing.assert_allclose(tm[tvalid], jm[jvalid], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts_p, js_p, rtol=1e-6)
