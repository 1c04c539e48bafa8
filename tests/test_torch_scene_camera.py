"""Port parity: scenes and cameras of sgrt_tpu_torch against sgrt_tpu.

The same inputs, made with numpy from a seed, go through both packages.
Scenes are constructed from the same float32 numbers, so they must match
exactly; camera matrices and rays are float32 chains of matrix products and
trigonometry, compared at atol 1e-6.
"""

import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401  (sets JAX's float32 matmul precision)
from sgrt_tpu.models import camera as jcam
from sgrt_tpu.models import gaussians as jg
from sgrt_tpu.ops.frame import orbit_camera as j_orbit_camera
from sgrt_tpu_torch.models import camera as tcam
from sgrt_tpu_torch.models import gaussians as tg
from sgrt_tpu_torch.ops.frame import orbit_camera as t_orbit_camera

FIELDS = ("mu", "sigma", "magnitude", "albedo")


def _port(js):
    return tg.scene_from_numpy(*(np.asarray(getattr(js, f)) for f in FIELDS),
                               device="cpu")


def _assert_scene_equal(js, ts):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy(), err_msg=f)


@pytest.mark.parametrize("dim", [2, 4, 8])
def test_grid_scene_matches(dim):
    _assert_scene_equal(jg.grid_scene(dim), tg.grid_scene(dim, device="cpu"))
    _assert_scene_equal(jg.grid_scene(dim, sigma=0.25, magnitude=3.0),
                        tg.grid_scene(dim, sigma=0.25, magnitude=3.0, device="cpu"))


@pytest.mark.parametrize("n", [50, 500, 1500])
def test_scene_from_vertices_matches(n):
    rng = np.random.default_rng(n)
    v = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v[0] = 0.0  # the origin vertex gets the gray albedo
    ts = tg.scene_from_vertices(v, device="cpu")
    _assert_scene_equal(jg.scene_from_vertices(v), ts)
    assert ts.n == n


def test_scene_from_obj_matches(tmp_path):
    rng = np.random.default_rng(3)
    v = rng.uniform(-2, 2, (40, 3))
    obj = tmp_path / "pts.obj"
    obj.write_text("".join(f"v {a} {b} {c}\n" for a, b, c in v) + "f 1 2 3\n")
    _assert_scene_equal(jg.scene_from_obj(str(obj)),
                        tg.scene_from_obj(str(obj), device="cpu"))


def test_pad_scene_and_scene_from_numpy():
    js = jg.grid_scene(3)
    ts = _port(js)
    _assert_scene_equal(js, ts)
    _assert_scene_equal(jg.pad_scene(js, 16), tg.pad_scene(ts, 16))
    assert tg.pad_scene(ts, 9) is ts


def test_pdf_matches():
    js = jg.grid_scene(4)
    x = np.array([0.1, -0.2, 0.9], np.float32)
    np.testing.assert_allclose(np.asarray(js.pdf(x)),
                               _port(js).pdf(torch.from_numpy(x)).numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pos,yaw,pitch,size", [
    ((0.0, 0.0, -4.0), -90.0, 0.0, (16, 16)),
    ((1.0, 0.5, -3.0), -70.0, 10.0, (12, 8)),
    ((-2.0, 1.0, 3.0), 45.0, -95.0, (8, 12)),
])
def test_camera_create_rays_match(pos, yaw, pitch, size):
    w, h = size
    jc = jcam.Camera.create(position=pos, yaw=yaw, pitch=pitch, width=w,
                            height=h, focal_length=1.5)
    tc = tcam.Camera.create(position=pos, yaw=yaw, pitch=pitch, width=w,
                            height=h, focal_length=1.5, device="cpu")
    for f in ("front", "up", "right", "view_matrix"):
        np.testing.assert_allclose(np.asarray(getattr(jc, f)),
                                   getattr(tc, f).numpy(), atol=1e-6, err_msg=f)
    jo, jd = jc.rays()
    to, td = tc.rays()
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=1e-6)
    assert td.shape == (w * h, 3)


def test_camera_turn_update_match():
    jc = jcam.Camera.create(position=(0.0, 0.0, -4.0), width=8, height=8)
    tc = tcam.Camera.create(position=(0.0, 0.0, -4.0), width=8, height=8,
                            device="cpu")
    jc = jc.with_position((0.5, 0.2, -3.0)).turn(-80.0, 5.0).update()
    tc = tc.with_position((0.5, 0.2, -3.0)).turn(-80.0, 5.0).update()
    np.testing.assert_allclose(np.asarray(jc.view_matrix), tc.view_matrix.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(jc.projection_plane()),
                               tc.projection_plane().numpy(), atol=1e-6)


@pytest.mark.parametrize("angle", [0.0, 23.0, 90.0, 200.0, 333.3])
def test_orbit_camera_and_rays_match(angle):
    jc = j_orbit_camera(angle, -4.0, 1.0, 16, 8)
    tc = t_orbit_camera(angle, -4.0, 1.0, 16, 8, device="cpu")
    np.testing.assert_allclose(np.asarray(jc.position), tc.position.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jc.view_matrix), tc.view_matrix.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(jc.rays()[1]), tc.rays()[1].numpy(), atol=1e-6)


def test_orbit_position_and_rotate_y_match():
    p = np.array([0.3, -0.2, -4.0], np.float32)
    np.testing.assert_allclose(
        np.asarray(jcam.orbit_position(p, 37.0)),
        tcam.orbit_position(torch.from_numpy(p), 37.0).numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jcam.rotate_y(121.0)),
                               tcam.rotate_y(121.0, device="cpu").numpy(), atol=1e-6)


def test_default_device_is_cuda():
    """Entry points default to the card; without one they raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        assert tg.grid_scene(2).mu.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tg.grid_scene(2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcam.Camera.create()
