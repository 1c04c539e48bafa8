"""The port's viewer (sgrt_tpu_torch.viewer, device="cpu", kernel backend:
the kernels' plain versions) over HTTP: a mirror of tests/test_viewer.py's
eight tests, its images against the JAX viewer's (8-bit, at most one level
apart, as tests/test_torch_cli.py), and the repaired capacity of the
anisotropic sliders."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

import sgrt_tpu  # noqa: F401
from sgrt_tpu.models.gaussians import grid_scene as j_grid
from sgrt_tpu.models.gaussians import scene_from_vertices as j_from_vertices
from sgrt_tpu.viewer import make_server as j_make_server
from sgrt_tpu_torch.models.gaussians import grid_scene, scene_from_vertices
from sgrt_tpu_torch.utils.image import to_rgba_u8
from sgrt_tpu_torch.viewer import make_server, render_query


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    srv = make_server(grid_scene(2, device="cpu"), width=32, height=32, tiles=2, capacity=8)
    yield _serve(srv)
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, dict(r.headers), r.read()


def _pixels(body):
    return np.asarray(Image.open(io.BytesIO(body)), np.int32)


def test_page(server):
    status, _, body = _get(server + "/")
    assert status == 200
    assert b"sgrt_tpu_torch" in body and b"per-Gaussian" in body


def test_render_roundtrip(server):
    status, headers, body = _get(server + "/render?angle=30&tiled=1")
    assert status == 200
    assert headers["Content-Type"] == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    assert float(headers["X-Render-Ms"]) > 0
    assert headers["X-Overflow"] == "0"


def test_render_overflow_surfaced(server):
    status, headers, _ = _get(server + "/render?angle=30&tiled=1&sigma=3")
    assert status == 200
    assert int(headers["X-Overflow"]) >= 0  # header present and integer


def test_render_untiled_and_approx_modes(server):
    for qs in ("tiled=0", "erf=as3&exp=fast", "sigma=1.5&mag=2"):
        status, headers, body = _get(server + f"/render?{qs}")
        assert status == 200, qs
        assert body[:8] == b"\x89PNG\r\n\x1a\n", qs


def test_scene_json(server):
    status, _, body = _get(server + "/scene")
    assert status == 200
    scene = json.loads(body)
    assert scene["n"] == 4
    assert set(scene["gaussians"][0]) == {"mu", "sigma", "magnitude", "albedo"}


def test_per_gaussian_edit_changes_image(server):
    """Killing one Gaussian's magnitude changes the pixels (the live
    per-Gaussian mutation of main.cpp:234-241); a reset restores them."""
    _, _, before = _get(server + "/render?angle=0")
    status, _, body = _get(server + "/edit?index=0&magnitude=0")
    assert status == 200 and json.loads(body)["ok"]
    _, _, after = _get(server + "/render?angle=0")
    assert before != after
    _, _, sj = _get(server + "/scene")
    assert json.loads(sj)["gaussians"][0]["magnitude"] == 0.0
    status, _, body = _get(server + "/edit?index=-1")
    assert json.loads(body)["ok"]
    _, _, restored = _get(server + "/render?angle=0")
    assert restored == before


def test_edit_rejects_bad_index(server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server + "/edit?index=99")
    assert exc.value.code == 400


def test_render_aniso_sliders(server):
    """Per-axis scales route through the anisotropic kernels (tiled and
    untiled) and change the image against the isotropic render."""
    def fetch(extra=""):
        status, _, body = _get(server + "/render?angle=30" + extra)
        assert status == 200
        return _pixels(body)

    iso = fetch("&tiled=1")
    ani = fetch("&tiled=1&sx=2.0&sy=0.5&sz=1.0")
    assert iso.shape == ani.shape
    assert np.abs(iso - ani).max() > 2
    ani_untiled = fetch("&tiled=0&sx=2.0&sy=0.5&sz=1.0")
    assert np.abs(ani_untiled - ani).max() <= 1


@pytest.mark.parametrize("query", ["angle=30&tiled=1", "angle=75&tiled=0&erf=as3&exp=fast"])
def test_render_matches_jax_viewer(query):
    """The same scene and query through both viewers: pixels at most one
    8-bit level apart, and equal to to_rgba_u8 of the direct render."""
    jsrv = j_make_server(j_grid(3), width=32, height=32, tiles=2, capacity=16)
    tsrv = make_server(grid_scene(3, device="cpu"), width=32, height=32, tiles=2,
                       capacity=16)
    try:
        _, jh, jbody = _get(_serve(jsrv) + "/render?" + query)
        _, th, tbody = _get(_serve(tsrv) + "/render?" + query)
    finally:
        for s in (jsrv, tsrv):
            s.shutdown()
            s.server_close()
    assert th["X-Overflow"] == jh["X-Overflow"] == "0"
    j, t = _pixels(jbody), _pixels(tbody)
    assert np.abs(j - t).max() <= 1 and t[..., :3].max() > 10
    q = dict(kv.split("=") for kv in query.split("&"))
    img, _ = render_query(grid_scene(3, device="cpu"), q, 32, 32, 2, 16)
    np.testing.assert_array_equal(t, to_rgba_u8(img.numpy()))


def test_aniso_sliders_do_not_overflow():
    """sx=sy=sz=3 on a 400-point cube cloud: the JAX viewer reuses the
    isotropic probe's capacity and drops Gaussians (X-Overflow > 0); the
    port probes again on the scaled scene's max-scale proxy."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    pts /= np.abs(pts).max(axis=1, keepdims=True)
    query = "/render?angle=30&tiled=1&sx=3&sy=3&sz=3"
    jsrv = j_make_server(j_from_vertices(pts), width=16, height=16, tiles=2)
    tsrv = make_server(scene_from_vertices(pts, device="cpu"), width=16, height=16, tiles=2)
    try:
        _, jh, _ = _get(_serve(jsrv) + query)
        _, th, tbody = _get(_serve(tsrv) + query)
    finally:
        for s in (jsrv, tsrv):
            s.shutdown()
            s.server_close()
    assert int(jh["X-Overflow"]) > 0
    assert th["X-Overflow"] == "0"
    assert _pixels(tbody)[..., :3].max() > 10
