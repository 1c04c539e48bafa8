"""The tiling kernel (csrc/tiling.cu, ops.cuda_tiling) against the plain
chain it replaces (ops.tiling: tile_membership and compact_rows), on the
card: idx and counts equal bit for bit, and no synchronising call.

The `gpu` tests decide inside themselves whether a CUDA device is present
and skip without one, so every pytest worker collects the same tests. Run
on a machine with the card:

    python -m pytest tests/test_torch_tiling_cuda.py -m gpu --noconftest

The tests without the mark check, on the CPU, how the focal length reaches
the kernel.
"""

import numpy as np
import pytest
import torch

from sgrt_tpu_torch.models.gaussians import make_scene, scene_from_vertices
from sgrt_tpu_torch.ops import cuda_tiling as ct
from sgrt_tpu_torch.ops import tiling as tt
from sgrt_tpu_torch.ops.frame import orbit_camera

ANGLES = [i * 45.0 for i in range(8)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the tiling kernel runs only on the card")
    return torch.device("cuda")


def _cube(n=3644):
    """bench.py's stand-in for the teapot: n points on the cube's surface."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return pts / np.maximum(np.abs(pts).max(axis=1, keepdims=True), 1e-6)


def _sphere(n=50_000):
    """scripts/large_n.py's sphere: n points on the unit sphere."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _chain(scene, view, tiles, capacity, focal_length):
    member = tt.tile_membership(scene, view, tiles, focal_length=focal_length)
    return (tt.compact_rows(member, capacity, scene.n),
            torch.sum(member, dim=-1, dtype=torch.int32))


def _check(scene, view, tiles, capacity, focal_length=1.0):
    """One launch of the kernel through tile_indices, equal to the chain bit
    for bit; returns the counts."""
    before = ct.TILE_COMPACT.launches
    idx, counts = tt.tile_indices(scene, view, tiles, capacity, focal_length=focal_length)
    assert ct.TILE_COMPACT.launches == before + 1
    want_idx, want_counts = _chain(scene, view, tiles, capacity, focal_length)
    assert idx.dtype == counts.dtype == torch.int32
    assert idx.shape == want_idx.shape and counts.shape == want_counts.shape
    assert torch.equal(counts, want_counts)
    assert torch.equal(idx, want_idx)
    return counts


@pytest.mark.gpu
@pytest.mark.parametrize("points", ["cube", "sphere50k"])
@pytest.mark.parametrize("tiles", [(32, 16), (64, 32)])
def test_kernel_equals_chain_on_orbit_views(points, tiles):
    """The cube scene (3644 Gaussians, not a multiple of the 256-Gaussian
    block) and the 50k sphere at 8 orbit views: at a capacity above every
    tile's count, at one below the densest tile's (idx cut to the first K
    members, ascending) and at one above N."""
    dev = _card()
    scene = scene_from_vertices(_cube() if points == "cube" else _sphere(), device=dev)
    for angle in ANGLES:
        view = orbit_camera(angle, -4.0, 1.0, 8, 8, device=dev).view_matrix
        top = int(_chain(scene, view, tiles, 1, 1.0)[1].max())
        assert top > 1
        _check(scene, view, tiles, top + 13)
        _check(scene, view, tiles, top // 2)
    _check(scene, view, tiles, scene.n + 5)


def _edge_scene(dev):
    """300 Gaussians (not a multiple of 256) seen through the identity view
    (p = mu): some behind the camera (z < 1, z just under 1), some at z = 1
    exactly, and sigma' around the 1e-5 cut (at z = 1 and f = 1, sigma' =
    sigma / 2 exactly); all in the left half of the frame, so the right
    half's tiles are empty."""
    rng = np.random.default_rng(3)
    n = 300
    mu = np.stack([rng.uniform(-0.9, -0.4, n), rng.uniform(-0.9, 0.9, n),
                   rng.uniform(1.0, 3.0, n)], axis=1).astype(np.float32)
    mu[:20, 2] = rng.uniform(-3.0, 0.99, 20)
    mu[20:25, 2] = np.nextafter(np.float32(1.0), np.float32(0.0))
    mu[25:60, 2] = 1.0
    sigma = rng.uniform(0.005, 0.02, n).astype(np.float32)
    cut = np.float32(1e-5)
    sigma[25:30] = 2 * cut                                        # sigma' = cut: kept
    sigma[30:35] = 2 * np.nextafter(cut, np.float32(0.0))         # just under: culled
    sigma[35:40] = 2 * np.nextafter(cut, np.float32(1.0))
    sigma[40:45] = 1e-7
    return make_scene(mu, sigma, np.ones(n, np.float32), np.full((n, 3), 0.5, np.float32),
                      device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("focal", ["number", "device", "half", "none"])
@pytest.mark.parametrize("capacity", [0, 1, 7, 40, 350])
def test_kernel_equals_chain_at_the_edges(focal, capacity):
    """Culling at z < 1 and sigma' < 1e-5f, empty tiles, capacities from 0
    (nothing written but the counts) past the densest tile's count to above
    N; the focal length a number, a tensor on the card, 0.5 on the card, and
    None (the view-frame projection)."""
    dev = _card()
    scene = _edge_scene(dev)
    f = {"number": 1.0, "device": torch.tensor(1.0, device=dev),
         "half": torch.tensor(0.5, device=dev), "none": None}[focal]
    view = torch.eye(4, device=dev)
    counts = _check(scene, view, (8, 4), capacity, f)
    assert int(counts.reshape(4, 8)[:, 4:].max()) == 0          # the right half: empty
    if capacity in (1, 7):
        assert int(counts.max()) > capacity


@pytest.mark.gpu
def test_tiling_synchronises_nothing():
    """tile_indices on the card makes no synchronising call once a Python
    focal length has been uploaded (its first use per value and device),
    nor with a focal length on the card; the results still equal the
    chain's."""
    dev = _card()
    scene = scene_from_vertices(_cube(), device=dev)
    view = orbit_camera(30.0, -4.0, 1.0, 8, 8, device=dev).view_matrix
    f_dev = torch.tensor(1.0, device=dev)
    for f in (1.0, f_dev):               # the upload and the kernel's first launch
        tt.tile_indices(scene, view, (32, 16), 471, focal_length=f)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tt.tile_indices(scene, view, (32, 16), 471, focal_length=f)
               for f in (1.0, f_dev)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = _chain(scene, view, (32, 16), 471, 1.0)
    for idx, counts in got:
        assert torch.equal(idx, want[0]) and torch.equal(counts, want[1])


def test_focal_on_uploads_a_number_once_and_keeps_tensors():
    """A number becomes one float32 on the device, the same tensor on every
    call with that value and device; a float32 scalar tensor on the device
    is used in place; another dtype is rounded as project_gaussians rounds
    it; a tensor on another device is refused (its copy would block); None
    stays None."""
    dev = torch.device("cpu")
    a = ct.focal_on(1.25, dev)
    assert a.dtype == torch.float32 and a.shape == () and float(a) == 1.25
    assert ct.focal_on(1.25, dev) is a and ct.focal_on(1.5, dev) is not a
    t = torch.tensor(0.75)
    assert ct.focal_on(t, dev).data_ptr() == t.data_ptr()
    d = ct.focal_on(torch.tensor(0.1, dtype=torch.float64), dev)
    assert d.dtype == torch.float32 and float(d) == float(np.float32(0.1))
    assert ct.focal_on(None, dev) is None
    with pytest.raises(ValueError):
        ct.focal_on(torch.ones(2), dev)
    with pytest.raises(ValueError, match="on meta"):
        ct.focal_on(torch.ones((), device="meta"), dev)


def test_cpu_scene_takes_the_chain():
    """A scene on the CPU is tiled by the plain chain: no kernel launch,
    the chain's idx and counts."""
    scene = scene_from_vertices(_cube(500), device="cpu")
    view = orbit_camera(20.0, -4.0, 1.0, 8, 8, device="cpu").view_matrix
    before = ct.TILE_COMPACT.launches
    idx, counts = tt.tile_indices(scene, view, (8, 4), 40)
    assert ct.TILE_COMPACT.launches == before
    want_idx, want_counts = _chain(scene, view, (8, 4), 40, 1.0)
    assert torch.equal(idx, want_idx) and torch.equal(counts, want_counts)
