"""Per-tile outputs of the port's frame step (make_frame_value_and_grad's
and make_frame_train_step's per_tile) on the CPU: a 700-Gaussian sphere
(the benchmark's sphere recipe, sigma 0.15) at 16x16 in 4x2 tiles of 32
rays: its 4 central tiles hold 350-410 live rows, the other 4 none. The
chunked route starts at 64 rows here, in chunks of 128, so the dense
bucket's live rows span 3-4 chunks; on the CPU the chunked route runs its
plain version, whose result does not depend on the chunk size, so the
smaller constants change only which route and contract the step takes.

Both routes of make_frame_value_and_grad: two buckets (4 dense tiles at
the probed capacity, the rest at 32 rows) and one bucket (every tile at the
probed capacity)."""

import pytest
import torch

from benchmark import scenes
from benchmark.reference.fit_tiles import tile_reference
from sgrt_tpu_torch.models.gaussians import GaussianScene
from sgrt_tpu_torch.ops import cuda_chunked
from sgrt_tpu_torch.ops.frame import orbit_camera, render_orbit_frame
from sgrt_tpu_torch.ops.scheduler import BucketConfig
from sgrt_tpu_torch.parallel.fit import adam, init_state, make_frame_train_step
from sgrt_tpu_torch.parallel.fit import make_frame_value_and_grad

FIELDS = ("mu", "sigma", "magnitude", "albedo")
W, H, TILES, ANGLE = 16, 16, (4, 2), 30.0
CAP = 540                  # the densest tile's live count x ~1.3
ROUTES = {"bucketed": BucketConfig(4, CAP, 32), "one_bucket": None}


@pytest.fixture
def chunked(monkeypatch):
    monkeypatch.setattr(cuda_chunked, "MAX_MONOLITHIC_CAPACITY", 64)
    monkeypatch.setattr(cuda_chunked, "DEFAULT_CHUNK", 128)


@pytest.fixture(scope="module")
def setup():
    """(truth fields, start fields, camera, rays, the program's target)."""
    truth, start = scenes.fit_inputs({"kind": "sphere_surface", "n": 700}, 0.05, 11, "cpu")
    cam = orbit_camera(ANGLE, -4.0, 1.0, W, H, device="cpu")
    with torch.no_grad():
        target = render_orbit_frame(GaussianScene(*truth), ANGLE, width=W, height=H,
                                    tiles=TILES, capacity=CAP, backend="kernel")[0]
    return truth, start, cam, cam.rays(), target


def _vg(route):
    assert cuda_chunked.tile_renderer_for(CAP)[0] == 640     # chunked: 5 chunks of 128
    return make_frame_value_and_grad(width=W, height=H, tiles=TILES, capacity=CAP,
                                     bucket_cfg=ROUTES[route])


def _call(setup, route, per_tile=None):
    """vg's (loss, overflow), grads and, with per_tile (tile ids), the
    {tile: TileOutput} it fills."""
    _, start, cam, (o, dirs), target = setup
    if per_tile is None:
        return _vg(route)(GaussianScene(*start), cam.view_matrix, o, dirs, target)
    tiles = dict.fromkeys(per_tile)
    out = _vg(route)(GaussianScene(*start), cam.view_matrix, o, dirs, target, per_tile=tiles)
    return (*out, tiles)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_request_leaves_the_loss_and_gradient_bit_equal(setup, chunked, route):
    (loss, ovf), grads = _call(setup, route)
    (loss_t, ovf_t), grads_t, tiles = _call(setup, route, per_tile=[1, 2, 5])
    assert int(ovf) == int(ovf_t) == 0 and torch.equal(loss, loss_t)
    for f in FIELDS:
        assert torch.equal(getattr(grads, f), getattr(grads_t, f)), f
    assert sorted(tiles) == [1, 2, 5]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tile_gradients_scattered_by_member_sum_to_the_step_gradient(setup, chunked, route):
    """Every tile requested: each tile's member gradients, added into the
    scene at its members, give the step's summed gradient (1e-6 of each
    field's largest entry: the gather's transpose adds the same terms in
    another order)."""
    (_, _), grads, tiles = _call(setup, route, per_tile=range(TILES[0] * TILES[1]))
    assert max(out.members.numel() for out in tiles.values()) > 128    # past one chunk
    for f in FIELDS:
        want = getattr(grads, f)
        got = torch.zeros_like(want)
        for out in tiles.values():
            got.index_add_(0, out.members, out.grads[f])
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max()), f


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tile_outputs_match_the_float64_per_tile_reference(setup, chunked, route):
    """Two dense tiles and an empty one against benchmark/reference/
    fit_tiles.py in float64, each from its own target. The members are the
    same (both cull in float32 in one order of operations). Colors within
    2e-4: the A&S erf's 1.5e-7 and cbar's exponent, which cancels |oc|^2 ~
    16 against mu_bar^2 at 1/(2 sigma^2) ~ 22 (sigma 0.15), so one ulp of
    16 moves a term by ~1e-4 relative. Gradients within 2e-3 of each
    field's largest entry: they scale with the residual colors - target
    (~0.05 here), of which those color errors, the program's target's
    included, are a few thousandths."""
    truth, start, *_ = setup
    (_, _), _, tiles = _call(setup, route, per_tile=[1, 6, 0])
    ref = tile_reference(truth, start, ANGLE, [1, 6, 0], width=W, height=H, tiles=TILES,
                         offset=-4.0, focal=1.0)
    assert tiles[1].members.numel() > 256 and tiles[0].members.numel() == 0
    assert not tiles[0].colors.any()
    for t, got in tiles.items():
        want = ref[t]
        assert torch.equal(got.members, want["members"]), t
        assert float((got.colors.double() - want["colors"]).abs().max()) < 2e-4, t
        for f in FIELDS if t else ():
            g, r = got.grads[f].double(), want["grads"][f]
            assert float((g - r).abs().max()) <= 2e-3 * float(r.abs().max()), (t, f)


def test_the_step_hands_over_the_tiles_and_applies_the_same_update(setup, chunked):
    _, start, cam, (o, dirs), target = setup
    step = make_frame_train_step(width=W, height=H, tiles=TILES, capacity=CAP,
                                 bucket_cfg=ROUTES["bucketed"])
    plain = step(init_state(GaussianScene(*start), adam(2e-3)), cam.view_matrix, o, dirs,
                 target)
    tiles = {2: None}
    asked = step(init_state(GaussianScene(*start), adam(2e-3)), cam.view_matrix, o, dirs,
                 target, per_tile=tiles)
    assert len(plain) == len(asked) == 3 and list(tiles) == [2]
    assert tiles[2].colors.shape == (W * H // 8, 3) and tiles[2].members.numel() > 256
    assert torch.equal(plain[1], asked[1])
    for f in FIELDS:
        assert torch.equal(getattr(plain[0].scene, f), getattr(asked[0].scene, f)), f


def test_the_request_is_refused_over_a_mesh_and_for_a_missing_tile(setup, chunked):
    from sgrt_tpu_torch.parallel.mesh import make_mesh

    _, start, cam, (o, dirs), target = setup
    vg = make_frame_value_and_grad(width=W, height=H, tiles=TILES, capacity=CAP,
                                   mesh=make_mesh(device="cpu"))
    with pytest.raises(ValueError, match="mesh"):
        vg(GaussianScene(*start), cam.view_matrix, o, dirs, target, per_tile={1: None})
    with pytest.raises(ValueError, match="no such tiles"):
        _call(setup, "bucketed", per_tile=[99])
