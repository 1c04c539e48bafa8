"""Whole-frame pipeline: orbit camera → rays → tile/cull → render (PyTorch
port of sgrt_tpu.ops.frame).

One call renders one frame of the reference's orbit loop
(main.cpp:257-335: orbit camera, re-tile, render) on the scene's device.
"""

from __future__ import annotations

import torch

from sgrt_tpu_torch.models.camera import Camera, orbit_position
from sgrt_tpu_torch.models.gaussians import GaussianScene
from sgrt_tpu_torch.ops.render import (
    _render_tiles_plain,
    _tile_rays,
    _untile_image,
    render_rays_impl,
)
from sgrt_tpu_torch.ops.tiling import (
    as_grid,
    gather_tiles,
    tile_indices,
    tile_membership,
)
from sgrt_tpu_torch.utils.device import resolve_device
from sgrt_tpu_torch.utils.trace import span

BACKENDS = ("kernel", "torch")


def orbit_camera(angle_deg, offset, focal_length, width: int, height: int,
                 *, device="cuda") -> Camera:
    """Camera on the reference's orbit (main.cpp:248-255, 330-334): start at
    (0, 0, offset) yaw=-90, rotated `angle_deg` about world Y."""
    dev = resolve_device(device)
    angle = torch.as_tensor(angle_deg, dtype=torch.float32, device=dev)
    e_z = torch.tensor([0.0, 0.0, 1.0], device=dev)
    e_y = torch.tensor([0.0, 1.0, 0.0], device=dev)
    cam = Camera(
        position=orbit_position(e_z * offset, angle),
        front=e_z,
        up=e_y,
        right=torch.zeros(3, device=dev),
        world_up=e_y,
        view_matrix=torch.eye(4, device=dev),
        focal_length=torch.as_tensor(focal_length, dtype=torch.float32, device=dev),
        width=width,
        height=height,
    )
    return cam.turn(-90.0 - angle, 0.0)


def render_orbit_frame(
    scene: GaussianScene,
    angle_deg,
    offset=-4.0,
    focal_length=1.0,
    *,
    width: int = 256,
    height: int = 256,
    tiles=16,
    capacity: int = 128,
    q_block: int = 128,
    ray_block: int = 2048,
    tile_batch: int = 16,
    use_tiling: bool = True,
    backend: str = "torch",
    erf_name: str = "as5",
    exp_name: str = "exact",
    bucket_cfg=None,
):
    """One full frame on the scene's device → (image (H,W,3), overflow
    (0-d int32 tensor)).

    overflow counts tiles whose true member count exceeded their capacity
    (Gaussians dropped); 0 means the frame is exact, and it is always 0 on
    the untiled path. backend="kernel" renders through the CUDA fused
    forward kernel (ops.cuda_kernel; its plain version for a scene on the
    CPU); "torch" is the plain tensor formulation (ops.render).
    erf_name/exp_name select the approximation on both; "exact" on the
    kernel route means the float32-exact as5. bucket_cfg (an
    ops.scheduler.BucketConfig) renders the kernel route's tiles in a dense
    and a sparse bucket, each at its own capacity (`capacity` is then
    unused); the torch route ignores it, as the JAX package's xla route
    does.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = scene.device
    with span("camera"):
        cam = orbit_camera(angle_deg, offset, focal_length, width, height, device=dev)
        o, dirs = cam.rays()
    if not use_tiling:
        no_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        if backend == "kernel":
            from sgrt_tpu_torch.ops.cuda_render import render_rays

            colors = render_rays(o, dirs, scene, erf_name=erf_name, exp_name=exp_name)
        else:
            colors = render_rays_impl(o, dirs, scene, q_block, ray_block,
                                      erf_name=erf_name, exp_name=exp_name)
        return colors.reshape(height, width, 3), no_overflow

    with span("tiling"):
        d = _tile_rays(dirs, height, width, tiles)
    if backend == "kernel" and bucket_cfg is not None:
        from sgrt_tpu_torch.ops.scheduler import render_tiles_bucketed

        colors, _, overflow = render_tiles_bucketed(
            scene, cam.view_matrix, o, d, bucket_cfg, erf_name=erf_name,
            exp_name=exp_name, tiles=tiles, focal_length=focal_length)
        with span("untile"):
            return _untile_image(colors, height, width, tiles), overflow
    if backend == "kernel":
        from sgrt_tpu_torch.ops.cuda_chunked import tile_renderer_for

        # one routing point for the per-tile kernel
        capacity, render_tiles = tile_renderer_for(capacity, erf_name=erf_name,
                                                   exp_name=exp_name)
        idx, counts = tile_indices(scene, cam.view_matrix, tiles, capacity,
                                   focal_length=focal_length)
        colors = render_tiles(gather_tiles(scene, idx), o, d, counts)
    else:
        # capacity must divide evenly into q-blocks
        qb = min(q_block, capacity)
        capacity = -(-capacity // qb) * qb
        idx, counts = tile_indices(scene, cam.view_matrix, tiles, capacity,
                                   focal_length=focal_length)
        colors = _render_tiles_plain(o, gather_tiles(scene, idx), d, qb, tile_batch,
                                     erf_name, exp_name)
    overflow = torch.sum(counts > capacity, dtype=torch.int32)
    with span("untile"):
        return _untile_image(colors, height, width, tiles), overflow


def render_orbit_frames(scene: GaussianScene, angles, offset=-4.0,
                        focal_length=1.0, **cfg):
    """Render an orbit sequence → (imgs (F, H, W, 3), overflow summed over
    frames): per-frame re-tiling, the same work per frame as
    render_orbit_frame (the reference's frame loop, main.cpp:257-335).
    Frames are queued without waiting for the device in between."""
    imgs, ovfs = [], []
    for a in angles:
        im, ov = render_orbit_frame(scene, float(a), offset, focal_length, **cfg)
        imgs.append(im)
        ovfs.append(ov)
    return torch.stack(imgs), torch.sum(torch.stack(ovfs), dtype=torch.int32)


def _render_orbit_batch(scene: GaussianScene, angles, offset, focal_length, *, width: int,
                        height: int, tiles, capacity: int, erf_name: str = "as5",
                        exp_name: str = "exact", bucket_cfg=None):
    """F orbit frames in one launch of the per-tile kernel (two when
    bucketed): the tile axis is batched across frames (B = F * T2, each
    tile with its frame's camera origin). Every frame is still re-tiled
    (the reference re-tiles every frame, main.cpp:263); only the launches
    fuse. → (imgs (F, H, W, 3), overflow (F,) int32, per frame)."""
    from sgrt_tpu_torch.ops.cuda_chunked import tile_renderer_for

    dev = scene.device
    tx, ty = as_grid(tiles)
    t2 = tx * ty
    if bucket_cfg is not None and not bucket_cfg.n_dense:
        capacity = max(capacity, bucket_cfg.cap_dense)
        bucket_cfg = None
    with span("camera"):
        cams = [orbit_camera(a, offset, focal_length, width, height, device=dev)
                for a in angles]
        rays = [cam.rays() for cam in cams]
    with span("tiling"):
        dirs = [_tile_rays(d, height, width, tiles) for _, d in rays]

    if bucket_cfg is None:
        cap, render_tiles = tile_renderer_for(capacity, erf_name=erf_name, exp_name=exp_name)
        tiled = [tile_indices(scene, cam.view_matrix, tiles, cap, focal_length=focal_length)
                 for cam in cams]
        counts = torch.cat([c for _, c in tiled])
        colors = render_tiles(gather_tiles(scene, torch.cat([i for i, _ in tiled])),
                              torch.cat([o.expand(t2, 3) for o, _ in rays]),
                              torch.cat(dirs), counts)
        with span("untile"):
            imgs = torch.stack([_untile_image(c, height, width, tiles)
                                for c in colors.split(t2)])
        return imgs, torch.sum(counts.reshape(-1, t2) > cap, dim=1, dtype=torch.int32)

    # bucketed: one dense and one sparse launch across all frames
    from sgrt_tpu_torch.ops.scheduler import BucketConfig, bucketed_tile_indices

    cap_d, render_dense = tile_renderer_for(bucket_cfg.cap_dense, erf_name=erf_name,
                                            exp_name=exp_name)
    cap_s, render_sparse = tile_renderer_for(bucket_cfg.cap_sparse, erf_name=erf_name,
                                             exp_name=exp_name)
    cfg = BucketConfig(bucket_cfg.n_dense, cap_d, cap_s)
    dense_ids, idx_d, sparse_ids, idx_s, counts = zip(*(
        bucketed_tile_indices(scene, cam.view_matrix, tiles, cfg, focal_length=focal_length)
        for cam in cams))
    overflow = torch.stack([torch.sum(c[s] > cap_s) + torch.sum(c[d] > cap_d)
                            for c, d, s in zip(counts, dense_ids, sparse_ids)]).to(torch.int32)

    def launch(render, ids, idx):
        """One launch over one bucket's tiles of every frame: ids[f] the
        tiles of frame f, idx[f] their compacted Gaussian indices."""
        return render(gather_tiles(scene, torch.cat(idx)),
                      torch.cat([o.expand(i.numel(), 3) for (o, _), i in zip(rays, ids)]),
                      torch.cat([d[i] for d, i in zip(dirs, ids)]),
                      torch.cat([c[i] for c, i in zip(counts, ids)]))

    colors_d = launch(render_dense, dense_ids, idx_d).split(cfg.n_dense)
    colors_s = launch(render_sparse, sparse_ids, idx_s).split(t2 - cfg.n_dense)
    imgs = []
    with span("untile"):
        for d_ids, s_ids, c_d, c_s in zip(dense_ids, sparse_ids, colors_d, colors_s):
            colors = c_s.new_zeros((t2,) + tuple(c_s.shape[1:]))
            colors = colors.index_copy(0, s_ids, c_s).index_copy(0, d_ids, c_d)
            imgs.append(_untile_image(colors, height, width, tiles))
        return torch.stack(imgs), overflow


def render_orbit_frames_batched(scene: GaussianScene, angles, offset=-4.0,
                                focal_length=1.0, *, batch_frames: int = 8, **cfg):
    """Orbit sequence with the tiles of `batch_frames` frames in one launch
    of the per-tile kernel (two when bucketed; see _render_orbit_batch) on
    the scene's device. cfg: width, height, tiles, capacity and optionally
    erf_name, exp_name, bucket_cfg (a BucketConfig with n_dense 0 folds
    into one bucket at max(capacity, cap_dense)). The trailing partial
    batch is padded with its last angle and the extra frames dropped (their
    overflow too, which the JAX package counts), so every launch has the
    same shape. Each frame equals render_orbit_frame's (backend="kernel")
    bit for bit.

    Returns (imgs (F, H, W, 3), overflow summed over frames)."""
    angles = [float(a) for a in angles]
    bf = max(1, min(batch_frames, len(angles)))
    imgs, overflow = [], torch.zeros((), dtype=torch.int32, device=scene.device)
    for s in range(0, len(angles), bf):
        batch = angles[s:s + bf]
        pad = bf - len(batch)
        im, ovf = _render_orbit_batch(scene, batch + batch[-1:] * pad, offset, focal_length,
                                      **cfg)
        imgs.append(im[:bf - pad])
        overflow = overflow + torch.sum(ovf[:bf - pad], dtype=torch.int32)
    return torch.cat(imgs), overflow


def probe_capacity(scene: GaussianScene, angles, offset, focal_length, tiles) -> int:
    """Max per-tile Gaussian count over sample orbit angles, to size
    `capacity` for a whole orbit. Waits for the device."""
    best = 0
    for a in angles:
        cam = orbit_camera(float(a), offset, focal_length, 8, 8, device=scene.device)
        member = tile_membership(scene, cam.view_matrix, tiles,
                                 focal_length=focal_length)
        best = max(best, int(torch.max(torch.sum(member, dim=-1))))
    return best


def auto_tile_grid(scene: GaussianScene, angles, offset, focal_length,
                   start=(16, 32), margin: float = 1.3,
                   width: int | None = None, height: int | None = None,
                   min_rays_per_tile: int = 32):
    """Smallest power-of-two refinement of `start` whose worst per-tile
    count (x margin) fits MAX_MONOLITHIC_CAPACITY → ((tx, ty), capacity).

    The JAX package's rule, kept so that both packages pick the same grid:
    refine (the axis with fewer tiles first) until the capacity fits the
    fused kernels; once tiles are down to 128 rays, stop if the chunked
    kernels' MAX_CHUNKED_CAPACITY covers the capacity; never go below
    min_rays_per_tile rays (nor past 8192 tiles), even if the capacity
    stays above every ceiling. Waits for the device."""
    from sgrt_tpu_torch.ops.cuda_chunked import MAX_CHUNKED_CAPACITY, MAX_MONOLITHIC_CAPACITY
    from sgrt_tpu_torch.ops.tiling import as_grid

    tx, ty = as_grid(start)
    sized = width is not None and height is not None
    while True:
        cap = max(64, int(probe_capacity(scene, angles, offset, focal_length, (tx, ty))
                          * margin))
        if cap <= MAX_MONOLITHIC_CAPACITY or tx * ty >= 8192:
            return (tx, ty), cap
        if sized and (width // tx) * (height // ty) <= 128 and cap <= MAX_CHUNKED_CAPACITY:
            return (tx, ty), cap
        nxt = (tx * 2, ty) if tx <= ty else (tx, ty * 2)
        if sized and (width // nxt[0]) * (height // nxt[1]) < min_rays_per_tile:
            return (tx, ty), cap
        tx, ty = nxt


def probe_buckets(scene: GaussianScene, angles, offset, focal_length, tiles,
                  margin: float = 1.2, dense_frac: float = 0.125,
                  multiple_of: int = 1):
    """Size a BucketConfig over sample orbit angles (the bucketed analog of
    probe_capacity; see ops.scheduler.probe_bucket_config). Waits for the
    device."""
    from sgrt_tpu_torch.ops.scheduler import probe_bucket_config

    views = [orbit_camera(float(a), offset, focal_length, 8, 8,
                          device=scene.device).view_matrix for a in angles]
    return probe_bucket_config(scene, views, tiles, margin=margin, dense_frac=dense_frac,
                               focal_length=focal_length, multiple_of=multiple_of)
