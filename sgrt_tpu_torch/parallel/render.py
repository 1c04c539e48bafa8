"""Forward rendering over a mesh (PyTorch port of sgrt_tpu.parallel.render).

The scene is replicated on every rank and each rank renders its own rays
or tiles; rendering needs no collective but the one that assembles the
image: each rank writes its rows into a zero-filled frame, and one SUM
all-reduce (parallel.mesh.Mesh.gather_rows) gives every rank the whole
frame.
"""

from __future__ import annotations

import torch

from sgrt_tpu_torch.models.camera import Camera
from sgrt_tpu_torch.models.gaussians import GaussianScene
from sgrt_tpu_torch.ops.render import _tile_rays, _untile_image, render_rays_impl
from sgrt_tpu_torch.parallel.mesh import Mesh, shard_rays


def render_rays_sharded(mesh: Mesh, o, dirs_local, scene: GaussianScene, q_block: int = 128,
                        ray_block: int = 2048) -> torch.Tensor:
    """dirs_local (R/D, 3), this rank's shard of the rays (shard_rays) →
    this rank's colors (R/D, 3): shard_map's local view, no collective."""
    return render_rays_impl(o, dirs_local, scene, q_block, ray_block)


def render_sharded(scene: GaussianScene, camera: Camera, mesh: Mesh, origin=None,
                   q_block: int = 128, ray_block: int = 2048) -> torch.Tensor:
    """The whole (H, W, 3) frame on every rank, each rank rendering a
    contiguous 1/D of the pixels (rows of the image)."""
    o, dirs = camera.rays(origin)
    colors = render_rays_sharded(mesh, o, shard_rays(mesh, dirs), scene, q_block, ray_block)
    colors = mesh.gather_rows(colors, mesh.shard(dirs.shape[0]), dirs.shape[0])
    return colors.reshape(camera.height, camera.width, 3)


def make_sharded_frame_renderer(mesh: Mesh, *, width: int = 256, height: int = 256, tiles=16,
                                capacity: int = 128, bucket_cfg=None, erf_name: str = "as5",
                                exp_name: str = "exact", focal_length=1.0):
    """The tiled forward through the port's kernels over a mesh:
    render(scene, view, o, dirs) → (image (H, W, 3), overflow (0-d int32)),
    both the whole frame's on every rank.

    Every rank computes the same tiling and renders its contiguous 1/D of
    the tiles through tile_renderer_for (the fused forward, or the chunked
    one above MAX_MONOLITHIC_CAPACITY). With bucket_cfg (n_dense > 0) both
    buckets are split, in the round-robin interleave of the count-sorted
    tile order (scheduler.bucketed_tile_indices(interleave=D)), so each
    rank's slice of a bucket carries a balanced mix of counts; bucket
    sizes the mesh does not divide raise ValueError (size them with
    probe_buckets(..., multiple_of=D)). A config with n_dense = 0 renders
    one launch at max(capacity, cap_dense), the probed capacity. A tile
    count the mesh does not divide raises ValueError. A tile's colors do
    not depend on the other tiles of its launch, so the frame equals the
    one-device render bit for bit."""
    from sgrt_tpu_torch.ops.cuda_chunked import tile_renderer_for
    from sgrt_tpu_torch.ops.scheduler import make_bucketed_renderer
    from sgrt_tpu_torch.ops.tiling import as_grid, gather_tiles, tile_indices

    tx, ty = as_grid(tiles)
    t2 = tx * ty

    if bucket_cfg is not None and bucket_cfg.n_dense:
        render_mine = make_bucketed_renderer(bucket_cfg, tiles=tiles, mesh=mesh,
                                             erf_name=erf_name, exp_name=exp_name,
                                             focal_length=focal_length)

        def render(scene, view, o, dirs):
            out = render_mine(scene, view, o, _tile_rays(dirs, height, width, tiles))
            colors = mesh.gather_rows(out.colors, out.ids, t2)
            return _untile_image(colors, height, width, tiles), out.overflow

        return render

    if bucket_cfg is not None:
        capacity = max(capacity, bucket_cfg.cap_dense)
    mine = mesh.shard(t2)
    cap, render_tiles = tile_renderer_for(capacity, erf_name=erf_name, exp_name=exp_name)

    def render(scene, view, o, dirs):
        idx, counts = tile_indices(scene, view, tiles, cap, focal_length=focal_length)
        overflow = torch.sum(counts > cap, dtype=torch.int32)
        d = _tile_rays(dirs, height, width, tiles)
        colors = render_tiles(gather_tiles(scene, idx[mine]), o, d[mine], counts[mine])
        colors = mesh.gather_rows(colors, mine, t2)
        return _untile_image(colors, height, width, tiles), overflow

    return render
