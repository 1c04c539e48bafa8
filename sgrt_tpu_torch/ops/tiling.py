"""Tile-based Gaussian culling as a fixed-capacity gather-compaction
(PyTorch port of sgrt_tpu.ops.tiling).

The reference's `tile_gaussians` (src/vrt/rt.cpp:29-69) builds per-tile
vectors of copied Gaussians; with fixed shapes it becomes:

  1. project:    mu' = (view @ mu).xy / z,  sigma' = sigma / z,
                 cull z < 1 and sigma' < 1e-5          (rt.cpp:35-45)
  2. membership: Gaussian q belongs to tile with center c iff
                 |c - mu'| <= tile_half + 3.3 sigma' on both axes (tight), or
                 the reference's wider |c| + tile_half + 3.3 sigma'
                 (rt.cpp:57-59, mode="reference")
  3. compact:    per tile, the first K member indices in ascending order,
                 padded with the dummy index N that maps to an inert
                 sigma=1/magnitude=0 Gaussian (types.cpp:53-63)

Tiles are indexed row-major (ty, tx) over NDC [-1,1]^2, the reference's
y-outer/x-inner tile loop (rt.cpp:47-49).
"""

from __future__ import annotations

import torch

from sgrt_tpu_torch.models.gaussians import GaussianScene
from sgrt_tpu_torch.utils.trace import count_rows, span


def as_grid(tiles) -> tuple[int, int]:
    """Normalize a tile spec to (tx, ty): int T → square T x T grid;
    a (tx, ty) pair is tx columns x ty rows."""
    if isinstance(tiles, int):
        return tiles, tiles
    tx, ty = tiles
    return int(tx), int(ty)


def project_gaussians(scene: GaussianScene, view: torch.Tensor,
                      focal_length=None):
    """Project Gaussian centers through the view matrix.

    Returns (mu2 (N,2) NDC centers, sigma_p (N,) projected stddevs,
    valid (N,) bool). Invalid entries get mu2=+inf so they never pass the
    membership test.

    focal_length=None is the reference's view-frame projection
    (rt.cpp:35-45): mu' = p.xy / p.z. With a focal length it projects into
    the ray frame, f*p.xy/(p.z + f) (the camera sits at view z = -f, the
    pixel plane at z = 0), where the 3.3-sigma test is exact.

    The view transform is written as explicit elementwise sums rather than
    a matrix product, so the CPU and the card round the same way.
    """
    mu, v = scene.mu, view
    p = [mu[:, 0] * v[i, 0] + mu[:, 1] * v[i, 1] + mu[:, 2] * v[i, 2] + v[i, 3]
         for i in range(3)]
    z = p[2]
    valid = z >= 1.0
    zs = torch.where(valid, z, torch.ones_like(z))
    if focal_length is None:
        denom, scale = zs, 1.0
    else:
        scale = torch.as_tensor(focal_length, dtype=torch.float32, device=mu.device)
        denom = zs + scale
    mu2 = scale * torch.stack([p[0], p[1]], dim=-1) / denom[:, None]
    sigma_p = scale * scene.sigma / denom
    valid = valid & (sigma_p >= 1e-5)
    mu2 = torch.where(valid[:, None], mu2, torch.full_like(mu2, float("inf")))
    return mu2, sigma_p, valid


def tile_centers(tiles, *, device="cuda") -> torch.Tensor:
    """NDC centers of a (tx, ty) grid over [-1,1]^2, row-major (ty, tx).
    Returns (tx*ty, 2)."""
    tx, ty = as_grid(tiles)
    hx, hy = 1.0 / tx, 1.0 / ty
    cx = -1.0 + hx + 2.0 * hx * torch.arange(tx, dtype=torch.float32, device=device)
    cy = -1.0 + hy + 2.0 * hy * torch.arange(ty, dtype=torch.float32, device=device)
    CY, CX = torch.meshgrid(cy, cx, indexing="ij")
    return torch.stack([CX.reshape(-1), CY.reshape(-1)], dim=-1)


def tile_membership(scene: GaussianScene, view: torch.Tensor, tiles,
                    mode: str = "tight", focal_length=1.0) -> torch.Tensor:
    """(tx*ty, N) bool membership matrix. `tiles`: int or (tx, ty).

    mode="tight": |c - mu'| <= tile_half + 3.3 sigma' on both axes in the
    ray frame — the minimal superset of visibly contributing Gaussians
    (3.3 sigma is the 8-bit visibility bound).
    mode="reference": the reference's view-frame projection plus its extra
    |tile_center| slack (rt.cpp:57-59); ignores focal_length.
    """
    tx, ty = as_grid(tiles)
    if mode == "reference":
        mu2, sigma_p, valid = project_gaussians(scene, view)
    else:
        mu2, sigma_p, valid = project_gaussians(scene, view, focal_length)
    centers = tile_centers((tx, ty), device=scene.device)    # (T2,2)
    reach = 3.3 * sigma_p[None, :]                           # (1, N)
    ok = valid[None, :]
    for ax, half in ((0, 1.0 / tx), (1, 1.0 / ty)):
        bound = half + reach
        if mode == "reference":
            bound = bound + torch.abs(centers[:, ax])[:, None]
        ok = ok & (torch.abs(centers[:, ax][:, None] - mu2[None, :, ax]) <= bound)
    return ok


def compact_rows(member: torch.Tensor, capacity: int, n: int) -> torch.Tensor:
    """Rows of a boolean (T, N) membership matrix → (T, capacity) int32
    index lists: the first `capacity` True positions in ascending order,
    padded with the dummy index n.

    Cumsum scatter: a member's slot is its rank among the row's members;
    members past `capacity` (and non-members) are sent to a spill column
    that is dropped."""
    t = member.shape[0]
    slot = torch.cumsum(member, dim=1) - 1
    slot = torch.where(member & (slot < capacity), slot,
                       torch.full_like(slot, capacity))
    q = torch.arange(n, dtype=torch.int32, device=member.device)
    idx = torch.full((t, capacity + 1), n, dtype=torch.int32, device=member.device)
    idx.scatter_(1, slot, q.expand(t, n).contiguous())
    return idx[:, :capacity].contiguous()


def tile_indices(scene: GaussianScene, view: torch.Tensor, tiles,
                 capacity: int, focal_length=1.0):
    """Per-tile compacted Gaussian indices.

    Returns (idx (T2, K) int32 — first K member indices, padded with N
    (the dummy slot); counts (T2,) int32 — true member counts, so callers
    can detect capacity overflow).

    A scene on the card takes the tiling kernel (ops.cuda_tiling: one
    launch, no synchronise, the same bits); on the CPU, the chain below.
    """
    with span("tiling"):
        if scene.mu.device.type == "cuda":
            from sgrt_tpu_torch.ops.cuda_tiling import tile_indices_cuda

            return tile_indices_cuda(scene, view, tiles, capacity, focal_length)
        member = tile_membership(scene, view, tiles, focal_length=focal_length)
        counts = torch.sum(member, dim=-1, dtype=torch.int32)
        return compact_rows(member, capacity, scene.n), counts


def gather_tiles(scene: GaussianScene, idx: torch.Tensor) -> GaussianScene:
    """Gather per-tile Gaussian blocks: idx (T2, K) → scene with leading
    (T2, K) axes. Index N selects the inert dummy row (sigma=1,
    magnitude=0). The four fields are packed into one (N+1, 8) matrix so
    the gather is one index_select."""
    with span("gather"):
        count_rows(idx, scene.n)
        packed = torch.cat([scene.mu, scene.sigma[:, None], scene.magnitude[:, None],
                            scene.albedo], dim=1)               # (N, 8)
        dummy = packed.new_zeros((1, 8))
        dummy[0, 3] = 1.0
        packed = torch.cat([packed, dummy])                     # (N+1, 8)
        t2, k = idx.shape
        out = packed.index_select(0, idx.reshape(-1)).reshape(t2, k, 8)
    return GaussianScene(mu=out[..., 0:3], sigma=out[..., 3],
                         magnitude=out[..., 4], albedo=out[..., 5:8])


def max_tile_count(scene: GaussianScene, view: torch.Tensor, tiles,
                   focal_length=1.0) -> int:
    """The max per-tile Gaussian count for this frame (to pick `capacity`
    without truncation). Waits for the device."""
    member = tile_membership(scene, view, tiles, focal_length=focal_length)
    return int(torch.max(torch.sum(member, dim=-1)))
