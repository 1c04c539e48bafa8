"""Fused, blocked forward renderer in plain tensor ops (PyTorch port of
sgrt_tpu.ops.render, the counterpart of its backend="xla").

Two algebraic simplifications over a literal translation of the reference
hot loop (src/vrt/rt.h:102-127, 205-223):

1. The constant part of the transmittance exponent is hoisted:
       G(r,s) = B(r) - sum_q coeff(r,q) * erf((s - mu_bar(r,q)) * inv_q),
       B(r)   = sum_q coeff(r,q) * erf1(r,q)
   so each (ray, sample, q) needs one erf.

2. The radiance pdf at sample s_pk = mu_bar_p + k*sigma_p collapses:
       pdf_p(o + s_pk n) = cbar(r,p) * exp(-k^2/2)
   so the color is a product with the albedo:
       L(r) = sum_p [sigma_p * cbar(r,p) * sum_k w_k T(r,p,k)] * albedo_p.

Every function takes optional leading batch axes (per-tile scenes), and
autograd differentiates all of it.
"""

from __future__ import annotations

import numpy as np
import torch

from sgrt_tpu_torch.models.camera import Camera
from sgrt_tpu_torch.models.gaussians import GaussianScene, pad_scene
from sgrt_tpu_torch.ops.approx import ERF_IMPLS, EXP_IMPLS
from sgrt_tpu_torch.ops.reference import INV_SQRT_2_PI, K_TAPS, SQRT_2
from sgrt_tpu_torch.ops.tiling import as_grid

# w_k = exp(-k^2/2) for k in {-4..0} — the collapsed pdf factors.
K_WEIGHTS = np.exp(-(K_TAPS**2) / 2.0).astype(np.float32)


def _resolve_approx(erf_name: str, exp_name: str):
    """Approximation names → (erf_fn, exp_fn), from the ops.approx registries."""
    return ERF_IMPLS[erf_name], EXP_IMPLS[exp_name]


def _ray_gaussian_terms(o, dirs, scene: GaussianScene, erf_fn=torch.erf,
                        exp_fn=torch.exp):
    """Shared per-(ray, Gaussian) precomputation.

    dirs: (..., R, 3). Returns mu_bar (..., R, N), cbar (..., R, N),
    coeff (..., R, N), inv (..., N), base (..., R) where
    base = sum_q coeff*erf1.
    """
    oc = scene.mu - o                                   # (..., N, 3)
    # mu_bar and |oc|^2 as sums of products in a fixed order, rounded as the
    # kernels round them (csrc/gauss_common.cuh, dot3_rn): the exponent
    # below cancels the two, so a matrix product's other rounding of mu_bar
    # would move cbar by up to 2 ulp(|oc|^2) / (2 sigma^2) against the
    # kernel route
    x, y, z = (oc[..., None, :, c] for c in range(3))   # (..., 1, N)
    mu_bar = dirs[..., :, 0:1] * x + dirs[..., :, 1:2] * y + dirs[..., :, 2:3] * z  # (..., R, N)
    oc_sq = (x * x + y * y + z * z)[..., 0, :]          # (..., N)
    inv_2s2 = 1.0 / (2.0 * scene.sigma**2)              # (..., N)
    cbar = scene.magnitude[..., None, :] * exp_fn(
        -(oc_sq[..., None, :] - mu_bar**2) * inv_2s2[..., None, :])
    coeff = (scene.sigma * INV_SQRT_2_PI)[..., None, :] * cbar
    inv = 1.0 / (SQRT_2 * scene.sigma)                  # (..., N)
    base = torch.sum(coeff * erf_fn(-mu_bar * inv[..., None, :]), dim=-1)
    return mu_bar, cbar, coeff, inv, base


def _radiance_block(o, dirs, scene: GaussianScene, q_block: int,
                    erf_name: str = "exact",
                    exp_name: str = "exact") -> torch.Tensor:
    """Radiance for one block of rays: dirs (..., R, 3) → (..., R, 3).

    The O(R * 5N * N) erf reduction runs over q-blocks so the pairwise
    intermediate stays (..., R, q_block, 5N).
    """
    erf_fn, exp_fn = _resolve_approx(erf_name, exp_name)
    n = scene.n
    mu_bar, cbar, coeff, inv, base = _ray_gaussian_terms(o, dirs, scene,
                                                         erf_fn, exp_fn)
    taps = torch.as_tensor(K_TAPS, dtype=mu_bar.dtype, device=dirs.device)
    # sample points s(r, p, k) = mu_bar(r,p) + k*sigma_p, flattened to (R, 5N)
    s = mu_bar[..., None] + taps * scene.sigma[..., None, :, None]
    s = s.reshape(*mu_bar.shape[:-1], n * 5)
    acc = torch.zeros_like(s)
    for q0 in range(0, n, q_block):
        mu_q = mu_bar[..., q0:q0 + q_block]             # (..., R, Qb)
        co_q = coeff[..., q0:q0 + q_block]
        inv_q = inv[..., q0:q0 + q_block]               # (..., Qb)
        args = ((s[..., None, :] - mu_q[..., None])
                * inv_q[..., None, :, None])            # (..., R, Qb, 5N)
        acc = acc + torch.sum(co_q[..., None] * erf_fn(args), dim=-2)
    T = exp_fn(base[..., None] - acc).reshape(*mu_bar.shape, 5)
    tw = T @ torch.as_tensor(K_WEIGHTS, dtype=T.dtype, device=dirs.device)  # (..., R, N)
    weights = scene.sigma[..., None, :] * cbar * tw
    return weights @ scene.albedo


def _unit_pad(dirs: torch.Tensor, pad: int) -> torch.Tensor:
    """Append `pad` rays with the UNIT direction +z. |d| <= 1 keeps
    mu_bar^2 <= |oc|^2 (Cauchy-Schwarz), so the exp in cbar of a dead ray
    stays <= 1 and cannot overflow to inf (0*inf = NaN would poison
    gradients reduced over rays)."""
    if not pad:
        return dirs
    unit = dirs.new_zeros((pad, 3))
    unit[:, 2] = 1.0
    return torch.cat([dirs, unit])


def render_rays_impl(o, dirs, scene: GaussianScene, q_block: int = 128,
                     ray_block: int = 2048, erf_name: str = "exact",
                     exp_name: str = "exact"):
    """Render a batch of rays → colors (R,3), `ray_block` rays at a time.
    Differentiable. erf_name/exp_name select the approximation."""
    scene = pad_scene(scene, q_block)
    r = dirs.shape[0]
    dirs_p = _unit_pad(dirs, (-r) % ray_block)
    colors = torch.cat([
        _radiance_block(o, dirs_p[i:i + ray_block], scene, q_block, erf_name,
                        exp_name)
        for i in range(0, dirs_p.shape[0], ray_block)])
    return colors[:r]


# the JAX package's name of the ray-batch render (there a compiled
# render_rays_impl)
render_rays = render_rays_impl


def render(scene: GaussianScene, camera: Camera, origin=None,
           q_block: int = 128, ray_block: int = 2048,
           erf_name: str = "exact", exp_name: str = "exact") -> torch.Tensor:
    """Full-frame fused render → float32 (H, W, 3), unclamped."""
    o, dirs = camera.rays(origin)
    colors = render_rays_impl(o, dirs, scene, q_block=q_block,
                              ray_block=ray_block, erf_name=erf_name,
                              exp_name=exp_name)
    return colors.reshape(camera.height, camera.width, 3)


def _tile_rays(dirs: torch.Tensor, h: int, w: int, tiles) -> torch.Tensor:
    """(H*W, 3) row-major rays → (tx*ty, P, 3) grouped by image tile, tile
    order row-major (ty, tx) to match ops.tiling. `tiles`: int or (tx, ty)."""
    tx, ty = as_grid(tiles)
    th, tw = h // ty, w // tx
    d = dirs.reshape(ty, th, tx, tw, 3)
    return d.permute(0, 2, 1, 3, 4).reshape(tx * ty, th * tw, 3)


def _untile_image(colors: torch.Tensor, h: int, w: int, tiles) -> torch.Tensor:
    """(tx*ty, P, 3) per-tile colors → (H, W, 3) (the reference's tile-buffer
    scatter-back, rt.h:388-399)."""
    tx, ty = as_grid(tiles)
    th, tw = h // ty, w // tx
    c = colors.reshape(ty, tx, th, tw, 3)
    return c.permute(0, 2, 1, 3, 4).reshape(h, w, 3)


def _render_tiles_plain(o, tiled: GaussianScene, tile_dirs, q_block: int, tile_batch: int,
                        erf_name: str = "exact", exp_name: str = "exact") -> torch.Tensor:
    """Gathered tiles (fields (T2, K, ...), K a multiple of q_block),
    tile_dirs (T2, P, 3) → per-tile colors (T2, P, 3) by the plain
    renderer, `tile_batch` tiles at a time (bounds the pairwise
    intermediate)."""
    fields = (tiled.mu, tiled.sigma, tiled.magnitude, tiled.albedo)
    return torch.cat([
        _radiance_block(o, tile_dirs[t:t + tile_batch],
                        GaussianScene(*(f[t:t + tile_batch] for f in fields)),
                        q_block, erf_name, exp_name)
        for t in range(0, tile_dirs.shape[0], tile_batch)])


def render_tiled(scene: GaussianScene, camera: Camera, origin=None, tiles=16,
                 capacity: int | None = None, q_block: int = 128, tile_batch: int = 16,
                 check_overflow: bool = True, erf_name: str = "exact",
                 exp_name: str = "exact") -> torch.Tensor:
    """Tiled and culled full-frame render by the plain renderer (the analog
    of the reference's modes 5-8) on the scene's device → (H, W, 3).

    Tiles are assigned every frame, as the reference re-tiles on the host
    every frame (main.cpp:263), and culled with the camera's focal length.
    `tiles` is a count per axis or (tx, ty). `capacity` is the per-tile
    Gaussian budget; None takes this frame's largest tile count (waits for
    the device). It is rounded up to a multiple of q_block (q_block clamped
    to it). With check_overflow a tile whose count exceeds the capacity
    raises ValueError (its Gaussians past the capacity were dropped)."""
    from sgrt_tpu_torch.ops.tiling import gather_tiles, max_tile_count, tile_indices

    h, w = camera.height, camera.width
    tx, ty = as_grid(tiles)
    if h % ty or w % tx:
        raise ValueError(f"image {w}x{h} not divisible into {tx}x{ty} tiles")
    o, dirs = camera.rays(origin)
    view, focal = camera.view_matrix, camera.focal_length
    if capacity is None:
        capacity = max_tile_count(scene, view, tiles, focal_length=focal)
    # round up so that the q blocks divide the capacity (dummies are inert)
    q_block = min(q_block, max(capacity, 1))
    capacity = max(q_block, -(-capacity // q_block) * q_block)
    idx, counts = tile_indices(scene, view, tiles, capacity, focal_length=focal)
    colors = _render_tiles_plain(o, gather_tiles(scene, idx), _tile_rays(dirs, h, w, tiles),
                                 q_block, tile_batch, erf_name, exp_name)
    if check_overflow and int(counts.max()) > capacity:
        raise ValueError(f"tile capacity {capacity} overflowed (max count "
                         f"{int(counts.max())}); raise `capacity`")
    return _untile_image(colors, h, w, tiles)
