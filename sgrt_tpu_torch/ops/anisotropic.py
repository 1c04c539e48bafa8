"""Anisotropic (diagonal-covariance) Gaussians (PyTorch port of
sgrt_tpu.ops.anisotropic).

For a diagonal covariance D = diag(s1^2, s2^2, s3^2) the density is
pdf(x) = c exp(-1/2 (x-mu)^T D^-1 (x-mu)). Along the ray x = o + t n
(|n| = 1) the exponent is quadratic in t, so the Gaussian restricted to a
ray is still a 1-D Gaussian, with direction-dependent parameters:

    A = sum_i n_i^2 / d_i          (d_i = s_i^2)
    B = sum_i (o-mu)_i n_i / d_i
    C = sum_i (o-mu)_i^2 / d_i
    sigma_bar = 1/sqrt(A),  mu_bar = -B/A,
    cbar      = c exp(-1/2 (C - B^2/A))

With (mu_bar, sigma_bar, cbar) per (ray, Gaussian) the isotropic
closed-form transmittance and 5-tap radiance carry over unchanged
(scale = (sigma, sigma, sigma) recovers the isotropic renderer). Tiling
culls on the conservative max-scale footprint (iso_proxy).

Two backends, as for isotropic scenes: "torch" differentiates the plain
blocked renderer here by autograd (the JAX package's "xla"); "kernel"
renders through the fused anisotropic CUDA kernels and their analytic
backward (ops.cuda_aniso; the JAX package's "pallas"), or for dense tiles
the chunked ones (ops.cuda_chunked_aniso), routed by
ops.cuda_chunked.tile_renderer_for on the row geometry
ops.cuda_render.ANISO.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgrt_tpu_torch.models.camera import Camera
from sgrt_tpu_torch.models.gaussians import GaussianScene
from sgrt_tpu_torch.ops.reference import INV_SQRT_2_PI, K_TAPS, SQRT_2
from sgrt_tpu_torch.ops.render import (
    K_WEIGHTS,
    _resolve_approx,
    _tile_rays,
    _unit_pad,
    _untile_image,
)
from sgrt_tpu_torch.ops.tiling import as_grid, tile_indices
from sgrt_tpu_torch.utils.device import resolve_device
from sgrt_tpu_torch.utils.trace import count_rows, span

FIELDS = ("mu", "scale", "magnitude", "albedo")


@dataclasses.dataclass
class AnisoScene:
    """N diagonal-covariance 3D Gaussians (fields may carry leading batch
    axes, as gather_tiles_aniso's (T, K, ...)):

        pdf_q(x) = magnitude_q exp(-1/2 sum_i (x - mu_q)_i^2 / scale_q,i^2)
    """

    mu: torch.Tensor         # (..., N, 3)
    scale: torch.Tensor      # (..., N, 3) per-axis standard deviations
    magnitude: torch.Tensor  # (..., N)
    albedo: torch.Tensor     # (..., N, 3)

    @property
    def n(self) -> int:
        return self.mu.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.mu.device

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        """Densities of all Gaussians at point x (3,). Returns (N,)."""
        d2 = torch.sum(((x[None, :] - self.mu) / self.scale) ** 2, dim=-1)
        return self.magnitude * torch.exp(-0.5 * d2)

    def replace(self, **changes) -> "AnisoScene":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "AnisoScene":
        dev = resolve_device(device)
        return AnisoScene(*(getattr(self, f).to(dev) for f in FIELDS))


def aniso_scene_from_numpy(mu, scale, magnitude, albedo, *, device="cuda") -> AnisoScene:
    """Build the port's scene from the four fields of a JAX sgrt_tpu
    AnisoScene given as numpy arrays, so both packages can be fed the same
    scene."""
    dev = resolve_device(device)

    def f32(x, shape):
        return torch.as_tensor(np.array(x, np.float32), device=dev).reshape(shape)

    return AnisoScene(mu=f32(mu, (-1, 3)), scale=f32(scale, (-1, 3)),
                      magnitude=f32(magnitude, (-1,)), albedo=f32(albedo, (-1, 3)))


def from_isotropic(scene: GaussianScene) -> AnisoScene:
    """Embed an isotropic scene (scale = (sigma, sigma, sigma))."""
    return AnisoScene(mu=scene.mu, scale=scene.sigma[..., None].expand(scene.mu.shape).clone(),
                      magnitude=scene.magnitude, albedo=scene.albedo)


def iso_proxy(scene: AnisoScene) -> GaussianScene:
    """Conservative isotropic stand-in (sigma = max per-axis scale) for the
    projected-footprint tile culling: the anisotropic footprint lies inside
    the max-scale disc, so the 3.3-sigma membership test stays a superset."""
    return GaussianScene(mu=scene.mu, sigma=torch.amax(scene.scale, dim=-1),
                         magnitude=scene.magnitude, albedo=scene.albedo)


def pad_scene_aniso(scene: AnisoScene, multiple: int = 128) -> AnisoScene:
    """Inert padding (scale 1, magnitude 0), as models.gaussians.pad_scene."""
    n_pad = (-scene.n) % multiple
    if n_pad == 0:
        return scene
    z3 = scene.mu.new_zeros((n_pad, 3))
    return AnisoScene(mu=torch.cat([scene.mu, z3]),
                      scale=torch.cat([scene.scale, scene.scale.new_ones((n_pad, 3))]),
                      magnitude=torch.cat([scene.magnitude, scene.magnitude.new_zeros(n_pad)]),
                      albedo=torch.cat([scene.albedo, z3]))


def _aniso_ray_terms(o, dirs, scene: AnisoScene, exp_fn=torch.exp):
    """Per-(ray, Gaussian) 1-D restriction parameters: dirs (..., R, 3)
    unit rays → mu_bar, sigma_bar, cbar, each (..., R, N)."""
    inv_d = 1.0 / (scene.scale * scene.scale)              # (..., N, 3)
    v = o - scene.mu                                         # (..., N, 3)
    a = (dirs * dirs) @ inv_d.transpose(-1, -2)              # (..., R, N)
    b = dirs @ (v * inv_d).transpose(-1, -2)
    c = torch.sum(v * v * inv_d, dim=-1)[..., None, :]       # (..., 1, N)
    sigma_bar = 1.0 / torch.sqrt(a)
    mu_bar = -b / a
    cbar = scene.magnitude[..., None, :] * exp_fn(-0.5 * (c - b * b / a))
    return mu_bar, sigma_bar, cbar


def transmittance_aniso(o, n, s, scene: AnisoScene) -> torch.Tensor:
    """Closed-form anisotropic transmittance at o + s n along one ray; s
    may be a tensor of sample parameters."""
    mu_bar, sigma_bar, cbar = (x[0] for x in _aniso_ray_terms(o, n[None, :], scene))  # (N,)
    inv = 1.0 / (SQRT_2 * sigma_bar)
    s = torch.as_tensor(s, dtype=torch.float32, device=mu_bar.device)[..., None]
    t = torch.sum(sigma_bar * cbar * INV_SQRT_2_PI
                  * (torch.erf(-mu_bar * inv) - torch.erf((s - mu_bar) * inv)), dim=-1)
    return torch.exp(t)


def transmittance_step_aniso(o, n, s, delta, scene: AnisoScene) -> torch.Tensor:
    """Riemann-sum numerical transmittance, the oracle's oracle. s, delta:
    Python floats."""
    ts = torch.arange(0.0, float(s) + 1e-9, float(delta), device=o.device)
    pts = o[None, :] + ts[:, None] * n[None, :]              # (S, 3)
    z = (pts[:, None, :] - scene.mu[None, :, :]) / scene.scale[None, :, :]
    dens = scene.magnitude[None, :] * torch.exp(-0.5 * torch.sum(z * z, dim=-1))
    return torch.exp(-delta * torch.sum(dens))


def radiance_aniso(o, n, scene: AnisoScene) -> torch.Tensor:
    """Oracle radiance along one ray: the literal 5-tap quadrature with the
    explicit matrix-form pdf at each sample point (no algebraic collapse),
    so the fused paths are tested against independent math."""
    mu_bar, sigma_bar, _ = (x[0] for x in _aniso_ray_terms(o, n[None, :], scene))   # (N,)
    taps = torch.as_tensor(K_TAPS, device=mu_bar.device)
    s_pk = mu_bar[:, None] + taps[None, :] * sigma_bar[:, None]  # (N, 5)
    T = transmittance_aniso(o, n, s_pk, scene)               # (N, 5)
    pts = o[None, None, :] + s_pk[..., None] * n[None, None, :]  # (N, 5, 3)
    z = (pts - scene.mu[:, None, :]) / scene.scale[:, None, :]
    pdf = scene.magnitude[:, None] * torch.exp(-0.5 * torch.sum(z * z, dim=-1))
    inner = torch.sum(pdf * T * sigma_bar[:, None], dim=-1)  # (N,)
    return inner @ scene.albedo


def _radiance_block_aniso(o, dirs, scene: AnisoScene, q_block: int,
                          erf_name: str = "exact", exp_name: str = "exact") -> torch.Tensor:
    """Fused radiance for a block of rays: dirs (..., R, 3) → (..., R, 3),
    the anisotropic twin of ops.render._radiance_block (the same pdf
    collapse and hoisted base; sigma_bar and inv are (..., R, N) planes
    instead of per-Gaussian columns). The q axis runs in blocks of q_block
    so the pairwise intermediate stays (..., R, q_block, 5N)."""
    erf_fn, exp_fn = _resolve_approx(erf_name, exp_name)
    n = scene.n
    mu_bar, sigma_bar, cbar = _aniso_ray_terms(o, dirs, scene, exp_fn)
    coeff = sigma_bar * INV_SQRT_2_PI * cbar
    inv = 1.0 / (SQRT_2 * sigma_bar)
    base = torch.sum(coeff * erf_fn(-mu_bar * inv), dim=-1)     # (..., R)
    taps = torch.as_tensor(K_TAPS, dtype=mu_bar.dtype, device=dirs.device)
    s = (mu_bar[..., None] + taps * sigma_bar[..., None]).reshape(*mu_bar.shape[:-1], n * 5)
    acc = torch.zeros_like(s)
    for q0 in range(0, n, q_block):
        mu_q = mu_bar[..., q0:q0 + q_block]                     # (..., R, Qb)
        co_q = coeff[..., q0:q0 + q_block]
        inv_q = inv[..., q0:q0 + q_block]
        args = (s[..., None, :] - mu_q[..., None]) * inv_q[..., None]   # (..., R, Qb, 5N)
        acc = acc + torch.sum(co_q[..., None] * erf_fn(args), dim=-2)
    T = exp_fn(base[..., None] - acc).reshape(*mu_bar.shape, 5)
    tw = T @ torch.as_tensor(K_WEIGHTS, dtype=T.dtype, device=dirs.device)   # (..., R, N)
    return (sigma_bar * cbar * tw) @ scene.albedo


def render_rays_aniso_impl(o, dirs, scene: AnisoScene, q_block: int = 128,
                           ray_block: int = 2048, erf_name: str = "exact",
                           exp_name: str = "exact") -> torch.Tensor:
    """Render a batch of rays through the plain renderer → colors (R,3),
    `ray_block` rays at a time. Differentiable with respect to every scene
    field, the per-axis scales included. Pad rays take the unit direction
    +z (|d| <= 1 keeps B^2/A <= C, so a dead ray's cbar cannot overflow)."""
    scene = pad_scene_aniso(scene, q_block)
    r = dirs.shape[0]
    dirs_p = _unit_pad(dirs, (-r) % ray_block)
    colors = torch.cat([
        _radiance_block_aniso(o, dirs_p[i:i + ray_block], scene, q_block, erf_name, exp_name)
        for i in range(0, dirs_p.shape[0], ray_block)])
    return colors[:r]


def render_aniso(scene: AnisoScene, camera: Camera, origin=None, q_block: int = 128,
                 ray_block: int = 2048, erf_name: str = "exact",
                 exp_name: str = "exact") -> torch.Tensor:
    """Full-frame anisotropic render → float32 (H, W, 3), unclamped."""
    o, dirs = camera.rays(origin)
    colors = render_rays_aniso_impl(o, dirs, scene, q_block=q_block, ray_block=ray_block,
                                    erf_name=erf_name, exp_name=exp_name)
    return colors.reshape(camera.height, camera.width, 3)


def gather_tiles_aniso(scene: AnisoScene, idx: torch.Tensor) -> AnisoScene:
    """Per-tile gather: idx (T2, K) → scene with leading (T2, K) axes. The
    four fields are packed into one (N+1, 10) matrix, so the gather is one
    index_select; index N selects the inert dummy (scale 1, magnitude 0)."""
    with span("gather"):
        count_rows(idx, scene.n)
        packed = torch.cat([scene.mu, scene.scale, scene.magnitude[:, None], scene.albedo],
                           dim=1)                             # (N, 10)
        dummy = packed.new_zeros((1, 10))
        dummy[0, 3:6] = 1.0
        packed = torch.cat([packed, dummy])                   # (N+1, 10)
        t2, k = idx.shape
        out = packed.index_select(0, idx.reshape(-1)).reshape(t2, k, 10)
    return AnisoScene(mu=out[..., 0:3], scale=out[..., 3:6], magnitude=out[..., 6],
                      albedo=out[..., 7:10])


def render_tiled_aniso(scene: AnisoScene, camera: Camera, origin=None, tiles=16,
                       capacity: int = 128, q_block: int = 128, tile_batch: int = 16,
                       backend: str = "torch", erf_name: str = "exact",
                       exp_name: str = "exact", bucket_cfg=None):
    """Tiled and culled anisotropic frame → ((H, W, 3), overflow (0-d
    int32)). Culling uses the conservative max-scale footprint (iso_proxy)
    and the camera's focal length. backend="kernel" renders through the
    fused anisotropic kernels (ops.cuda_aniso) or, above
    MAX_BWD_CAPACITY_ANISO, the chunked ones, routed by tile_renderer_for
    (ops.cuda_render.ANISO); bucket_cfg (ops.scheduler.BucketConfig, kernel
    only) renders a dense and a sparse bucket, each at its own capacity.
    backend="torch" is the plain renderer, tile_batch tiles at a time.
    erf_name/exp_name select the approximation on both."""
    from sgrt_tpu_torch.ops.frame import BACKENDS

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    h, w = camera.height, camera.width
    tx, ty = as_grid(tiles)
    if h % ty or w % tx:
        raise ValueError(f"image {w}x{h} not divisible into {tx}x{ty} tiles")
    o, dirs = camera.rays(origin)
    view, focal = camera.view_matrix, camera.focal_length
    d = _tile_rays(dirs, h, w, tiles)

    if backend == "kernel":
        from sgrt_tpu_torch.ops.cuda_chunked import tile_renderer_for
        from sgrt_tpu_torch.ops.cuda_render import ANISO

        if bucket_cfg is not None and bucket_cfg.n_dense:
            from sgrt_tpu_torch.ops.scheduler import render_tiles_bucketed

            colors, _, overflow = render_tiles_bucketed(
                scene, view, o, d, bucket_cfg, erf_name=erf_name, exp_name=exp_name,
                tiles=tiles, focal_length=focal)
            return _untile_image(colors, h, w, tiles), overflow
        # one routing point for the per-tile kernel, which pads the capacity
        capacity, render_tiles = tile_renderer_for(capacity, geometry=ANISO,
                                                   erf_name=erf_name, exp_name=exp_name)
        with torch.no_grad():
            idx, counts = tile_indices(iso_proxy(scene), view, tiles, capacity,
                                       focal_length=focal)
        colors = render_tiles(gather_tiles_aniso(scene, idx), o, d, counts)
    else:
        qb = min(q_block, max(capacity, 1))
        capacity = max(qb, -(-capacity // qb) * qb)
        with torch.no_grad():
            idx, counts = tile_indices(iso_proxy(scene), view, tiles, capacity,
                                       focal_length=focal)
        tiled = gather_tiles_aniso(scene, idx)
        colors = torch.cat([
            _radiance_block_aniso(o, d[t:t + tile_batch],
                                  AnisoScene(*(getattr(tiled, f)[t:t + tile_batch]
                                               for f in FIELDS)),
                                  qb, erf_name, exp_name)
            for t in range(0, tx * ty, tile_batch)])
    overflow = torch.sum(counts > capacity, dtype=torch.int32)
    return _untile_image(colors, h, w, tiles), overflow
