"""Gaussian scene representation (PyTorch port of sgrt_tpu.models.gaussians).

The scene is a dataclass of tensors, structure-of-arrays:

    mu        (N, 3) float32   Gaussian centers
    sigma     (N,)   float32   isotropic standard deviations
    magnitude (N,)   float32   density magnitudes c_q
    albedo    (N, 3) float32   RGB albedo

Padding convention (the reference's SIMD padding, src/vrt/types.cpp:53-63):
padded entries use sigma=1 (no div-by-zero), magnitude=0 (zero density, so
zero contribution to transmittance and radiance), mu=0, albedo=0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgrt_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class GaussianScene:
    """N isotropic 3D Gaussians. Density of Gaussian q at point x
    (reference: gaussian_t::pdf, src/vrt/types.h:204-208):

        pdf_q(x) = magnitude_q * exp(-||x - mu_q||^2 / (2 sigma_q^2))

    Fields may carry leading batch axes (per-tile scenes from
    ops.tiling.gather_tiles are (T, K, ...))."""

    mu: torch.Tensor         # (..., N, 3)
    sigma: torch.Tensor      # (..., N)
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
        d2 = torch.sum((x[None, :] - self.mu) ** 2, dim=-1)
        return self.magnitude * torch.exp(-d2 / (2.0 * self.sigma**2))

    def replace(self, **changes) -> "GaussianScene":
        return dataclasses.replace(self, **changes)


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, np.float32), device=device)


def make_scene(mu, sigma, magnitude, albedo, *, device="cuda") -> GaussianScene:
    """Scene from array-likes (numpy, lists or tensors), cast to float32."""
    dev = resolve_device(device)
    return GaussianScene(
        mu=_f32(mu, dev).reshape(-1, 3),
        sigma=_f32(sigma, dev).reshape(-1),
        magnitude=_f32(magnitude, dev).reshape(-1),
        albedo=_f32(albedo, dev).reshape(-1, 3),
    )


def scene_from_numpy(mu, sigma, magnitude, albedo, *, device="cuda") -> GaussianScene:
    """Build the port's scene from the four fields of a JAX
    sgrt_tpu GaussianScene given as numpy arrays (np.asarray of each
    field), so both packages can be fed the same scene."""
    return make_scene(np.asarray(mu), np.asarray(sigma), np.asarray(magnitude),
                      np.asarray(albedo), device=device)


def pad_scene(scene: GaussianScene, multiple: int = 128) -> GaussianScene:
    """Pad N up to a multiple with inert Gaussians (sigma=1, magnitude=0),
    which keep every formula finite while contributing exactly zero."""
    n_pad = (-scene.n) % multiple
    if n_pad == 0:
        return scene
    z3 = scene.mu.new_zeros((n_pad, 3))
    return GaussianScene(
        mu=torch.cat([scene.mu, z3]),
        sigma=torch.cat([scene.sigma, scene.sigma.new_ones(n_pad)]),
        magnitude=torch.cat([scene.magnitude, scene.magnitude.new_zeros(n_pad)]),
        albedo=torch.cat([scene.albedo, z3]),
    )


def grid_scene(dim: int = 4, sigma: float | None = None, magnitude: float = 1.0,
               *, device="cuda") -> GaussianScene:
    """Procedural dim x dim Gaussian grid — the reference's default `-g` scene
    (src/volumetric-ray-tracer/main.cpp:196-205):

        albedo = (1 - t, 0, t), t = (i*dim + j) / dim^2
        mu     = (-1 + 1/dim + i/(dim/2), -1 + 1/dim + j/(dim/2), 1)
        sigma  = 1/(2*dim), magnitude = 1
    """
    i, j = np.meshgrid(np.arange(dim), np.arange(dim), indexing="ij")
    t = (i * dim + j).astype(np.float32) / float(dim * dim)
    mu = np.stack(
        [
            -1.0 + 1.0 / dim + i / (dim / 2.0),
            -1.0 + 1.0 / dim + j / (dim / 2.0),
            np.ones_like(t),
        ],
        axis=-1,
    ).reshape(-1, 3)
    albedo = np.stack([1.0 - t, np.zeros_like(t), t], axis=-1).reshape(-1, 3)
    if sigma is None:
        sigma = 1.0 / (2.0 * dim)
    n = dim * dim
    return make_scene(mu, np.full(n, sigma), np.full(n, magnitude), albedo,
                      device=device)


def scene_from_vertices(vertices: np.ndarray, *, device="cuda") -> GaussianScene:
    """Vertices (N,3) → Gaussians by the reference's obj-loading rules
    (src/vrt/gaussians-from-file.cpp:26-41):

        sigma: N<300 → 0.3, N<1000 → 0.15, else 0.05  (same for all)
        albedo = 0.5*normalize(position) + 0.5
        magnitude = 1

    A vertex at the exact origin gets a mid-gray albedo (0.5, 0.5, 0.5)
    instead of the reference's undefined glm::normalize(0) (NaN).
    """
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    n = v.shape[0]
    sigma = 0.3 if n < 300 else (0.15 if n < 1000 else 0.05)
    norm = np.sqrt(np.sum(v * v, axis=-1, keepdims=True))
    albedo = 0.5 * np.divide(v, norm, out=np.zeros_like(v), where=norm > 0) + 0.5
    return make_scene(v, np.full(n, sigma), np.ones(n), albedo, device=device)


def scene_from_obj(path: str, *, device="cuda") -> GaussianScene:
    """Load a .obj file's vertices as Gaussians (reference:
    read_from_obj, src/vrt/gaussians-from-file.cpp:7-44)."""
    from sgrt_tpu_torch.utils.objio import read_obj_vertices

    return scene_from_vertices(read_obj_vertices(path), device=device)
