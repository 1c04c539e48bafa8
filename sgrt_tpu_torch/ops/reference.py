"""Un-fused reference implementation — the correctness oracle (PyTorch port
of sgrt_tpu.ops.reference).

These functions follow the reference math term by term and are the ground
truth the fused paths are tested against; they are plain differentiable
tensor code, so autograd through them is the gradient oracle too.

Math contract (scalar code at src/vrt/rt.h:32-54, 146-164):

  Transmittance along ray o + s*n through Gaussians {a_q, mu_q, sigma_q, c_q}:

      mu_bar_q = (mu_q - o) . n
      cbar_q   = c_q * exp(-(||mu_q - o||^2 - mu_bar_q^2) / (2 sigma_q^2))
      T(s)     = exp( sum_q sigma_q cbar_q sqrt(pi/2)
                      * (erf(-mu_bar_q/(sqrt2 sigma_q))
                         - erf((s - mu_bar_q)/(sqrt2 sigma_q))) )

  Radiance (5-point footprint quadrature, k in {-4..0}, lambda_q = sigma_q):

      L = sum_q a_q sum_k lambda_q * pdf_q(o + s_qk n) * T(s_qk),
      s_qk = mu_bar_q + k * lambda_q
"""

from __future__ import annotations

import numpy as np
import torch

from sgrt_tpu_torch.models.camera import Camera
from sgrt_tpu_torch.models.gaussians import GaussianScene

# Constants as in src/vrt/rt.h:18-20.
SQRT_2_PI = 0.7978845608028654  # sqrt(2/pi)
INV_SQRT_2_PI = 1.0 / SQRT_2_PI  # = sqrt(pi/2)
SQRT_2 = 1.4142135623730951

K_TAPS = np.arange(-4.0, 1.0, dtype=np.float32)  # k in {-4,...,0}


def _per_gaussian_terms(o, dirs, scene: GaussianScene):
    """mu_bar, cbar for rays dirs (C,3) → both (C, N)."""
    oc = scene.mu - o[None, :]                          # (N,3)
    mu_bar = dirs @ oc.T                                # (C,N)
    oc_sq = torch.sum(oc * oc, dim=-1)                  # (N,)
    inv_2s2 = 1.0 / (2.0 * scene.sigma**2)
    cbar = scene.magnitude * torch.exp(-(oc_sq - mu_bar**2) * inv_2s2)
    return mu_bar, cbar


def _transmittance_rays(mu_bar, cbar, s, scene: GaussianScene):
    """T at samples s (C, S) along each of C rays → (C, S)."""
    inv = 1.0 / (SQRT_2 * scene.sigma)                  # (N,)
    erf1 = torch.erf(-mu_bar * inv)                     # (C,N)
    erf2 = torch.erf((s[:, :, None] - mu_bar[:, None, :]) * inv)  # (C,S,N)
    coef = scene.sigma * cbar * INV_SQRT_2_PI           # (C,N)
    t = torch.sum(coef[:, None, :] * (erf1[:, None, :] - erf2), dim=-1)
    return torch.exp(t)


def transmittance(o, n, s, scene: GaussianScene) -> torch.Tensor:
    """Closed-form transmittance at o + s*n (scalar). rt.h:32-54."""
    mu_bar, cbar = _per_gaussian_terms(o, n[None, :], scene)
    s = torch.as_tensor(s, dtype=torch.float32, device=o.device).reshape(1, 1)
    return _transmittance_rays(mu_bar, cbar, s, scene)[0, 0]


def transmittance_step(o, n, s, delta, scene: GaussianScene) -> torch.Tensor:
    """Riemann-sum numerical transmittance (debug integrator, rt.cpp:8-17).

    Sums density at t = 0, delta, 2*delta, ... <= s and returns exp(-sum*delta).
    `s` and `delta` are Python floats.
    """
    ts = torch.arange(0.0, float(s) + 1e-9, float(delta), dtype=torch.float32,
                      device=o.device)
    pts = o[None, :] + ts[:, None] * n[None, :]         # (S,3)
    d2 = torch.sum((pts[:, None, :] - scene.mu[None, :, :]) ** 2, dim=-1)
    dens = scene.magnitude[None, :] * torch.exp(-d2 / (2.0 * scene.sigma**2)[None, :])
    return torch.exp(-delta * torch.sum(dens))


def density(pt, scene: GaussianScene) -> torch.Tensor:
    """Combined density at a point (rt.cpp:19-27)."""
    pt = torch.as_tensor(pt, dtype=torch.float32, device=scene.device)
    return torch.sum(scene.pdf(pt))


def _radiance_rays(o, dirs, scene: GaussianScene) -> torch.Tensor:
    """Literal 5-tap quadrature for rays dirs (C,3) → (C,3), keeping the
    explicit pdf at o + s*n as the oracle for the simplified fast paths."""
    mu_bar, cbar = _per_gaussian_terms(o, dirs, scene)  # (C,N)
    lam = scene.sigma
    taps = torch.as_tensor(K_TAPS, device=o.device)
    s_pk = mu_bar[:, :, None] + taps * lam[:, None]     # (C,N,5)
    c, n = mu_bar.shape
    T = _transmittance_rays(mu_bar, cbar, s_pk.reshape(c, n * 5),
                            scene).reshape(c, n, 5)
    pts = o + s_pk[..., None] * dirs[:, None, None, :]  # (C,N,5,3)
    d2 = torch.sum((pts - scene.mu[None, :, None, :]) ** 2, dim=-1)
    pdf = scene.magnitude[:, None] * torch.exp(-d2 / (2.0 * scene.sigma**2)[:, None])
    inner = torch.sum(pdf * T * lam[:, None], dim=-1)   # (C,N)
    return inner @ scene.albedo


def radiance(o, n, scene: GaussianScene) -> torch.Tensor:
    """Radiance (RGB) along one ray — literal 5-tap quadrature (rt.h:146-164)."""
    return _radiance_rays(o, n[None, :], scene)[0]


def render_rays_reference(o, dirs, scene: GaussianScene, chunk: int = 16) -> torch.Tensor:
    """Oracle render of a batch of rays: dirs (R,3) → colors (R,3), `chunk`
    rays at a time to bound the O(chunk * N^2 * 5) intermediate."""
    return torch.cat([_radiance_rays(o, dirs[i:i + chunk], scene)
                      for i in range(0, dirs.shape[0], chunk)])


def render_reference(scene: GaussianScene, camera: Camera, origin=None,
                     chunk: int = 16) -> torch.Tensor:
    """Full-frame oracle render → float32 (H, W, 3), values unclamped."""
    o, dirs = camera.rays(origin)
    colors = render_rays_reference(o, dirs, scene, chunk=chunk)
    return colors.reshape(camera.height, camera.width, 3)
