"""Scenes from a configuration's recipe and a seed.

A recipe ({"kind", "n", ...} under a configuration's "scene") names one of
the point sets below, each its source's own fixed draw, so that every seed
gets the same scene and the same work; the seed draws the order of the
Gaussians (on the device, from a generator seeded with --seed), and a fit
draws its noise from the same generator after it. Sigma, albedo and
magnitude follow the reference's obj-loader rule
(gaussians-from-file.cpp:26-41): sigma 0.3 under 300 points, 0.15 under
1000, else 0.05; albedo 0.5 normalize(v) + 0.5; magnitude 1. A scene is
(mu (N,3), sigma (N,), magnitude (N,), albedo (N,3)), float32.
"""

from __future__ import annotations

import numpy as np
import torch


def _cube_surface(n: int) -> np.ndarray:
    """bench.py:40-51's stand-in for the teapot: n points uniform in
    [-1, 1]^3 pushed onto the cube's surface."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return pts / np.maximum(np.abs(pts).max(axis=1, keepdims=True), 1e-6)


def _sphere_surface(n: int) -> np.ndarray:
    """scripts/large_n.py's sphere: n normal points on the unit sphere."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


KINDS = {"cube_surface": _cube_surface, "sphere_surface": _sphere_surface}


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def obj_loader_sigma(n: int) -> float:
    return 0.3 if n < 300 else (0.15 if n < 1000 else 0.05)


def make_scene(recipe: dict, gen: torch.Generator, device):
    """The scene of `recipe`, its Gaussians in an order drawn from `gen`."""
    n = int(recipe["n"])
    pts = torch.from_numpy(KINDS[recipe["kind"]](n)).to(device)
    mu = pts[torch.randperm(n, generator=gen, device=device)]
    norm = torch.linalg.vector_norm(mu, dim=1, keepdim=True)
    albedo = torch.where(norm > 0, 0.5 * mu / torch.clamp(norm, min=1e-30) + 0.5,
                         torch.full_like(mu, 0.5))
    sigma = torch.full((n,), obj_loader_sigma(n), device=device)
    magnitude = torch.full((n,), float(recipe.get("magnitude", 1.0)), device=device)
    return mu, sigma, magnitude, albedo


def fit_inputs(recipe: dict, noise: float, seed: int, device):
    """(truth, start) of a fit: the scene of `recipe`, and the same with
    mu + N(0, noise), both drawn from one generator seeded with `seed`."""
    gen = generator(seed, device)
    truth = make_scene(recipe, gen, device)
    mu = truth[0] + noise * torch.randn(truth[0].shape, generator=gen, device=device)
    return truth, (mu,) + truth[1:]
