"""Tiling on the card in one hand-written kernel (csrc/tiling.cu).

`tile_indices_cuda` returns what ops.tiling's plain chain (project_gaussians,
tile_membership, compact_rows) returns, bit for bit: per tile the first K
member indices in ascending order padded with N, and the true member
counts. It launches one kernel, synchronises nothing and uploads nothing
per call: the tile centres are made once per grid and device, a Python
focal length is uploaded once per value and device, and a focal length on
the card is read in place. ops.tiling.tile_indices takes it for tensors on
the card; the plain chain stays the CPU path and the kernel's oracle.
"""

from __future__ import annotations

import functools

import torch

from sgrt_tpu_torch.models.gaussians import GaussianScene
from sgrt_tpu_torch.ops.cuda_kernel import CudaKernel
from sgrt_tpu_torch.ops.tiling import as_grid, tile_centers

TILE_COMPACT = CudaKernel("tile_compact", "tiling.cu", "sgrt_tile_compact",
                          "sgrt_tpu/ops/tiling.py:162", 7, 4)


@functools.lru_cache(maxsize=64)
def _centers(tx: int, ty: int, device: torch.device) -> torch.Tensor:
    return tile_centers((tx, ty), device=device).contiguous()


@functools.lru_cache(maxsize=64)
def _focal_scalar(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def focal_on(focal_length, device: torch.device) -> torch.Tensor | None:
    """The focal length as one float32 on `device`, as project_gaussians
    rounds it: a scalar tensor already there is used in place (rounded to
    float32 there if it is of another dtype); a number is uploaded once per
    value and device and kept. A tensor on another device is refused: its
    copy would block on every call. None (the view-frame projection) stays
    None."""
    if focal_length is None:
        return None
    if isinstance(focal_length, torch.Tensor):
        if focal_length.numel() != 1:
            raise ValueError(f"focal_length has {focal_length.numel()} elements, expected 1")
        if focal_length.device != device:
            raise ValueError(f"focal_length is on {focal_length.device}; the tiling kernel "
                             f"takes a number or a tensor on {device}")
        return focal_length.to(dtype=torch.float32).reshape(())
    return _focal_scalar(float(focal_length), device)


def tile_indices_cuda(scene: GaussianScene, view: torch.Tensor, tiles, capacity: int,
                      focal_length=1.0):
    """ops.tiling.tile_indices for a scene on the card: (idx (T2, K) int32,
    counts (T2,) int32), one launch of the tiling kernel."""
    dev = scene.mu.device
    mu, sigma = scene.mu.detach(), scene.sigma.detach()
    n = mu.shape[0]
    if mu.dim() != 2 or mu.shape[1] != 3 or tuple(sigma.shape) != (n,):
        raise ValueError(f"tiling takes mu (N, 3) and sigma (N,), got {tuple(mu.shape)} "
                         f"and {tuple(sigma.shape)}")
    if view.dim() != 2 or view.shape[0] < 3 or view.shape[1] != 4:
        raise ValueError(f"view has shape {tuple(view.shape)}, expected (4, 4)")
    for name, t in (("mu", mu), ("sigma", sigma), ("view", view)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the tiling kernel takes "
                             f"float32 on {dev}")
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    tx, ty = as_grid(tiles)
    idx = torch.empty((tx * ty, capacity), dtype=torch.int32, device=dev)
    counts = torch.empty((tx * ty,), dtype=torch.int32, device=dev)
    TILE_COMPACT.launch([mu.contiguous(), sigma.contiguous(), view.detach().contiguous(),
                         focal_on(focal_length, dev), _centers(tx, ty, dev), idx, counts],
                        [n, tx, ty, capacity], what=f"{tx}x{ty} tiles, N {n}, K {capacity}")
    return idx, counts
