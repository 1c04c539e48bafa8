"""Routing of the per-tile renderer by capacity (PyTorch port of the routing
half of sgrt_tpu.ops.pallas_chunked).

`tile_renderer_for` is THE single place that decides which kernel renders
a tile batch of a given capacity. Up to MAX_MONOLITHIC_CAPACITY rows the
fused forward kernel (ops.cuda_kernel) takes it. Above it the JAX package
switches to its Gaussian-axis chunked kernels; those are not ported yet,
so the port raises there rather than run anything else.
"""

from __future__ import annotations

import math

from sgrt_tpu_torch.ops.cuda_kernel import _block_sizes, render_tiles_fused

# Per-tile capacity above which the JAX package routes to its chunked
# kernels (its MAX_BWD_CAPACITY). Kept at the same value until the chunked
# kernels are ported and the card's own ceiling is measured.
MAX_MONOLITHIC_CAPACITY = 4096

# Chunk size of the chunked kernels' Gaussian axis (JAX: DEFAULT_CHUNK).
DEFAULT_CHUNK = 2048


def chunk_plan(capacity: int) -> tuple[int, int]:
    """Size the chunk axis for a per-tile capacity: the smallest chunk
    count C = ceil(capacity / DEFAULT_CHUNK), with the chunk size ck
    rounded up to 128. Returns (padded_capacity = C * ck, ck)."""
    c = max(1, -(-capacity // DEFAULT_CHUNK))
    per = -(-capacity // c)
    ck = -(-per // 128) * 128
    return c * ck, ck


def tile_renderer_for(capacity: int, *, erf_name: str = "as5",
                      exp_name: str = "exact", pb: int | None = None,
                      qb: int | None = None, rb: int = 128):
    """Route a per-tile renderer by capacity. Returns (padded_capacity,
    render_fn(tiled_scene, o, tile_dirs, counts)); callers gather and
    compact at the padded capacity (a multiple of lcm(pb, qb)). pb/qb
    override the kernel's block sizes and reach the kernel."""
    if capacity > MAX_MONOLITHIC_CAPACITY:
        raise NotImplementedError(
            f"per-tile capacity {capacity} is above {MAX_MONOLITHIC_CAPACITY}, "
            "where the JAX package switches to its Gaussian-axis chunked "
            "kernels (sgrt_tpu/ops/pallas_chunked.py); those are not ported "
            "yet. Use a finer tile grid to lower the per-tile count.")
    dpb, dqb = _block_sizes(capacity)
    pb = dpb if pb is None else pb
    qb = dqb if qb is None else qb
    align = math.lcm(pb, qb)
    cap = max(align, -(-capacity // align) * align)

    def render_fn(tiled, o, d, counts):
        return render_tiles_fused(tiled, o, d, counts, rb=rb, pb=pb, qb=qb,
                                  erf_name=erf_name, exp_name=exp_name)

    return cap, render_fn
