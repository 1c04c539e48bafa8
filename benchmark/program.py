"""What the drivers take from the program (sgrt_tpu_torch): its scene
class, the capacity and bucket rules a cell pins, and its kernels' launch
counters. The only module of the benchmark besides the drivers that
imports the program."""

from __future__ import annotations


def scene_of(fields):
    """The program's GaussianScene over (mu, sigma, magnitude, albedo)."""
    from sgrt_tpu_torch.models.gaussians import GaussianScene

    return GaussianScene(*fields)


def pinned_buckets(scene, angles, *, offset, focal, tiles, width, height, rule: dict):
    """(capacity, BucketConfig or None) of a cell, by the fixed rule its
    file gives, never by the cost model timed on the card:

    one           one bucket at max(min, probe_capacity over the angles x margin)
    dense_sparse  the densest n_dense tiles at auto_tile_grid's capacity
                  (margin), started at the cell's own grid, the rest at
                  cap_sparse rows"""
    from sgrt_tpu_torch.ops.frame import auto_tile_grid, probe_capacity
    from sgrt_tpu_torch.ops.scheduler import BucketConfig

    tiles = tuple(tiles)
    if rule["rule"] == "one":
        cap = max(int(rule["min"]), int(probe_capacity(scene, angles, offset, focal, tiles)
                                        * float(rule["margin"])))
        return cap, None
    if rule["rule"] == "dense_sparse":
        grid, cap = auto_tile_grid(scene, angles, offset, focal, start=tiles,
                                   margin=float(rule["margin"]), width=width, height=height)
        if tuple(grid) != tiles:
            raise ValueError(f"auto_tile_grid refines the cell's grid {tiles} to {grid}")
        return cap, BucketConfig(int(rule["n_dense"]), cap, int(rule["cap_sparse"]))
    raise ValueError(f"unknown bucket rule {rule['rule']!r}")


def launches() -> int:
    """Launches of the program's kernels since the last reset."""
    from sgrt_tpu_torch.ops.kernels import KERNELS

    return sum(k.launches for k in KERNELS)


def reset_launches() -> None:
    from sgrt_tpu_torch.ops.kernels import reset_launch_counts

    reset_launch_counts()
