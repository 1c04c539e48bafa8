"""Bucketed tile scheduling (PyTorch port of sgrt_tpu.ops.scheduler).

Fixed-capacity tiling pays the worst tile's cost everywhere: one dense tile
forces every sparse tile to carry the same Gaussian capacity. The
scheduler splits a frame's tiles into two buckets:

    dense  — the top `n_dense` tiles by live count, capacity `cap_dense`
    sparse — the remaining tiles, capacity `cap_sparse`

and renders each bucket with one launch of the fused kernel at its own
capacity, then scatters the colors back into tile order. The scheduler
launches no kernel of its own. `probe_bucket_config` picks the split on
the host from sample views and a cost model of a launch
(`calibrate_cost_model`), keeping one bucket (n_dense = 0) when a second
launch would not pay for itself.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sgrt_tpu_torch.models.gaussians import GaussianScene
from sgrt_tpu_torch.ops.tiling import as_grid, compact_rows, gather_tiles, tile_membership
from sgrt_tpu_torch.utils.trace import span


class BucketConfig(NamedTuple):
    n_dense: int      # tiles in the dense bucket (0 → single-bucket mode)
    cap_dense: int    # Gaussian capacity of dense tiles
    cap_sparse: int   # Gaussian capacity of sparse tiles

    def round_to(self, qd: int, qs: int) -> "BucketConfig":
        return BucketConfig(
            self.n_dense,
            -(-self.cap_dense // qd) * qd,
            -(-self.cap_sparse // qs) * qs,
        )


class BucketedRender(NamedTuple):
    """One frame of make_bucketed_renderer's render."""
    colors: torch.Tensor      # (M, P, 3) of the tiles `ids`
    ids: torch.Tensor         # (M,)
    counts: torch.Tensor      # (T2,) true live counts
    overflow: torch.Tensor    # 0-d int32: tiles whose true count exceeds their bucket's
                              # capacity; 0 means nothing was dropped
    rows: list                # per bucket, in the order of the colors: (tile ids (M_b,),
                              # indices (M_b, cap_b), the gathered scene with leading
                              # (M_b, cap_b) axes), to differentiate at the rows rendered


# Decision constants for devices where nothing is measured (the CPU): the
# JAX package's own static cost model, kept so that bucket decisions made
# on the CPU equal the JAX package's. They describe no speed of the port.
LAUNCH_OVERHEAD_ERF = 5e8
LINEAR_ERF_PER_ROW_RAY = 10.0
_STATIC_RATE_ERF = 120e9

# measured models, one per CUDA device name, for the life of the process
_CALIBRATIONS: dict[str, dict] = {}


def _static_model() -> dict:
    return {"rate_erf": _STATIC_RATE_ERF,
            "linear_s": LINEAR_ERF_PER_ROW_RAY / _STATIC_RATE_ERF,
            "launch_s": LAUNCH_OVERHEAD_ERF / _STATIC_RATE_ERF,
            "measured": False}


def calibrate_cost_model(device="cuda", force: bool = False) -> dict:
    """Cost model of one count-bounded launch of the fused forward kernel:
    {rate_erf (erf/s), linear_s (s per capacity-row-ray), launch_s (s per
    extra launch), measured}.

    On a CUDA device the three constants are measured once per process
    (force=True measures again) with the port's kernel and CUDA events, at
    the JAX package's synthetic shapes: two launches against one of the
    same total work (the launch cost), two empty-count capacities (the
    capacity-linear cost) and two dense capacities (the rate). Every
    constant is a difference of two timings, so fixed per-call costs
    cancel. Elsewhere (device="cpu") the JAX package's static decision
    constants are returned."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return _static_model()
    key = torch.cuda.get_device_name(dev)
    if key in _CALIBRATIONS and not force:
        return _CALIBRATIONS[key]

    from sgrt_tpu_torch.ops.cuda_kernel import fused_forward

    def mk(b, cap, full, seed):
        g = torch.Generator().manual_seed(seed)
        oc = torch.randn((b, cap, 3), generator=g)
        sig = torch.full((b, cap), 0.3)
        mag = torch.full((b, cap), 1.0 if full else 0.0)
        alb = torch.randn((b, cap, 3), generator=g).abs()
        d = torch.randn((b, 3, 128), generator=g)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        counts = torch.full((b,), cap if full else 0, dtype=torch.int32)
        return [t.to(dev).contiguous() for t in (oc, sig, mag, alb, d, counts)]

    def timed(datas, reps=24):
        """Seconds per pass over `datas`, one launch each, by CUDA events."""
        def run():
            for args in datas:
                fused_forward(*args, pb=8, qb=16)

        run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(dev):
            start.record()
            for _ in range(reps):
                run()
            end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / reps

    a, b2, ab = mk(64, 256, True, 0), mk(64, 256, True, 1), mk(128, 256, True, 2)
    e_lo, e_hi, big = mk(64, 128, False, 3), mk(64, 1024, False, 4), mk(64, 512, True, 5)
    launch_s = max(5e-6, timed([a, b2]) - timed([ab]))
    linear_s = max(1e-13, (timed([e_hi]) - timed([e_lo])) / (64 * (1024 - 128) * 128))
    d_work = 5 * 64 * (512 * 512 - 256 * 256) * 128
    d_lin = 64 * (512 - 256) * 128 * linear_s
    rate_erf = d_work / max(timed([big]) - timed([a]) - d_lin, 1e-5)
    model = {"rate_erf": float(rate_erf), "linear_s": float(linear_s),
             "launch_s": float(launch_s), "measured": True}
    _CALIBRATIONS[key] = model
    return model


def _quantized_pairs(counts, cap: int) -> float:
    """Pair-block erf work of one launch over `counts`, quantized to the
    kernel's (pb, qb) blocks at capacity `cap`, per ray."""
    from sgrt_tpu_torch.ops.cuda_kernel import _block_sizes

    pb, qb = _block_sizes(cap)
    c = np.maximum(np.asarray(counts, np.int64), 0)
    return float((np.ceil(c / pb) * pb * np.ceil(c / qb) * qb * 5).sum())


def _launch_time_s(counts, cap, rays_per_tile, calib) -> float:
    """Seconds model of one count-bounded launch over `counts` at capacity
    `cap`: the quantized erf work at the model's rate, plus the
    capacity-linear per-row cost and the fixed launch cost."""
    return (_quantized_pairs(counts, cap) * rays_per_tile / calib["rate_erf"]
            + len(counts) * cap * rays_per_tile * calib["linear_s"]
            + calib["launch_s"])


def _quantized_work_erf(counts, cap, rays_per_tile) -> float:
    """Erf-equivalent work of one launch with the static constants (the
    JAX package's view of _launch_time_s, for tests)."""
    linear = len(counts) * cap * LINEAR_ERF_PER_ROW_RAY
    return (_quantized_pairs(counts, cap) + linear) * rays_per_tile


def probe_bucket_config(scene: GaussianScene, views, tiles, margin: float = 1.2,
                        dense_frac: float = 0.125, focal_length=1.0,
                        multiple_of: int = 1, rays_per_tile: int = 128) -> BucketConfig:
    """Host-side sizing: over sample view matrices, take the worst-case
    per-tile counts (sorted, elementwise max); the dense bucket holds the
    top tiles and the sparse capacity covers the largest count outside it.
    Candidate dense sizes (and n_dense = 0, one launch) are scored with the
    cost model and the fastest is kept. multiple_of rounds n_dense up so
    both buckets split evenly over that many devices. Waits for the
    device."""
    tx, ty = as_grid(tiles)
    t2 = tx * ty
    if t2 % multiple_of:
        raise ValueError(f"tile count {t2} not divisible by {multiple_of}")
    worst = None
    with torch.no_grad():
        for view in views:
            member = tile_membership(scene, view, tiles, focal_length=focal_length)
            counts = torch.sort(torch.sum(member, dim=-1), descending=True).values
            worst = counts if worst is None else torch.maximum(worst, counts)
    worst = worst.cpu().numpy()
    cap_dense = max(32, int(float(worst[0]) * margin))

    calib = calibrate_cost_model(scene.device)
    fracs = sorted({dense_frac, 1 / 32, 1 / 16, 1 / 8, 1 / 4})
    cands = {0}
    for fr in fracs:
        nd = max(1, int(t2 * fr))
        nd = min(-(-nd // multiple_of) * multiple_of, t2 - multiple_of)
        if nd > 0:
            cands.add(nd)
    best = (None, None)
    for nd in sorted(cands):
        if nd == 0:
            cfg = BucketConfig(0, cap_dense, cap_dense)
            t = _launch_time_s(worst, cap_dense, rays_per_tile, calib)
        else:
            cap_sparse = max(32, int(float(worst[nd]) * margin))
            if cap_sparse >= cap_dense:
                continue
            cfg = BucketConfig(nd, cap_dense, cap_sparse)
            t = (_launch_time_s(worst[:nd], cap_dense, rays_per_tile, calib)
                 + _launch_time_s(worst[nd:], cap_sparse, rays_per_tile, calib))
        if best[0] is None or t < best[0]:
            best = (t, cfg)
    return best[1]


def bucketed_tile_indices(scene: GaussianScene, view: torch.Tensor, tiles,
                          cfg: BucketConfig, focal_length=1.0, interleave: int = 1):
    """Per-bucket compacted Gaussian indices: (dense_ids (D,), idx_dense
    (D, cap_dense), sparse_ids (S,), idx_sparse (S, cap_sparse), counts
    (T2,)). Tiles are ordered by count, densest first (a stable sort, so
    ties keep tile order). interleave=D permutes each bucket so a
    contiguous 1/D slice holds every D-th tile of that order. No gradient
    flows through the indices."""
    with torch.no_grad(), span("tiling"):
        member = tile_membership(scene, view, tiles, focal_length=focal_length)
        counts = torch.sum(member, dim=-1, dtype=torch.int32)
        order = torch.argsort(-counts, stable=True)
        dense_ids = order[:cfg.n_dense]
        sparse_ids = order[cfg.n_dense:]
        if interleave > 1:
            dense_ids = dense_ids.reshape(-1, interleave).T.reshape(-1)
            sparse_ids = sparse_ids.reshape(-1, interleave).T.reshape(-1)
        idx_dense = compact_rows(member[dense_ids], cfg.cap_dense, scene.n)
        idx_sparse = compact_rows(member[sparse_ids], cfg.cap_sparse, scene.n)
    return dense_ids, idx_dense, sparse_ids, idx_sparse, counts


def make_bucketed_renderer(cfg: BucketConfig, *, tiles, aniso: bool = False, mesh=None,
                           erf_name: str = "as5", exp_name: str = "exact", rb: int = 128,
                           pb: int | None = None, qb: int | None = None, focal_length=1.0):
    """Two-bucket tiled render of this rank's tiles: render(scene, view, o,
    tile_dirs (T2, P, 3)) → BucketedRender of this rank's M tiles.

    mesh (parallel.mesh.Mesh) None is one rank holding every tile; over a
    mesh of D ranks each bucket is permuted by bucketed_tile_indices'
    interleave and this rank takes its contiguous 1/D of each, so M =
    T2 / D and every rank carries a balanced mix of counts; bucket sizes
    the mesh does not divide raise ValueError (size them with
    probe_buckets(..., multiple_of=D)). The capacities are rounded and
    routed, once per bucket, by tile_renderer_for, for the row geometry that
    aniso selects (ops.cuda_render.ANISO: an AnisoScene, culled on its
    max-scale proxy). Differentiable with respect to the scene: the bucket
    gathers transpose to scatter-adds."""
    from sgrt_tpu_torch.ops import cuda_chunked
    from sgrt_tpu_torch.ops.cuda_render import ANISO, ISO

    geometry = ANISO if aniso else ISO
    # this module's gather_tiles, looked up here, gathers isotropic rows, so
    # that a gather replaced in this module is the one the buckets take
    gather = gather_tiles if geometry is ISO else geometry.gather
    tx, ty = as_grid(tiles)
    n_d, n_s = cfg.n_dense, tx * ty - cfg.n_dense
    n_dev = 1 if mesh is None else mesh.size
    if n_d % n_dev or n_s % n_dev:
        raise ValueError(f"bucket sizes ({n_d}, {n_s}) must divide the mesh ({n_dev} "
                         f"ranks); size with probe_buckets(..., multiple_of={n_dev})")
    cap_d, render_dense = cuda_chunked.tile_renderer_for(
        cfg.cap_dense, geometry=geometry, pb=pb, qb=qb, rb=rb, erf_name=erf_name,
        exp_name=exp_name)
    cap_s, render_sparse = cuda_chunked.tile_renderer_for(
        cfg.cap_sparse, geometry=geometry, pb=pb, qb=qb, rb=rb, erf_name=erf_name,
        exp_name=exp_name)
    cfg = BucketConfig(n_d, cap_d, cap_s)
    sd, ss = (slice(None),) * 2 if mesh is None else (mesh.shard(n_d), mesh.shard(n_s))

    def render(scene, view, o, tile_dirs):
        dense_ids, idx_d, sparse_ids, idx_s, counts = bucketed_tile_indices(
            geometry.proxy(scene), view, tiles, cfg,
            focal_length=focal_length, interleave=n_dev)
        overflow = (torch.sum(counts[sparse_ids] > cfg.cap_sparse)
                    + torch.sum(counts[dense_ids] > cfg.cap_dense)).to(torch.int32)
        ids_s, idx_s = sparse_ids[ss], idx_s[ss]
        rows_s = gather(scene, idx_s)
        colors = render_sparse(rows_s, o, tile_dirs[ids_s], counts[ids_s])
        rows = [(ids_s, idx_s, rows_s)]
        if n_d == 0:
            return BucketedRender(colors, ids_s, counts, overflow, rows)
        ids_d, idx_d = dense_ids[sd], idx_d[sd]
        rows_d = gather(scene, idx_d)
        colors_d = render_dense(rows_d, o, tile_dirs[ids_d], counts[ids_d])
        return BucketedRender(torch.cat([colors_d, colors]), torch.cat([ids_d, ids_s]), counts,
                              overflow, [(ids_d, idx_d, rows_d)] + rows)

    return render


def render_tiles_bucketed(scene, view, o, tile_dirs, cfg: BucketConfig,
                          erf_name: str = "as5", exp_name: str = "exact", tiles=None,
                          rb: int = 128, pb: int | None = None, qb: int | None = None,
                          focal_length=1.0):
    """Two-bucket tiled render of a GaussianScene or an AnisoScene:
    tile_dirs (T2, P, 3) → (colors (T2, P, 3), counts (T2,), overflow (0-d
    int32: tiles whose true count exceeds their bucket's capacity; 0 means
    nothing was dropped)). make_bucketed_renderer's render on one rank,
    its colors scattered back into tile order (differentiable: the scatter
    transposes to a gather)."""
    from sgrt_tpu_torch.ops.cuda_render import ANISO, geometry_of

    t2 = tile_dirs.shape[0]
    if tiles is None:
        tiles = int(round(t2 ** 0.5))  # square-grid default
    render = make_bucketed_renderer(cfg, tiles=tiles, aniso=geometry_of(scene) is ANISO,
                                    erf_name=erf_name, exp_name=exp_name, rb=rb, pb=pb,
                                    qb=qb, focal_length=focal_length)
    out = render(scene, view, o, tile_dirs)
    with span("untile"):
        colors = out.colors.new_zeros((t2,) + tuple(out.colors.shape[1:])).index_copy(
            0, out.ids, out.colors)
    return colors, out.counts, out.overflow
