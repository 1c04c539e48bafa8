"""The plain reference of the benchmark: the orbit camera, the 3.3-sigma
tile culling and the renderer of the math contract, in plain PyTorch.

It imports neither the program nor anything of it, and takes nothing the
program has made: it works the camera, the rays, the tiles' member lists,
the targets and every gradient out again from the seeded scene it is given.

- Camera and culling run in float32, in the same order of operations as the
  camera and tiling the program documents (the reference's camera.cpp and
  rt.cpp), so that a Gaussian at the edge of a tile falls on the same side
  in both.
- The renderer is the math contract term by term (rt.h:32-54, 146-164):

      T(s) = exp( sum_q sigma_q cbar_q sqrt(pi/2)
                  (erf(-mu_bar_q / (sqrt2 sigma_q)) - erf((s - mu_bar_q) / (sqrt2 sigma_q))) )
      L    = sum_p albedo_p sum_k sigma_p pdf_p(o + s_pk n) T(s_pk),
      s_pk = mu_bar_p + k sigma_p, k in {-4, ..., 0}

  with pdf_p evaluated at the sample point itself, over each tile's culled
  members, in `dtype` (float64 for the check). erf is torch.erf: the
  program's A&S erf is within 1.5e-7 of it.
- tf32=True is the control: the operands of each product that is a matrix
  product (mu_bar = d . oc and the albedo sum) rounded to TF32's 10-bit
  mantissa first, as a TF32 matrix product would.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

K_SAMPLES = (-4.0, -3.0, -2.0, -1.0, 0.0)
REACH_SIGMAS = 3.3


def no_tf32() -> None:
    """Full float32 matrix products for the camera (the reference's own
    setting, whatever the process set before)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (float32 with a 10-bit mantissa, to nearest); the
    gradient passes through unchanged."""
    bits = x.detach().to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return x + (bits.view(torch.float32).to(x.dtype) - x).detach()


# ---------------------------------------------------------------------------
# camera (float32)
# ---------------------------------------------------------------------------

def _normalize(v):
    return v / torch.linalg.vector_norm(v)


def _look_at(eye, center, up):
    f = _normalize(center - eye)
    s = _normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=eye.dtype, device=eye.device)
    return torch.stack([torch.cat([s, -torch.dot(s, eye)[None]]),
                        torch.cat([u, -torch.dot(u, eye)[None]]),
                        torch.cat([-f, torch.dot(f, eye)[None]]), last])


def _translate(m, v):
    t = torch.eye(4, dtype=m.dtype, device=m.device)
    t[:3, 3] = v
    return m @ t


def _rotate_y(angle):
    a = torch.deg2rad(angle)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack([c, zero, s, zero]), torch.stack([zero, one, zero, zero]),
                        torch.stack([-s, zero, c, zero]), torch.stack([zero, zero, zero, one])])


def orbit_view(angle_deg: float, offset: float, focal: float, device):
    """(position (3,), view matrix (4,4)) of the orbit camera at angle_deg:
    at (0, 0, offset) facing +z, rotated about world y, then turned to yaw
    -90 - angle (main.cpp:248-255, 330-334; camera.cpp:7-52)."""
    no_tf32()
    f32 = dict(dtype=torch.float32, device=device)
    angle = torch.as_tensor(angle_deg, **f32)
    e_z = torch.tensor([0.0, 0.0, 1.0], device=device)
    e_y = torch.tensor([0.0, 1.0, 0.0], device=device)
    hom = torch.cat([e_z * offset, (e_z * offset).new_ones(1)])
    position = (_rotate_y(angle) @ hom)[:3]
    yaw = torch.deg2rad(torch.as_tensor(-90.0 - angle, **f32))
    pitch = torch.deg2rad(torch.clamp(torch.as_tensor(0.0, **f32), -89.0, 89.0))
    front = _normalize(torch.stack([torch.cos(yaw) * torch.cos(pitch), torch.sin(pitch),
                                    torch.sin(yaw) * torch.cos(pitch)]))
    right = _normalize(torch.linalg.cross(front, e_y))
    up = _normalize(torch.linalg.cross(right, front))
    focal_t = torch.as_tensor(focal, **f32)
    view = _translate(_look_at(position, position + front, up), focal_t * front)
    return position, view


def camera_rays(position, view, width: int, height: int):
    """Unit ray directions (H*W, 3), row-major, toward the projection plane
    inverse(view) @ (ndc_x, ndc_y, 0, 1) (camera.cpp:60-69, rt.h:232-237)."""
    dev = position.device
    x = -1.0 + torch.arange(width, dtype=torch.float32, device=dev) / (width / 2.0)
    y = -1.0 + torch.arange(height, dtype=torch.float32, device=dev) / (height / 2.0)
    xx, yy = x[None, :].expand(height, width), y[:, None].expand(height, width)
    ndc = torch.stack([xx, yy, torch.zeros_like(xx), torch.ones_like(xx)], dim=-1)
    r = view[:3, :3]
    inv = torch.eye(4, dtype=view.dtype, device=dev)
    inv[:3, :3] = r.T
    inv[:3, 3] = -(r.T @ view[:3, 3])
    pts = (ndc.reshape(-1, 4) @ inv.T)[:, :3]
    d = pts - position[None, :]
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# culling (float32)
# ---------------------------------------------------------------------------

def membership(mu, sigma, view, tiles, focal: float) -> torch.Tensor:
    """(tx*ty, N) bool: Gaussian q is a member of a tile when its projected
    center lies within half the tile plus 3.3 projected sigmas of the
    tile's center on both axes, in the ray frame f p.xy / (p.z + f), and
    p.z >= 1 (rt.cpp:35-59). Tiles row-major (ty, tx) over NDC [-1, 1]^2."""
    tx, ty = tiles
    mu = mu.detach().to(torch.float32)
    sigma = sigma.detach().to(torch.float32)
    v = view
    p = [mu[:, 0] * v[i, 0] + mu[:, 1] * v[i, 1] + mu[:, 2] * v[i, 2] + v[i, 3]
         for i in range(3)]
    z = p[2]
    valid = z >= 1.0
    zs = torch.where(valid, z, torch.ones_like(z))
    scale = torch.as_tensor(focal, dtype=torch.float32, device=mu.device)
    denom = zs + scale
    mu2 = scale * torch.stack([p[0], p[1]], dim=-1) / denom[:, None]
    sigma_p = scale * sigma / denom
    valid = valid & (sigma_p >= 1e-5)
    mu2 = torch.where(valid[:, None], mu2, torch.full_like(mu2, float("inf")))
    hx, hy = 1.0 / tx, 1.0 / ty
    dev = mu.device
    cx = -1.0 + hx + 2.0 * hx * torch.arange(tx, dtype=torch.float32, device=dev)
    cy = -1.0 + hy + 2.0 * hy * torch.arange(ty, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    reach = REACH_SIGMAS * sigma_p[None, :]
    ok = valid[None, :]
    for ax, half in ((0, hx), (1, hy)):
        ok = ok & (torch.abs(centers[:, ax][:, None] - mu2[None, :, ax]) <= half + reach)
    return ok


def tile_counts(mu, sigma, view, tiles, focal: float) -> torch.Tensor:
    """Live member count of each tile (tx*ty,), int64."""
    return membership(mu, sigma, view, tiles, focal).sum(dim=1)


def pixel_tiles(width: int, height: int, tiles, device) -> torch.Tensor:
    """The tile of each pixel (H*W,), row-major pixels and tiles."""
    tx, ty = tiles
    i = torch.arange(height, device=device)[:, None] // (height // ty)
    j = torch.arange(width, device=device)[None, :] // (width // tx)
    return (i * tx + j).reshape(-1)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def ray_colors(o, dirs, mu, sigma, mag, alb, *, qb: int = 64, tf32: bool = False):
    """The math contract for B groups of rays, each against its own rows:
    o (3,), dirs (B, M, 3), mu (B, C, 3), sigma/mag (B, C), alb (B, C, 3) →
    colors (B, M, 3) in the rows' dtype. Rows with mag 0 add nothing."""
    dt = mu.dtype
    dirs = dirs.to(dt)
    o = o.to(dt)
    oc = mu - o                                                   # (B, C, 3)
    mm = tf32_round if tf32 else (lambda t: t)
    mu_bar = torch.einsum("bmj,bcj->bmc", mm(dirs), mm(oc))      # (B, M, C)
    oc_sq = torch.sum(oc * oc, dim=-1)                            # (B, C)
    n_sq = torch.sum(dirs * dirs, dim=-1)                         # (B, M)
    two_s2 = 2.0 * sigma * sigma                                  # (B, C)
    cbar = mag[:, None, :] * torch.exp(-(oc_sq[:, None, :] - mu_bar ** 2) / two_s2[:, None, :])
    inv = 1.0 / (math.sqrt(2.0) * sigma)                          # (B, C)
    coef = sigma[:, None, :] * cbar * math.sqrt(math.pi / 2.0)    # (B, M, C)
    base = torch.sum(coef * torch.erf(-mu_bar * inv[:, None, :]), dim=-1)   # (B, M)
    k = torch.tensor(K_SAMPLES, dtype=dt, device=mu.device)
    s = mu_bar[..., None] + k * sigma[:, None, :, None]           # (B, M, C, 5)
    b, m, c, _ = s.shape
    s_flat = s.reshape(b, m, c * 5)
    acc = torch.zeros_like(s_flat)
    for q0 in range(0, c, qb):
        q1 = min(c, q0 + qb)
        arg = ((s_flat[..., None] - mu_bar[:, :, None, q0:q1])
               * inv[:, None, None, q0:q1])                       # (B, M, 5C, qb)
        acc = acc + torch.sum(coef[:, :, None, q0:q1] * torch.erf(arg), dim=-1)
    t = torch.exp(base[..., None] - acc).reshape(b, m, c, 5)
    # pdf at the sample point o + s n: |s n - oc|^2 = s^2 |n|^2 - 2 s mu_bar + |oc|^2
    d2 = (s * s * n_sq[:, :, None, None] - 2.0 * s * mu_bar[..., None]
          + oc_sq[:, None, :, None])
    pdf = mag[:, None, :, None] * torch.exp(-d2 / two_s2[:, None, :, None])
    inner = torch.sum(sigma[:, None, :, None] * pdf * t, dim=-1)  # (B, M, C)
    return torch.einsum("bmc,bcj->bmj", mm(inner), mm(alb))


def _inert_padded(fields, member_rows: torch.Tensor, n: int):
    """Gather each group's member rows, padded to the longest with inert
    rows (mu 0, sigma 1, mag 0, albedo 0): fields (mu, sigma, mag, alb) of
    the scene, member_rows (B, N) bool → (mu (B,C,3), sigma, mag, alb)."""
    counts = member_rows.sum(dim=1)
    cmax = max(int(counts.max()), 1)
    order = torch.argsort((~member_rows).to(torch.int8), dim=1, stable=True)[:, :cmax]
    live = torch.arange(cmax, device=member_rows.device)[None, :] < counts[:, None]
    idx = torch.where(live, order, torch.full_like(order, n))
    mu, sigma, mag, alb = fields
    pad = lambda t, v: torch.cat([t, torch.full((1,) + tuple(t.shape[1:]), v, dtype=t.dtype,
                                                device=t.device)])
    return (pad(mu, 0.0)[idx], pad(sigma, 1.0)[idx], pad(mag, 0.0)[idx], pad(alb, 0.0)[idx])


def _tile_batches(counts: torch.Tensor, rays: int, budget: float, grad: bool):
    """Tiles with members, in batches of similar counts whose pairwise
    intermediates (tiles x rays x 5 C x 64 without gradient, x 5 C x C
    with: the backward keeps every q block's) stay under `budget` elements."""
    order = torch.argsort(counts, descending=True).tolist()
    cnt = counts.tolist()
    batch, out = [], []
    for t in order:
        if cnt[t] == 0:
            break
        cmax = cnt[batch[0]] if batch else cnt[t]
        if batch and (len(batch) + 1) * rays * 5 * cmax * (cmax if grad else 64) > budget:
            out.append(batch)
            batch = []
        batch.append(t)
    if batch:
        out.append(batch)
    return out


def render_tiles(o, tile_dirs, fields, member, *, tf32: bool = False,
                 budget: float = 2.5e8, grad: bool = False):
    """Colors of every tile's rays against its members: tile_dirs (T, P, 3),
    fields (mu, sigma, mag, alb) of the whole scene, member (T, N) bool →
    (T, P, 3). grad=True checkpoints each batch, so the backward recomputes
    one batch's intermediates at a time."""
    n = fields[0].shape[0]
    t2, p, _ = tile_dirs.shape
    counts = member.sum(dim=1)
    out = fields[0].new_zeros((t2, p, 3))
    for batch in _tile_batches(counts, p, budget, grad):
        ids = torch.tensor(batch, device=member.device)

        def run(mu, sigma, mag, alb, ids=ids):
            rows = _inert_padded((mu, sigma, mag, alb), member[ids], n)
            return ray_colors(o, tile_dirs[ids], *rows, tf32=tf32)

        if grad:
            colors = checkpoint(run, *fields, use_reentrant=False)
        else:
            colors = run(*fields)
        out = out.index_copy(0, ids, colors)
    return out


def tile_rays(dirs, width: int, height: int, tiles):
    """(H*W, 3) row-major rays → (tx*ty, P, 3) grouped by tile, tiles
    row-major (ty, tx)."""
    tx, ty = tiles
    th, tw = height // ty, width // tx
    return dirs.reshape(ty, th, tx, tw, 3).permute(0, 2, 1, 3, 4).reshape(tx * ty, th * tw, 3)


def render_pixels(scene, angle_deg: float, pixels, *, width: int, height: int, tiles,
                  offset: float, focal: float, dtype=torch.float64, tf32: bool = False):
    """Colors (len(pixels), 3) of the orbit frame at angle_deg at the given
    row-major pixel indices, each against the culled members of its tile.
    scene: (mu, sigma, mag, alb) float32 tensors of the seeded scene."""
    mu, sigma, mag, alb = scene
    dev = mu.device
    position, view = orbit_view(angle_deg, offset, focal, dev)
    dirs = camera_rays(position, view, width, height)
    member = membership(mu, sigma, view, tiles, focal)
    pix = torch.as_tensor(pixels, device=dev)
    tile_of = pixel_tiles(width, height, tiles, dev)[pix]
    fields = tuple(f.to(dtype) for f in (mu, sigma, mag, alb))
    out = torch.zeros((pix.numel(), 3), dtype=dtype, device=dev)
    with torch.no_grad():
        for t in torch.unique(tile_of).tolist():
            sel = (tile_of == t).nonzero().reshape(-1)
            rows = _inert_padded(fields, member[t:t + 1], mu.shape[0])
            out[sel] = ray_colors(position, dirs[pix[sel]][None], *rows, tf32=tf32)[0]
    return out
