"""Pinhole camera with a precomputed world-space projection plane (PyTorch
port of sgrt_tpu.models.camera).

Reproduces the reference camera math (src/vrt/camera.cpp:7-71):

  - view matrix = lookAt(pos, pos+front, up) then post-translated by
    focal_length*front (glm::translate post-multiplies: V = L @ T(f*front)),
    camera.cpp:52
  - per-pixel projection-plane point = inverse(view) @ (ndc_x, ndc_y, 0, 1)
    with ndc = (-1 + j/(w/2), -1 + i/(h/2)), camera.cpp:60-69
  - turn(yaw, pitch) spherical front vector + Gram-Schmidt right/up,
    camera.cpp:7-23

All math is float32 on the camera's device; the package turns TF32 off, so
the matrix products here are full float32 on the card too.
"""

from __future__ import annotations

import dataclasses

import torch

from sgrt_tpu_torch.utils.device import resolve_device


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v)


def look_at(eye: torch.Tensor, center: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Right-handed lookAt view matrix (glm::lookAtRH semantics), (4,4)."""
    f = _normalize(center - eye)
    s = _normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=eye.dtype, device=eye.device)
    return torch.stack(
        [
            torch.cat([s, -torch.dot(s, eye)[None]]),
            torch.cat([u, -torch.dot(u, eye)[None]]),
            torch.cat([-f, torch.dot(f, eye)[None]]),
            last,
        ]
    )


def translate(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """glm::translate(m, v) = m @ T(v) (post-multiplication)."""
    t = torch.eye(4, dtype=m.dtype, device=m.device)
    t[:3, 3] = v
    return m @ t


def inverse_rigid(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform [[R, t], [0, 1]] = [[R^T, -R^T t], [0, 1]]."""
    r = m[:3, :3]
    inv = torch.eye(4, dtype=m.dtype, device=m.device)
    inv[:3, :3] = r.T
    inv[:3, 3] = -(r.T @ m[:3, 3])
    return inv


def rotate_y(angle_deg, *, device="cuda") -> torch.Tensor:
    """Rotation about the +Y axis (glm::rotate(mat4(1), radians(a), (0,1,0))), (4,4)."""
    a = torch.deg2rad(_f32(angle_deg, resolve_device(device)))
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([
        torch.stack([c, zero, s, zero]),
        torch.stack([zero, one, zero, zero]),
        torch.stack([-s, zero, c, zero]),
        torch.stack([zero, zero, zero, one]),
    ])


def front_from_angles(yaw_deg, pitch_deg, constrain: bool = True, *,
                      device="cuda") -> torch.Tensor:
    """Spherical front vector from yaw/pitch in degrees (camera.cpp:7-19)."""
    dev = resolve_device(device)
    pitch = _f32(pitch_deg, dev)
    if constrain:
        pitch = torch.clamp(pitch, -89.0, 89.0)
    yaw_r, pitch_r = torch.deg2rad(_f32(yaw_deg, dev)), torch.deg2rad(pitch)
    f = torch.stack(
        [
            torch.cos(yaw_r) * torch.cos(pitch_r),
            torch.sin(pitch_r),
            torch.sin(yaw_r) * torch.cos(pitch_r),
        ]
    )
    return _normalize(f)


@dataclasses.dataclass
class Camera:
    """Pinhole camera; width/height are plain ints."""

    position: torch.Tensor      # (3,)
    front: torch.Tensor         # (3,)
    up: torch.Tensor            # (3,)
    right: torch.Tensor         # (3,)
    world_up: torch.Tensor      # (3,)
    view_matrix: torch.Tensor   # (4,4)
    focal_length: torch.Tensor  # scalar
    width: int = 256
    height: int = 256

    @property
    def device(self) -> torch.device:
        return self.position.device

    @classmethod
    def create(
        cls,
        position=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        yaw: float = -90.0,
        pitch: float = 0.0,
        width: int = 256,
        height: int = 256,
        focal_length: float = 1.0,
        *,
        device="cuda",
    ) -> "Camera":
        """Matches camera_t's ctor + initial turn(yaw, pitch) (camera.cpp:25-36)."""
        dev = resolve_device(device)
        cam = cls(
            position=_f32(position, dev),
            front=_f32([0.0, 0.0, 1.0], dev),
            up=_f32(up, dev),
            right=torch.zeros(3, dtype=torch.float32, device=dev),
            world_up=_f32(up, dev),
            view_matrix=torch.eye(4, dtype=torch.float32, device=dev),
            focal_length=_f32(focal_length, dev),
            width=width,
            height=height,
        )
        return cam.turn(yaw, pitch)

    def replace(self, **changes) -> "Camera":
        return dataclasses.replace(self, **changes)

    def turn(self, yaw, pitch, constrain: bool = True) -> "Camera":
        front = front_from_angles(yaw, pitch, constrain, device=self.device)
        right = _normalize(torch.linalg.cross(front, self.world_up))
        up = _normalize(torch.linalg.cross(right, front))
        view = translate(
            look_at(self.position, self.position + front, up),
            self.focal_length * front,
        )
        return self.replace(front=front, right=right, up=up, view_matrix=view)

    def with_position(self, position) -> "Camera":
        return self.replace(position=_f32(position, self.device))

    def update(self) -> "Camera":
        """Recompute the view matrix for the current pose (camera.cpp:50-52)."""
        view = translate(
            look_at(self.position, self.position + self.front, self.up),
            self.focal_length * self.front,
        )
        return self.replace(view_matrix=view)

    def projection_plane(self) -> torch.Tensor:
        """World-space points of the focal plane, one per pixel: (H*W, 3).

        Pixel (row i, col j) → NDC (-1 + j/(w/2), -1 + i/(h/2), 0) mapped
        through inverse(view) (camera.cpp:60-69); stored row-major [i*w+j].
        """
        w, h, dev = self.width, self.height, self.device
        x = -1.0 + torch.arange(w, dtype=torch.float32, device=dev) / (w / 2.0)
        y = -1.0 + torch.arange(h, dtype=torch.float32, device=dev) / (h / 2.0)
        xx = x[None, :].expand(h, w)
        yy = y[:, None].expand(h, w)
        ndc = torch.stack([xx, yy, torch.zeros_like(xx), torch.ones_like(xx)],
                          dim=-1)
        pts = ndc.reshape(-1, 4) @ inverse_rigid(self.view_matrix).T
        return pts[:, :3]

    def rays(self, origin=None):
        """(origin (3,), unit directions (H*W, 3)) toward the projection plane
        (reference ray setup: rt.h:232-237 — dir = normalize(plane - origin))."""
        o = self.position if origin is None else _f32(origin, self.device)
        d = self.projection_plane() - o[None, :]
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return o, d


def orbit_position(position: torch.Tensor, angle_deg) -> torch.Tensor:
    """Rotate the camera position about the world Y axis (main.cpp:330-332)."""
    hom = torch.cat([position, position.new_ones(1)])
    return (rotate_y(angle_deg, device=position.device) @ hom)[:3]
