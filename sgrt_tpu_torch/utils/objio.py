"""Minimal Wavefront .obj vertex reader.

Only vertex positions are read: each `v` line becomes one Gaussian
(src/vrt/gaussians-from-file.cpp:31-42 of the reference renderer); faces,
normals and texcoords are ignored. The native C++ scanner (utils.native)
is the fast path; the pure-Python parser below, the path when the native
library does not build or load.
"""

from __future__ import annotations

import numpy as np

from sgrt_tpu_torch.utils.native import read_obj_vertices_native


def read_obj_vertices(path: str) -> np.ndarray:
    """Parse `v x y z [...]` lines → (N, 3) float32 array."""
    out = read_obj_vertices_native(path)
    if out is not None:
        return out
    verts = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
    if not verts:
        raise ValueError(f"no vertices found in {path}")
    return np.asarray(verts, dtype=np.float32)
