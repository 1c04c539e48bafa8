"""Renderer operations: oracle math, the plain fused renderer, tiling,
approximations, the CUDA kernels' wrappers and routing, the frame
pipeline."""

from sgrt_tpu_torch.ops.reference import (
    density,
    radiance,
    render_reference,
    transmittance,
    transmittance_step,
)
from sgrt_tpu_torch.ops.render import render, render_rays

__all__ = [
    "transmittance",
    "transmittance_step",
    "density",
    "radiance",
    "render_reference",
    "render",
    "render_rays",
]
