"""sgrt_tpu_torch — the volumetric Gaussian ray tracer on PyTorch and CUDA.

A port of the JAX/Pallas package `sgrt_tpu` to an NVIDIA H100: closed-form
erf-based transmittance through isotropic and anisotropic (diagonal-
covariance) 3D Gaussians, 5-sample radiance quadrature, 3.3-sigma tile
culling, the fused forward renderer and its analytic backward as
hand-written CUDA kernels (csrc/), and scene fitting with Adam. It imports torch and numpy only; entry points run on the card
(device="cuda") unless the caller passes device="cpu", where the kernels'
plain tensor versions run instead.

Layout (mirrors sgrt_tpu):
    models/    Gaussian scene and camera dataclasses, procedural/obj scenes
    ops/       oracle math, plain fused renderer, tiling, approximations,
               the CUDA kernels' wrappers, the differentiable fused op and
               its routing, the bucketed tile scheduler, the frame pipeline
    parallel/  the train steps (one device)
    utils/     obj parsing, PNG/GIF writers, the native host library
               (native/sgrt_native.cpp by g++), checkpoints, nvcc build,
               device selection
    csrc/      CUDA sources, built with nvcc on first use
    cli.py, render.py (its alias), fit_cli.py, viewer.py, verify.py:
               the entry points
"""

import torch as _torch

# mu_bar feeds the erf arguments: float32 matrix products must stay full
# float32 on the card, never TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from sgrt_tpu_torch.models.camera import Camera  # noqa: E402
from sgrt_tpu_torch.models.gaussians import (  # noqa: E402
    GaussianScene,
    grid_scene,
    make_scene,
    pad_scene,
    scene_from_numpy,
    scene_from_obj,
    scene_from_vertices,
)
from sgrt_tpu_torch.ops.scheduler import BucketConfig  # noqa: E402
from sgrt_tpu_torch.parallel.fit import (  # noqa: E402
    FitState,
    adam,
    init_state,
    make_frame_train_step,
)

__version__ = "0.1.0"

__all__ = [
    "GaussianScene",
    "grid_scene",
    "make_scene",
    "pad_scene",
    "scene_from_numpy",
    "scene_from_obj",
    "scene_from_vertices",
    "Camera",
    "BucketConfig",
    "FitState",
    "adam",
    "init_state",
    "make_frame_train_step",
    "__version__",
]
