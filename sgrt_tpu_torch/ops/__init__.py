"""Renderer operations: oracle math, the plain fused renderer, tiling,
approximations, the CUDA kernels' wrappers and routing, the frame
pipeline."""
