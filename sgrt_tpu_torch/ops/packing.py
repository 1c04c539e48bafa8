"""u32 pixel packing, bit-exact with the reference image format (PyTorch
port of sgrt_tpu.ops.packing).

The reference packs each pixel as a u32 `A<<24 | R<<16 | G<<8 | B` with
channels clamped by min(x, 1) * 255 and truncated (rt.h:239-243; the tiled
SIMD path also derives A from the accumulated albedo w, rt.h:373-377).
PyTorch has no shifts or masks on uint32 tensors, so the bits are put
together in int64 and the packed pixels converted to torch.uint32 at the
end (and back to int64 to unpack them).
"""

from __future__ import annotations

import torch


def _quantize(c: torch.Tensor) -> torch.Tensor:
    """min(max(c, 0), 1) * 255 in float32, truncated to an integer."""
    return (torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.int64)


def pack_u32(image: torch.Tensor, alpha_from_w: bool = False) -> torch.Tensor:
    """Float (..., 3|4) color → u32 packed pixels (...,), torch.uint32.

    alpha_from_w=False forces A=0xFF (rt.h:239, untiled paths);
    alpha_from_w=True uses channel 3 like the tiled SIMD path (rt.h:373).
    """
    r, g, b = (_quantize(image[..., c]) for c in range(3))
    if alpha_from_w and image.shape[-1] >= 4:
        a = _quantize(image[..., 3])
    else:
        a = torch.full(image.shape[:-1], 255, dtype=torch.int64, device=image.device)
    return ((a << 24) | (r << 16) | (g << 8) | b).to(torch.uint32)


def unpack_u32(packed: torch.Tensor) -> torch.Tensor:
    """u32 pixels → float32 (..., 4) RGBA in [0, 1]."""
    p = packed.to(torch.int64)
    return torch.stack([((p >> s) & 0xFF).to(torch.float32) / 255.0 for s in (16, 8, 0, 24)],
                       dim=-1)
