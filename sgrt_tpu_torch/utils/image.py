"""PNG and GIF output.

The reference renderer dumps PNGs through stb_image_write
(src/volumetric-ray-tracer/main.cpp:306) and pipes frames through ffmpeg for
GIFs (gen-gif.sh). The native C++ encoders (utils.native) are the fast path;
both encoders are also written out here in pure Python (zlib and struct from
the stdlib), the path when the native library does not build or load.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from sgrt_tpu_torch.utils.native import write_gif_native, write_png_native


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(rgba: np.ndarray) -> bytes:
    """Encode (H, W, 4) uint8 → PNG bytes."""
    h, w, c = rgba.shape
    if c != 4 or rgba.dtype != np.uint8:
        raise ValueError("encode_png expects (H, W, 4) uint8")
    raw = b"".join(b"\x00" + rgba[i].tobytes() for i in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def to_rgba_u8(image: np.ndarray) -> np.ndarray:
    """Float (H,W,3|4) linear color → (H,W,4) uint8.

    Matches the reference quantization (rt.h:239-243): clamp channel to
    [0,1] via min(x,1), scale by 255, truncate to int; alpha forced 255
    when absent.
    """
    img = np.asarray(image, np.float32)
    if img.ndim != 3:
        raise ValueError("expected (H,W,C)")
    rgb = np.clip(img[..., :3], 0.0, None)
    u8 = np.minimum(rgb, 1.0) * 255.0
    u8 = u8.astype(np.uint32).astype(np.uint8)
    if img.shape[-1] >= 4:
        a = (np.minimum(np.clip(img[..., 3], 0.0, None), 1.0) * 255.0).astype(np.uint8)
    else:
        a = np.full(img.shape[:2], 255, np.uint8)
    return np.concatenate([u8, a[..., None]], axis=-1)


def write_png(path: str, image: np.ndarray) -> None:
    """Write float (H,W,3|4) or uint8 (H,W,4) image to a PNG file."""
    if image.dtype != np.uint8:
        image = to_rgba_u8(image)
    if write_png_native(path, image):
        return
    with open(path, "wb") as f:
        f.write(encode_png(image))


# GIF: one fixed 3-3-2 RGB palette, and LZW written as 9-bit literal codes
# with a clear code every _GIF_RUN pixels, so the code table never reaches
# 512 entries and the code width never grows. Valid GIF89a that any decoder
# reads; larger than an adaptive encoder's output, and simple.
_GIF_RUN = 254
_GIF_CLEAR, _GIF_EOI = 256, 257


def _gif_palette() -> bytes:
    i = np.arange(256)
    pal = np.stack([((i >> 5) & 7) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                    (i & 3) * 255 // 3], axis=-1)
    return pal.astype(np.uint8).tobytes()


def _gif_lzw(index: np.ndarray) -> bytes:
    """Palette indices (H*W,) uint8 → GIF image data sub-blocks."""
    pix = index.astype(np.uint16)
    codes = np.insert(pix, np.arange(0, pix.size, _GIF_RUN), _GIF_CLEAR)
    codes = np.append(codes, np.uint16(_GIF_EOI))
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.ravel(), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return b"\x08" + blocks + b"\x00"


def write_gif(path: str, frames, delay_cs: int = 4) -> None:
    """Write an animated, looping GIF from float (F,H,W,3) or uint8
    (F,H,W,3|4) frames — the orbit-animation output. `delay_cs` is the
    frame delay in hundredths of a second. The native encoder (a 6x6x6
    color cube and a gray ramp, as the JAX package writes) is the fast
    path; the pure-Python one takes a fixed 3-3-2 palette."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.stack([to_rgba_u8(f)[..., :3] for f in frames])
    frames = frames[..., :3]
    if write_gif_native(path, frames, delay_cs):
        return
    _, h, w, _ = frames.shape
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _gif_palette(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for f in frames:
        r, g, b = (f[..., c].astype(np.uint16) for c in range(3))
        index = ((r >> 5) << 5) | ((g >> 5) << 2) | (b >> 6)
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(_gif_lzw(index.reshape(-1)))
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
