"""ctypes bindings to the native C++ host runtime (native/sgrt_native.cpp).

The library is built on first use with the local g++ and the flags of
native/Makefile into build/sgrt_tpu_torch/ at the root of the checkout
(git-ignored), named by a hash of the source and the flags; nothing is
written under native/. Each build compiles to a name of its own and is
renamed into place, so processes that build at once do not race.

Every function here is a fast path of host I/O: its caller keeps a
pure-Python path (utils.image, utils.objio) for when the library does not
build or load, and `load_error()` says why it did not.

Native functions and the reference's counterparts:
    sgrt_read_obj   ← tinyobjloader (vendored, src/include/tiny_obj_loader.h)
    sgrt_write_png  ← stb_image_write (main.cpp:306)
    sgrt_write_pngs ← thread_pool_t-parallel frame output (thread-pool.h)
    sgrt_write_gif  ← gen-gif.sh (orbit frames → ffmpeg gif)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from sgrt_tpu_torch.utils.nvcc import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "sgrt_native.cpp"
# native/Makefile's CXXFLAGS (less its warnings) and LDFLAGS
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LD_FLAGS = ("-lz", "-lpthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None


def library_path() -> Path:
    """The library's path, named by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return BUILD_DIR / f"libsgrt_native-{h.hexdigest()[:12]}.so"


def _build() -> Path:
    """Compile the library if it is missing; raises with g++'s output."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LD_FLAGS],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exited {res.returncode}: {res.stderr[-2000:]}")
    os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the four entry points' signatures."""
    u8p, f32p = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_float)
    c_int, c_str = ctypes.c_int, ctypes.c_char_p
    lib.sgrt_read_obj.restype = ctypes.c_long
    lib.sgrt_read_obj.argtypes = [c_str, f32p, ctypes.c_long]
    lib.sgrt_write_png.restype = c_int
    lib.sgrt_write_png.argtypes = [c_str, c_int, c_int, u8p]
    lib.sgrt_write_pngs.restype = c_int
    lib.sgrt_write_pngs.argtypes = [ctypes.POINTER(c_str), c_int, c_int, c_int, u8p, c_int]
    lib.sgrt_write_gif.restype = c_int
    lib.sgrt_write_gif.argtypes = [c_str, c_int, c_int, c_int, u8p, c_int]
    return lib


def _load() -> ctypes.CDLL | None:
    """Build (if needed) and load the library once per process; None if it
    did not build or load (load_error() has the reason)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(_build())))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = f"{type(e).__name__}: {e}"
    return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    """Why the library did not build or load, or None."""
    _load()
    return _error


def _frames_u8(frames: np.ndarray, ndim: int, channels: int) -> np.ndarray:
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != ndim or frames.shape[-1] != channels:
        raise ValueError(f"expected {ndim - 1} axes of pixels and {channels} channels, "
                         f"got shape {frames.shape}")
    return frames


def read_obj_vertices_native(path: str) -> np.ndarray | None:
    """(N, 3) float32 vertices, or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    count = lib.sgrt_read_obj(path.encode(), None, 0)
    if count < 0:
        raise FileNotFoundError(path)
    if count == 0:
        raise ValueError(f"no vertices found in {path}")
    out = np.empty((count, 3), np.float32)
    got = lib.sgrt_read_obj(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            count)
    return out[:got]


def write_png_native(path: str, rgba: np.ndarray) -> bool:
    """Write (H, W, 4) uint8 → PNG. False if the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    rgba = _frames_u8(rgba, 3, 4)
    h, w, _ = rgba.shape
    rc = lib.sgrt_write_png(path.encode(), w, h,
                            rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if rc != 0:
        raise OSError(f"sgrt_write_png failed ({rc}) for {path}")
    return True


def write_pngs_native(paths: list[str], frames: np.ndarray, threads: int = 0) -> bool:
    """Thread-pooled batch write: frames (N, H, W, 4) uint8 → paths. False
    if the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    frames = _frames_u8(frames, 4, 4)
    n, h, w, _ = frames.shape
    if len(paths) != n:
        raise ValueError(f"{len(paths)} paths for {n} frames")
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.sgrt_write_pngs(arr, n, w, h,
                             frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), threads)
    if rc != 0:
        raise OSError(f"sgrt_write_pngs: {rc} frames failed")
    return True


def write_gif_native(path: str, frames: np.ndarray, delay_cs: int = 4) -> bool:
    """Animated GIF from (N, H, W, 3) uint8 frames (the orbit output, the
    gen-gif.sh analog). False if the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    frames = _frames_u8(frames, 4, 3)
    n, h, w, _ = frames.shape
    rc = lib.sgrt_write_gif(path.encode(), w, h, n,
                            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), delay_cs)
    if rc != 0:
        raise OSError(f"sgrt_write_gif failed ({rc}) for {path}")
    return True
