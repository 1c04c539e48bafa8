"""The port's native C++ host runtime (sgrt_tpu_torch.utils.native, built
from native/sgrt_native.cpp into build/sgrt_tpu_torch/) against the
pure-Python paths: a mirror of tests/test_native.py's five tests, where the
library is built, the fallback when it is missing, and the GIF bytes
against the JAX package's writer."""

import os
import shutil
import zlib
from pathlib import Path

import numpy as np
import pytest

import sgrt_tpu  # noqa: F401
from sgrt_tpu.utils.image import write_gif as jax_write_gif
from sgrt_tpu_torch.utils import image, native, objio
from sgrt_tpu_torch.utils.image import encode_png, to_rgba_u8, write_gif, write_png

ROOT = Path(__file__).resolve().parents[1]
OBJ_TEXT = "# comment\nv 1.0 2.0 3.5\nvn 0 0 1\nv -1 0.25 9\nf 1 2 1\nv 0 0 0\n"


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"native library unavailable: {native.load_error()}")


@pytest.fixture
def obj(tmp_path):
    path = tmp_path / "tri.obj"
    path.write_text(OBJ_TEXT)
    return str(path)


def _decode_png_idat(data: bytes, w: int, h: int) -> np.ndarray:
    """Minimal PNG reader for filter-0 RGBA (what both encoders emit)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        (length,) = np.frombuffer(data[pos:pos + 4], ">u4")
        tag = data[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + int(length)]
        pos += 12 + int(length)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * 4 + 1)
    assert np.all(rows[:, 0] == 0), "expected filter-0 scanlines"
    return rows[:, 1:].reshape(h, w, 4)


def test_obj_native_matches_python(lib, obj):
    want = [[1.0, 2.0, 3.5], [-1.0, 0.25, 9.0], [0.0, 0.0, 0.0]]
    np.testing.assert_allclose(native.read_obj_vertices_native(obj), want)
    np.testing.assert_allclose(objio.read_obj_vertices(obj), want)


def test_png_native_round_trip(lib, tmp_path):
    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, (17, 23, 4), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    assert native.write_png_native(p, rgba)
    np.testing.assert_array_equal(_decode_png_idat(open(p, "rb").read(), 23, 17), rgba)


def test_png_native_matches_python_encoder(lib, tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1.4, (9, 11, 3)).astype(np.float32)
    p = str(tmp_path / "n.png")
    write_png(p, img)  # goes native
    back_n = _decode_png_idat(open(p, "rb").read(), 11, 9)
    back_p = _decode_png_idat(encode_png(to_rgba_u8(img)), 11, 9)
    np.testing.assert_array_equal(back_n, back_p)


def test_batch_pngs_threadpool(lib, tmp_path):
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (8, 16, 16, 4), dtype=np.uint8)
    paths = [str(tmp_path / f"f{i}.png") for i in range(8)]
    assert native.write_pngs_native(paths, frames, threads=4)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(_decode_png_idat(open(p, "rb").read(), 16, 16),
                                      frames[i])
    with pytest.raises(ValueError, match="paths"):
        native.write_pngs_native(paths[:3], frames)


def test_gif_structure(lib, tmp_path):
    rng = np.random.default_rng(3)
    frames = rng.uniform(0, 1, (5, 12, 10, 3)).astype(np.float32)
    p = str(tmp_path / "a.gif")
    write_gif(p, frames, delay_cs=4)
    data = open(p, "rb").read()
    assert data[:6] == b"GIF89a"
    assert data[-1:] == b"\x3b"
    assert data.count(b"\x21\xf9\x04") == 5  # one graphic control per frame


def test_gif_bytes_equal_jax(lib, tmp_path):
    """Both packages write an orbit's GIF through the same native encoder:
    the same bytes for the same float frames."""
    rng = np.random.default_rng(4)
    frames = rng.uniform(0, 1.3, (3, 8, 12, 3)).astype(np.float32)
    jax_write_gif(str(tmp_path / "j.gif"), frames, delay_cs=6)
    write_gif(str(tmp_path / "t.gif"), frames, delay_cs=6)
    assert (tmp_path / "t.gif").read_bytes() == (tmp_path / "j.gif").read_bytes()


def test_library_builds_under_build_dir(monkeypatch, tmp_path):
    """The library is built into the port's build directory, named by a
    hash of the source and flags, and nothing under native/ is written."""
    assert native.library_path().parent == ROOT / "build" / "sgrt_tpu_torch"
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH")
    before = {p.name: p.stat().st_mtime_ns for p in (ROOT / "native").iterdir()}
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    lib_path = native._build()
    assert lib_path.parent == tmp_path / "build" and lib_path.exists()
    assert lib_path.name.startswith("libsgrt_native-") and lib_path.suffix == ".so"
    assert [p.name for p in lib_path.parent.iterdir()] == [lib_path.name]
    after = {p.name: p.stat().st_mtime_ns for p in (ROOT / "native").iterdir()}
    assert after == before


def test_available_where_the_toolchain_is():
    """With g++ and zlib's header present the library must build and load,
    so that the tests above cannot skip unnoticed."""
    if shutil.which("g++") is None or not os.path.exists("/usr/include/zlib.h"):
        pytest.skip("no g++ or zlib.h: the Python paths serve")
    assert native.available(), native.load_error()
    assert native.load_error() is None


def test_python_paths_when_library_is_missing(monkeypatch, tmp_path, obj):
    """Without the library the writers and the reader take their
    pure-Python paths: the same pixels and vertices, a 3-3-2 GIF."""
    monkeypatch.setattr(native, "_load", lambda: None)
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1.2, (6, 7, 3)).astype(np.float32)
    write_png(str(tmp_path / "p.png"), img)
    assert (tmp_path / "p.png").read_bytes() == image.encode_png(to_rgba_u8(img))
    np.testing.assert_allclose(objio.read_obj_vertices(obj)[1], [-1.0, 0.25, 9.0])
    write_gif(str(tmp_path / "p.gif"), img[None], delay_cs=4)
    data = (tmp_path / "p.gif").read_bytes()
    assert data[:6] == b"GIF89a" and data[16:19] == b"\x00\x00\x55"  # 3-3-2 palette
    assert not native.write_png_native(str(tmp_path / "n.png"), to_rgba_u8(img))
