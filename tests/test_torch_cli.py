"""Port parity: the sgrt_tpu_torch CLI (--device cpu) against the sgrt_tpu
CLI — same flags, same TIME/AVG. TIME lines, and the same 8-bit images
(at most one level apart: the float renders agree to well under one level,
but a value on a level's edge can truncate either way)."""

import re

import numpy as np
import pytest
import torch
from PIL import Image

import sgrt_tpu  # noqa: F401
from sgrt_tpu.cli import main as jax_main
from sgrt_tpu_torch.cli import main as torch_main


def _png(path):
    return np.asarray(Image.open(path), np.int32)


def test_cli_matches_jax_cli_u8(tmp_path, capsys):
    common = ["-g", "4", "-w", "32", "--height", "32", "--tiles", "4", "-q"]
    assert jax_main(common + ["-o", str(tmp_path / "jax.png")]) == 0
    assert torch_main(common + ["--device", "cpu", "-o", str(tmp_path / "port.png")]) == 0
    out = capsys.readouterr().out
    assert len(re.findall(r"^TIME: [\d.]+ ms$", out, re.M)) == 2
    a, b = _png(tmp_path / "jax.png"), _png(tmp_path / "port.png")
    assert a.shape == b.shape == (32, 32, 4)
    assert np.abs(a - b).max() <= 1
    assert b[..., :3].max() > 10


def test_cli_untiled_obj_matches_jax(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\n")
    common = ["-f", str(obj), "-w", "16", "-h", "16", "-q", "-m", "1"]
    assert jax_main(common + ["-o", str(tmp_path / "j.png")]) == 0
    assert torch_main(common + ["--device", "cpu", "-o", str(tmp_path / "t.png")]) == 0
    assert np.abs(_png(tmp_path / "j.png") - _png(tmp_path / "t.png")).max() <= 1


def test_cli_frames_avg_time_and_names(tmp_path, capsys):
    rc = torch_main(["-g", "2", "-w", "16", "-h", "16", "-q", "--frames", "3",
                     "--tiles", "2", "--device", "cpu", "--backend", "torch",
                     "-o", str(tmp_path / "f.png")])
    assert rc == 0
    outp = capsys.readouterr().out
    assert re.search(r"AVG\. TIME: [\d.]+ ms \(3 frames\)", outp)
    assert "TIME:" not in outp.replace("AVG. TIME:", "")
    for i in (1, 2, 3):
        assert (tmp_path / f"f_{i}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_gif(tmp_path):
    out = tmp_path / "orbit.gif"
    rc = torch_main(["-g", "2", "-w", "16", "-h", "8", "-q", "--frames", "3",
                     "--tiles", "2", "--device", "cpu", "--gif", str(out)])
    assert rc == 0
    im = Image.open(out)
    assert im.size == (16, 8) and im.n_frames == 3


@pytest.mark.parametrize("extra,jextra", [
    (["--tiles", "4"], ["--tiles", "4"]),                       # tiled, bucketed probe
    (["-m", "1"], ["-m", "1"]),                                 # untiled, the kernels
    (["--tiles", "4", "--backend", "torch"], ["--tiles", "4", "--backend", "xla"]),
])
def test_cli_aniso_matches_jax_cli(tmp_path, capsys, extra, jextra):
    """--aniso SX,SY,SZ renders the stretched scene as the JAX CLI does:
    the same TIME line and 8-bit images at most one level apart."""
    common = ["-g", "4", "-w", "32", "--height", "32", "-q", "--aniso", "1.6,0.7,1.0"]
    assert jax_main(common + jextra + ["-o", str(tmp_path / "jax.png")]) == 0
    assert torch_main(common + extra + ["--device", "cpu", "-o", str(tmp_path / "port.png")]) == 0
    out = capsys.readouterr().out
    assert len(re.findall(r"^TIME: [\d.]+ ms$", out, re.M)) == 2
    a, b = _png(tmp_path / "jax.png"), _png(tmp_path / "port.png")
    assert np.abs(a - b).max() <= 1 and b[..., :3].max() > 10
    iso = tmp_path / "iso.png"
    assert torch_main(common[:-2] + extra + ["--device", "cpu", "-o", str(iso)]) == 0
    assert np.abs(_png(iso) - b).max() > 1      # the scales act on the image
    assert torch_main(common[:-1] + ["2,1", "--device", "cpu"]) == 1


def test_cli_rejects_indivisible_tiles(capsys):
    assert torch_main(["-g", "2", "-w", "30", "-h", "16", "-q", "--tiles", "4",
                       "--device", "cpu"]) == 1
    assert "not divisible" in capsys.readouterr().err


def test_cli_defaults_to_the_card():
    """The default device is CUDA; without a card the CLI raises rather
    than render on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the card path is tested on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_main(["-g", "2", "-w", "16", "-h", "16", "-q"])
