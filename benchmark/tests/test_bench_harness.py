"""The harness: what it loads, how it finds cells and metrics, what it does
without a card, and that its check fails when the timed path is broken."""

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from bench_helpers import ROOT, make_tiny_copy, tiny_root  # noqa: F401

BANNED = {"jax", "jaxlib", "flax", "sgrt_tpu"}


def _python(code: str, cwd: Path, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=600, env=env)


def _tops_after(code: str, cwd: Path) -> set:
    out = _python(code + "\nimport sys, json\n"
                  "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))", cwd)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_benchmark_loads_no_jax(tmp_path):
    """Every module of the benchmark imported, then a tiny run of each cell
    kind on the CPU: nothing of JAX or the JAX package is loaded, compared
    by whole top-level names (the port's name begins with the JAX
    package's)."""
    root = make_tiny_copy(tmp_path)
    code = (
        "import sys, time\n"
        "sys.path.insert(0, '.')\n"
        "from pathlib import Path\n"
        "import benchmark.harness as h, benchmark.control, benchmark.reference.fit\n"
        "for f in sorted(Path('benchmark/drivers').glob('*.py')):\n"
        "    h.load_module(f, 'd')\n"
        "for f in sorted(Path('benchmark/metrics').glob('*.py')):\n"
        "    h.load_module(f, 'm')\n"
        "for cell in ('tiny.fit', 'tiny.orbit'):\n"
        "    r, _ = h.run_cell(Path('.'), cell, 5, 0.2, False, 'cpu', time.perf_counter())\n"
        "    assert r['correct'], r\n")
    tops = _tops_after(code, root)
    assert not tops & BANNED, tops & BANNED
    assert "sgrt_tpu_torch" in tops and "benchmark" in tops


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import numpy as np\n"
        "from benchmark import checks, scenes\n"
        "from benchmark.reference import render\n"
        "from benchmark.reference.fit import fit_reference\n"
        "f = scenes.make_scene({'kind': 'cube_surface', 'n': 60}, scenes.generator(1, 'cpu'),"
        " 'cpu')\n"
        "render.render_pixels(f, 10.0, np.arange(8), width=8, height=8, tiles=(2, 2),"
        " offset=-4.0, focal=1.0)\n"
        "fit_reference(f, f, [0.0], steps=1, width=8, height=8, tiles=(2, 2), offset=-4.0,"
        " focal=1.0, lr=1e-3)\n")
    tops = _tops_after(code, tmp_path)
    assert "sgrt_tpu_torch" not in tops and not tops & BANNED


def _hashes(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_found_from_new_files_alone(tiny_root):
    """A cell, its traffic and a metric added as new files and entries: the
    harness runs the cell and reports the metric, and no file it had is
    edited."""
    before = _hashes(tiny_root)
    wl = json.loads((tiny_root / "benchmark/workloads/tiny.orbit.json").read_text())
    wl["params"]["frames_per_orbit"] = 7
    (tiny_root / "benchmark/workloads/tiny.orbit7.json").write_text(json.dumps(wl))
    (tiny_root / "benchmark/metrics/frames_per_s.py").write_text(
        '"""Completed frames over the window, 1/s."""\n\n\ndef read(run):\n'
        '    return run.record["completed"] / run.record["window_s"]\n')
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.orbit7", "config": "tiny", "traffic": "orbit7",
                               "chips": 1, "why": "a cell added as files"})
    bench["end_to_end"].append({"name": "frames_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny.orbit7"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    from benchmark.harness import run_cell

    result, lines = run_cell(tiny_root, "tiny.orbit7", 3, 0.2, False, "cpu",
                             time.perf_counter())
    assert result["correct"] and result["metrics"]["frames_per_s"]["value"] > 0
    # the other metrics list their cells, and this one is not among them
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(result)[-1] == "checks" and lines[-1].startswith("check pixel_gap")
    after = _hashes(tiny_root)
    assert all(after[p] == h for p, h in before.items())


def test_the_measurement_path_needs_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cube3644.fit256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_tree_without_the_program_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _python("import sys, time\nsys.path.insert(0, '.')\nfrom pathlib import Path\n"
                  "from benchmark.harness import run_cell\n"
                  "print(run_cell(Path('.'), 'cube3644.orbit512', 1, 0.1, False, 'cpu',"
                  " time.perf_counter()))\n", tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "sgrt_tpu_torch" in out.stderr


class _HalfMean:
    """torch, but mean() over the first half of the batch: half of the
    batch left out, the mean taken over the rest."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def mean(x, *args, **kwargs):
        return torch.mean(x[: max(1, x.shape[0] // 2)], *args, **kwargs)


def _wrap_renderer(monkeypatch, change):
    """tile_renderer_for whose colors pass through change(colors)."""
    from sgrt_tpu_torch.ops import cuda_chunked

    real = cuda_chunked.tile_renderer_for

    def patched(capacity, **kw):
        cap, fn = real(capacity, **kw)
        return cap, lambda *a: change(fn(*a))

    monkeypatch.setattr(cuda_chunked, "tile_renderer_for", patched)


def _half_tiles(colors):
    out = colors.clone()
    out[colors.shape[0] // 2:] = 0
    return out


def _plant(monkeypatch, fault):
    import importlib

    frame = importlib.import_module("sgrt_tpu_torch.ops.frame")
    fit = importlib.import_module("sgrt_tpu_torch.parallel.fit")

    if fault == "state_unchanged":
        def no_update(state, grads, trainable):
            state.step += 1

        monkeypatch.setattr(fit, "_apply_updates", no_update)
    elif fault == "half_batch_fit":
        monkeypatch.setattr(fit, "torch", _HalfMean())
    elif fault == "half_batch_frame":
        _wrap_renderer(monkeypatch, _half_tiles)
    elif fault == "answer_altered":
        _wrap_renderer(monkeypatch, lambda c: c * 1.1)
    elif fault == "stale_frame":
        real, first = frame.render_orbit_frame, []

        def stale(*a, **kw):
            if not first:
                first.append(real(*a, **kw))
            return first[0]

        monkeypatch.setattr(frame, "render_orbit_frame", stale)


def _plant_after_setup(monkeypatch, fault):
    """The fault planted once the cell's set-up has returned: only the
    window's steps and frames, and what follows them, are broken."""
    from benchmark import harness

    real = harness.load_module

    def load(path, prefix):
        mod = real(path, prefix)
        if prefix == "bench_driver":
            make = mod.make

            def make_then_plant(ctx):
                cell = make(ctx)
                _plant(monkeypatch, fault)
                return cell

            mod.make = make_then_plant
        return mod

    monkeypatch.setattr(harness, "load_module", load)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.fit", "state_unchanged"), ("tiny.fit", "half_batch_fit"),
    ("tiny.fit", "answer_altered"), ("tiny.orbit", "stale_frame"),
    ("tiny.orbit", "half_batch_frame"), ("tiny.orbit", "answer_altered"),
    ("tiny.fit", "state_unchanged@window"), ("tiny.fit", "half_batch_fit@window"),
    ("tiny.orbit", "answer_altered@window")])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    """The rest of a run, the look for a card skipped, with the program's
    timed path broken underneath: `correct` comes out false. (One card: no
    exchange between chips to leave out.) A fault "@window" is planted
    after set-up, so that the steps set-up runs are sound."""
    from benchmark.harness import run_cell

    sound, _ = run_cell(tiny_root, cell, 11, 0.3, False, "cpu", time.perf_counter())
    assert sound["correct"], sound["checks"]
    if fault.endswith("@window"):
        _plant_after_setup(monkeypatch, fault.split("@")[0])
    else:
        _plant(monkeypatch, fault)
    broken, _ = run_cell(tiny_root, cell, 11, 0.3, False, "cpu", time.perf_counter())
    assert not broken["correct"], broken["checks"]
    if fault.endswith("@window") and cell == "tiny.fit":
        first = ("loss_gap", "grad_gap", "change_gap")
        assert all(broken["checks"][k] == sound["checks"][k] for k in first)


def test_the_reservoir_keeps_a_uniform_sample():
    """The orbit's frames for the check: every completed frame equally
    likely to be kept, however many the window completes."""
    import numpy as np

    from benchmark.harness import load_module

    orbit = load_module(ROOT / "benchmark/drivers/orbit.py", "t_orbit")
    n, room, picks = 500, 8, []
    for seed in range(400):
        cell = object.__new__(orbit.OrbitCell)
        cell.rng, cell.room, cell.kept, cell.last, cell.done = (
            np.random.default_rng(seed), room, [], None, 0)
        for i in range(n):
            cell.done += 1
            cell._keep(i, None)
        assert len(cell.kept) == room and cell.last == (n - 1, None)
        picks += [i for i, _ in cell.kept]
    counts = np.bincount(picks, minlength=n).reshape(5, -1).sum(axis=1)
    # each fifth of the window holds a fifth of the kept frames
    assert np.all(np.abs(counts / len(picks) - 0.2) < 0.03), counts


def test_a_traced_run_reads_host_clock_metrics_from_an_untraced_window(tiny_root):
    """--trace 1: a per-layer metric of the host clock is read from an
    untraced window as long as a --trace 0 run's; the others from the
    traced window that follows."""
    wl_path = tiny_root / "benchmark/workloads/tiny.orbit.json"
    wl = json.loads(wl_path.read_text())
    wl["trace_seconds"] = 0.1
    wl_path.write_text(json.dumps(wl))
    for name, source in (("probe_host_s", "host_clock"), ("probe_traced_s", "device_trace")):
        (tiny_root / f"benchmark/metrics/{name}.py").write_text(
            '"""The length of the window read, s."""\n\n\ndef read(run):\n'
            '    return run.record["window_s"]\n')
        bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
        bench["per_layer"].append({"name": name, "unit": "s", "better": "lower",
                                   "source": source, "layer": "frame",
                                   "moves": "render_rays_per_s.host",
                                   "workloads": ["tiny.orbit"]})
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    from benchmark.harness import run_cell

    result, _ = run_cell(tiny_root, "tiny.orbit", 7, 0.8, True, "cpu", time.perf_counter())
    got = {k: v["value"] for k, v in result["metrics"].items()}
    host_s, traced_s = result["window"]["seconds"]
    assert got["probe_host_s"] == host_s >= 0.8 and got["probe_traced_s"] == traced_s
    assert len(result["window"]["completed"]) == 2 and result["correct"]
    assert result["attempted"] == sum(result["window"]["completed"])


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    """One short run of each cell on the card: the last line is a correct
    result with the cell's end-to-end metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell["name"],
                              "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] and result["device"]["platform"] == "gpu"
        assert "setup_s" in result["metrics"]
