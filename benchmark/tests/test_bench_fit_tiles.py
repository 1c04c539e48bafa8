"""The `fit_tiles` driver and its reference on the CPU, at a size whose
dense bucket takes the chunked route with live rows in three chunks or
more: a sound run is correct, and a run with the program's dense path
broken underneath (benchmark/fit_tiles_faults.py) or with the TF32 control
in the program's place is not."""

import json
import time

import pytest
import torch
from bench_helpers import ROOT, make_tiny_copy  # noqa: F401

from benchmark.fit_tiles_faults import FAULTS

CELL = "tiny.fit_tiles"
# 700 points of the sphere at 16x16 in 4x2 tiles: its 4 central tiles hold
# 350-410 live rows each, in chunks of 128 rows once the chunked route starts
# at 64; the other 4 tiles are empty
SIZE = {"width": 16, "height": 16, "tiles": [4, 2], "views": 4,
        "buckets": {"rule": "dense_sparse", "n_dense": 4, "margin": 1.3, "cap_sparse": 32},
        "check_tiles": 4, "check_dense": 3}
WALL, CHUNK = 64, 128


def _tiny_fit_tiles(dest):
    root = make_tiny_copy(dest)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/sphere50k_fit.json").read_text())
    cfg["scene"]["n"] = 700
    (root / "benchmark/configs/tiny_sphere.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny_sphere", "source": "a test's stand-in",
                             "file": "benchmark/configs/tiny_sphere.json", "reduced": ["scene"],
                             "why": "CPU tests"})
    wl = json.loads((root / "benchmark/workloads/sphere50k.fit512.json").read_text())
    wl["params"].update(SIZE)
    (root / f"benchmark/workloads/{CELL}.json").write_text(json.dumps(wl))
    bench["workloads"].append({"name": CELL, "config": "tiny_sphere", "traffic": "fit_tiles",
                               "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sphere50k.fit512" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def chunked(monkeypatch):
    """The chunked route from 64 rows, in chunks of 128."""
    from sgrt_tpu_torch.ops import cuda_chunked

    monkeypatch.setattr(cuda_chunked, "MAX_MONOLITHIC_CAPACITY", WALL)
    monkeypatch.setattr(cuda_chunked, "DEFAULT_CHUNK", CHUNK)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny_fit_tiles(tmp_path_factory.mktemp("bench"))


def _run(root, seed=5, trace=False):
    from benchmark.harness import run_cell

    return run_cell(root, CELL, seed, 0.3, trace, "cpu", time.perf_counter())[0]


def test_a_sound_run_is_correct_and_reports_the_dense_metrics(root, chunked):
    result = _run(root, trace=True)
    assert result["correct"], result["checks"]
    assert result["checks"]["overflow"]["value"] == 0
    assert result["window"]["buckets"][0] == SIZE["buckets"]["n_dense"]
    assert result["window"]["buckets"][1] > WALL      # the chunked route
    # the rooflines read the card's kernels, which the CPU's trace lacks
    got = set(result["metrics"])
    for name in ("mfu", "idle_share", "live_row_share", "saved_t_gib", "launches_per_step",
                 "tiling_host_ms", "gather_host_ms", "launch_host_ms", "backward_host_ms",
                 "optimizer_host_ms", "idle_unattributed_share"):
        assert f"{name}.fit.dense" in got, got
    assert result["metrics"]["saved_t_gib.fit.dense"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(root, chunked, monkeypatch, fault):
    FAULTS[fault](monkeypatch.setattr)
    result = _run(root)
    assert not result["correct"], result["checks"]


def test_the_control_is_not_correct(root, chunked):
    from benchmark import checks
    from benchmark.harness import Context, _span_factory, load_module, load_spec

    spec = load_spec(root, CELL)
    ctx = Context(spec, 5, 0.3, False, torch.device("cpu"), _span_factory(False),
                  time.perf_counter())
    cell = load_module(spec.folder / "drivers" / "fit_tiles.py", "bench_driver").make(ctx)
    cell.window(ctx)
    cell.free()
    sound, _ = checks.judge(cell.check(), spec.workload["limits"])
    control = cell.control()
    correct, _ = checks.judge(control, spec.workload["limits"])
    assert sound and not correct, control


def test_tile_gradients_are_matched_member_by_member():
    """A tile whose gradients have the right norms but sit on the wrong
    members, or whose members differ, reads over the limits."""
    from benchmark.drivers.fit_tiles import tile_numbers

    limits = json.loads((ROOT / "benchmark/workloads/sphere50k.fit512.json").read_text())[
        "limits"]
    g = torch.arange(1.0, 9.0).reshape(4, 2)
    ref = {0: {"colors": torch.zeros(2, 3), "loss": 1.0, "members": torch.tensor([2, 5, 7, 9]),
               "grads": {"mu": g, "sigma": g[:, 0]}}}

    def prog(members, grads):
        return {0: {"colors": torch.zeros(2, 3), "loss": 1.0, "members": members,
                    "grads": grads}}

    same = tile_numbers(prog(torch.tensor([2, 5, 7, 9]), {"mu": g, "sigma": g[:, 0]}), ref)
    assert same["tile_grad_gap"] == same["tile_member_gap"] == 0.0
    swapped = tile_numbers(prog(torch.tensor([2, 5, 7, 9]),
                                {"mu": g.flip(0), "sigma": g[:, 0].flip(0)}), ref)
    assert swapped["tile_member_gap"] == 0.0
    assert swapped["tile_grad_gap"] > limits["tile_grad_gap"]
    moved = tile_numbers(prog(torch.tensor([2, 5, 7, 11]), {"mu": g, "sigma": g[:, 0]}), ref)
    assert moved["tile_member_gap"] == 0.5 > limits["tile_member_gap"]
    assert moved["tile_grad_gap"] > limits["tile_grad_gap"]


def test_the_per_tile_reference_loads_nothing_of_the_program(tmp_path):
    import subprocess
    import sys

    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark import scenes\n"
        "from benchmark.reference.fit_tiles import adam_change, tile_reference\n"
        "t, s = scenes.fit_inputs({'kind': 'sphere_surface', 'n': 80}, 0.02, 3, 'cpu')\n"
        "out = tile_reference(t, s, 0.0, [1, 2], width=8, height=8, tiles=(2, 2),"
        " offset=-4.0, focal=1.0)\n"
        "assert out[1]['members'].numel() > 0\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"sgrt_tpu_torch", "sgrt_tpu", "jax", "jaxlib", "flax"}
