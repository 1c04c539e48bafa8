"""Shared set-up of the benchmark's tests: the checkout's root on the path,
and a copy of the benchmark with tiny cells that run on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny stand-ins of the real cells: same drivers, parameters and limits,
# at a size the CPU renders in seconds
TINY = {"tiny.fit": ("cube3644.fit256", {"width": 16, "height": 16, "tiles": [4, 2]}),
        "tiny.orbit": ("cube3644.orbit512", {"width": 16, "height": 16, "tiles": [4, 2],
                                             "check": {"frames": 3, "pixels": 8}})}


def make_tiny_copy(dest: Path, n: int = 200) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under dest, the program
    linked beside them, with a tiny configuration and the cells of TINY."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    (dest / "sgrt_tpu_torch").symlink_to(ROOT / "sgrt_tpu_torch")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    cfg = json.loads((dest / "benchmark/configs/cube3644.json").read_text())
    cfg["scene"]["n"] = n
    (dest / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "a test's stand-in",
                             "file": "benchmark/configs/tiny.json", "reduced": ["scene"],
                             "why": "CPU tests"})
    for name, (like, params) in TINY.items():
        wl = json.loads((dest / f"benchmark/workloads/{like}.json").read_text())
        for k, v in params.items():
            wl["params"][k] = {**wl["params"][k], **v} if isinstance(v, dict) else v
        (dest / f"benchmark/workloads/{name}.json").write_text(json.dumps(wl))
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": name[5:],
                                   "chips": 1, "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_copy(tmp_path)
