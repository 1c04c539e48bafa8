"""The readings a `fit_tiles` cell's limits are set from, besides its own
runs: the control (benchmark/reference/fit_tiles.py in float32 with the
operands of its matrix products rounded to TF32, in the program's place)
and the faults of benchmark/fit_tiles_faults.py planted in the program, on
the cell's own sizes.

    python3 benchmark/control_fit_tiles.py --workload <cell> --seeds 1,2 \
        [--seconds 3] [--faults half_dense,one_chunk,stale_t,adam_skipped]

Per seed: the cell's set-up, a window of --seconds and the step after it,
then the program's numbers (reading "program") and the control's
("control"); then per fault the same run with the fault planted before
set-up (reading: the fault's name), and the fault undone. One JSON line
per seed and reading, with the seconds its check took. The benchmark's
runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class Patches:
    """setattr that remembers what it replaced, and undo()."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            setattr(*self.saved.pop())


def readings(spec, seed, device, seconds, fault=None):
    """{reading: (numbers, check seconds)} of one run of the cell."""
    import torch

    from benchmark.fit_tiles_faults import FAULTS
    from benchmark.harness import Context, _span_factory, load_module

    patches = Patches()
    if fault is not None:
        FAULTS[fault](patches)
    try:
        ctx = Context(spec, seed, seconds, False, device, _span_factory(False),
                      time.perf_counter())
        cell = load_module(spec.folder / "drivers" / "fit_tiles.py", "bench_driver").make(ctx)
        window = cell.window(ctx)
        cell.free()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = {fault or "program": (cell.check(), time.perf_counter() - t0)}
        if fault is None:
            t0 = time.perf_counter()
            out["control"] = (cell.control(), time.perf_counter() - t0)
        out[fault or "program"][0]["window_steps"] = window["completed"]
        return out
    finally:
        patches.undo()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import load_spec

    spec = load_spec(ROOT, args.workload)
    device = torch.device(args.device)
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in [None] + faults:
            for name, (numbers, secs) in readings(spec, seed, device, args.seconds,
                                                  fault).items():
                print(json.dumps({"cell": args.workload, "seed": seed, "reading": name,
                                  "numbers": numbers, "check_s": secs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
