"""The readings that a cell's limits are set from, besides the benchmark's
own runs: the control (the plain reference in the program's place, in the
precision below the configuration's: float32 with the operands of its
matrix products rounded to TF32) and, for a fit cell, the planted fault
"half of the batch left out" (the reference with each step's loss the mean
over the first half of the tiles). Each is held against the float64
reference by the cell's own comparison, on the cell's own sizes.

A fit cell's step after the window is followed from the state the
program's window left, so for a fit cell each seed first runs the cell's
own set-up, a window of --seconds and that step, and prints the program's
numbers too (reading "program"); the control and the fault then follow the
first steps from the start and that step from the same state.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]

One JSON line per seed and reading. The benchmark's runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def fit_readings(spec, seed, device, seconds):
    import torch

    from benchmark import checks
    from benchmark.harness import Context, _span_factory, load_module
    from benchmark.reference.fit import fit_reference

    ctx = Context(spec, seed, seconds, False, device, _span_factory(False),
                  time.perf_counter())
    cell = load_module(spec.folder / "drivers" / "fit.py", "bench_driver").make(ctx)
    window = cell.window(ctx)
    cell.free()
    t0 = time.perf_counter()
    out = {"program": (cell.check(), time.perf_counter() - t0)}
    p = spec.workload["params"]
    kw = cell.reference_kw()
    t0 = time.perf_counter()
    ref = fit_reference(cell.truth, cell.start, cell.angles, steps=int(p["check_steps"]), **kw)
    late_ref = cell.late_reference()
    t_ref = time.perf_counter() - t0
    for name, extra in (("control", dict(dtype=torch.float32, tf32=True)),
                        ("half_batch", dict(half_batch=True))):
        t0 = time.perf_counter()
        got = fit_reference(cell.truth, cell.start, cell.angles, steps=int(p["check_steps"]),
                            **kw, **extra)
        numbers = {**checks.fit_numbers(got, ref),
                   **checks.late_numbers(cell.late_reference(**extra), late_ref)}
        out[name] = (numbers, time.perf_counter() - t0)
    out["program"][0]["window_steps"] = window["completed"]
    return t_ref, out


def orbit_readings(spec, seed, device, seconds):
    import numpy as np
    import torch

    from benchmark import checks, scenes
    from benchmark.reference import render

    p, cam = spec.workload["params"], spec.config["camera"]
    w, h, tiles = int(p["width"]), int(p["height"]), tuple(p["tiles"])
    fields = scenes.make_scene(spec.config["scene"], scenes.generator(seed, device), device)
    f = int(p["frames_per_orbit"])
    rng = np.random.default_rng(seed)
    kw = dict(width=w, height=h, tiles=tiles, offset=float(cam["offset"]),
              focal=float(cam["focal_length"]))
    t_ref, t_ctl, gap = 0.0, 0.0, 0.0
    for i in rng.choice(f, size=int(p["check"]["frames"]), replace=False).tolist():
        angle = i * 360.0 / f
        view = render.orbit_view(angle, kw["offset"], kw["focal"], device)[1]
        counts = render.tile_counts(fields[0], fields[1], view, tiles, kw["focal"]).cpu().numpy()
        pix = checks.sample_pixels(counts, rng, int(p["check"]["pixels"]), width=w, height=h,
                                   tiles=tiles)
        t0 = time.perf_counter()
        ref = render.render_pixels(fields, angle, pix, **kw)
        t1 = time.perf_counter()
        ctl = render.render_pixels(fields, angle, pix, dtype=torch.float32, tf32=True, **kw)
        t_ctl += time.perf_counter() - t1
        t_ref += t1 - t0
        gap = max(gap, checks.pixel_gap(ctl, ref))
    return t_ref, {"control": ({"pixel_gap": gap}, t_ctl)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="a fit cell's window before the step it follows")
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import load_spec

    spec = load_spec(ROOT, args.workload)
    device = torch.device(args.device)
    readings = fit_readings if spec.workload["driver"] == "fit" else orbit_readings
    for seed in (int(s) for s in args.seeds.split(",")):
        t_ref, out = readings(spec, seed, device, args.seconds)
        for name, (numbers, secs) in out.items():
            print(json.dumps({"cell": args.workload, "seed": seed, "reading": name,
                              "numbers": numbers, "seconds": secs, "reference_s": t_ref}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
