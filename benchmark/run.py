"""One run of one cell of the benchmark of sgrt_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Makes the cell's scene and inputs on the card
from --seed, builds or loads the program's kernels (build/ inside the
checkout), warms up, measures for --seconds, checks what the window
produced against the plain reference (benchmark/reference/), and prints one
JSON object as the last line of standard output: with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics under
torch.profiler. The numbers compared, each with its limit, end both the
object (under "checks") and standard error.

Exits non-zero, printing no result, without enough CUDA cards, or when
jax, jaxlib, flax or sgrt_tpu is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "sgrt_tpu")

# every cache of the program and its libraries inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import load_spec, run_cell

    chips = int(load_spec(ROOT, args.workload).cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START)
    found = banned_modules()
    if found:
        print(f"error: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
