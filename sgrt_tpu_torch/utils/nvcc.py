"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under sgrt_tpu_torch/csrc/ compiles on first use into a shared
library with a plain C interface, in build/sgrt_tpu_torch/ at the root of
the checkout (git-ignored). The library's name carries a hash of the source
and the flags, so an edited source rebuilds and an unchanged one loads
straight away. Nothing is built at import time.

Flags: sm_90a (Hopper), -O3, and no --use_fast_math (it would turn every
expf and division into an approximation; the as5 erf tap takes the SFU's
reciprocal by name, csrc/gauss_common.cuh). -Xptxas -v writes each kernel's
registers, shared memory and spills to the build log beside the library.
--split-compile=0 spreads one source's optimisation and ptxas over every
CPU core, since chunked.cu instantiates its kernels for every erf and exp.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sgrt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0")


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
                           "the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def library_path(source: Path) -> Path:
    """The library's path, named by a hash of the source, the shared
    headers beside it (csrc/*.cuh) and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def build_log(source: Path) -> str:
    """The nvcc output (ptxas register/shared-memory/spill lines) of the
    library built from `source`, or "" if it was not built here."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(sources) -> list[Path]:
    """Compile every source whose library is missing, all nvcc processes at
    once, and wait for them. Raises with the compiler output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in map(Path, sources):
        lib = library_path(src)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = lib.with_suffix(".log")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((proc, tmp, lib, log))
    failed = []
    for proc, tmp, lib, log in jobs:
        if proc.wait() == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{lib.name}:\n{log.read_text()[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [library_path(Path(s)) for s in sources]


def load(source: Path) -> ctypes.CDLL:
    """Build `source` if needed and load its library."""
    (lib,) = build([source])
    return ctypes.CDLL(str(lib))
