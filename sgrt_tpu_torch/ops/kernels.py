"""Registry of the port's hand-written kernels: one object per kernel, each
with `name`, `route`, `source`, `replaces` (the TPU kernel it ports) and a
`launches` count that its wrapper raises by one per launch."""

from __future__ import annotations

import ctypes

from sgrt_tpu_torch.ops.cuda_aniso import (
    FUSED_BWD_ANISO,
    FUSED_BWD_T_ANISO,
    FUSED_FWD_ANISO,
    FUSED_FWD_T_ANISO,
)
from sgrt_tpu_torch.ops.cuda_chunked import CHUNKED_BWD, CHUNKED_BWD_T, CHUNKED_FWD, CHUNKED_FWD_T
from sgrt_tpu_torch.ops.cuda_chunked_aniso import (
    CHUNKED_BWD_ANISO,
    CHUNKED_BWD_T_ANISO,
    CHUNKED_FWD_ANISO,
    CHUNKED_FWD_T_ANISO,
)
from sgrt_tpu_torch.ops.cuda_kernel import FUSED_BWD, FUSED_BWD_T, FUSED_FWD, FUSED_FWD_T
from sgrt_tpu_torch.ops.cuda_split import SPLIT_BWD, SPLIT_BWD_COLOR, SPLIT_FWD, SPLIT_FWD_COLOR
from sgrt_tpu_torch.ops.cuda_tiling import TILE_COMPACT
from sgrt_tpu_torch.utils import nvcc

# in the order of the kernel table (PERF.md): rows 1-20 (19-20: the saved-T
# schedule of rows 13-14), then row 21, the tiling kernel (no Pallas
# counterpart: it replaces the JAX package's XLA chain)
KERNELS = (FUSED_FWD, FUSED_FWD_T, FUSED_BWD_T, FUSED_BWD,
           CHUNKED_FWD, CHUNKED_FWD_T, CHUNKED_BWD, CHUNKED_BWD_T,
           FUSED_FWD_ANISO, FUSED_FWD_T_ANISO, FUSED_BWD_T_ANISO, FUSED_BWD_ANISO,
           CHUNKED_FWD_ANISO, CHUNKED_BWD_ANISO,
           SPLIT_FWD, SPLIT_BWD, SPLIT_FWD_COLOR, SPLIT_BWD_COLOR,
           CHUNKED_FWD_T_ANISO, CHUNKED_BWD_T_ANISO, TILE_COMPACT)


def build_all() -> None:
    """Compile every kernel's source, all nvcc processes at once."""
    nvcc.build(sorted({k.source for k in KERNELS}))


def kernel_resources(threads: int = 128, qb: int = 32) -> list[dict]:
    """What each device function of the libraries takes of an SM
    (sgrt_kernel_resources: cudaFuncGetAttributes and the occupancy
    calculator, csrc/gauss_common.cuh kernel_resources) at `threads` rays per
    block and qb staged rows: registers and spill bytes per thread, shared
    memory, and resident blocks and warps per SM. Builds the libraries."""
    out = []
    for source in sorted({k.source for k in KERNELS}):
        lib = ctypes.CDLL(str(nvcc.build([source])[0]))
        fn = lib.sgrt_kernel_resources
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        vals, name = (ctypes.c_int * 7)(), ctypes.c_char_p()
        i = 0
        while (err := fn(i, threads, qb, vals, ctypes.byref(name))) != -1:
            if err:
                raise RuntimeError(f"kernel_resources of {source.name}[{i}]: CUDA error {err}")
            regs, local, max_thr, static, dyn, thr, blocks = list(vals)
            out.append({"source": source.name, "kernel": name.value.decode(), "registers": regs,
                        "local_bytes": local, "max_threads_per_block": max_thr,
                        "static_smem": static, "dynamic_smem": dyn, "threads": thr,
                        "blocks_per_sm": blocks, "warps_per_sm": blocks * thr // 32})
            i += 1
    return out


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
