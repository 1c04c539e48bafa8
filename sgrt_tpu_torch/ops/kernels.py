"""Registry of the port's hand-written kernels: one object per kernel, each
with `name`, `route`, `source`, `replaces` (the TPU kernel it ports) and a
`launches` count that its wrapper raises by one per launch."""

from __future__ import annotations

from sgrt_tpu_torch.ops.cuda_aniso import (
    FUSED_BWD_ANISO,
    FUSED_BWD_T_ANISO,
    FUSED_FWD_ANISO,
    FUSED_FWD_T_ANISO,
)
from sgrt_tpu_torch.ops.cuda_chunked import CHUNKED_BWD, CHUNKED_BWD_T, CHUNKED_FWD, CHUNKED_FWD_T
from sgrt_tpu_torch.ops.cuda_chunked_aniso import CHUNKED_BWD_ANISO, CHUNKED_FWD_ANISO
from sgrt_tpu_torch.ops.cuda_kernel import FUSED_BWD, FUSED_BWD_T, FUSED_FWD, FUSED_FWD_T
from sgrt_tpu_torch.utils import nvcc

# in the order of the kernel table (PERF.md): rows 1-14
KERNELS = (FUSED_FWD, FUSED_FWD_T, FUSED_BWD_T, FUSED_BWD,
           CHUNKED_FWD, CHUNKED_FWD_T, CHUNKED_BWD, CHUNKED_BWD_T,
           FUSED_FWD_ANISO, FUSED_FWD_T_ANISO, FUSED_BWD_T_ANISO, FUSED_BWD_ANISO,
           CHUNKED_FWD_ANISO, CHUNKED_BWD_ANISO)


def build_all() -> None:
    """Compile every kernel's source, all nvcc processes at once."""
    nvcc.build(sorted({k.source for k in KERNELS}))


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
