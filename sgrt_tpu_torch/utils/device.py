"""Device selection for the port's entry points.

Every entry point that makes tensors takes an explicit `device`, "cuda" by
default. Asking for the card where there is none raises: nothing falls back
to the CPU unless the caller passes device="cpu".
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if it names CUDA and no card is
    visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return dev
