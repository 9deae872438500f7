"""Device selection for the port's entry points.

Entry points default to ``"cuda"`` and refuse to run there when no CUDA
device exists: a silent drop to the CPU would make every timing and every
kernel check meaningless. Pass ``device="cpu"`` explicitly to run on the
CPU (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but torch.cuda.is_available() "
            "is False. Pass device='cpu' to run on the CPU."
        )
    return dev
