"""Device resolution for the port's entry points.

Entry points default to ``"cuda"`` and never fall back to the CPU on their
own: without CUDA they raise, and they run on the CPU only when the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The torch.device for ``device`` (default ``"cuda"``). Raises
    RuntimeError for a CUDA device when CUDA is not available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {str(dev)!r}")
    return dev
