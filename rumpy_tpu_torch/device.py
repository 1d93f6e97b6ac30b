"""Device resolution for the port's entry points.

Entry points default to ``"cuda"`` and never fall back to the CPU on their
own: without CUDA they raise, and they run on the CPU only when the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
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


def to_device(x, device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` (in ``dtype`` if
    given). A host array bound for the card goes through pinned memory and
    a copy that does not wait for the card."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None and t.device.type == "cpu":
        t = t.to(dtype)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t if dtype is None else t.to(dtype)


def true_div(a, b) -> torch.Tensor:
    """``a / b`` rounded as IEEE division on every device, where one of the
    two may be a Python number. PyTorch multiplies a CUDA tensor by the
    reciprocal of a Python-number divisor, one ulp off the quotient for 126
    of the 256 levels ``v / 255``, and turns a Python number over a tensor
    into the tensor's reciprocal times the number on every device. A 0-d
    tensor filled on the device keeps the division and uploads nothing."""
    if not torch.is_tensor(a):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    if not torch.is_tensor(b):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)
