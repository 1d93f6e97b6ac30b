"""Window sums of an entropy map: the CUDA kernel's wrapper and its plain
version.

Replaces the XLA code of ``rumpy_tpu/ops/entropy.py::
entropy_patch_positions`` that pools the entropy map at the crop size
(``_box_filter_same(ent, crop_size)`` and the trim; no Pallas kernel): for
an (H, W) float32 map, the (H - size + 1, W - size + 1) map whose entry
(y, x) is the sum over the ``size`` x ``size`` window with top-left corner
(y, x), added as ``box_filter_same`` adds, rows first, then columns, each
in ascending order. The kernel (``csrc/window_sum.cu``) gives the plain
version's bits, and can also leave the pick of the map (its first maximum
or minimum, row-major, as ``np.nanargmax`` chooses) in an 8-byte slot, so
that a single index crosses to the host. ``window_sum`` launches it for
CUDA tensors and raises if that fails; it runs ``window_sum_reference``
only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# Launches of the CUDA kernel (one per ``window_sum`` call on the card).
launches = 0

_count_lock = threading.Lock()  # the loader's workers count too


def box_filter_same(x: torch.Tensor, size: int) -> torch.Tensor:
    """Separable box sum over the first two axes with zero padding
    ('same'), the windows added in ascending order.

    Ceil-left anchor: output[i] sums window [i - size//2, i + (size-1)//2],
    which makes ``window_sum_reference``'s trim an exact VALID window, so
    its entry j is the patch whose top-left corner is j."""
    pad_l = size // 2
    pad_r = size - 1 - pad_l

    def conv1d(v, axis):
        pads = [0, 0] * v.dim()
        k = 2 * (v.dim() - 1 - axis)  # F.pad lists the last axis first
        pads[k], pads[k + 1] = pad_l, pad_r
        vp = F.pad(v, pads)
        n = v.shape[axis]
        out = vp.narrow(axis, 0, n)
        for i in range(1, size):
            out = out + vp.narrow(axis, i, n)
        return out

    return conv1d(conv1d(x, 0), 1)


def window_sum_reference(x: torch.Tensor, size: int) -> torch.Tensor:
    """The same function in plain PyTorch ops: ``box_filter_same`` trimmed
    to the windows that lie inside the map."""
    return box_filter_same(x, size)[size // 2: x.shape[0] - (size - 1) // 2,
                                    size // 2: x.shape[1] - (size - 1) // 2]


def pick_index(key: int) -> int:
    """The flat index that a pick slot's key holds."""
    return 0xFFFFFFFF - (key & 0xFFFFFFFF)


def pick_reference(pooled: torch.Tensor, lowest: bool = False) -> Tuple[int, float]:
    """The plain version of the kernel's pick: (flat index, value) of the
    first maximum (first minimum with ``lowest``)."""
    flat = pooled.reshape(-1)
    i = int((flat.argmin() if lowest else flat.argmax()).item())
    return i, float(flat[i].item())


def window_sum(x: torch.Tensor, size: int, pick: Optional[torch.Tensor] = None,
               lowest: bool = False) -> torch.Tensor:
    """Sums over every ``size`` x ``size`` window inside an (H, W) float32
    map: (H - size + 1, W - size + 1) float32. ``pick``: an int64 tensor of
    one element on the card that holds 0 (``local_entropy_rgb``'s
    ``clear`` sets it); the launch leaves there the key of the map's first
    maximum (minimum with ``lowest``), which ``pick_index`` reads. On the
    CPU ``pick`` is not taken: ``pick_reference`` computes the pick."""
    global launches
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"window_sum: need an (H, W) float32 map, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not 1 <= size <= min(x.shape):
        raise ValueError(f"window_sum: size {size} does not fit a {tuple(x.shape)} map")
    if x.device.type == "cpu":
        if pick is not None:
            raise ValueError("window_sum: a pick slot is taken on the card only")
        return window_sum_reference(x, size)
    if x.device.type != "cuda":
        raise RuntimeError(f"window_sum: unsupported device {x.device}")
    if pick is not None and (pick.device != x.device or pick.dtype != torch.int64
                             or pick.numel() != 1):
        raise ValueError("window_sum: pick must be one int64 on the map's device")
    lib = _library()
    if size > lib.window_sum_max_size():
        raise ValueError(f"window_sum: size {size} is over the kernel's "
                         f"{lib.window_sum_max_size()}")
    x = x.contiguous()
    h, w = x.shape
    out = torch.empty((h - size + 1, w - size + 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.window_sum_forward(
            x.data_ptr(), out.data_ptr(), None if pick is None else pick.data_ptr(),
            h, w, size, int(lowest), torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        name = lib.window_sum_error_name(err).decode()
        raise RuntimeError(f"window_sum: CUDA launch failed with error {err} ({name})")
    with _count_lock:
        launches += 1
    return out


def _bind(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.window_sum_forward.argtypes = [vp, vp, vp, i, i, i, i, vp]
    lib.window_sum_forward.restype = i
    lib.window_sum_max_size.argtypes = []
    lib.window_sum_max_size.restype = i
    lib.window_sum_error_name.argtypes = [i]
    lib.window_sum_error_name.restype = ctypes.c_char_p


def _library():
    """The kernel's C entry points, built and loaded at first use."""
    from rumpy_tpu_torch.ops.cuda import build
    return build.load("window_sum", _bind)
