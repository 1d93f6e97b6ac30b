"""Fused RCAB forward: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``rumpy_tpu/ops/pallas/rcab_fused.py::
rcab_fused``. One residual channel-attention block on NHWC activations::

    h1  = round_dtype(relu(conv3x3(x, w1) + b1))
    h2  = conv3x3(h1, w2) + b2
    u   = sigmoid(relu(mean_hw(h2) @ wd + bd) @ wu + bu)
    out = round_dtype(h2 * u * res_scale + x)

with every accumulation in float32. The kernel (``csrc/rcab_fused.cu``) is
bound by operations on an H100 (2.42 GFLOP against 4.2 MB moved per
128x128x64 bf16 image); the source says how its three launches split the
global average pool across blocks. ``rcab_fused`` launches it for CUDA
tensors and raises if that fails; it runs ``rcab_reference`` only for
tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

# Launches of the CUDA kernel (one per ``rcab_fused`` call on the card).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rcab_reference(x, w1, b1, w2, b2, wd, bd, wu, bu, res_scale=1.0):
    """The block in plain PyTorch ops, the same arithmetic as the kernel:
    products of values in x's dtype, summed in float32, h1 rounded to x's
    dtype before the second conv. Same arguments as :func:`rcab_fused`."""
    dt = x.dtype
    c = x.shape[-1]

    def conv(a, w, b):
        k = w.to(dt).float().reshape(3, 3, c, c).permute(3, 2, 0, 1)
        return F.conv2d(a.float(), k, padding=1) + b.float()[:, None, None]

    xc = x.permute(0, 3, 1, 2)
    h1 = torch.relu(conv(xc, w1, b1)).to(dt)
    h2 = conv(h1, w2, b2)
    gap = h2.mean(dim=(2, 3))
    d = torch.relu(gap @ wd.float() + bd.float())
    u = torch.sigmoid(d @ wu.float() + bu.float())
    y = h2 * u[:, :, None, None] * res_scale + xc.float()
    return y.to(dt).permute(0, 2, 3, 1).contiguous()


def _check(x, w1, b1, w2, b2, wd, bd, wu, bu):
    if x.dim() != 4:
        raise ValueError(f"rcab_fused: x must be (N,H,W,C), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if c % 8:
        raise ValueError(f"rcab_fused: C={c} is not a multiple of 8")
    if n * h * w == 0:
        raise ValueError(f"rcab_fused: empty input {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("rcab_fused: x must be a contiguous NHWC tensor "
                         "(a channels_last NCHW tensor permuted to NHWC is)")
    r = wd.shape[-1]
    want = {"w1": (w1, (9, c, c)), "w2": (w2, (9, c, c)), "b1": (b1, (c,)),
            "b2": (b2, (c,)), "wd": (wd, (c, r)), "bd": (bd, (r,)),
            "wu": (wu, (r, c)), "bu": (bu, (c,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"rcab_fused: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != x.device:
            raise ValueError(f"rcab_fused: {name} is on {t.device}, x on {x.device}")


def rcab_fused(x, w1, b1, w2, b2, wd, bd, wu, bu, res_scale=1.0):
    """Fused RCAB forward.

    Args:
      x: (N, H, W, C) contiguous activations, float32 or bfloat16; C a
        multiple of 8.
      w1, w2: (9, C, C) 3x3 conv kernels tap-major (HWIO kernel k ->
        k.reshape(9, C, C)), in x's dtype on the card.
      b1, b2: (C,) biases. wd: (C, C//r), bd: (C//r,), wu: (C//r, C),
        bu: (C,) channel-attention weights; float32 on the card.
      res_scale: multiplies the attended branch before the residual add.
    Returns (N, H, W, C) in x's dtype.
    """
    global launches
    _check(x, w1, b1, w2, b2, wd, bd, wu, bu)
    if x.device.type == "cpu":
        return rcab_reference(x, w1, b1, w2, b2, wd, bd, wu, bu, res_scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"rcab_fused: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rcab_fused: dtype {x.dtype} is not float32 or bfloat16")
    for name, t in (("w1", w1), ("w2", w2)):
        if t.dtype != x.dtype or not t.is_contiguous():
            raise TypeError(f"rcab_fused: {name} must be contiguous {x.dtype}")
    f32 = [t.contiguous().float() for t in (b1, b2, wd, bd, wu, bu)]
    n, h, w, c = x.shape
    dt = _DTYPES[x.dtype]
    lib = _library()
    floats = _workspace_floats(dt, n, h, w, c)
    workspace = torch.empty(floats, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = lib.rcab_fused_forward(
        dt, x.data_ptr(), w1.data_ptr(), f32[0].data_ptr(), w2.data_ptr(),
        f32[1].data_ptr(), f32[2].data_ptr(), f32[3].data_ptr(),
        f32[4].data_ptr(), f32[5].data_ptr(), float(res_scale), out.data_ptr(),
        workspace.data_ptr(), floats, n, h, w, c, wd.shape[-1],
        torch._C._cuda_getCurrentRawStream(x.device.index))
    _raise_on(err, "launch")
    launches += 1
    return out


def _raise_on(err: int, what: str):
    if err != 0:
        name = _library().rcab_fused_error_name(err).decode()
        raise RuntimeError(f"rcab_fused: CUDA {what} failed with error {err} ({name})")


@functools.lru_cache(maxsize=None)
def _workspace_floats(dtype: int, n: int, h: int, w: int, c: int) -> int:
    """Float32 scratch of one launch, as the kernel's own plan sizes it."""
    floats = ctypes.c_longlong()
    _raise_on(_library().rcab_fused_workspace(dtype, n, h, w, c,
                                              ctypes.byref(floats)), "plan")
    return floats.value


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's C entry points, built and loaded at first use."""
    from rumpy_tpu_torch.ops.cuda import build
    lib = build.load("rcab_fused")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rcab_fused_forward.argtypes = ([i] + [vp] * 9 + [ctypes.c_float]
                                       + [vp, vp, ll] + [i] * 5 + [vp])
    lib.rcab_fused_forward.restype = i
    lib.rcab_fused_workspace.argtypes = [i] * 5 + [ctypes.POINTER(ll)]
    lib.rcab_fused_workspace.restype = i
    lib.rcab_fused_error_name.argtypes = [i]
    lib.rcab_fused_error_name.restype = ctypes.c_char_p
    return lib
