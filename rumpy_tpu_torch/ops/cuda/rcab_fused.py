"""Fused RCAB, forward and backward: the CUDA kernels' wrapper and their
plain versions.

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

When a gradient is wanted, ``rcab_fused`` goes through a
``torch.autograd.Function`` whose backward is hand-written too
(``csrc/rcab_fused_bwd.cu``): it keeps the forward's h2 and gate, computes
h1 again from x, and returns the gradients of all nine inputs, the
parameters' in float32. In bfloat16 with C in {16, 32, 64, 128} its
convolutions and weight gradients run on the tensor cores, and dh2 is
rounded to bfloat16 on its way into them; float32 and other widths run on
the CUDA cores. The Pallas kernel has no backward; the yardstick
is autograd of ``rcab_reference`` (``rcab_backward_reference``), which the
Function uses for tensors on the CPU and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

# Launches of the CUDA kernels: one per forward, and one per backward, of a
# ``rcab_fused`` call on the card.
launches = 0
backward_launches = 0

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


def rcab_backward_reference(dout, x, w1, b1, w2, b2, wd, bd, wu, bu, res_scale=1.0):
    """The gradients of :func:`rcab_reference` at ``dout`` for all nine
    inputs, by PyTorch's autograd: the plain version of the backward
    kernel. Each gradient has its input's dtype."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(True)
                for t in (x, w1, b1, w2, b2, wd, bd, wu, bu)]
        out = rcab_reference(*args, res_scale=res_scale)
        return torch.autograd.grad(out, args, dout)


def rcab_fused(x, w1, b1, w2, b2, wd, bd, wu, bu, res_scale=1.0):
    """Fused RCAB, differentiable in all nine tensors.

    Args:
      x: (N, H, W, C) contiguous activations, float32 or bfloat16; C a
        multiple of 8.
      w1, w2: (9, C, C) 3x3 conv kernels tap-major (HWIO kernel k ->
        k.reshape(9, C, C)); used in x's dtype. Without a gradient they
        must be contiguous and in x's dtype already (a packed, cached
        weight); with one, live parameters of another dtype are cast.
      b1, b2: (C,) biases. wd: (C, C//r), bd: (C//r,), wu: (C//r, C),
        bu: (C,) channel-attention weights; used in float32.
      res_scale: multiplies the attended branch before the residual add.
    Returns (N, H, W, C) in x's dtype.
    """
    _check(x, w1, b1, w2, b2, wd, bd, wu, bu)
    args = (x, w1, b1, w2, b2, wd, bd, wu, bu)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _RCABFunction.apply(*args, float(res_scale))
    if x.device.type == "cpu":
        return rcab_reference(*args, res_scale)
    for name, t in (("w1", w1), ("w2", w2)):
        if t.dtype != x.dtype or not t.is_contiguous():
            raise TypeError(f"rcab_fused: {name} must be contiguous {x.dtype}")
    return _forward(*args, res_scale)[0]


def _kernel_args(x, w1, b1, w2, b2, wd, bd, wu, bu):
    """The arguments as the kernels take them: conv weights contiguous in
    x's dtype, the rest contiguous float32."""
    if x.device.type != "cuda":
        raise RuntimeError(f"rcab_fused: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rcab_fused: dtype {x.dtype} is not float32 or bfloat16")
    convs = [t.detach().to(x.dtype).contiguous() for t in (w1, w2)]
    f32 = [t.detach().float().contiguous() for t in (b1, b2, wd, bd, wu, bu)]
    return convs[0], f32[0], convs[1], *f32[1:]


def _forward(x, w1, b1, w2, b2, wd, bd, wu, bu, res_scale):
    """Launch the forward kernel; returns (out, workspace, kernel args)."""
    global launches
    kargs = _kernel_args(x, w1, b1, w2, b2, wd, bd, wu, bu)
    n, h, w, c = x.shape
    dt = _DTYPES[x.dtype]
    lib = _library()
    floats = _workspace_floats(dt, n, h, w, c)
    workspace = torch.empty(floats, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = lib.rcab_fused_forward(
        dt, x.data_ptr(), *(t.data_ptr() for t in kargs), float(res_scale),
        out.data_ptr(), workspace.data_ptr(), floats, n, h, w, c, wd.shape[-1],
        torch._C._cuda_getCurrentRawStream(x.device.index))
    _raise_on(err, "launch")
    launches += 1
    return out, workspace, kargs


def _backward(dout, x, workspace, kargs, res_scale):
    """Launch the backward kernel; returns the nine gradients, dx in x's
    dtype and the parameters' in float32."""
    global backward_launches
    w1, b1, w2, _, wd, bd, wu, _ = kargs
    n, h, w, c = x.shape
    r = wd.shape[-1]
    dt = _DTYPES[x.dtype]
    lib = _backward_library()
    partial_at, gate_at, n_tiles = _forward_layout(dt, n, h, w, c)
    floats = _backward_workspace_floats(dt, n, h, w, c, r, torch.cuda.current_device())
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    h1, dh1, dx = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    grads = [torch.empty_like(t, dtype=torch.float32)
             for t in (w1, b1, w2, b1, wd, bd, wu, b1)]  # dw1 db1 dw2 db2 dwd dbd dwu dbu
    dout = dout.to(x.dtype).contiguous()
    base = workspace.data_ptr()
    err = lib.rcab_fused_backward(
        dt, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        wd.data_ptr(), bd.data_ptr(), wu.data_ptr(), float(res_scale),
        dout.data_ptr(), base, base + 4 * partial_at, base + 4 * gate_at, n_tiles,
        dx.data_ptr(), *(g.data_ptr() for g in grads), h1.data_ptr(),
        dh1.data_ptr(), scratch.data_ptr(), floats, n, h, w, c, r,
        torch._C._cuda_getCurrentRawStream(x.device.index))
    _raise_on(err, "backward launch")
    backward_launches += 1
    return (dx, *grads)


class _RCABFunction(torch.autograd.Function):
    """``rcab_fused`` with a gradient: both directions are the hand-written
    kernels on the card, and the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, wd, bd, wu, bu, res_scale):
        ctx.res_scale = res_scale
        params = (w1, b1, w2, b2, wd, bd, wu, bu)
        if x.device.type == "cpu":
            ctx.save_for_backward(x, *params)
            return rcab_reference(x, *params, res_scale)
        out, workspace, kargs = _forward(x, *params, res_scale)
        ctx.save_for_backward(x, workspace, *kargs)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, *saved = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = rcab_backward_reference(dout, x, *saved, res_scale=ctx.res_scale)
        else:
            grads = _backward(dout, x, saved[0], saved[1:], ctx.res_scale)
        return (*grads, None)


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
def _forward_layout(dtype: int, n: int, h: int, w: int, c: int):
    """Float offsets of the tile sums and the gate in the forward's
    workspace, and the tiles an image, as the kernel's plan lays them."""
    layout = (ctypes.c_longlong * 3)()
    _raise_on(_library().rcab_fused_layout(dtype, n, h, w, c, layout), "plan")
    return tuple(layout)


@functools.lru_cache(maxsize=None)
def _backward_workspace_floats(dtype: int, n: int, h: int, w: int, c: int, r: int,
                              device: int) -> int:
    """Float32 scratch of one backward launch, as its own plan sizes it for
    the current device ``device`` (the plan follows the card's SM count)."""
    floats = ctypes.c_longlong()
    _raise_on(_backward_library().rcab_fused_backward_workspace(
        dtype, n, h, w, c, r, ctypes.byref(floats)), "backward plan")
    return floats.value


def _bind_forward(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rcab_fused_forward.argtypes = ([i] + [vp] * 9 + [ctypes.c_float]
                                       + [vp, vp, ll] + [i] * 5 + [vp])
    lib.rcab_fused_forward.restype = i
    lib.rcab_fused_workspace.argtypes = [i] * 5 + [ctypes.POINTER(ll)]
    lib.rcab_fused_workspace.restype = i
    lib.rcab_fused_layout.argtypes = [i] * 5 + [ctypes.POINTER(ll)]
    lib.rcab_fused_layout.restype = i
    lib.rcab_fused_error_name.argtypes = [i]
    lib.rcab_fused_error_name.restype = ctypes.c_char_p


def _bind_backward(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rcab_fused_backward.argtypes = (
        [i] + [vp] * 7 + [ctypes.c_float] + [vp] * 4 + [i] + [vp] * 12
        + [ll] + [i] * 5 + [vp])
    lib.rcab_fused_backward.restype = i
    lib.rcab_fused_backward_workspace.argtypes = [i] * 6 + [ctypes.POINTER(ll)]
    lib.rcab_fused_backward_workspace.restype = i


def _library():
    """The forward kernel's C entry points, built and loaded at first use."""
    from rumpy_tpu_torch.ops.cuda import build
    return build.load("rcab_fused", _bind_forward)


def _backward_library():
    """The backward kernel's C entry points, built and loaded at first use."""
    from rumpy_tpu_torch.ops.cuda import build
    return build.load("rcab_fused_bwd", _bind_backward)
