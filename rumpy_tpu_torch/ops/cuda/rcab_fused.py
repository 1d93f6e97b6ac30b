"""Fused RCAB, forward and backward: the CUDA kernels' wrapper and their
plain versions.

Replaces the Pallas TPU kernel ``rumpy_tpu/ops/pallas/rcab_fused.py::
rcab_fused``. One residual channel-attention block on NHWC activations::

    h1  = round_dtype(relu(conv3x3(x, w1) + b1))
    h2  = conv3x3(h1, w2) + b2
    u   = sigmoid(relu(mean_hw(h2) @ wd + bd) @ wu + bu)
    out = round_dtype(h2 * u * res_scale + x)

with every accumulation in float32. A QRCAB (the meta-attention block of
``rumpy_tpu/models/attention_manipulators.py``) is the same block with
per-image gate inputs: ``bd`` (N, R) and ``bu`` (N, C) in place of the
shared vectors, and a channel scale ``s`` (N, C) float32 passed as
``res_scale``, ``out = round_dtype((h2 * u) * s[n, c] + x)``; the kernels
read them per image in the passes that already read ``bd``, ``bu`` and
``res_scale``, and the backward returns gradients of the same shapes.
The kernel (``csrc/rcab_fused.cu``) is
bound by operations on an H100: 5.44 GFLOP at the train shape
16x48x48x64 (5.5 us at the bf16 peak) against 9.4 MB of bf16 in and out.
In bfloat16 with C in {16, 32, 64, 128} it runs three passes: conv1 on the
tensor cores into h1 (bf16, kept in the output's buffer, so the call
allocates no scratch for it), conv2 into h2 (float32) and per-tile channel
sums, then one pass that computes each image's gate from the tile sums in
a fixed order and applies it. Each conv pass is an implicit GEMM over
pixels, split into warp-sized units over persistent blocks sized from the
card's SM count (:func:`plan` reports it). Float32 and other widths run
one conv pass on the CUDA cores (conv1 on a halo, then conv2) and the same
gate-and-apply pass. ``rcab_fused`` launches it for CUDA tensors and raises
if that fails; it runs ``rcab_reference`` only for tensors that lie on the
CPU.

When a gradient is wanted, ``rcab_fused`` goes through a
``torch.autograd.Function`` whose backward is hand-written too
(``csrc/rcab_fused_bwd.cu``): it keeps the forward's workspace (h2, the
tile sums and the gate), computes h1 again from x, and returns the
gradients of all nine inputs, the parameters' in float32. In bfloat16 with
C in {16, 32, 64, 128} its convolutions and weight gradients run on the
tensor cores, and dh2 is rounded to bfloat16 on its way into them; float32
and other widths run on the CUDA cores. The Pallas kernel has no backward;
the yardstick is autograd of ``rcab_reference``
(``rcab_backward_reference``), which the Function uses for tensors on the
CPU and nowhere else.
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
    dtype before the second conv. Same arguments as :func:`rcab_fused`,
    per-image ``bd``, ``bu`` and ``res_scale`` included."""
    dt = x.dtype
    if torch.is_tensor(res_scale):
        res_scale = res_scale.float()[:, :, None, None]
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


def _check(x, w1, b1, w2, b2, wd, bd, wu, bu, scale=None):
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
    want = {"w1": (w1, [(9, c, c)]), "w2": (w2, [(9, c, c)]), "b1": (b1, [(c,)]),
            "b2": (b2, [(c,)]), "wd": (wd, [(c, r)]), "bd": (bd, [(r,), (n, r)]),
            "wu": (wu, [(r, c)]), "bu": (bu, [(c,), (n, c)])}
    if scale is not None:
        want["res_scale"] = (scale, [(n, c)])
    for name, (t, shapes) in want.items():
        if tuple(t.shape) not in shapes:
            raise ValueError(f"rcab_fused: {name} has shape {tuple(t.shape)}, "
                             f"expected one of {shapes}")
        if t.device != x.device:
            raise ValueError(f"rcab_fused: {name} is on {t.device}, x on {x.device}")


def rcab_backward_reference(dout, x, w1, b1, w2, b2, wd, bd, wu, bu, res_scale=1.0):
    """The gradients of :func:`rcab_reference` at ``dout`` for all nine
    inputs, and for ``res_scale`` where it is a per-image tensor, by
    PyTorch's autograd: the plain version of the backward kernel. Each
    gradient has its input's dtype and shape."""
    with torch.enable_grad():
        tensors = (x, w1, b1, w2, b2, wd, bd, wu, bu)
        if torch.is_tensor(res_scale):
            tensors += (res_scale,)
        args = [t.detach().requires_grad_(True) for t in tensors]
        out = rcab_reference(*args[:9], res_scale=args[9] if len(args) > 9 else res_scale)
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
      b1, b2: (C,) biases. wd: (C, C//r), wu: (C//r, C) channel-attention
        weights; bd: (C//r,) or per image (N, C//r), bu: (C,) or per image
        (N, C); used in float32.
      res_scale: a number, or a per-image channel scale (N, C), that
        multiplies the attended branch before the residual add.
    Returns (N, H, W, C) in x's dtype.
    """
    scale = res_scale if torch.is_tensor(res_scale) else None
    _check(x, w1, b1, w2, b2, wd, bd, wu, bu, scale)
    args = (x, w1, b1, w2, b2, wd, bd, wu, bu)
    tensors = args if scale is None else args + (scale,)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _RCABFunction.apply(*args, scale, 1.0 if scale is not None else float(res_scale))
    if x.device.type == "cpu":
        return rcab_reference(*args, res_scale)
    for name, t in (("w1", w1), ("w2", w2)):
        if t.dtype != x.dtype or not t.is_contiguous():
            raise TypeError(f"rcab_fused: {name} must be contiguous {x.dtype}")
    return _forward(*args, scale, 1.0 if scale is not None else res_scale)[0]


def _kernel_args(x, w1, b1, w2, b2, wd, bd, wu, bu, scale=None):
    """The arguments as the kernels take them: conv weights contiguous in
    x's dtype, the rest (and the per-image scale, if any) contiguous
    float32."""
    if x.device.type != "cuda":
        raise RuntimeError(f"rcab_fused: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rcab_fused: dtype {x.dtype} is not float32 or bfloat16")
    convs = [t.detach().to(x.dtype).contiguous() for t in (w1, w2)]
    f32 = [t.detach().float().contiguous() for t in (b1, b2, wd, bd, wu, bu)]
    if scale is not None:
        scale = scale.detach().float().contiguous()
    return (convs[0], f32[0], convs[1], *f32[1:], scale)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(x, w1, b1, w2, b2, wd, bd, wu, bu, scale, res_scale):
    """Launch the forward kernel; returns (out, workspace, kernel args).
    ``scale`` is None or the per-image (N, C) scale, which then replaces
    ``res_scale``."""
    global launches
    kargs = _kernel_args(x, w1, b1, w2, b2, wd, bd, wu, bu, scale)
    n, h, w, c = x.shape
    r = wd.shape[-1]
    dt = _DTYPES[x.dtype]
    lib = _library()
    floats = _workspace_floats(dt, n, h, w, c, torch.cuda.current_device())
    workspace = torch.empty(floats, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = lib.rcab_fused_forward(
        dt, x.data_ptr(), *(t.data_ptr() for t in kargs[:8]), float(res_scale),
        _ptr(kargs[8]), r if bd.dim() == 2 else 0, c if bu.dim() == 2 else 0,
        out.data_ptr(), workspace.data_ptr(), floats, n, h, w, c, r,
        torch._C._cuda_getCurrentRawStream(x.device.index))
    _raise_on(err, "launch")
    launches += 1
    return out, workspace, kargs


def _backward(dout, x, workspace, kargs, res_scale, keep=None):
    """Launch the backward kernel; returns the nine gradients, dx in x's
    dtype and the parameters' in float32, each of its input's shape (bd
    and bu per image where they were), and the per-image scale's gradient
    (N, C) float32, or None without one. A ``keep`` dict receives the
    kernel's own h1 (recomputed, rounded as the forward rounds it) and
    dh1 (the gradient at conv1's output, after the ReLU), NHWC in x's
    dtype."""
    global backward_launches
    w1, b1, w2, _, wd, bd, wu, bu, scale = kargs
    n, h, w, c = x.shape
    r = wd.shape[-1]
    dt = _DTYPES[x.dtype]
    lib = _backward_library()
    partial_at, gate_at, n_tiles = _forward_layout(dt, n, h, w, c,
                                                   torch.cuda.current_device())
    floats = _backward_workspace_floats(dt, n, h, w, c, r, torch.cuda.current_device())
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    h1, dh1, dx = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    grads = [torch.empty_like(t, dtype=torch.float32)
             for t in (w1, b1, w2, b1, wd, bd, wu, bu)]  # dw1 db1 dw2 db2 dwd dbd dwu dbu
    dscale = None if scale is None else torch.empty_like(scale)
    dout = dout.to(x.dtype).contiguous()
    base = workspace.data_ptr()
    err = lib.rcab_fused_backward(
        dt, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        wd.data_ptr(), bd.data_ptr(), r if bd.dim() == 2 else 0, wu.data_ptr(),
        float(res_scale), _ptr(scale), int(bu.dim() == 2),
        dout.data_ptr(), base, base + 4 * partial_at, base + 4 * gate_at, n_tiles,
        dx.data_ptr(), *(g.data_ptr() for g in grads), _ptr(dscale), h1.data_ptr(),
        dh1.data_ptr(), scratch.data_ptr(), floats, n, h, w, c, r,
        torch._C._cuda_getCurrentRawStream(x.device.index))
    _raise_on(err, "backward launch")
    backward_launches += 1
    if keep is not None:
        keep.update(h1=h1, dh1=dh1)
    return (dx, *grads, dscale)


class _RCABFunction(torch.autograd.Function):
    """``rcab_fused`` with a gradient: both directions are the hand-written
    kernels on the card, and the plain versions on the CPU. ``scale`` is
    None or the per-image (N, C) scale that replaces ``res_scale``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, wd, bd, wu, bu, scale, res_scale):
        ctx.res_scale = res_scale
        params = (w1, b1, w2, b2, wd, bd, wu, bu)
        if x.device.type == "cpu":
            ctx.save_for_backward(x, *params, scale)
            return rcab_reference(x, *params, res_scale if scale is None else scale)
        out, workspace, kargs = _forward(x, *params, scale, res_scale)
        ctx.save_for_backward(x, workspace, *kargs)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, *saved = ctx.saved_tensors
        if x.device.type == "cpu":
            *params, scale = saved
            grads = rcab_backward_reference(
                dout, x, *params, res_scale=ctx.res_scale if scale is None else scale)
            if scale is None:
                grads = (*grads, None)
        else:
            grads = _backward(dout, x, saved[0], saved[1:], ctx.res_scale)
        return (*grads, None)


def _raise_on(err: int, what: str):
    if err != 0:
        name = _library().rcab_fused_error_name(err).decode()
        raise RuntimeError(f"rcab_fused: CUDA {what} failed with error {err} ({name})")


@functools.lru_cache(maxsize=None)
def _workspace_floats(dtype: int, n: int, h: int, w: int, c: int, device: int) -> int:
    """Float32 scratch of one launch, as the kernel's own plan sizes it for
    the current device ``device`` (the plan follows the card's SM count)."""
    floats = ctypes.c_longlong()
    _raise_on(_library().rcab_fused_workspace(dtype, n, h, w, c,
                                              ctypes.byref(floats)), "plan")
    return floats.value


@functools.lru_cache(maxsize=None)
def _forward_layout(dtype: int, n: int, h: int, w: int, c: int, device: int):
    """Float offsets of the tile sums and the gate in the forward's
    workspace, and the tiles an image, as the kernel's plan lays them on
    the current device ``device``."""
    layout = (ctypes.c_longlong * 3)()
    _raise_on(_library().rcab_fused_layout(dtype, n, h, w, c, layout), "plan")
    return tuple(layout)


_PLAN_KEYS = ("tensor_cores", "unit_rows", "unit_cols", "unit_channels", "blocks",
              "warps_per_block", "sms", "blocks_per_sm", "units", "waves",
              "apply_blocks")


def plan(shape, dtype) -> dict:
    """The forward kernel's launch plan for an (N, H, W, C) input of
    ``dtype`` on the current CUDA device: whether its convs run on the
    tensor cores; the work unit (a warp's pixel rows x columns x output
    channels on the tensor cores, a block's tile on the CUDA cores); conv
    blocks in all, warps a block, the device's SMs, blocks an SM that fit,
    units in all, units the busiest warp (tensor cores) or SM slot (CUDA
    cores) takes in turn (``waves``), and the gate-and-apply pass's blocks."""
    n, h, w, c = shape
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    _raise_on(_library().rcab_fused_plan(_DTYPES[dtype], n, h, w, c, out), "plan")
    return dict(zip(_PLAN_KEYS, out))


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
    lib.rcab_fused_forward.argtypes = ([i] + [vp] * 9 + [ctypes.c_float, vp, i, i]
                                       + [vp, vp, ll] + [i] * 5 + [vp])
    lib.rcab_fused_forward.restype = i
    lib.rcab_fused_workspace.argtypes = [i] * 5 + [ctypes.POINTER(ll)]
    lib.rcab_fused_workspace.restype = i
    lib.rcab_fused_layout.argtypes = [i] * 5 + [ctypes.POINTER(ll)]
    lib.rcab_fused_layout.restype = i
    lib.rcab_fused_plan.argtypes = [i] * 5 + [ctypes.POINTER(ll)]
    lib.rcab_fused_plan.restype = i
    lib.rcab_fused_error_name.argtypes = [i]
    lib.rcab_fused_error_name.restype = ctypes.c_char_p


def _bind_backward(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rcab_fused_backward.argtypes = (
        [i] + [vp] * 6 + [i, vp, ctypes.c_float, vp, i] + [vp] * 4 + [i] + [vp] * 13
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
