"""The RCAB backward kernel of this checkout against another checkout's, in
one call on the card, in the order other, this, this, other.

    python3 scripts/rcab_backward_ab.py OTHER_CHECKOUT

Each side runs in a process of its own from its own checkout's root, which
builds its kernels there, and times the bf16 backward by CUDA events
(``chip_smoke.cuda_ms``, 3 x 20 calls behind a held card): shared gate
inputs at the train shape 16x48x48x64, with each pass's device time from a
trace, and the per-image form of max_concat with q-layers (bd and scale per
image) at 16x48x48x64, 1x339x510x64 and 96x48x48x64. Prints one JSON line a
side and shape, then the card's name and power limit.
"""

import json
import os
import subprocess
import sys

SHAPES = [((16, 48, 48, 64), False), ((16, 48, 48, 64), True),
          ((1, 339, 510, 64), True), ((96, 48, 48, 64), True)]


def time_here(label: str) -> None:
    """Times the backward of the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from rumpy_tpu_torch.ops.cuda import build
    from rumpy_tpu_torch.ops.cuda import rcab_fused as rcab

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(os.path.join(os.getcwd(), "build"), exist_ok=True)  # traces go there
    build.build_all(["rcab_fused", "rcab_fused_bwd"])
    for shape, per_image in SHAPES:
        if per_image:
            args, scale = cs.qrcab_inputs(shape, torch.bfloat16, 5, cs.MAX_CONCAT_Q)
            scale = scale.requires_grad_(True)
        else:
            args, scale = cs.rcab_inputs(shape, torch.bfloat16, 5), None
        args = [a.requires_grad_(True) for a in args]
        g = torch.Generator().manual_seed(6)
        dout = torch.randn(*shape, generator=g).cuda().to(torch.bfloat16)
        out = rcab.rcab_fused(*args, res_scale=1.0 if scale is None else scale)
        leaves = args + ([] if scale is None else [scale])
        backward = lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
        row = {"side": label, "shape": shape, "per_image": per_image,
               "ms": [cs.cuda_ms(backward, 20) for _ in range(3)]}
        if not per_image:
            row["pass_device_us"] = cs.traced(backward, f"rcab_backward_ab_{label}", 5,
                                              by_kernel=True)["per_call_device_us_by_kernel"]
        print(json.dumps(row), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        time_here(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(sys.argv[1])
    for label, root in (("other", other), ("this", this), ("this", this), ("other", other)):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--time", label], cwd=root,
                       check=True)
    sys.path.insert(0, this)
    import chip_smoke
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
