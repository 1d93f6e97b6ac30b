"""Spatial (H-axis) sharding for giant-image SR: a halo exchange over the
group's ranks. Port of ``rumpy_tpu/parallel/spatial.py``.

The reference bounds memory on large images with recursive single-device
tiling (SAN's ``forward_chop``). Over a data-parallel group an image's
height can be sharded instead: each rank takes an H-strip, receives
``halo`` rows from each neighbour so that its convolutions see the context
they need, and runs the network on its strip alone.

- :func:`halo_exchange` extends a strip with ``halo`` rows from the ranks
  before and after it, taken from one ``all_gather`` of every strip's edge
  rows; a strip at the image's top or bottom reflects its own rows there
  (``jnp.pad(mode="reflect")``).
- :func:`spatial_sharded_forward` runs an (N, H, W, C) -> (N, sH, sW, C)
  forward over an image whose height is sharded across the ranks. Every
  rank holds the whole input and returns the whole output, as the JAX
  function's global array reads. Contract: when ``halo`` covers the
  network's receptive-field radius the result equals
  ``crop(forward(reflect_pad(image, halo)))``. A network that pools over
  the whole image (RCAN's channel attention) sees its strip's pool instead:
  no halo makes it exact, and ``halo`` trades accuracy against memory as
  ``forward_chop``'s ``shave`` does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from rumpy_tpu_torch.parallel.mesh import Mesh, all_gather_rows, get_mesh


def _reflect_rows(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """``x`` (N, H, W, C) reflect-padded by ``top`` and ``bottom`` rows."""
    if not (top or bottom):
        return x
    return F.pad(x.permute(0, 3, 1, 2), (0, 0, top, bottom), mode="reflect").permute(0, 2, 3, 1)


def halo_exchange(x: torch.Tensor, halo: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's (N, h, W, C) strip extended by ``halo`` rows from each
    neighbour: (N, h + 2 * halo, W, C). The edge rows of every strip come
    from one all_gather; the first and the last rank reflect their own rows
    at the image's top and bottom (``halo`` < h)."""
    mesh = mesh or get_mesh()
    edges = torch.cat([x[:, :halo], x[:, -halo:]], dim=1)  # (N, 2 * halo, W, C)
    every = all_gather_rows(edges[None], mesh)  # (W, N, 2 * halo, W, C)
    r, last = mesh.rank, mesh.size - 1
    from_prev = (x[:, 1:halo + 1].flip(1) if r == 0 else every[r - 1][:, halo:])
    from_next = (x[:, -halo - 1:-1].flip(1) if r == last else every[r + 1][:, :halo])
    return torch.cat([from_prev, x, from_next], dim=1)


def spatial_sharded_forward(forward: Callable, image: torch.Tensor, scale: int,
                            mesh: Optional[Mesh] = None, halo: int = 10) -> torch.Tensor:
    """SR an image with its height sharded across the group's ranks.

    :param forward: (N, h, W, C) -> (N, s*h, s*W, C) network.
    :param image: (N, H, W, C), the same on every rank; H is reflect-padded
        up to a multiple of the rank count and the result cropped back.
    :param halo: context rows exchanged with each neighbour; exact when at
        least the network's receptive-field radius (in input rows).
    :returns: the whole (N, s*H, s*W, C) output on every rank.
    """
    mesh = mesh or get_mesh()
    n_ranks = mesh.shape["data"]
    h = image.shape[1]
    pad_h = (-h) % n_ranks
    image = _reflect_rows(image, 0, pad_h)
    rows = image.shape[1] // n_ranks
    strip = image[:, mesh.rank * rows:(mesh.rank + 1) * rows]
    out = forward(halo_exchange(strip, halo, mesh))
    out = out[:, halo * scale:out.shape[1] - halo * scale]
    whole = all_gather_rows(out.contiguous()[None], mesh)  # (W, N, s*rows, sW, C)
    whole = torch.cat(list(whole.unbind(0)), dim=1)
    return whole[:, :h * scale]
