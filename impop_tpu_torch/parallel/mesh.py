"""A (data, site) grid of devices (counterpart of
:mod:`impop_tpu.parallel.mesh`).

Windows are independent, so the ``data`` axis splits the window-batch
dimension; the ``site`` axis splits the site dimension of a long window's
allele tile.  The JAX package places arrays with ``NamedSharding`` and lets
``psum`` merge partials; here one process drives every device of the grid:
it queues each device's share on that device's current stream (CUDA
launches return at once, so the devices overlap) and merges the partials by
moving them to the first device of the axis.  The partials are small (per
window [N, N] counts, per pair [6, Q] sums, per column min / max).

A grid may repeat a device: ``[cpu] x 8`` in the tests, ``[cuda:0] x 4``
on a one-card host, so every split, pad, gather and reduction runs there.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from impop_tpu_torch.device import local_devices, resolve_device

__all__ = ["Mesh", "make_mesh", "split_rows", "split_windows",
           "split_sites", "gather_windows", "reduce_sum", "reduce_min",
           "reduce_max"]


class Mesh:
    """``grid[i][j]`` is the device of data shard i and site shard j."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid = [list(row) for row in grid]
        if not self.grid or not self.grid[0] or len(
                {len(row) for row in self.grid}) != 1:
            raise ValueError("a mesh is a non-empty rectangle of devices")

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "site": len(self.grid[0])}

    @property
    def devices(self) -> List[torch.device]:
        """Every device of the grid, row by row."""
        return [d for row in self.grid for d in row]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` through the grid's first device."""
        if axis == "data":
            return [row[0] for row in self.grid]
        if axis == "site":
            return list(self.grid[0])
        raise ValueError(f"unknown mesh axis {axis!r} (data or site)")


def make_mesh(data: Optional[int] = None, site: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, site) mesh over ``devices`` (default: every local GPU).

    ``data`` defaults to len(devices) // site.  Devices may repeat.  Raises
    when the grid needs more devices than it is given."""
    devs = [resolve_device(d) for d in devices] if devices is not None \
        else local_devices("cuda")
    if data is None:
        data = max(1, len(devs) // site)
    need = data * site
    if need > len(devs):
        raise ValueError(f"mesh {data}x{site} needs {need} devices, have "
                         f"{len(devs)}")
    return Mesh([devs[i * site:(i + 1) * site] for i in range(data)])


def _as_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x


def _pad_to(x: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    """Zero rows appended along ``dim`` up to a multiple of ``multiple``:
    a zero row has no member, no active site and length 0, so it is
    inert in every statistic."""
    extra = -x.shape[dim] % multiple
    if not extra:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)],
                     dim=dim)


def split_rows(x, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` (a tensor or numpy array) as contiguous chunks of its leading
    axis, one per device and each on its device, after padding with zero
    rows to a multiple of len(devices)."""
    x = _pad_to(_as_tensor(x), 0, len(devices))
    step = x.shape[0] // len(devices)
    return [x[k * step:(k + 1) * step].to(dev)
            for k, dev in enumerate(devices)]


def split_windows(x, mesh: Mesh) -> List[torch.Tensor]:
    """The counterpart of ``window_sharding``: the leading (window) axis
    split over ``data``, one chunk on each data shard's first device."""
    return split_rows(x, mesh.axis_devices("data"))


def split_sites(x, mesh: Mesh, axis: int) -> List[List[torch.Tensor]]:
    """The counterpart of ``site_sharding``: the window axis split over
    ``data`` and ``axis`` over ``site``; ``[i][j]`` lies on grid[i][j].
    Both axes are padded with zeros (a zero site-mask column is inert)."""
    x = _as_tensor(x)
    d, s = mesh.shape["data"], mesh.shape["site"]
    x = _pad_to(_pad_to(x, 0, d), axis, s)
    wstep, sstep = x.shape[0] // d, x.shape[axis] // s
    return [[x[i * wstep:(i + 1) * wstep].narrow(axis, j * sstep, sstep)
             .to(mesh.grid[i][j]) for j in range(s)] for i in range(d)]


def gather_windows(chunks: Sequence[torch.Tensor],
                   n: Optional[int] = None) -> torch.Tensor:
    """The chunks of :func:`split_windows` (or any per-shard results along
    the window axis) back in window order on the first chunk's device,
    the padding rows dropped when ``n`` is given.  One chunk is returned
    as it is (a view when cut), not copied."""
    dev = chunks[0].device
    out = (chunks[0] if len(chunks) == 1
           else torch.cat([c.to(dev) for c in chunks], dim=0))
    return out if n is None else out[:n]


def _reduce(parts: Sequence[torch.Tensor], op, device=None) -> torch.Tensor:
    dev = parts[0].device if device is None else device
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = op(out, p.to(dev))
    return out


def reduce_sum(parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """``psum``: the partials of one axis summed, in axis order, on the
    first partial's device (or ``device``)."""
    return _reduce(parts, torch.add, device)


def reduce_min(parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """``pmin`` over the partials of one axis."""
    return _reduce(parts, torch.minimum, device)


def reduce_max(parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """``pmax`` over the partials of one axis."""
    return _reduce(parts, torch.maximum, device)

