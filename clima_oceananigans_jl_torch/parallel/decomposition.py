"""Domain decomposition: a global grid cut into one local grid per shard.

Counterpart of ``clima_oceananigans_jl_tpu/parallel/decomposition.py``
(Oceananigans' distributed grids): the global grid is sliced into
identical local grids whose cut axes are ``FULLY_CONNECTED`` and carry
``dist = (mesh_axis, n_shards, global_topology)``; the halo fills turn
that into the neighbour exchange of ``parallel/halo_exchange.py``. Each
local axis is the global axis' with-halo arrays sliced at the shard's
window, so coordinates and metrics are the global ones. An
``ImmersedGrid`` partitions its parent and slices its masks (and
partial-cell Δz) with the same windows. Where JAX assembles the shards'
leaves into stacked arrays for ``shard_map``, the port keeps a list of
local grids in rank order (shard (i, j) is rank i·Ry + j), each on its
shard's device.

``scatter_array`` cuts a global with-halo array into the shards'
with-halo blocks (halos included, as the JAX function does);
``gather_array`` stitches the blocks' interiors back, with the halos of
the blocks at the global edges.
"""
from __future__ import annotations

import dataclasses

import torch

from ..grids.latlon import LatitudeLongitudeGrid
from ..grids.rectilinear import _Axis
from ..grids.topology import FULLY_CONNECTED


def _to(t, device):
    return t if t.device == device else t.to(device)


def _slice_axis(ax, i, n_loc, n_shards, device):
    """The local axis of shard ``i`` along a cut axis (its arrays sliced
    with their halos)."""
    sl = slice(i * n_loc, i * n_loc + n_loc + 2 * ax.h)
    topo = FULLY_CONNECTED if n_shards > 1 else ax.topo
    extent = ax.extent / n_shards  # the same float on every shard
    return _Axis(n_loc, ax.h, topo, *(_to(a[sl], device)
                                      for a in (ax.cf, ax.cc, ax.dc, ax.df)),
                 ax.regular, extent)


def _windows(grid, mesh_shape, i, j):
    """The with-halo x and y windows of shard (i, j)."""
    Rx, Ry = mesh_shape
    nxl, nyl = grid.Nx // Rx, grid.Ny // Ry
    return (slice(i * nxl, i * nxl + nxl + 2 * grid.Hx),
            slice(j * nyl, j * nyl + nyl + 2 * grid.Hy))


def _cut_boundary(boundary, sx, sy, device):
    """An immersed boundary's 3D tensors sliced at a shard's windows."""
    cut = {}
    for f in dataclasses.fields(boundary):
        v = getattr(boundary, f.name)
        if isinstance(v, torch.Tensor) and v.ndim == 3:
            v = _to(v[sx if v.shape[0] > 1 else slice(None),
                      sy if v.shape[1] > 1 else slice(None)].contiguous(), device)
        cut[f.name] = v
    return dataclasses.replace(boundary, **cut)


def partition_grid(grid, mesh_shape, devices=None):
    """The local grids of an (Rx, Ry) mesh, in rank order, each on its
    shard's device (``devices``, rank order; default the grid's)."""
    from ..immersed.immersed import ImmersedGrid
    imm = grid if isinstance(grid, ImmersedGrid) else None
    gp = grid.parent if imm is not None else grid
    Rx, Ry = mesh_shape
    if gp.Nx % max(Rx, 1) or gp.Ny % max(Ry, 1):
        raise ValueError(f"grid {gp.shape} not divisible by mesh {tuple(mesh_shape)}")
    nxl, nyl = gp.Nx // Rx, gp.Ny // Ry
    for n, nl, h in ((Rx, nxl, gp.Hx), (Ry, nyl, gp.Hy)):
        if n > 1 and nl < h:
            raise ValueError(f"a shard of {nl} cells is narrower than its halo "
                             f"of {h} along a cut axis")
    dist = (("x", Rx, gp.topology[0]) if Rx > 1 else None,
            ("y", Ry, gp.topology[1]) if Ry > 1 else None,
            None)
    devices = ([gp.device] * (Rx * Ry) if devices is None
               else [torch.device(d) for d in devices])

    def local(i, j):
        device = devices[i * Ry + j]
        new = object.__new__(type(gp))
        new._set_dtype_device(gp.dtype, device)
        new.dist = dist
        az = gp._axes[2]
        new._axes = (
            _slice_axis(gp._axes[0], i, nxl, Rx, device),
            _slice_axis(gp._axes[1], j, nyl, Ry, device),
            _Axis(az.n, az.h, az.topo, *(_to(a, device) for a in
                                          (az.cf, az.cc, az.dc, az.df)),
                  az.regular, az.extent),
        )
        new._init_static()
        sx, sy = _windows(gp, mesh_shape, i, j)
        if isinstance(gp, LatitudeLongitudeGrid):
            new.radius = gp.radius
            pick = lambda m: {k: _to(v[sx if v.shape[0] > 1 else slice(None),
                                       sy if v.shape[1] > 1 else slice(None)],
                                     device) for k, v in m.items()}
            new._dx_m = pick(gp._dx_m)
            new._az_m = pick(gp._az_m)
            new._dy_m = pick(gp._dy_m)
        if imm is not None:
            return ImmersedGrid.wrap(new, _cut_boundary(imm.boundary, sx, sy, device))
        return new

    return [local(i, j) for i in range(Rx) for j in range(Ry)]


def scatter_array(arr, grid, mesh_shape, devices=None):
    """A global with-halo array → the shards' with-halo blocks (rank
    order, each contiguous on its shard's device). An array with fewer
    than 2 axes is given to every shard as it is; an axis of extent 1
    (a broadcast plane) is not cut."""
    Rx, Ry = mesh_shape
    n = Rx * Ry
    devices = [arr.device] * n if devices is None else [torch.device(d) for d in devices]
    if arr.ndim < 2:
        return [_to(arr, d) for d in devices]
    out = []
    for i in range(Rx):
        for j in range(Ry):
            sx, sy = _windows(grid, mesh_shape, i, j)
            blk = arr[sx if arr.shape[0] > 1 else slice(None),
                      sy if arr.shape[1] > 1 else slice(None)]
            out.append(blk.to(devices[i * Ry + j], copy=True,
                              memory_format=torch.contiguous_format))
    return out


def gather_array(blocks, grid, mesh_shape):
    """The shards' with-halo blocks (rank order) → the global with-halo
    array: every block's interior, with the halos of the blocks at the
    global edges, on the first block's device."""
    Rx, Ry = mesh_shape
    b0 = blocks[0]
    if b0.ndim < 2:
        return b0
    Hx, Hy = grid.Hx, grid.Hy
    x_blocked, y_blocked = b0.shape[0] > 1, b0.shape[1] > 1
    rows = []
    for i in range(Rx if x_blocked else 1):
        cols = []
        for j in range(Ry if y_blocked else 1):
            blk = _to(blocks[i * Ry + j], b0.device)
            x0 = 0 if (i == 0 or not x_blocked) else Hx
            x1 = blk.shape[0] if (i == Rx - 1 or not x_blocked) else blk.shape[0] - Hx
            y0 = 0 if (j == 0 or not y_blocked) else Hy
            y1 = blk.shape[1] if (j == Ry - 1 or not y_blocked) else blk.shape[1] - Hy
            cols.append(blk[x0:x1, y0:y1])
        rows.append(torch.cat(cols, dim=1) if y_blocked else cols[0])
    return torch.cat(rows, dim=0) if x_blocked else rows[0]
