"""Trilinear interpolation of a with-halo field at arbitrary points.

Counterpart of ``interpolate_field`` in
``clima_oceananigans_jl_tpu/particles/lagrangian.py`` (Oceananigans'
``interpolate``), which ``fields/field.py``'s ``interpolate`` and
``regrid`` call. ``LagrangianParticles`` waits for ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import torch


def _frac_index(coords, q):
    """Left index and fractional weight of ``q`` in the increasing 1D
    coordinate tensor ``coords`` (weight clipped to [0, 1])."""
    if coords.shape[0] == 1:
        return torch.zeros(q.shape, dtype=torch.int64, device=q.device), torch.zeros_like(q)
    i = torch.clamp(torch.searchsorted(coords.contiguous(), q.contiguous(), right=True) - 1,
                    0, coords.shape[0] - 2)
    w = (q - coords[i]) / (coords[i + 1] - coords[i])
    return i, torch.clamp(w, 0.0, 1.0)


def interpolate_field(data, grid, loc, x, y, z):
    """Trilinear interpolation of ``data`` (with halos, at ``loc``) at the
    points (x, y, z), 1D tensors of one length."""
    ix, wx = _frac_index(grid.coord(0, loc[0], with_halo=True), x)
    iy, wy = _frac_index(grid.coord(1, loc[1], with_halo=True), y)
    iz, wz = _frac_index(grid.coord(2, loc[2], with_halo=True), z)

    def g(dx, dy, dz):
        return data[torch.clamp(ix + dx, max=data.shape[0] - 1),
                    torch.clamp(iy + dy, max=data.shape[1] - 1),
                    torch.clamp(iz + dz, max=data.shape[2] - 1)]

    return (
        g(0, 0, 0) * (1 - wx) * (1 - wy) * (1 - wz)
        + g(1, 0, 0) * wx * (1 - wy) * (1 - wz)
        + g(0, 1, 0) * (1 - wx) * wy * (1 - wz)
        + g(1, 1, 0) * wx * wy * (1 - wz)
        + g(0, 0, 1) * (1 - wx) * (1 - wy) * wz
        + g(1, 0, 1) * wx * (1 - wy) * wz
        + g(0, 1, 1) * (1 - wx) * wy * wz
        + g(1, 1, 1) * wx * wy * wz)
