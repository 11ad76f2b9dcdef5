"""Lagrangian particle tracking.

Counterpart of ``clima_oceananigans_jl_tpu/particles/lagrangian.py``
(Oceananigans' LagrangianParticleTracking): ``interpolate_field``, the
trilinear interpolation of a with-halo field at arbitrary points (which
``fields/field.py``'s ``interpolate`` and ``regrid`` also call), and
``LagrangianParticles``, a batch of particles as 1D tensors advected by
forward Euler on the trilinearly interpolated staggered velocities, one
vectorised gather over the batch. Periodic axes wrap (``torch.remainder``,
the floor modulo of ``jnp.mod``: both take the remainder of ``fmod`` and
add the divisor where its sign differs, exactly); walls reflect a
particle with the ``restitution`` coefficient, then clip it into the
domain. Tracked fields are sampled onto per-particle properties at the
new positions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..grids.topology import FLAT, PERIODIC
from ..utils.location import CENTER, U_LOC, V_LOC, W_LOC


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


@dataclasses.dataclass
class LagrangianParticles:
    """Particle positions ``x``, ``y``, ``z`` (1D tensors of one length),
    per-particle ``properties`` (a dict of 1D tensors), the walls'
    ``restitution`` and the names of the fields each step samples into
    ``properties`` (``tracked_fields``)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    properties: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    restitution: float = 1.0
    tracked_fields: Tuple[str, ...] = ()

    def __len__(self):
        return self.x.shape[0]

    def _apply_boundaries(self, q, grid, axis):
        ax = grid._axes[axis]
        if ax.topo is FLAT:
            return q
        lo = ax.cf[ax.h]
        hi = lo + ax.extent
        if ax.topo is PERIODIC:
            return lo + torch.remainder(q - lo, ax.extent)
        # bounded: reflection damped by restitution, then clipped
        e = self.restitution
        q = torch.where(q < lo, lo + e * (lo - q), q)
        q = torch.where(q > hi, hi - e * (q - hi), q)
        return torch.minimum(torch.maximum(q, lo), hi)

    def step(self, grid, velocities, dt, fields=None):
        """Forward Euler on the trilinearly sampled u, v, w (w zero where
        ``velocities`` has none), the periodic and wall boundaries, then
        the tracked fields sampled at the new positions; returns new
        particles."""
        u = interpolate_field(velocities["u"], grid, U_LOC, self.x, self.y, self.z)
        v = interpolate_field(velocities["v"], grid, V_LOC, self.x, self.y, self.z)
        w = (interpolate_field(velocities["w"], grid, W_LOC, self.x, self.y, self.z)
             if "w" in velocities else torch.zeros_like(u))
        x = self._apply_boundaries(self.x + dt * u, grid, 0)
        y = self._apply_boundaries(self.y + dt * v, grid, 1)
        z = self._apply_boundaries(self.z + dt * w, grid, 2)
        props = dict(self.properties)
        if fields:
            for name in self.tracked_fields:
                if name in fields:
                    props[name] = interpolate_field(fields[name], grid, CENTER,
                                                    x, y, z)
        return LagrangianParticles(x, y, z, props, self.restitution,
                                   self.tracked_fields)
