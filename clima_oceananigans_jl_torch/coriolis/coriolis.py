"""Coriolis parameterizations.

Counterpart of ``clima_oceananigans_jl_tpu/coriolis/coriolis.py``
(Oceananigans' ``FPlane``, ``BetaPlane``, ``ConstantCartesianCoriolis``
and ``NonTraditionalBetaPlane``): the staggered cross-product terms
``x_f_cross_U`` at (F,C,C), ``y_f_cross_U`` at (C,F,C) and
``z_f_cross_U`` at (C,C,F), zero under the traditional approximation,
and ``HydrostaticSphericalCoriolis`` (f = 2Ω sin φ at the vorticity
points of a lat-lon grid) for the hydrostatic model. The nonhydrostatic
model adds the two non-traditional forms as PyTorch terms beside the
kernels (its general branch, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import stencil as st
from ..utils.location import C, F, U_LOC, V_LOC, W_LOC


@dataclasses.dataclass(frozen=True)
class FPlane:
    """f-plane: f = 2Ω sin(φ) constant."""

    f: float = 0.0

    def x_f_cross_U(self, grid, u, v, w):
        return -self.f * st.ixf(st.iyc(v))   # −f v̄ˣʸ at (F,C,C)

    def y_f_cross_U(self, grid, u, v, w):
        return self.f * st.iyf(st.ixc(u))    # +f ūˣʸ at (C,F,C)

    def z_f_cross_U(self, grid, u, v, w):
        return torch.zeros_like(w)


@dataclasses.dataclass(frozen=True)
class BetaPlane:
    """β-plane: f = f₀ + βy."""

    f0: float = 0.0
    beta: float = 0.0

    def _f(self, grid, loc):
        y = grid.nodes(loc, with_halo=True)[1]
        return self.f0 + self.beta * y

    def x_f_cross_U(self, grid, u, v, w):
        return -self._f(grid, U_LOC) * st.ixf(st.iyc(v))

    def y_f_cross_U(self, grid, u, v, w):
        return self._f(grid, V_LOC) * st.iyf(st.ixc(u))

    def z_f_cross_U(self, grid, u, v, w):
        return torch.zeros_like(w)


@dataclasses.dataclass(frozen=True)
class ConstantCartesianCoriolis:
    """The full rotation vector (fx, fy, fz): f⃗ × u⃗ with all three
    components kept (the non-traditional terms)."""

    fx: float = 0.0
    fy: float = 0.0
    fz: float = 0.0

    def x_f_cross_U(self, grid, u, v, w):
        return self.fy * st.ixf(st.izc(w)) - self.fz * st.ixf(st.iyc(v))

    def y_f_cross_U(self, grid, u, v, w):
        return self.fz * st.iyf(st.ixc(u)) - self.fx * st.iyf(st.izc(w))

    def z_f_cross_U(self, grid, u, v, w):
        return self.fx * st.izf(st.iyc(v)) - self.fy * st.izf(st.ixc(u))


@dataclasses.dataclass(frozen=True)
class NonTraditionalBetaPlane:
    """Non-traditional β-plane: fz = fz0 + βy and the horizontal
    component fy = fy0 + γy (2Ω cos φ₀ with its β-correction)."""

    fz0: float = 0.0
    fy0: float = 0.0
    beta: float = 0.0
    gamma: float = 0.0

    def _fz(self, grid, loc):
        y = grid.nodes(loc, with_halo=True)[1]
        return self.fz0 + self.beta * y

    def _fy(self, grid, loc):
        y = grid.nodes(loc, with_halo=True)[1]
        return self.fy0 + self.gamma * y

    def x_f_cross_U(self, grid, u, v, w):
        return (self._fy(grid, U_LOC) * st.ixf(st.izc(w))
                - self._fz(grid, U_LOC) * st.ixf(st.iyc(v)))

    def y_f_cross_U(self, grid, u, v, w):
        return self._fz(grid, V_LOC) * st.iyf(st.ixc(u))

    def z_f_cross_U(self, grid, u, v, w):
        return -self._fy(grid, W_LOC) * st.izf(st.ixc(u))


@dataclasses.dataclass(frozen=True)
class HydrostaticSphericalCoriolis:
    """f = 2Ω sin φ with f at the vorticity points (F, F, ·) of a lat-lon
    grid (Oceananigans' hydrostatic_spherical_coriolis.jl). ``scheme``:
    "energy" (f·ℑv averaged together, energy-conserving under
    vector-invariant advection) or "enstrophy" (f averaged apart from the
    doubly averaged transport)."""

    rotation_rate: float = 7.292115e-5  # Ω of the Earth, 1/s
    scheme: str = "energy"

    def __post_init__(self):
        if self.scheme not in ("energy", "enstrophy"):
            raise ValueError(f"unknown Coriolis scheme {self.scheme!r}")

    def f_ff(self, grid):
        """f at (F, F) over the with-halo latitude axis, shape (1, Y, 1)."""
        phi_f = grid.nodes((F, F, C), with_halo=True)[1]
        return 2.0 * self.rotation_rate * torch.sin(math.pi / 180.0 * phi_f)

    def x_f_cross_U(self, grid, u, v, w):
        f = self.f_ff(grid)
        dxv = grid.dx((C, F, C)) * v
        if self.scheme == "enstrophy":
            return -st.iyc(f) * st.ixf(st.iyc(dxv)) / grid.dx(U_LOC)
        return -st.iyc(f * st.ixf(dxv)) / grid.dx(U_LOC)

    def y_f_cross_U(self, grid, u, v, w):
        f = self.f_ff(grid)
        dyu = grid.dy((F, C, C)) * u
        if self.scheme == "enstrophy":
            return st.ixc(f) * st.iyf(st.ixc(dyu)) / grid.dy(V_LOC)
        return st.ixc(f * st.iyf(dyu)) / grid.dy(V_LOC)

    def z_f_cross_U(self, grid, u, v, w):
        return torch.zeros_like(w)
