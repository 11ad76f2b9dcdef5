"""Coriolis parameterizations.

Counterpart of ``clima_oceananigans_jl_tpu/coriolis/coriolis.py``
(Oceananigans' ``FPlane`` and ``BetaPlane``): the staggered cross-product
terms ``x_f_cross_U`` at (F,C,C), ``y_f_cross_U`` at (C,F,C) and
``z_f_cross_U`` at (C,C,F), zero under the traditional approximation.
``ConstantCartesianCoriolis``, ``NonTraditionalBetaPlane`` and
``HydrostaticSphericalCoriolis`` are not ported yet; the model refuses
them (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import stencil as st
from ..utils.location import U_LOC, V_LOC


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
