"""Stokes drift: the Craik-Leibovich vortex-force terms of surface waves.

Counterpart of ``clima_oceananigans_jl_tpu/stokes_drift.py``
(Oceananigans' ``UniformStokesDrift``): user profiles ∂z uˢ(z, t),
∂z vˢ(z, t), ∂t uˢ(z, t) and ∂t vˢ(z, t); the curl(Uˢ)×U terms are
whole-array interpolations weighted by the profiles on the grid's with-halo
z coordinates. A profile takes (z, t) with z a (1, 1, Z) tensor and
returns something that broadcasts with it.
"""
from __future__ import annotations

import dataclasses

import torch

from .ops import stencil as st
from .utils.location import C, F


def _zero(z, t):
    return torch.zeros_like(z)


@dataclasses.dataclass(frozen=True)
class UniformStokesDrift:
    dz_us: callable = _zero    # ∂z uˢ(z, t)
    dz_vs: callable = _zero
    dt_us_fn: callable = _zero  # ∂t uˢ(z, t)
    dt_vs_fn: callable = _zero

    def _zc(self, grid):
        return grid.coord(2, C, with_halo=True).reshape(1, 1, -1)

    def _zf(self, grid):
        return grid.coord(2, F, with_halo=True).reshape(1, 1, -1)

    def x_curl_Us_cross_U(self, grid, u, v, w, t):
        """ℑxzᶠᵃᶜ(w) ∂z uˢ at (F, C, C)."""
        return st.ixf(st.izc(w)) * self.dz_us(self._zc(grid), t)

    def y_curl_Us_cross_U(self, grid, u, v, w, t):
        return st.iyf(st.izc(w)) * self.dz_vs(self._zc(grid), t)

    def z_curl_Us_cross_U(self, grid, u, v, w, t):
        zf = self._zf(grid)
        return (-st.ixc(st.izf(u)) * self.dz_us(zf, t)
                - st.iyc(st.izf(v)) * self.dz_vs(zf, t))

    def dt_us(self, grid, t):
        return self.dt_us_fn(self._zc(grid), t)

    def dt_vs(self, grid, t):
        return self.dt_vs_fn(self._zc(grid), t)

    def dt_ws(self, grid, t):
        return torch.zeros((1, 1, 1), dtype=grid.dtype, device=grid.device)
