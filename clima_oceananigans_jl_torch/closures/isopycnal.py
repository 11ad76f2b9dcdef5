"""The isopycnal skew-symmetric (GM/Redi) tracer diffusivity.

Counterpart of ``clima_oceananigans_jl_tpu/closures/isopycnal.py``
(Oceananigans' isopycnal_skew_symmetric_diffusivity.jl): the small-slope
Redi rotation tensor and the Gent-McWilliams skew flux,

    Fx = −κR ∂x c − (κR − κGM) Sx ∂z c
    Fy = −κR ∂y c − (κR − κGM) Sy ∂z c
    Fz = −(κR + κGM)(Sx ∂x c + Sy ∂y c) − κR |S|² ∂z c

with the slope S = −∇h b / ∂z b, every slope-dependent term tapered by
``FluxTapering(max_slope)`` (taper = min(1, (max_slope/|S|)²)). The
tracer tendency is −∇·F; momentum is untouched.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import operators as op
from ..ops import stencil as st
from ..utils.location import CENTER, U_LOC, V_LOC, W_LOC


@dataclasses.dataclass(frozen=True)
class FluxTapering:
    max_slope: float = 1e-2


@dataclasses.dataclass(frozen=True)
class IsopycnalSkewSymmetricDiffusivity:
    kappa_skew: float = 1000.0       # κ_GM
    kappa_symmetric: float = 1000.0  # κ_Redi
    slope_limiter: FluxTapering = FluxTapering(1e-2)

    vertically_implicit = False

    def compute_diffusivities(self, grid, fields, buoyancy, tracers):
        """The tapered slope components and |S|² at the centres."""
        b = buoyancy.buoyancy_perturbation(grid, tracers)
        bx = op.interp_to(st.dxf(b) / grid.dx(U_LOC), U_LOC, CENTER)
        by = op.interp_to(st.dyf(b) / grid.dy(V_LOC), V_LOC, CENTER)
        bz = op.interp_to(st.dzf(b) / grid.dz(W_LOC), W_LOC, CENTER)
        bz = torch.where(bz.abs() < 1e-20,
                         torch.full((), 1e-20, dtype=bz.dtype, device=bz.device), bz)
        sx = -bx / bz
        sy = -by / bz
        s2 = sx * sx + sy * sy
        smax = self.slope_limiter.max_slope
        # a tensor numerator: torch's number / tensor is a reciprocal and a
        # product, not a division
        smax2 = torch.full((), smax * smax, dtype=s2.dtype, device=s2.device)
        taper = torch.clamp_max(smax2 / torch.clamp_min(s2, 1e-30), 1.0)
        return dict(slope_x=sx * taper, slope_y=sy * taper,
                    slope2=s2 * taper * taper)

    def nu(self, diffusivities):
        return 0.0

    def kappa_for_tracer(self, name, diffusivities):
        return 0.0  # the rotated fluxes are ``tracer_tendency``'s

    def tracer_tendency(self, c, grid, name, diffusivities):
        kR = self.kappa_symmetric
        kGM = self.kappa_skew
        sx, sy = diffusivities["slope_x"], diffusivities["slope_y"]
        s2 = diffusivities["slope2"]

        dxc = st.dxf(c) / grid.dx(U_LOC)          # ∂x c at (F, C, C)
        dyc = st.dyf(c) / grid.dy(V_LOC)          # (C, F, C)
        dzc = st.dzf(c) / grid.dz(W_LOC)          # (C, C, F)
        dzc_ctr = st.izc(dzc)                     # at the centres
        dxc_ctr = st.ixc(dxc)
        dyc_ctr = st.iyc(dyc)

        fx = -kR * dxc - (kR - kGM) * st.ixf(sx * dzc_ctr)
        fy = -kR * dyc - (kR - kGM) * st.iyf(sy * dzc_ctr)
        fz = (-(kR + kGM) * st.izf(sx * dxc_ctr + sy * dyc_ctr)
              - kR * st.izf(s2) * dzc)

        div = (st.dxc(grid.Ax(U_LOC) * fx)
               + st.dyc(grid.Ay(V_LOC) * fy)
               + st.dzc(grid.Az(W_LOC) * fz)) / grid.V(CENTER)
        return -div
