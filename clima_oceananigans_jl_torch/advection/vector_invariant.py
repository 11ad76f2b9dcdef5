"""Vector-invariant (rotational-form) momentum advection.

Counterpart of ``clima_oceananigans_jl_tpu/advection/vector_invariant.py``
(Oceananigans' vector_invariant_advection.jl), in the JAX expression
trees:

    U·∇u = −ζ₃·v̂ + w∂z(u)-term + ∂x K,   K = (ū²ˣ + v̄²ʸ)/2

with the vorticity term discretised energy- or enstrophy-conserving, or
by a select-first WENO5 reconstruction of ζ₃ along the transport
direction with ζ₃'s own smoothness ("weno") or the mean smoothness of
the tangential velocities ℑy u and ℑx v ("weno_velocity", Oceananigans'
VelocityStencil). Plain torch ops; no kernel runs here.
"""
from __future__ import annotations

import dataclasses

from ..ops import stencil as st
from ..ops.operators import zeta3_ffc
from ..utils.location import C, F, U_LOC, V_LOC
from .schemes import WENO5, upwind_stream

SCHEMES = ("enstrophy", "energy", "weno", "weno_velocity")


@dataclasses.dataclass(frozen=True)
class VectorInvariant:
    """``scheme``: one of ``SCHEMES`` ("enstrophy" by default)."""

    scheme: str = "enstrophy"

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown vector-invariant scheme {self.scheme!r}")

    @property
    def required_halo(self):
        return 3 if self.scheme in ("weno", "weno_velocity") else 2

    def _weno_vorticity(self, zeta, vel, u, v, axis):
        """vel · (select-first WENO5 reconstruction of ζ₃ onto centres
        along ``axis``)."""
        sel = vel >= 0
        az = upwind_stream(zeta, sel, axis, False)
        if self.scheme == "weno_velocity":
            smooths = (st.iyf(u), st.ixf(v))  # tangential velocities at (F, F)
            ss = [upwind_stream(f, sel, axis, False) for f in smooths]
            return vel * WENO5().stream_reconstruct_smooth(az, ss)
        return vel * WENO5().stream_reconstruct(az)

    def U_dot_grad_u(self, grid, u, v, w):
        """U·∇u at (F, C, C)."""
        zeta = zeta3_ffc(u, v, grid)
        dx_v = grid.dx((C, F, C)) * v
        if self.scheme == "energy":
            vort = -st.iyc(zeta * st.ixf(dx_v)) / grid.dx(U_LOC)
        elif self.scheme in ("weno", "weno_velocity"):
            v_hat = st.ixf(st.iyc(dx_v)) / grid.dx(U_LOC)
            vort = -self._weno_vorticity(zeta, v_hat, u, v, 1)
        else:
            vort = -st.iyc(zeta) * st.ixf(st.iyc(dx_v)) / grid.dx(U_LOC)
        # vertical advection: ℑzᶜ(ℑxᶠ(Az w) ∂zᶠᶜᶠ u) / Azᶠᶜᶜ
        az_w = grid.Az((C, C, F)) * w
        dz_u = st.dzf(u) / grid.dz((F, C, F))
        vadv = st.izc(st.ixf(az_w) * dz_u) / grid.Az(U_LOC)
        K = 0.5 * (st.ixc(u * u) + st.iyc(v * v))
        bern = st.dxf(K) / grid.dx(U_LOC)
        return vort + vadv + bern

    def U_dot_grad_v(self, grid, u, v, w):
        """U·∇v at (C, F, C)."""
        zeta = zeta3_ffc(u, v, grid)
        dy_u = grid.dy((F, C, C)) * u
        if self.scheme == "energy":
            vort = st.ixc(zeta * st.iyf(dy_u)) / grid.dy(V_LOC)
        elif self.scheme in ("weno", "weno_velocity"):
            u_hat = st.iyf(st.ixc(dy_u)) / grid.dy(V_LOC)
            vort = self._weno_vorticity(zeta, u_hat, u, v, 0)
        else:
            vort = st.ixc(zeta) * st.iyf(st.ixc(dy_u)) / grid.dy(V_LOC)
        az_w = grid.Az((C, C, F)) * w
        dz_v = st.dzf(v) / grid.dz((C, F, F))
        vadv = st.izc(st.iyf(az_w) * dz_v) / grid.Az(V_LOC)
        K = 0.5 * (st.ixc(u * u) + st.iyc(v * v))
        bern = st.dyf(K) / grid.dy(V_LOC)
        return vort + vadv + bern
