"""Advective flux-divergence operators.

Counterpart of ``clima_oceananigans_jl_tpu/advection/fluxes.py``
(Oceananigans' momentum and tracer advection operators). Each transport
names the advected field's location, which the conditional fluxes next
to an immersed boundary read.

Staggering (C-grid):
  div_Uc  → (C,C,C)   tracer advection  ∇·(v c)
  div_vu  → (F,C,C)   x-momentum        ∇·(v u)
  div_vv  → (C,F,C)   y-momentum
  div_vw  → (C,C,F)   z-momentum
"""
from __future__ import annotations

from ..ops import stencil as st
from ..utils.location import C, CENTER, F, U_LOC, V_LOC, W_LOC
from .schemes import transport


def div_Uc(grid, scheme, u, v, w, c):
    """Tracer flux divergence at centres:
    1/V [δxᶜ(Ax u c̃ˣ) + δyᶜ(Ay v c̃ʸ) + δzᶜ(Az w c̃ᶻ)]."""
    fx = grid.Ax(U_LOC) * transport(scheme, u, c, 0, True, grid, CENTER)
    fy = grid.Ay(V_LOC) * transport(scheme, v, c, 1, True, grid, CENTER)
    fz = grid.Az(W_LOC) * transport(scheme, w, c, 2, True, grid, CENTER)
    return (st.dxc(fx) + st.dyc(fy) + st.dzc(fz)) / grid.V(CENTER)


def div_vu(grid, scheme, u, v, w, U=None):
    """x-momentum advection ∇·(v u) at (F,C,C); `U` optionally
    carries the advecting velocity (default (u, v, w)), as the background
    cross terms use it."""
    ua, va, wa = U if U is not None else (u, v, w)
    u_cc = st.ixc(ua)          # (C,C,C)
    v_ff = st.ixf(va)          # (F,F,C)
    w_ff = st.ixf(wa)          # (F,C,F)
    fx = grid.Ax(CENTER) * transport(scheme, u_cc, u, 0, False, grid, U_LOC)
    fy = grid.Ay((F, F, C)) * transport(scheme, v_ff, u, 1, True, grid, U_LOC)
    fz = grid.Az((F, C, F)) * transport(scheme, w_ff, u, 2, True, grid, U_LOC)
    return (st.dxf(fx) + st.dyc(fy) + st.dzc(fz)) / grid.V(U_LOC)


def div_vv(grid, scheme, u, v, w, U=None):
    """y-momentum advection ∇·(v v) at (C,F,C); `U` optionally
    carries the advecting velocity (default (u, v, w)), as the background
    cross terms use it."""
    ua, va, wa = U if U is not None else (u, v, w)
    u_ff = st.iyf(ua)          # (F,F,C)
    v_cc = st.iyc(va)          # (C,C,C)
    w_ff = st.iyf(wa)          # (C,F,F)
    fx = grid.Ax((F, F, C)) * transport(scheme, u_ff, v, 0, True, grid, V_LOC)
    fy = grid.Ay(CENTER) * transport(scheme, v_cc, v, 1, False, grid, V_LOC)
    fz = grid.Az((C, F, F)) * transport(scheme, w_ff, v, 2, True, grid, V_LOC)
    return (st.dxc(fx) + st.dyf(fy) + st.dzc(fz)) / grid.V(V_LOC)


def div_vw(grid, scheme, u, v, w, U=None):
    """z-momentum advection ∇·(v w) at (C,C,F); `U` optionally
    carries the advecting velocity (default (u, v, w)), as the background
    cross terms use it."""
    ua, va, wa = U if U is not None else (u, v, w)
    u_ff = st.izf(ua)          # (F,C,F)
    v_ff = st.izf(va)          # (C,F,F)
    w_cc = st.izc(wa)          # (C,C,C)
    fx = grid.Ax((F, C, F)) * transport(scheme, u_ff, w, 0, True, grid, W_LOC)
    fy = grid.Ay((C, F, F)) * transport(scheme, v_ff, w, 1, True, grid, W_LOC)
    fz = grid.Az(CENTER) * transport(scheme, w_cc, w, 2, False, grid, W_LOC)
    return (st.dxc(fx) + st.dyc(fy) + st.dzf(fz)) / grid.V(W_LOC)
