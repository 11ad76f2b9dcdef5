"""Eddy-viscosity LES closures: Smagorinsky-Lilly, AMD, 2D Leith.

Counterpart of ``clima_oceananigans_jl_tpu/closures/eddy_viscosity.py``
(Oceananigans' smagorinsky_lilly.jl, anisotropic_minimum_dissipation.jl,
leith_enstrophy_diffusivity.jl): each closure computes a centre-located
eddy viscosity (and diffusivity) once per step, in ``update_state``
(Oceananigans' ``calculate_diffusivities!``), which ∇·(κ∇c) of
``closures/scalar_diffusivity.py`` interpolates onto the flux faces.

These are eager PyTorch ops, as they are XLA ops in the JAX package (it
has no Pallas kernel for them), in the JAX expression trees and orders of
summation, ``x ** 2`` written ``x * x``. Each gradient is freed as soon as
the sums that read it are formed.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import operators as op
from ..ops import stencil as st
from ..utils.location import CENTER, F, C, U_LOC, V_LOC, W_LOC


def _grad_at_centers(q, grid, q_loc, axis):
    """∂q/∂axis interpolated to cell centres."""
    g = op.dd(q, grid, axis, q_loc)
    g_loc = op.flip_loc(q_loc, axis)
    return op.interp_to(g, g_loc, CENTER)


def velocity_gradients_at_centers(grid, u, v, w):
    """All nine ∂j u_i at centres; a dict keyed by (j, i)."""
    comps = ((u, U_LOC), (v, V_LOC), (w, W_LOC))
    return {(j, i): _grad_at_centers(q, grid, loc, j)
            for j in range(3) for i, (q, loc) in enumerate(comps)}


def strain_rate_squared(G):
    """2 Σ Sij Sij from the centre-located gradient dict."""
    s2 = 0.0
    for i in range(3):
        for j in range(3):
            sij = 0.5 * (G[(j, i)] + G[(i, j)])
            s2 = s2 + 2.0 * sij * sij
    return s2


def brunt_vaisala_centers(grid, buoyancy, tracers):
    """N² at centres, from ∂z b at (C, C, F)."""
    if buoyancy is None:
        return 0.0
    b = buoyancy.buoyancy_perturbation(grid, tracers)
    n2f = st.dzf(b) / grid.dz(W_LOC)
    return st.izc(n2f)


@dataclasses.dataclass(frozen=True)
class SmagorinskyLilly:
    """νₑ = (CΔ)²|S|·ς with Lilly's stratification correction
    ς = √max(0, 1 − Cb N²/(Pr |S|²))."""

    C: float = 0.16
    Cb: float = 1.0
    Pr: float = 1.0
    nu_background: float = 0.0
    kappa_background: float = 0.0

    vertically_implicit = False

    def compute_diffusivities(self, grid, fields, buoyancy, tracers):
        u, v, w = fields["u"], fields["v"], fields["w"]
        G = velocity_gradients_at_centers(grid, u, v, w)
        s2 = strain_rate_squared(G)
        del G
        n2 = brunt_vaisala_centers(grid, buoyancy, tracers)
        vol = torch.pow(grid.V(CENTER), 1.0 / 3.0)
        delta2 = vol * vol
        stab = torch.sqrt(torch.clamp_min(
            1.0 - self.Cb * n2 / (self.Pr * torch.clamp_min(s2, 1e-30)), 0.0))
        nu_e = (self.C ** 2) * delta2 * torch.sqrt(s2) * stab + self.nu_background
        kappa_e = (nu_e - self.nu_background) / self.Pr + self.kappa_background
        return dict(nu_e=nu_e, kappa_e=kappa_e)

    def nu(self, diffusivities):
        return diffusivities["nu_e"]

    def kappa_for_tracer(self, name, diffusivities):
        return diffusivities["kappa_e"]


@dataclasses.dataclass(frozen=True)
class AnisotropicMinimumDissipation:
    """AMD (Rozema et al. 2015, Verstappen), with normalised gradients
    ∂̂k = Δk ∂k:

        νₑ = C max(0, −Σ ∂̂k uᵢ ∂̂k uⱼ Sᵢⱼ + Cb ∂̂z w ∂̂z b) / Σ (∂l um)²
        κₑ = C max(0, −Σ ∂̂k uᵢ ∂̂k c ∂ᵢ c) / |∇c|²
    """

    C: float = 1.0 / 12.0
    Cb: float = 0.0
    nu_background: float = 0.0
    kappa_background: float = 0.0

    vertically_implicit = False

    def compute_diffusivities(self, grid, fields, buoyancy, tracers):
        u, v, w = fields["u"], fields["v"], fields["w"]
        G = velocity_gradients_at_centers(grid, u, v, w)
        deltas = [grid.dx(CENTER), grid.dy(CENTER), grid.dz(CENTER)]
        num = 0.0
        den = 1e-30
        for k in range(3):
            for i in range(3):
                den = den + G[(k, i)] * G[(k, i)]
        for k in range(3):
            dk2 = deltas[k] * deltas[k]
            for i in range(3):
                for j in range(3):
                    sij = 0.5 * (G[(j, i)] + G[(i, j)])
                    num = num - dk2 * G[(k, i)] * G[(k, j)] * sij
        if self.Cb != 0.0 and buoyancy is not None:
            b = buoyancy.buoyancy_perturbation(grid, tracers)
            dzb = _grad_at_centers(b, grid, CENTER, 2)
            num = num + self.Cb * (deltas[2] * deltas[2]) * G[(2, 2)] * dzb
            del b, dzb
        nu_e = self.C * torch.clamp_min(num, 0.0) / den + self.nu_background
        del num, den

        kappas = {}
        for name, c in tracers.items():
            dc = [_grad_at_centers(c, grid, CENTER, a) for a in range(3)]
            numc = 0.0
            denc = 1e-30 + dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2]
            for k in range(3):
                dk2 = deltas[k] * deltas[k]
                for i in range(3):
                    numc = numc - dk2 * G[(k, i)] * dc[k] * dc[i]
            kappas[name] = (self.C * torch.clamp_min(numc, 0.0) / denc
                            + self.kappa_background)
            del dc, numc, denc
        return dict(nu_e=nu_e, kappa_e=kappas)

    def nu(self, diffusivities):
        return diffusivities["nu_e"]

    def kappa_for_tracer(self, name, diffusivities):
        k = diffusivities["kappa_e"]
        return k[name] if isinstance(k, dict) else k


@dataclasses.dataclass(frozen=True)
class TwoDimensionalLeith:
    """νₑ = (C Δ)³ |∇h ζ| (+ C_div³ Δ³ |∇h δ|): the 2D enstrophy-cascade
    closure."""

    C: float = 0.3
    C_div: float = 0.0
    nu_background: float = 0.0

    vertically_implicit = False

    def compute_diffusivities(self, grid, fields, buoyancy, tracers):
        u, v = fields["u"], fields["v"]
        zeta = op.zeta3_ffc(u, v, grid)
        dzx = op.interp_to(op.dd(zeta, grid, 0, (F, F, C)), (C, F, C), CENTER)
        dzy = op.interp_to(op.dd(zeta, grid, 1, (F, F, C)), (F, C, C), CENTER)
        grad_zeta = torch.sqrt(dzx * dzx + dzy * dzy)
        mag = (self.C ** 3) * grad_zeta
        if self.C_div != 0.0:
            div = op.div_xy_ccc(u, v, grid)
            ddx = _grad_at_centers(div, grid, CENTER, 0)
            ddy = _grad_at_centers(div, grid, CENTER, 1)
            mag = mag + (self.C_div ** 3) * torch.sqrt(ddx * ddx + ddy * ddy)
        side = torch.sqrt(grid.Az(CENTER))
        delta3 = side * side * side
        nu_e = delta3 * mag + self.nu_background
        return dict(nu_e=nu_e, kappa_e=nu_e)

    def nu(self, diffusivities):
        return diffusivities["nu_e"]

    def kappa_for_tracer(self, name, diffusivities):
        return diffusivities["kappa_e"]
