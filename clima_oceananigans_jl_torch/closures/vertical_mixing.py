"""Vertical boundary-layer mixing: convective adjustment, Ri-based mixing
and CATKE.

Counterpart of ``clima_oceananigans_jl_tpu/closures/vertical_mixing.py``
(Oceananigans' convective_adjustment_vertical_diffusivity.jl,
ri_based_vertical_diffusivity.jl and CATKEVerticalDiffusivities/), in the
JAX expression trees: each closure computes vertical diffusivities at
(C, C, F) from the state once a step (``compute_diffusivities``, in the
models' ``update_state``), which the implicit vertical diffusion
(``implicit_vertical_diffusion.py``, T1 on the card) takes by default.
CATKE adds a prognostic turbulent kinetic energy ``e`` with shear
production, buoyancy flux and dissipation (``tke_tendency``); its
dissipation enters the column solve as a linear coefficient Lᵉ.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops import stencil as st
from ..utils.location import C, F, W_LOC


def _full(x, like):
    """The number ``x`` as a 0-d tensor of ``like``'s dtype and device."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _where(cond, a, b, like):
    """``torch.where`` with numbers as 0-d tensors of ``like``'s type."""
    a = a if isinstance(a, torch.Tensor) else _full(a, like)
    b = b if isinstance(b, torch.Tensor) else _full(b, like)
    return torch.where(cond, a, b)


def buoyancy_gradient_faces(grid, buoyancy, tracers):
    """N² = ∂z b at (C, C, F)."""
    b = buoyancy.buoyancy_perturbation(grid, tracers)
    return st.dzf(b) / grid.dz(W_LOC)


def shear_squared_faces(grid, u, v):
    """S² = ℑxᶜ[(∂zᶠᶜᶠ u)²] + ℑyᶜ[(∂zᶜᶠᶠ v)²] at (C, C, F): the gradients
    squared before the horizontal interpolation."""
    dzu = st.dzf(u) / grid.dz((F, C, F))
    dzv = st.dzf(v) / grid.dz((C, F, F))
    return st.ixc(dzu * dzu) + st.iyc(dzv * dzv)


@dataclasses.dataclass(frozen=True)
class ConvectiveAdjustmentVerticalDiffusivity:
    """κz = κ_convective where N² < 0, else κ_background."""

    convective_kappa_z: float = 1.0
    convective_nu_z: float = 0.0
    background_kappa_z: float = 1e-5
    background_nu_z: float = 1e-5
    time_discretization: str = "vertically_implicit"

    @property
    def vertically_implicit(self):
        return self.time_discretization == "vertically_implicit"

    def compute_diffusivities(self, grid, fields, buoyancy, tracers):
        n2 = buoyancy_gradient_faces(grid, buoyancy, tracers)
        unstable = n2 < 0
        kz = _where(unstable, self.convective_kappa_z, self.background_kappa_z, n2)
        nz = _where(unstable, self.convective_nu_z, self.background_nu_z, n2)
        return dict(kappa_z=kz, nu_z=nz)

    def nu(self, diffusivities):
        return 0.0  # no horizontal part

    def kappa_for_tracer(self, name, diffusivities):
        return 0.0

    def vertical_nu(self, diffusivities):
        return diffusivities["nu_z"]

    def vertical_kappa(self, name, diffusivities):
        return diffusivities["kappa_z"]


@dataclasses.dataclass(frozen=True)
class RiBasedVerticalDiffusivity:
    """κz = κ₀ + κᶜ·step(Ri), Ri = N²/S², a smooth step from 1 (Ri ≤ 0) to
    0 (Ri ≥ Ri_c)."""

    nu_0: float = 0.7
    kappa_0: float = 0.5
    Ri_0: float = 0.1
    Ri_delta: float = 0.4
    background_kappa_z: float = 1e-5
    background_nu_z: float = 1e-5
    time_discretization: str = "vertically_implicit"

    @property
    def vertically_implicit(self):
        return self.time_discretization == "vertically_implicit"

    def _step(self, ri):
        return 0.5 * (1.0 - torch.tanh((ri - self.Ri_0) / self.Ri_delta))

    def compute_diffusivities(self, grid, fields, buoyancy, tracers):
        n2 = buoyancy_gradient_faces(grid, buoyancy, tracers)
        s2 = shear_squared_faces(grid, fields["u"], fields["v"])
        ri = n2 / torch.clamp_min(s2, 1e-30)
        stepf = self._step(ri)
        kz = self.background_kappa_z + self.kappa_0 * stepf
        nz = self.background_nu_z + self.nu_0 * stepf
        return dict(kappa_z=kz, nu_z=nz)

    def nu(self, diffusivities):
        return 0.0

    def kappa_for_tracer(self, name, diffusivities):
        return 0.0

    def vertical_nu(self, diffusivities):
        return diffusivities["nu_z"]

    def vertical_kappa(self, name, diffusivities):
        return diffusivities["kappa_z"]


@dataclasses.dataclass(frozen=True)
class MixingLength:
    """CATKE's mixing-length parameters, the LES-calibrated defaults
    (Oceananigans' CATKEVerticalDiffusivities/mixing_length.jl).

    The length of φ ∈ {u (momentum), c (tracers), e (TKE)} combines a
    grid-spacing length ℓᵟ = Cᵟφ Δz, a convective length
    ℓᴬ = Cᴬφ e^{3/2}/Qᵇ (while N² < 0 and Qᵇ > 0) and a stable length
    ℓ★ = σφ(Ri)·min(d, Cᵇφ √e/N, Cˢφ √e/S), with the stability scale
    σ = σ⁻ + rσ·(1 + tanh((Ri−Riᶜ)/Riʷ)).
    """

    Cb: float = float("inf")    # Cᵇ global cap (inert default)
    Cs: float = float("inf")    # Cˢ global cap (inert default)
    Cb_u: float = 1.55
    Cb_c: float = 0.01
    Cb_e: float = 0.60
    Cs_u: float = 5.1
    Cs_c: float = 4.3
    Cs_e: float = 1.49
    Cd_u: float = 0.5           # Cᵟu
    Cd_c: float = 0.5
    Cd_e: float = 0.5
    Ca_u: float = 0.0           # Cᴬu (convective)
    Ca_c: float = 0.0
    Ca_e: float = 0.0
    Cas_u: float = 0.0          # Cᴬˢu (sheared-convection correction)
    Cas_c: float = 0.0
    Cas_e: float = 0.0
    Ck_u_lo: float = 0.14       # Cᴷu⁻
    Ck_u_r: float = 0.1         # Cᴷuʳ
    Ck_c_lo: float = 0.35
    Ck_c_r: float = 0.05
    Ck_e_lo: float = 0.49
    Ck_e_r: float = 17.0
    Ck_Ri_w: float = 30.0       # CᴷRiʷ
    Ck_Ri_c: float = 1.1        # CᴷRiᶜ


@dataclasses.dataclass(frozen=True)
class SurfaceTKEFlux:
    """Surface TKE flux parameters: Qᵉ = −Cᴰ (Cᵂu★ u★³ + CᵂwΔ w★³)."""

    Cw_u: float = 0.01   # Cᵂu★
    Cw_w: float = 40.0   # CᵂwΔ


@dataclasses.dataclass(frozen=True)
class CATKEVerticalDiffusivity:
    """CATKE: a prognostic TKE ``e`` with the mixing lengths of
    ``MixingLength`` and diffusivities at (C, C, F)

        Kᵘ = ℓu √e⁺,  Kᶜ = ℓc √e⁺,  Kᵉ = ℓe √e⁺,

    the TKE tendency ∂t e += Kᵘ S² − Kᶜ N² − Cᴰ e^{3/2}/ℓe + surface flux,
    the dissipation vertically implicit through the linear coefficient
    Lᵉ = −Cᴰ √|e| / ℓe of the column solve, and the surface TKE flux
    Qᵉ = −Cᴰ(Cᵂu★ u★³ + CᵂwΔ w★³) from the surface fluxes.

    ``surface_momentum_flux`` is a (Qu, Qv) pair and
    ``surface_buoyancy_flux`` Qᵇ (> 0 destabilising); each entry a number
    or an (x, y) with-halo array. The model adds ``e`` to its tracers
    (``required_tracers``).
    """

    C_diss: float = 0.81  # Cᴰ
    mixing_length: MixingLength = MixingLength()
    surface_tke_flux: SurfaceTKEFlux = SurfaceTKEFlux()
    surface_momentum_flux: Any = None   # (Qu, Qv) kinematic stress
    surface_buoyancy_flux: Any = None   # Qᵇ
    min_tke: float = 1e-12
    background_kappa_z: float = 1e-5
    background_nu_z: float = 1e-5
    time_discretization: str = "vertically_implicit"

    required_tracers = ("e",)

    @property
    def vertically_implicit(self):
        return self.time_discretization == "vertically_implicit"

    # -- pieces ---------------------------------------------------------
    def _wall_distance(self, grid):
        """min(depth below the surface, height above the bottom) at
        (C, C, F)."""
        zf = grid.coord(2, F, with_halo=True).reshape(1, 1, -1)
        z_top = grid._axes[2].cf[grid.Hz + grid.Nz]
        z_bot = grid._axes[2].cf[grid.Hz]
        return torch.clamp_min(torch.minimum(z_top - zf, zf - z_bot), 0.0)

    def _stability_scale(self, ri, lo, r):
        ml = self.mixing_length
        stp = 1.0 + torch.tanh((ri - ml.Ck_Ri_c) / ml.Ck_Ri_w)
        return lo + r * stp

    def _qb(self, grid, like):
        qb = self.surface_buoyancy_flux
        if qb is None:
            return None
        return torch.as_tensor(qb, dtype=like.dtype, device=like.device)

    def _convective_length(self, grid, Ca, Cas, e_plus, s, n2, qb):
        """ℓʰ = Cᴬ e⁺^{3/2}/Qᵇ (1 − Cᴬˢ α) while convecting."""
        if Ca == 0.0 or qb is None:
            return None
        qb = torch.clamp_min(qb, 1e-30)
        alpha = s * qb / torch.clamp_min(e_plus, self.min_tke)
        ell_a = e_plus ** 1.5 / qb
        ell_h = Ca * ell_a * (1.0 - Cas * alpha)
        convecting = (n2 < 0) & (qb > 0) & (e_plus > 0)
        return _where(convecting, ell_h, 0.0, ell_h)

    def _lengths(self, grid, e, u, v, buoyancy, tracers):
        """ℓu, ℓc, ℓe at (C, C, F), and N², S², √e⁺."""
        ml = self.mixing_length
        e_plus = st.izf(torch.clamp_min(e, 0.0))            # ℑz e⁺
        sqrt_e = torch.sqrt(torch.clamp_min(e_plus, 0.0))
        n2 = buoyancy_gradient_faces(grid, buoyancy, tracers)
        s2 = shear_squared_faces(grid, u, v)
        s = torch.sqrt(s2)
        n_plus = torch.sqrt(torch.clamp_min(n2, 0.0))
        ri = _where(n2 == 0.0, 0.0, n2 / torch.clamp_min(s2, 1e-30), n2)
        big = _full(3.0e38, e_plus)
        ell_b = torch.where(n_plus > 0, sqrt_e / torch.clamp_min(n_plus, 1e-30), big)
        ell_s = torch.where(s > 0, sqrt_e / torch.clamp_min(s, 1e-30), big)
        d = self._wall_distance(grid)
        dz = torch.broadcast_to(grid.dz(W_LOC), e_plus.shape)
        qb = self._qb(grid, e_plus)

        def length(Cb, Cs, Cd, Ca, Cas, lo, r, use_conv=True):
            l_star = torch.minimum(d, torch.minimum(
                min(ml.Cb, Cb) * ell_b, min(ml.Cs, Cs) * ell_s))
            sig = self._stability_scale(ri, lo, r)
            base = sig * torch.maximum(Cd * dz, l_star)
            if use_conv:
                lh = self._convective_length(grid, Ca, Cas, e_plus, s, n2, qb)
                if lh is not None:
                    base = torch.maximum(lh, base)
            return base

        # momentum has no convective length
        ell_u = length(ml.Cb_u, ml.Cs_u, ml.Cd_u, ml.Ca_u, ml.Cas_u,
                       ml.Ck_u_lo, ml.Ck_u_r, use_conv=False)
        ell_c = length(ml.Cb_c, ml.Cs_c, ml.Cd_c, ml.Ca_c, ml.Cas_c,
                       ml.Ck_c_lo, ml.Ck_c_r)
        ell_e = length(ml.Cb_e, ml.Cs_e, ml.Cd_e, ml.Ca_e, ml.Cas_e,
                       ml.Ck_e_lo, ml.Ck_e_r)
        return ell_u, ell_c, ell_e, n2, s2, sqrt_e

    # -- protocol --------------------------------------------------------
    def compute_diffusivities(self, grid, fields, buoyancy, tracers):
        e = tracers["e"]
        ell_u, ell_c, ell_e, n2, s2, sqrt_e = self._lengths(
            grid, e, fields["u"], fields["v"], buoyancy, tracers)
        Ku = ell_u * sqrt_e + self.background_nu_z
        Kc = ell_c * sqrt_e + self.background_kappa_z
        Ke = ell_e * sqrt_e + self.background_kappa_z
        # the implicit dissipation coefficient Lᵉ = −Cᴰ √|e| / ℓe at centres
        ell_e_c = torch.clamp_min(st.izc(ell_e), 1e-30)
        Le = -self.C_diss * torch.sqrt(e.abs()) / ell_e_c
        return dict(Ku=Ku, Kc=Kc, Ke=Ke, Le=Le, n2=n2, s2=s2)

    def nu(self, diffusivities):
        return 0.0  # no horizontal part

    def kappa_for_tracer(self, name, diffusivities):
        return 0.0

    def vertical_nu(self, diffusivities):
        return diffusivities["Ku"]

    def vertical_kappa(self, name, diffusivities):
        return diffusivities["Ke" if name == "e" else "Kc"]

    def implicit_linear_coefficient(self, name, diffusivities):
        """The linear term of a field's implicit column solve: Lᵉ for e."""
        if name == "e" and self.vertically_implicit:
            return diffusivities["Le"]
        return None

    def _surface_tke_flux(self, grid, like):
        """Qᵉ = −Cᴰ(Cᵂu★ u★³ + CᵂwΔ w★³), or None without surface fluxes."""
        sf = self.surface_tke_flux
        qu_qv = self.surface_momentum_flux
        qb = self._qb(grid, like)
        if qu_qv is None and qb is None:
            return None
        as_t = lambda x: torch.as_tensor(x, dtype=like.dtype, device=like.device)
        u_star3 = 0.0
        if qu_qv is not None:
            qu, qv = as_t(qu_qv[0]), as_t(qu_qv[1])
            u_star3 = (qu * qu + qv * qv) ** 0.75
        w_star3 = 0.0
        if qb is not None:
            dz_top = grid._axes[2].dc[grid.Hz + grid.Nz - 1]
            w_star3 = torch.clamp_min(qb, 0.0) * dz_top
        return -self.C_diss * (sf.Cw_u * u_star3 + sf.Cw_w * w_star3)

    def tke_tendency(self, grid, fields, diffusivities, tracers):
        """Shear production + buoyancy flux (+ the dissipation e·Lᵉ when not
        vertically implicit) + the surface TKE flux into the top cell, at
        centres."""
        d = diffusivities
        u, v = fields["u"], fields["v"]
        dzu = st.dzf(u) / grid.dz((F, C, F))
        dzv = st.dzf(v) / grid.dz((C, F, F))
        s2_c = st.ixc(st.izc(dzu * dzu)) + st.iyc(st.izc(dzv * dzv))
        prod = st.izc(d["Ku"]) * s2_c
        buoy = -st.izc(d["Kc"]) * st.izc(d["n2"])
        G = prod + buoy
        if not self.vertically_implicit:
            G = G + tracers["e"] * d["Le"]  # explicit −ε = e·L, L < 0
        qe = self._surface_tke_flux(grid, G)
        if qe is not None:
            # the top cell's flux divergence, as apply_flux_bcs takes a top
            # flux (−q/Δz); Qᵉ < 0 puts TKE in
            Hz, Nz = grid.Hz, grid.Nz
            dz_top = grid._axes[2].dc[Hz + Nz - 1]
            contrib = -qe / dz_top
            if contrib.ndim == 3:
                contrib = contrib[:, :, 0]
            G = G.clone()
            G[:, :, Hz + Nz - 1] += contrib
        return G
