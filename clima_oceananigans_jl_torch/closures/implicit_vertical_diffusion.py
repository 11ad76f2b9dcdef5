"""Vertically implicit diffusion: the backward-Euler column solve.

Counterpart of ``clima_oceananigans_jl_tpu/closures/
implicit_vertical_diffusion.py`` (Oceananigans'
vertically_implicit_diffusion_solver.jl): after the explicit substep, each
prognostic field is updated by solving

    (I − Δt ∂z κ ∂z) c^{n+1} = c*

column by column. The bands come from κ at the z location opposite the
field's (faces for z-centred fields, centres for w), in the JAX
expression trees; Value and Gradient walls are folded into the wall rows,
w's boundary faces stay as they are. The solve goes through
``solvers/tridiagonal.py``'s ``solve_batched_tridiagonal`` (kernel T1 on
the card) unless the caller passes another function of its signature
(its plain version): it reads the interior levels of the field as a view
and writes the solution into the same levels of the field's copy.
"""
from __future__ import annotations

import torch

from ..boundary_conditions.bcs import _bvalue
from ..ops import stencil as st
from ..solvers.tridiagonal import solve_batched_tridiagonal
from ..utils.location import C


def _kappa_levels(kappa, grid, k0, k1, at_faces, like):
    """κ at the with-halo z indices k0..k1−1 (faces or centres), as a
    tensor of ``like``'s type: (k1−k0,) for a scalar, a callable of z or a
    1D with-halo column, (X, Y, k1−k0) for a 3D with-halo array. Each entry
    is the JAX package's κ of that level, level by level."""
    if callable(kappa) and not isinstance(kappa, torch.Tensor):
        az = grid._axes[2]
        z = (az.cf if at_faces else az.cc)[k0:k1]
        out = kappa(z)
    elif not isinstance(kappa, torch.Tensor) or kappa.ndim == 0:
        out = torch.full((k1 - k0,), float(kappa), dtype=like.dtype,
                         device=like.device)
    elif kappa.ndim == 1:
        out = kappa[k0:k1]
    else:
        out = kappa[:, :, k0:k1]
    out = torch.as_tensor(out, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(out, (k1 - k0,)) if out.ndim <= 1 else out


def _zero_end(band, end):
    """The band with its first (``end`` 0) or last (−1) level set to 0."""
    z = torch.zeros_like(band[..., :1])
    if end == 0:
        return torch.cat([z, band[..., 1:]], -1)
    return torch.cat([band[..., :-1], z], -1)


def implicit_vertical_diffusion_step(data, grid, loc, kappa, dt,
                                     linear_coeff=None, bc_bottom=None,
                                     bc_top=None, t=0.0, solve=None):
    """Solve (I − Δt(∂z κ ∂z + L)) out = data along z; returns a new
    with-halo tensor.

    ``kappa``: a scalar, a callable of z, a 1D with-halo column or a 3D
    with-halo array, evaluated at z faces for z-centred fields and at
    centres for w. ``linear_coeff``: an optional 3D with-halo array L ≤ 0
    at the field's location, folded into the diagonal (CATKE's implicit
    dissipation). ``bc_bottom``/``bc_top``: Value and Gradient walls are
    folded into the solve (ghost = 2b − c, and the prescribed-gradient
    flux); flux walls stay explicit. ``solve`` replaces
    ``solve_batched_tridiagonal`` (called as ``solve(a, b, c, rhs,
    out=view)``).

    The bands are the JAX package's, level by level (−Δt κ / (Δz Δz) with
    IEEE division), formed for all levels at once; they are 1D (Nz,) when
    κ depends on z only, else (X, Y, Nz)."""
    solve = solve or solve_batched_tridiagonal
    az = grid._axes[2]
    Nz, Hz = az.n, az.h
    if Nz == 1:
        return data
    dzc, dzf = az.dc, az.df
    shape2 = tuple(data.shape[:2])

    if loc[2] is C:
        # unknowns at centres k = 0..Nz−1; κ at faces k = 0..Nz
        kf = _kappa_levels(kappa, grid, Hz, Hz + Nz + 1, True, data)
        dzc_k = dzc[Hz: Hz + Nz]
        a = _zero_end(-dt * kf[..., :Nz] / (dzc_k * dzf[Hz: Hz + Nz]), 0)
        c = _zero_end(-dt * kf[..., 1:] / (dzc_k * dzf[Hz + 1: Hz + Nz + 1]), -1)
        bands_1d = a.ndim == 1
        if linear_coeff is not None and bands_1d:
            a = torch.broadcast_to(a.reshape(1, 1, -1), shape2 + (Nz,))
            c = torch.broadcast_to(c.reshape(1, 1, -1), shape2 + (Nz,))
            bands_1d = False
        b = 1.0 - a - c
        if linear_coeff is not None:
            b = b - dt * linear_coeff[:, :, Hz: Hz + Nz]
        rhs = data[:, :, Hz: Hz + Nz]

        def wall(bc, side):
            nonlocal a, b, c, rhs, bands_1d
            if bc is None or bc.kind not in ("value", "gradient"):
                return
            bw = torch.as_tensor(_bvalue(bc, grid, 2, side, loc, t),
                                 dtype=data.dtype, device=data.device)
            if bw.ndim == 3:
                bw = bw[:, :, 0]
            kk = 0 if side == 0 else Nz - 1
            kface = 0 if side == 0 else Nz
            kap_w = kf[..., kface]
            dz_c = dzc[Hz + kk]
            if bc.kind == "value":
                # ghost = 2·b_w − c ⇒ wall flux = 2κ(c − b_w)/Δz_f
                dz_f = dzf[Hz + kface]
                coef = dt * 2.0 * kap_w / (dz_c * dz_f)
                if bands_1d and coef.ndim == 0:
                    b = b.clone()
                    b[kk] = b[kk] + coef
                else:
                    if bands_1d:  # a spatially varying wall κ: promote
                        sh = shape2 + (Nz,)
                        a = torch.broadcast_to(a.reshape(1, 1, -1), sh)
                        b = torch.broadcast_to(b.reshape(1, 1, -1), sh)
                        c = torch.broadcast_to(c.reshape(1, 1, -1), sh)
                        bands_1d = False
                    b = b.clone()
                    b[:, :, kk] = b[:, :, kk] + torch.broadcast_to(coef, shape2)
                rhs = rhs.clone()
                rhs[:, :, kk] = rhs[:, :, kk] + torch.broadcast_to(
                    coef * bw, shape2)
            else:  # a prescribed wall gradient g: the flux κ·g goes to the RHS
                sgn = -1.0 if side == 0 else 1.0
                rhs = rhs.clone()
                rhs[:, :, kk] = rhs[:, :, kk] + torch.broadcast_to(
                    sgn * dt * kap_w * bw / dz_c, shape2)

        wall(bc_bottom, 0)
        wall(bc_top, 1)
        out = data.clone()
        solve(a, b, c, rhs, out=out[:, :, Hz: Hz + Nz])
        return out

    # w: unknowns at the interior faces k = 1..Nz−1, κ at centres; the
    # boundary faces stay as they are (impenetrable walls)
    kc = _kappa_levels(kappa, grid, Hz, Hz + Nz, False, data)
    dzf_k = dzf[Hz + 1: Hz + Nz]
    a = _zero_end(-dt * kc[..., :Nz - 1] / (dzf_k * dzc[Hz: Hz + Nz - 1]), 0)
    c = _zero_end(-dt * kc[..., 1:] / (dzf_k * dzc[Hz + 1: Hz + Nz]), -1)
    b = 1.0 - a - c
    out = data.clone()
    solve(a, b, c, data[:, :, Hz + 1: Hz + Nz], out=out[:, :, Hz + 1: Hz + Nz])
    return out


def _vertical_coefficient(closure, name, diffusivities):
    """κz of one field from a closure (a scalar setting or a field of the
    step)."""
    if name in ("u", "v", "w"):
        if hasattr(closure, "vertical_nu"):
            return closure.vertical_nu(diffusivities)
        return closure.nu_z if closure.nu_z is not None else closure.nu
    if hasattr(closure, "vertical_kappa"):
        return closure.vertical_kappa(name, diffusivities)
    return closure.kappa_z_for(name)


def implicit_step_is_noop(closure):
    """True when ``implicit_step_fields`` is the identity for this closure."""
    if closure is None:
        return True
    if isinstance(closure, (tuple, list)):
        return all(implicit_step_is_noop(c) for c in closure)
    return not getattr(closure, "vertically_implicit", False)


def implicit_step_fields(solution, grid, locs, closure, dt, diffusivities=None,
                         bcs=None, t=0.0, solve=None):
    """The implicit vertical solve of every prognostic field (Oceananigans'
    ``implicit_step!``); closure tuples apply in turn (operator
    splitting). ``bcs`` (name → FieldBCs) folds Value/Gradient walls into
    the solves; ``solve`` replaces ``solve_batched_tridiagonal``."""
    if closure is None:
        return solution
    if isinstance(closure, (tuple, list)):
        diffusivities = diffusivities or (None,) * len(closure)
        for c, d in zip(closure, diffusivities):
            solution = implicit_step_fields(solution, grid, locs, c, dt, d,
                                            bcs, t, solve)
        return solution
    if not getattr(closure, "vertically_implicit", False):
        return solution
    out = {}
    for name, data in solution.items():
        kz = _vertical_coefficient(closure, name, diffusivities)
        if isinstance(kz, torch.Tensor) and kz.ndim == 3:
            # (C, C, ·) diffusivity fields: to the field's horizontal stagger
            if locs[name][0] is not C:
                kz = st.ixf(kz)
            if locs[name][1] is not C:
                kz = st.iyf(kz)
        lin = (closure.implicit_linear_coefficient(name, diffusivities)
               if hasattr(closure, "implicit_linear_coefficient") else None)
        fb = bcs.get(name) if bcs else None
        out[name] = implicit_vertical_diffusion_step(
            data, grid, locs[name], kz, dt, lin,
            bc_bottom=fb.bottom if fb else None,
            bc_top=fb.top if fb else None, t=t, solve=solve)
    return out
