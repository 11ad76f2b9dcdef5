"""Explicit scalar (and biharmonic) diffusivity closures.

Counterpart of ``clima_oceananigans_jl_tpu/closures/scalar_diffusivity.py``
(Oceananigans' ``ScalarDiffusivity`` and ``ScalarBiharmonicDiffusivity``
and the generic flux divergence ∇·(κ∇c) of
abstract_scalar_diffusivity_closure.jl), in the JAX expression trees. ν
and κ are scalars, per-tracer dicts, 3D with-halo arrays at cell centres
(interpolated onto the flux faces) or, for a vertically implicit part,
callables of z (evaluated by the implicit solve); isotropic or split into
horizontal and vertical parts. Closures with diffusivity fields of the
step (the LES, vertical-mixing and GM/Redi closures) give them through
``nu``/``kappa_for_tracer``, ``vertical_nu``/``vertical_kappa`` (at (C,
C, F)) or their own ``tracer_tendency``. Closure tuples sum their
explicit parts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..grids.topology import FLAT
from ..ops import operators as op
from ..utils.location import CENTER, C, F


@dataclasses.dataclass(frozen=True)
class ScalarDiffusivity:
    """ν (momentum) and κ (tracers; scalar or per-tracer dict), with
    optional vertical ``nu_z``/``kappa_z`` (default: ν and κ)."""

    nu: Any = 0.0
    kappa: Any = 0.0
    nu_z: Optional[Any] = None
    kappa_z: Optional[Any] = None
    time_discretization: str = "explicit"  # or "vertically_implicit"

    def kappa_for(self, name):
        if isinstance(self.kappa, dict):
            return self.kappa.get(name, 0.0)
        return self.kappa

    def kappa_z_for(self, name):
        kz = self.kappa_z if self.kappa_z is not None else self.kappa
        if isinstance(kz, dict):
            return kz.get(name, 0.0)
        return kz

    @property
    def vertically_implicit(self):
        return self.time_discretization == "vertically_implicit"


@dataclasses.dataclass(frozen=True)
class ScalarBiharmonicDiffusivity:
    """4th-order hyperdiffusion −ν∇⁴. ``formulation``:
    "three_dimensional" (default) or "horizontal" (∇h⁴ only)."""

    nu: Any = 0.0
    kappa: Any = 0.0
    formulation: str = "three_dimensional"

    def kappa_for(self, name):
        if isinstance(self.kappa, dict):
            return self.kappa.get(name, 0.0)
        return self.kappa

    vertically_implicit = False


def HorizontalScalarDiffusivity(nu=0.0, kappa=0.0):
    """Horizontal-only ν/κ."""
    return ScalarDiffusivity(nu=nu, kappa=kappa, nu_z=0.0, kappa_z=0.0)


def VerticalScalarDiffusivity(nu=0.0, kappa=0.0,
                              time_discretization="explicit"):
    """Vertical-only ν/κ."""
    return ScalarDiffusivity(nu=0.0, kappa=0.0, nu_z=nu, kappa_z=kappa,
                             time_discretization=time_discretization)


def _kappa_at_flux_loc(kappa, loc, axis, from_loc=None):
    """A 3D κ array interpolated from ``from_loc`` (default centres) onto
    the flux location for ``axis``; scalars pass through."""
    if not (isinstance(kappa, torch.Tensor) and kappa.ndim == 3):
        return kappa
    target = op.flip_loc(loc, axis)
    return op.interp_to(kappa, from_loc or CENTER, target)


def div_kappa_grad(c, grid, loc, kappa, kappa_z=None, horizontal_only=False,
                   vertical=True, kappa_z_at_faces=False):
    """∇·(κ∇c) at `loc` in finite-volume form; κ a scalar, horizontally /
    vertically split, or a 3D diffusivity array (at centres by default,
    interpolated onto the flux faces; ``kappa_z_at_faces`` when the
    vertical one lives at (C, C, F)). ``vertical=False`` or
    ``horizontal_only`` leaves the vertical flux out (to an implicit
    solve). On a grid with an immersed boundary the fluxes through solid
    faces are zero (no flux into the solid, and the solid's masked zeros
    do not act as a value wall)."""
    kz = kappa if kappa_z is None else kappa_z
    kx = _kappa_at_flux_loc(kappa, loc, 0)
    ky = _kappa_at_flux_loc(kappa, loc, 1)
    imm = getattr(grid, "immersed", None)

    def zero_solid(f, axis):
        if imm is None:
            return f
        return torch.where(imm.mask_for(op.flip_loc(loc, axis)),
                           torch.zeros((), dtype=f.dtype, device=f.device), f)

    fx = zero_solid(grid.Ax(op.flip_loc(loc, 0)) * (kx * op.dd(c, grid, 0, loc)), 0)
    fy = zero_solid(grid.Ay(op.flip_loc(loc, 1)) * (ky * op.dd(c, grid, 1, loc)), 1)
    out = (op.delta(fx, 0, op.flip_loc(loc, 0))
           + op.delta(fy, 1, op.flip_loc(loc, 1)))
    if vertical and not horizontal_only:
        kz_from = (C, C, F) if kappa_z_at_faces else None
        kzf = _kappa_at_flux_loc(kz, loc, 2, from_loc=kz_from)
        fz = zero_solid(grid.Az(op.flip_loc(loc, 2)) * (kzf * op.dd(c, grid, 2, loc)), 2)
        out = out + op.delta(fz, 2, op.flip_loc(loc, 2))
    return out / grid.V(loc)


def biharmonic(c, grid, loc, kappa, horizontal=False):
    """−∇·(κ∇(∇²c)), two Laplacian passes (consumes 2 halo cells);
    ``horizontal`` → ∇h⁴."""
    axes = (0, 1) if horizontal else (0, 1, 2)
    lap = op.laplacian(c, grid, loc, axes=axes)
    return -div_kappa_grad(lap, grid, loc, kappa, vertical=not horizontal)


def compute_closure_diffusivities(closure, grid, fields, buoyancy, tracers):
    """The diffusivity pass of ``update_state``: one entry per closure
    (tuples give tuples), None for closures without diffusivity fields."""
    if closure is None:
        return None
    if isinstance(closure, (tuple, list)):
        return tuple(compute_closure_diffusivities(c, grid, fields, buoyancy,
                                                   tracers) for c in closure)
    if hasattr(closure, "compute_diffusivities"):
        return closure.compute_diffusivities(grid, fields, buoyancy, tracers)
    return None


def momentum_diffusion(u, grid, u_loc, closure, diffusivities=None):
    """The tendency contribution +∇·(ν∇u) of one velocity component
    (explicit part)."""
    if closure is None:
        return torch.zeros_like(u)
    if isinstance(closure, (tuple, list)):
        out = torch.zeros_like(u)
        diffusivities = diffusivities or (None,) * len(closure)
        for c, d in zip(closure, diffusivities):
            out = out + momentum_diffusion(u, grid, u_loc, c, d)
        return out
    if isinstance(closure, ScalarBiharmonicDiffusivity):
        return biharmonic(u, grid, u_loc, closure.nu,
                          horizontal=closure.formulation == "horizontal")
    if isinstance(closure, ScalarDiffusivity):
        nu_z = closure.nu_z if closure.nu_z is not None else closure.nu
        return div_kappa_grad(u, grid, u_loc, closure.nu, nu_z,
                              vertical=not closure.vertically_implicit)
    # diffusivity-field closures (the LES, vertical-mixing and GM/Redi
    # closures); a vertical ν at (C, C, F) where the closure gives one
    nu = closure.nu(diffusivities)
    nu_z = (closure.vertical_nu(diffusivities)
            if hasattr(closure, "vertical_nu") else nu)
    return div_kappa_grad(u, grid, u_loc, nu, nu_z,
                          vertical=not closure.vertically_implicit,
                          kappa_z_at_faces=hasattr(closure, "vertical_nu"))


def tracer_diffusion(c, grid, name, closure, diffusivities=None):
    """The tendency contribution ∇·(κ∇c) of one tracer (explicit part)."""
    if closure is None:
        return torch.zeros_like(c)
    if isinstance(closure, (tuple, list)):
        out = torch.zeros_like(c)
        diffusivities = diffusivities or (None,) * len(closure)
        for cl, d in zip(closure, diffusivities):
            out = out + tracer_diffusion(c, grid, name, cl, d)
        return out
    if isinstance(closure, ScalarBiharmonicDiffusivity):
        return biharmonic(c, grid, CENTER, closure.kappa_for(name),
                          horizontal=closure.formulation == "horizontal")
    if isinstance(closure, ScalarDiffusivity):
        return div_kappa_grad(c, grid, CENTER, closure.kappa_for(name),
                              closure.kappa_z_for(name),
                              vertical=not closure.vertically_implicit)
    if hasattr(closure, "tracer_tendency"):  # GM/Redi's rotated fluxes
        return closure.tracer_tendency(c, grid, name, diffusivities)
    kap = closure.kappa_for_tracer(name, diffusivities)
    kap_z = (closure.vertical_kappa(name, diffusivities)
             if hasattr(closure, "vertical_kappa") else kap)
    return div_kappa_grad(c, grid, CENTER, kap, kap_z,
                          vertical=not closure.vertically_implicit,
                          kappa_z_at_faces=hasattr(closure, "vertical_kappa"))


def add_tke_tendency(Ge, closure, grid, fields, diffusivities, tracer_names):
    """``Ge`` (the tendency of ``e``) plus the TKE sources of each closure
    (of a tuple too) that has a ``tke_tendency`` (CATKE), added one by one
    in the closures' order, as the JAX models add them."""
    closures = closure if isinstance(closure, (tuple, list)) else (closure,)
    diffs = (diffusivities if isinstance(closure, (tuple, list))
             else (diffusivities,))
    for cl, d in zip(closures, diffs or (None,) * len(closures)):
        if hasattr(cl, "tke_tendency"):
            tracers = {n: fields[n] for n in tracer_names}
            Ge = Ge + cl.tke_tendency(grid, fields, d, tracers)
    return Ge


def _max_diffusivity(value, tracer_names=()):
    """max |ν| or |κ| of a scalar, a per-tracer dict or a 3D array;
    callables (evaluated elsewhere) count 0."""
    if value is None:
        return 0.0
    if isinstance(value, dict):
        names = tracer_names or tuple(value)
        return max((_max_diffusivity(value.get(n, 0.0)) for n in names),
                   default=0.0)
    if isinstance(value, torch.Tensor):
        return float(value.abs().max())
    if callable(value):
        return 0.0
    return float(abs(np.asarray(value, dtype=np.float64)).max())


def cell_diffusion_timescale(closure, grid, diffusivities=None,
                             tracer_names=()):
    """min over closures and fields of Δ²/max(ν, κ) (Δ⁴/ν for biharmonic
    closures): horizontal diffusivities limited by the smallest horizontal
    spacing, vertical ones by Δz; a vertically implicit part does not
    limit. +inf when nothing limits."""
    if closure is None:
        return math.inf
    if isinstance(closure, (tuple, list)):
        diffs = diffusivities if diffusivities is not None \
            else (None,) * len(closure)
        return min(cell_diffusion_timescale(c, grid, d, tracer_names)
                   for c, d in zip(closure, diffs))
    spacing = lambda a: float(grid.spacing(a, CENTER).min())
    h_sp = [spacing(a) for a in (0, 1) if grid.topology[a] is not FLAT]
    dh = min(h_sp) if h_sp else math.inf
    dz = spacing(2) if grid.topology[2] is not FLAT else math.inf

    def ts(delta, kap, power=2):
        if kap > 0.0 and math.isfinite(delta):
            return delta ** power / kap
        return math.inf

    if isinstance(closure, ScalarBiharmonicDiffusivity):
        d = dh if closure.formulation == "horizontal" else min(dh, dz)
        kap = max(_max_diffusivity(closure.nu),
                  _max_diffusivity(closure.kappa, tracer_names))
        return ts(d, kap, power=4)
    if isinstance(closure, ScalarDiffusivity):
        t = ts(dh, max(_max_diffusivity(closure.nu),
                       _max_diffusivity(closure.kappa, tracer_names)))
        if not closure.vertically_implicit:
            nu_z = closure.nu_z if closure.nu_z is not None else closure.nu
            kz = closure.kappa_z if closure.kappa_z is not None else closure.kappa
            t = min(t, ts(dz, max(_max_diffusivity(nu_z),
                                  _max_diffusivity(kz, tracer_names))))
        return t
    # diffusivity-field closures (LES, vertical mixing, GM/Redi): their
    # fields live in ``diffusivities``
    t = math.inf
    if diffusivities is None:
        return t
    kap = 0.0
    if hasattr(closure, "nu"):
        kap = _max_diffusivity(closure.nu(diffusivities))
    if hasattr(closure, "kappa_for_tracer"):
        kap = max(kap, max((_max_diffusivity(
            closure.kappa_for_tracer(n, diffusivities))
            for n in tracer_names), default=0.0))
    iso_d = dh if closure.vertically_implicit else min(dh, dz)
    t = min(t, ts(iso_d, kap))
    if not closure.vertically_implicit:
        kz = 0.0
        if hasattr(closure, "vertical_nu"):
            kz = _max_diffusivity(closure.vertical_nu(diffusivities))
        if hasattr(closure, "vertical_kappa"):
            kz = max(kz, max((_max_diffusivity(
                closure.vertical_kappa(n, diffusivities))
                for n in tracer_names), default=0.0))
        t = min(t, ts(dz, kz))
    return t
