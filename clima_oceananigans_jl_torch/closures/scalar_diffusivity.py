"""Explicit scalar diffusivity closures.

Counterpart of ``clima_oceananigans_jl_tpu/closures/scalar_diffusivity.py``
(Oceananigans' ``ScalarDiffusivity`` and the generic flux divergence
∇·(κ∇c) of abstract_scalar_diffusivity_closure.jl), in the JAX
expression trees. ν and κ are scalars (κ may be a per-tracer dict of
scalars), isotropic or split into horizontal and vertical parts.

Not ported yet, and refused by the model (ROADMAP Queue 1 item 4):
``ScalarBiharmonicDiffusivity``, the diffusivity-field closures (LES,
vertical mixing), array- or callable-valued ν/κ, closure tuples and the
vertically implicit time discretization.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..grids.topology import FLAT
from ..ops import operators as op
from ..utils.location import CENTER


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


def HorizontalScalarDiffusivity(nu=0.0, kappa=0.0):
    """Horizontal-only ν/κ."""
    return ScalarDiffusivity(nu=nu, kappa=kappa, nu_z=0.0, kappa_z=0.0)


def VerticalScalarDiffusivity(nu=0.0, kappa=0.0,
                              time_discretization="explicit"):
    """Vertical-only ν/κ."""
    return ScalarDiffusivity(nu=0.0, kappa=0.0, nu_z=nu, kappa_z=kappa,
                             time_discretization=time_discretization)


def div_kappa_grad(c, grid, loc, kappa, kappa_z=None, vertical=True):
    """∇·(κ∇c) at `loc` in finite-volume form, for a scalar κ with an
    optional vertical ``kappa_z``; ``vertical=False`` leaves the vertical
    flux to an implicit solve."""
    kz = kappa if kappa_z is None else kappa_z
    fx = grid.Ax(op.flip_loc(loc, 0)) * (kappa * op.dd(c, grid, 0, loc))
    fy = grid.Ay(op.flip_loc(loc, 1)) * (kappa * op.dd(c, grid, 1, loc))
    out = (op.delta(fx, 0, op.flip_loc(loc, 0))
           + op.delta(fy, 1, op.flip_loc(loc, 1)))
    if vertical:
        fz = grid.Az(op.flip_loc(loc, 2)) * (kz * op.dd(c, grid, 2, loc))
        out = out + op.delta(fz, 2, op.flip_loc(loc, 2))
    return out / grid.V(loc)


def _not_ported(closure):
    return NotImplementedError(
        f"{type(closure).__name__} closures are not ported yet (ROADMAP "
        "Queue 1 item 4)")


def compute_closure_diffusivities(closure, grid, fields, buoyancy, tracers):
    """The diffusivity pass of ``update_state``. No ported closure has
    diffusivity fields: None for None and ``ScalarDiffusivity``."""
    if closure is None or isinstance(closure, ScalarDiffusivity):
        return None
    raise _not_ported(closure)


def momentum_diffusion(u, grid, u_loc, closure, diffusivities=None):
    """The tendency contribution +∇·(ν∇u) of one velocity component
    (explicit part)."""
    if closure is None:
        return torch.zeros_like(u)
    if not isinstance(closure, ScalarDiffusivity):
        raise _not_ported(closure)
    nu_z = closure.nu_z if closure.nu_z is not None else closure.nu
    return div_kappa_grad(u, grid, u_loc, closure.nu, nu_z,
                          vertical=not closure.vertically_implicit)


def tracer_diffusion(c, grid, name, closure, diffusivities=None):
    """The tendency contribution ∇·(κ∇c) of one tracer (explicit part)."""
    if closure is None:
        return torch.zeros_like(c)
    if not isinstance(closure, ScalarDiffusivity):
        raise _not_ported(closure)
    return div_kappa_grad(c, grid, CENTER, closure.kappa_for(name),
                          closure.kappa_z_for(name),
                          vertical=not closure.vertically_implicit)


def _max_diffusivity(value, tracer_names=()):
    """max |ν| or |κ| of a scalar or a per-tracer dict."""
    if value is None:
        return 0.0
    if isinstance(value, dict):
        names = tracer_names or tuple(value)
        return max((abs(float(value.get(n, 0.0))) for n in names), default=0.0)
    return abs(float(value))


def cell_diffusion_timescale(closure, grid, diffusivities=None,
                             tracer_names=()):
    """min Δ²/max(ν, κ): horizontal diffusivities limited by the smallest
    horizontal spacing, vertical ones by Δz; a vertically implicit part
    does not limit. +inf when nothing limits."""
    if closure is None:
        return math.inf
    if not isinstance(closure, ScalarDiffusivity):
        raise _not_ported(closure)
    spacing = lambda a: float(grid.spacing(a, CENTER).min())
    h_sp = [spacing(a) for a in (0, 1) if grid.topology[a] is not FLAT]
    dh = min(h_sp) if h_sp else math.inf
    dz = spacing(2) if grid.topology[2] is not FLAT else math.inf
    ts = lambda delta, kap: (delta ** 2 / kap if kap > 0.0 and math.isfinite(delta)
                             else math.inf)
    t = ts(dh, max(_max_diffusivity(closure.nu),
                   _max_diffusivity(closure.kappa, tracer_names)))
    if not closure.vertically_implicit:
        nu_z = closure.nu_z if closure.nu_z is not None else closure.nu
        kz = closure.kappa_z if closure.kappa_z is not None else closure.kappa
        t = min(t, ts(dz, max(_max_diffusivity(nu_z),
                              _max_diffusivity(kz, tracer_names))))
    return t
