"""User forcing functions.

Counterpart of ``clima_oceananigans_jl_tpu/forcings/forcing.py``
(Oceananigans' ``Forcing``, ``Relaxation`` and ``AdvectiveForcing``):
models call a forcing as ``f(grid, clock, fields) -> tendency`` (the
discrete form), a with-halo tensor or anything that broadcasts with one.
``Forcing`` adapts the continuous form ``func(x, y, z, t, *field
dependencies[, parameters])``, the coordinates being the field's
with-halo nodes as broadcastable tensors. The model binds ``Relaxation``
and ``AdvectiveForcing`` to the field of their dict key
(``regularize_forcing``).
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from ..utils.location import CENTER


class Forcing:
    """Continuous-form forcing: func(x, y, z, t, *deps [, parameters]);
    with ``discrete_form``, func(grid, clock, fields [, parameters])."""

    def __init__(self, func, parameters=None, field_dependencies=(),
                 discrete_form=False, loc=CENTER):
        self.func = func
        self.parameters = parameters
        self.field_dependencies = (field_dependencies,) if isinstance(
            field_dependencies, str) else tuple(field_dependencies)
        self.discrete_form = discrete_form
        self.loc = loc

    def __call__(self, grid, clock, fields):
        if self.discrete_form:
            if self.parameters is None:
                return self.func(grid, clock, fields)
            return self.func(grid, clock, fields, self.parameters)
        x, y, z = grid.nodes(self.loc, with_halo=True)
        deps = [fields[name] for name in self.field_dependencies]
        args = [x, y, z, clock.time] + deps
        if self.parameters is not None:
            args.append(self.parameters)
        return self.func(*args)


class Relaxation:
    """F = rate · mask(x, y, z) · (target(x, y, z, t) − field); register
    it as the forcing of a field name."""

    def __init__(self, rate, mask=None, target=0.0, field_name=None,
                 loc=CENTER):
        self.rate = rate
        self.mask = mask
        self.target = target
        self.field_name = field_name
        self.loc = loc

    def for_field(self, name):
        out = copy.copy(self)
        out.field_name = name
        return out

    def __call__(self, grid, clock, fields):
        x, y, z = grid.nodes(self.loc, with_halo=True)
        m = self.mask(x, y, z) if callable(self.mask) else (
            1.0 if self.mask is None else self.mask)
        tgt = self.target(x, y, z, clock.time) if callable(self.target) else self.target
        field = fields[self.field_name]
        return self.rate * m * (tgt - field)


@dataclasses.dataclass(frozen=True)
class GaussianMask:
    """exp(−(r − center)² / 2 width²) along one axis."""

    center: float = 0.0
    width: float = 1.0
    axis: int = 2

    def __call__(self, x, y, z):
        r = (x, y, z)[self.axis]
        return torch.exp(-((r - self.center) ** 2) / (2.0 * self.width ** 2))


@dataclasses.dataclass(frozen=True)
class LinearTarget:
    """target = intercept + gradient · coordinate."""

    intercept: float = 0.0
    gradient: float = 0.0
    axis: int = 2

    def __call__(self, x, y, z, t):
        return self.intercept + self.gradient * (x, y, z)[self.axis]


class AdvectiveForcing:
    """Forcing as the flux divergence of a slip velocity,
    F_c = −∇·(u_slip c), e.g. sinking particles."""

    def __init__(self, scheme=None, u=0.0, v=0.0, w=0.0, field_name=None):
        from ..advection.schemes import CenteredSecondOrder
        self.scheme = scheme or CenteredSecondOrder()
        self.u, self.v, self.w = u, v, w
        self.field_name = field_name

    def for_field(self, name):
        out = copy.copy(self)
        out.field_name = name
        return out

    def __call__(self, grid, clock, fields):
        from ..advection.fluxes import div_Uc
        c = fields[self.field_name]
        shape = grid.total_shape
        to = lambda q: torch.broadcast_to(
            torch.as_tensor(q, dtype=grid.dtype, device=grid.device), shape)
        return -div_Uc(grid, self.scheme, to(self.u), to(self.v), to(self.w), c)


class MultipleForcings:
    """Several forcings on one field, summed in order."""

    def __init__(self, parts):
        self.parts = tuple(parts)

    def __call__(self, grid, clock, fields):
        out = self.parts[0](grid, clock, fields)
        for p in self.parts[1:]:
            out = out + p(grid, clock, fields)
        return out


def regularize_forcing(name, f):
    """One field's forcing spec, normalised: tuples and lists sum
    (``MultipleForcings``); a ``Relaxation`` or ``AdvectiveForcing``
    without a ``field_name`` binds to its dict key ``name``."""
    if isinstance(f, (tuple, list)):
        return MultipleForcings(regularize_forcing(name, p) for p in f)
    if (isinstance(f, (AdvectiveForcing, Relaxation))
            and f.field_name is None):
        return f.for_field(name)
    return f
