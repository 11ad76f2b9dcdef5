"""Prescribed-velocity (tracer-only) model mode.

Counterpart of ``clima_oceananigans_jl_tpu/models/prescribed.py``
(Oceananigans' prescribed_hydrostatic_velocity_fields.jl): velocities are
fixed functions (or arrays) of space and time; only tracers are
prognostic — advection tests, offline transport and calibration. The
tracer transport is the plain ``div_Uc``, as in the JAX package; the
step is quasi-AB2 with χ = 0.1, Euler on the first step and on a change
of Δt.
"""
from __future__ import annotations

import torch

from ..advection.fluxes import div_Uc
from ..advection.schemes import CenteredSecondOrder
from ..boundary_conditions.bcs import apply_flux_bcs, fill_halos, regularize_bcs
from ..closures.scalar_diffusivity import tracer_diffusion
from ..fields.field import Field, new_field, set_field
from ..forcings.forcing import regularize_forcing
from ..timesteppers.steppers import Clock, ab2_substep, dt_changed, host_scalar
from ..utils.location import CENTER, U_LOC, V_LOC, W_LOC


class PrescribedVelocityFields:
    """u/v/w as callables f(x, y, z, t) or constant arrays/scalars."""

    def __init__(self, u=0.0, v=0.0, w=0.0):
        self.u, self.v, self.w = u, v, w

    def evaluate(self, grid, t):
        """(u, v, w), each broadcast to the grid's with-halo shape."""
        out = []
        for q, loc in ((self.u, U_LOC), (self.v, V_LOC), (self.w, W_LOC)):
            val = q(*grid.nodes(loc, with_halo=True), t) if callable(q) else q
            out.append(torch.broadcast_to(
                torch.as_tensor(val, dtype=grid.dtype, device=grid.device),
                grid.total_shape))
        return tuple(out)


class PrescribedVelocityModel:
    """AB2 tracer transport under prescribed velocities."""

    def __init__(self, grid, velocities, tracers=("c",),
                 tracer_advection=None, closure=None, forcing=None,
                 boundary_conditions=None):
        self.velocities = velocities
        self.tracer_advection = (tracer_advection if tracer_advection is not None
                                 else CenteredSecondOrder())
        h = max(self.tracer_advection.required_halo, 1)
        self.grid = grid.with_halo((h, h, h))
        self.tracer_names = tuple(tracers)
        self.closure = closure
        self.forcing = {k: regularize_forcing(k, v)
                        for k, v in (forcing or {}).items()}
        self.ab2_chi = 0.1
        user_bcs = boundary_conditions or {}
        self.bcs = {n: regularize_bcs(self.grid, CENTER, user_bcs.get(n))
                    for n in self.tracer_names}

    def prognostic_names(self):
        return self.tracer_names

    def _locs(self):
        return {n: CENTER for n in self.tracer_names}

    def initial_state(self, clock=None, **values):
        g = self.grid
        sol = {}
        for name in self.tracer_names:
            f = new_field(g, CENTER, self.bcs[name])
            sol[name] = set_field(f, g, values.get(name, 0.0)).data
        clock = clock or Clock(host_scalar(g.dtype, 0.0), 0)
        zeros = {k: torch.zeros_like(v) for k, v in sol.items()}
        return dict(solution=sol, clock=clock, G_prev=zeros,
                    previous_dt=host_scalar(g.dtype, -1.0))

    def tendencies(self, state):
        grid = self.grid
        clock = state["clock"]
        u, v, w = self.velocities.evaluate(grid, clock.time)
        sol = state["solution"]
        G = {}
        for name in self.tracer_names:
            # fill a copy: the state's tensors stay as they were (JAX's fill
            # is functional)
            c = fill_halos(sol[name].clone(), grid, CENTER, self.bcs[name],
                           clock.time)
            Gc = -div_Uc(grid, self.tracer_advection, u, v, w, c)
            if self.closure is not None:
                Gc = Gc + tracer_diffusion(c, grid, name, self.closure)
            if name in self.forcing:
                Gc = Gc + self.forcing[name](grid, clock, dict(sol, u=u, v=v, w=w))
            G[name] = apply_flux_bcs(Gc, grid, CENTER, self.bcs[name], clock.time)
        return G

    def step(self, state, dt):
        clock0 = state["clock"]
        euler = clock0.iteration == 0 or dt_changed(state["previous_dt"], dt)
        G = self.tendencies(state)
        sol = ab2_substep(state["solution"], G, state["G_prev"], dt,
                          self.ab2_chi, euler)
        clock = clock0.tick(dt)
        sol = {n: fill_halos(arr, self.grid, CENTER, self.bcs[n], clock.time)
               for n, arr in sol.items()}
        return dict(state, solution=sol, clock=clock, G_prev=G,
                    previous_dt=host_scalar(self.grid.dtype, 1.0) * dt)

    def fields(self, state):
        return {n: Field(arr, CENTER, self.bcs[n])
                for n, arr in state["solution"].items()}
