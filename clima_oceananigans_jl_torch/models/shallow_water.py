"""Shallow-water model, conservative (uh, vh, h) and vector-invariant
(u, v, h) forms.

Counterpart of ``clima_oceananigans_jl_tpu/models/shallow_water.py``
(Oceananigans' ``ShallowWaterModel``):

  ∂t(uh) = −∇·(uh v) − g ∂x(h²/2) − f×(uh) + g h ∂x(hB) + ν∇²(uh)
  ∂t(vh) = (y analogue)
  ∂t(h)  = −∇·(uh, vh)
  ∂t(c)  = −∇·(U c) + c ∇·U + κ∇²c

and the vector-invariant form with its Bernoulli head. Each RK3 stage of
the conservative form is: the core tendencies through
``fused_shallow_water_tendencies`` (kernel K3a on the GPU, and on the CPU
its plain PyTorch version, the JAX package's ``_core_tendencies``),
Coriolis and diffusion with PyTorch ops, then each field's forcing and
boundary fluxes, ``rk3_substep``, then ``fill_all_halos``. The
vector-invariant form runs on PyTorch ops alone, as the JAX package runs
it without Pallas.

Forcing: a callable ``f(grid, clock, fields)`` per field (``fields`` the
solution), or any of ``forcings/forcing.py``'s forms, normalised by
``regularize_forcing`` at construction and added to G after the core,
Coriolis and diffusion, before the boundary fluxes, as torch ops (the JAX
package adds it after its kernel too).

State: ``solution`` (with-halo tensors, halo ``(h, h, 0)``; no TPU x-halo
pad) and a host ``clock``; RK3 carries no tendency history across steps,
so there is no ``G_prev``. Decomposed over a mesh of shards
(``parallel/distributed.py``) its fills exchange along the cut axes and
K3a reads their halos; the bathymetry is cut with the grid. Lagrangian particles (``particles=``) ride in
``state["particles"]`` and are advected after each step in the
diagnostic velocities, sampling the tracers they track.
"""
from __future__ import annotations

import torch

from ..advection.schemes import WENO5, transport
from ..boundary_conditions.bcs import apply_flux_bcs, fill_halos, regularize_bcs
from ..closures.scalar_diffusivity import (cell_diffusion_timescale,
                                           momentum_diffusion,
                                           tracer_diffusion)
from ..fields.field import Field, new_field, set_field
from ..forcings.forcing import regularize_forcing
from ..grids.topology import FLAT
from ..ops import stencil as st
from ..ops.fused_tendencies import (fused_shallow_water_tendencies,
                                    fused_shallow_water_tendencies_reference)
from ..timesteppers.steppers import (RK3_GAMMA, RK3_ZETA, Clock, host_scalar,
                                     rk3_substep, scaled)
from ..utils.location import CENTER, U_LOC, V_LOC

#: the kernel's wrapper a step calls, by name: the conservative core (K3a)
KERNELS = dict(core=fused_shallow_water_tendencies)
#: its plain version: ``step(..., kernels=PLAIN)`` runs a step without the
#: kernel on the card
PLAIN = dict(core=fused_shallow_water_tendencies_reference)


class ShallowWaterModel:
    def __init__(self, grid, gravitational_acceleration=9.80665,
                 advection=None, tracer_advection=None, coriolis=None,
                 closure=None, bathymetry=None, tracers=(), forcing=None,
                 boundary_conditions=None, formulation="conservative",
                 particles=None):
        """``formulation``: "conservative" (prognostic uh, vh, h, the
        default) or "vector_invariant" (prognostic u, v, h; ``advection``
        is then a ``VectorInvariant`` and h is advected with
        ``tracer_advection``)."""
        if grid.topology[2] is not FLAT or grid.Nz != 1:
            raise ValueError("ShallowWaterModel requires a flat z-axis (size[2]=1)")
        if formulation not in ("conservative", "vector_invariant"):
            raise ValueError(f"unknown formulation {formulation!r}")
        self.formulation = formulation
        if formulation == "vector_invariant":
            from ..advection.vector_invariant import VectorInvariant
            self.advection = (advection if advection is not None
                              else VectorInvariant())
            self.tracer_advection = (tracer_advection
                                     if tracer_advection is not None else WENO5())
        else:
            self.advection = advection if advection is not None else WENO5()
            self.tracer_advection = (tracer_advection if tracer_advection is not None
                                     else self.advection)
        h_req = max(self.advection.required_halo,
                    self.tracer_advection.required_halo)
        self.grid = grid.with_halo((h_req, h_req, 0))
        self.g = float(gravitational_acceleration)
        self.coriolis = coriolis
        self.closure = closure
        # hB at centres, with-halo (the model grid's total_shape), or None
        self.bathymetry = (None if bathymetry is None else torch.as_tensor(
            bathymetry, dtype=self.grid.dtype, device=self.grid.device).contiguous())
        self.tracer_names = tuple(tracers)
        self.particles = particles
        self.forcing = {k: regularize_forcing(k, v)
                        for k, v in (forcing or {}).items()}
        user_bcs = boundary_conditions or {}
        self.bcs = {name: regularize_bcs(self.grid, loc, user_bcs.get(name))
                    for name, loc in self._locs().items()}

    def _momentum_names(self):
        return (("u", "v") if self.formulation == "vector_invariant"
                else ("uh", "vh"))

    # -- state ------------------------------------------------------------------
    def prognostic_names(self):
        return self._momentum_names() + ("h",) + self.tracer_names

    def _locs(self):
        un, vn = self._momentum_names()
        locs = {un: U_LOC, vn: V_LOC, "h": CENTER}
        for n in self.tracer_names:
            locs[n] = CENTER
        return locs

    def initial_state(self, clock=None, h=1.0, **values):
        """A filled state: ``h`` and ``values`` (scalars, arrays or
        callables of x, y, z) on the named fields, zero elsewhere. No
        ``G_prev``: RK3 keeps its stage tendencies within a step."""
        g = self.grid
        vals = dict(values, h=h)
        locs = self._locs()
        sol = {}
        for name in self.prognostic_names():
            f = new_field(g, locs[name], self.bcs[name])
            sol[name] = set_field(f, g, vals.get(name, 0.0)).data
        state = dict(solution=sol,
                     clock=clock or Clock(host_scalar(g.dtype, 0.0), 0))
        if self.particles is not None:
            state["particles"] = self.particles
        return state

    def fill_all_halos(self, sol, t=0.0):
        """Fill the halos of every field of ``sol`` in place; returns it."""
        locs = self._locs()
        for name, arr in sol.items():
            fill_halos(arr, self.grid, locs[name], self.bcs[name], t)
        return sol

    # -- physics --------------------------------------------------------------------
    def _finish(self, G, state):
        """Each tendency's forcing (its callable of the grid, the clock
        and the solution), then its boundary fluxes (value-less flux BCs
        add nothing)."""
        locs, clock = self._locs(), state["clock"]
        fields = dict(state["solution"])
        out = {}
        for name in self.prognostic_names():
            g = G[name]
            if name in self.forcing:
                g = g + self.forcing[name](self.grid, clock, fields)
            out[name] = apply_flux_bcs(g, self.grid, locs[name],
                                       self.bcs[name], clock.time)
        return out

    def _vi_tendencies(self, state):
        """Vector-invariant tendencies (prognostic u, v, h): rotational
        momentum form with Bernoulli head; h and tracers advected by
        (u, v) with ``tracer_advection``."""
        grid, g = self.grid, self.g
        sol = state["solution"]
        u, v, h = sol["u"], sol["v"], sol["h"]
        zero_w = torch.zeros_like(h)
        ts = self.tracer_advection

        Gu = -self.advection.U_dot_grad_u(grid, u, v, zero_w) \
            - g * st.dxf(h) / grid.dx(U_LOC)
        Gv = -self.advection.U_dot_grad_v(grid, u, v, zero_w) \
            - g * st.dyf(h) / grid.dy(V_LOC)
        if self.bathymetry is not None:
            Gu = Gu + g * st.dxf(self.bathymetry) / grid.dx(U_LOC)
            Gv = Gv + g * st.dyf(self.bathymetry) / grid.dy(V_LOC)
        if self.coriolis is not None:
            Gu = Gu - self.coriolis.x_f_cross_U(grid, u, v, zero_w)
            Gv = Gv - self.coriolis.y_f_cross_U(grid, u, v, zero_w)
        if self.closure is not None:
            Gu = Gu + momentum_diffusion(u, grid, U_LOC, self.closure)
            Gv = Gv + momentum_diffusion(v, grid, V_LOC, self.closure)

        def div_Uc_2d(c):
            fx = grid.Ax(U_LOC) * transport(ts, u, c, 0, True, grid)
            fy = grid.Ay(V_LOC) * transport(ts, v, c, 1, True, grid)
            return (st.dxc(fx) + st.dyc(fy)) / grid.V(CENTER)

        G = {"u": Gu, "v": Gv, "h": -div_Uc_2d(h)}
        if self.tracer_names:
            # c ∇·U compressibility correction
            div_U = (st.dxc(grid.Ax(U_LOC) * u)
                     + st.dyc(grid.Ay(V_LOC) * v)) / grid.V(CENTER)
            for name in self.tracer_names:
                c = sol[name]
                Gc = -div_Uc_2d(c) + c * div_U
                if self.closure is not None:
                    Gc = Gc + tracer_diffusion(c, grid, name, self.closure)
                G[name] = Gc
        return self._finish(G, state)

    def tendencies(self, state, kernels=None):
        """G of every prognostic field: with-halo tensors valid on the
        interior. In the conservative form the core terms go through
        ``kernels["core"]``, K3a's wrapper unless ``kernels`` replaces it
        (``PLAIN``: the plain version)."""
        if self.formulation == "vector_invariant":
            return self._vi_tendencies(state)
        core = dict(KERNELS, **(kernels or {}))["core"]
        grid = self.grid
        sol = state["solution"]
        uh, vh, h = sol["uh"], sol["vh"], sol["h"]
        outs = core(grid, self.advection, self.tracer_advection, self.g, uh,
                    vh, h, [sol[n] for n in self.tracer_names],
                    self.bathymetry)
        Guh, Gvh, Gh = outs[:3]
        if self.coriolis is not None:
            zero_w = torch.zeros_like(h)
            Guh = Guh - self.coriolis.x_f_cross_U(grid, uh, vh, zero_w)
            Gvh = Gvh - self.coriolis.y_f_cross_U(grid, uh, vh, zero_w)
        if self.closure is not None:
            Guh = Guh + momentum_diffusion(uh, grid, U_LOC, self.closure)
            Gvh = Gvh + momentum_diffusion(vh, grid, V_LOC, self.closure)
        G = dict(uh=Guh, vh=Gvh, h=Gh)
        for name, Gc in zip(self.tracer_names, outs[3:]):
            if self.closure is not None:
                Gc = Gc + tracer_diffusion(sol[name], grid, name, self.closure)
            G[name] = Gc
        return self._finish(G, state)

    # -- stepping -----------------------------------------------------------------
    def step(self, state, dt, kernels=None):
        """One RK3 step: three stages of ``tendencies`` → ``rk3_substep`` →
        ``fill_all_halos``. ``kernels`` as in ``tendencies``."""
        clock0 = state["clock"]
        tick, dt = dt, float(dt)
        G_prev = None
        for gamma, zeta in zip(RK3_GAMMA, RK3_ZETA):
            G = self.tendencies(state, kernels)
            sol = rk3_substep(state["solution"], G, G_prev, dt, gamma, zeta)
            clock = state["clock"].tick(scaled(gamma + zeta, tick), stage=True)
            state = dict(state, solution=self.fill_all_halos(sol, clock.time),
                         clock=clock)
            G_prev = G
        state = dict(state, clock=clock0.tick(tick))
        p = state.get("particles")
        if p is not None:
            fields = {n: state["solution"][n] for n in self.tracer_names}
            state = dict(state, particles=p.step(self.grid, self.velocities(state),
                                                 dt, fields))
        return state

    def cell_diffusion_timescale(self, state):
        """min Δ²/max(ν, κ) over this model's closure; +inf when nothing
        limits."""
        return cell_diffusion_timescale(self.closure, self.grid, None,
                                        self.tracer_names)

    def cell_advection_timescale(self, state):
        """min(Δ / (|u| + √(gh))): the gravity-wave-aware CFL timescale."""
        grid = self.grid
        cg = torch.sqrt(self.g * torch.abs(state["solution"]["h"]))
        vels = self.velocities(state)
        u = torch.abs(vels["u"]) + cg
        v = torch.abs(vels["v"]) + cg
        tx = grid.interior(grid.dx(U_LOC) / torch.clamp(u, min=1e-30))
        ty = grid.interior(grid.dy(V_LOC) / torch.clamp(v, min=1e-30))
        return float(torch.minimum(tx.min(), ty.min()))

    def velocities(self, state):
        """Diagnostic velocities: u = uh/h̄ˣ in the conservative form,
        prognostic in the vector-invariant form."""
        sol = state["solution"]
        if self.formulation == "vector_invariant":
            return dict(u=sol["u"], v=sol["v"])
        return dict(u=sol["uh"] / st.ixf(sol["h"]),
                    v=sol["vh"] / st.iyf(sol["h"]))

    def fields(self, state):
        locs = self._locs()
        return {name: Field(arr, locs[name], self.bcs[name])
                for name, arr in state["solution"].items()}
