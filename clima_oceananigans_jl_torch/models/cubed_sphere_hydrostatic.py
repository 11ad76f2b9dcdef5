"""Hydrostatic free-surface model on the cubed sphere.

Counterpart of ``clima_oceananigans_jl_tpu/models/cubed_sphere_hydrostatic.py``
(Oceananigans' HydrostaticFreeSurfaceModel on a ConformalCubedSphereGrid).
The whole state lives on the (6, X, Y, Z) layout of ``CubedSphereGrid``:
the tendencies are one ``torch.func.vmap`` over the faces of the
per-face stencils (vector-invariant momentum, the tracer schemes, the
spherical Coriolis force with f at vorticity points from the faces' true
latitudes), and the inter-face exchange (``CubedSphereGrid.fill_halos``)
fills the halos.

Prognostic: u, v (face-tangent velocities, 3D), tracers (3D), η (the
(6, X, Y, 1) free surface); w is diagnosed from continuity, and the free
surface is explicit (∂t η = −∇·∫u dz). Time stepping: RK3 with the
Le-Moin table. Plain PyTorch operations: the JAX package runs this model
in XLA and no kernel of either package serves it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..advection.fluxes import div_Uc
from ..advection.schemes import CenteredSecondOrder
from ..advection.vector_invariant import VectorInvariant
from ..ops import stencil as st
from ..timesteppers.steppers import RK3_GAMMA, RK3_ZETA, Clock, host_scalar, scaled
from ..utils.location import C, CENTER, F, U_LOC, V_LOC


class CubedSphereHydrostaticModel:
    """Config container; the step is a function of the (6, X, Y, Z) state."""

    def __init__(self, grid, momentum_advection=None, tracer_advection=None,
                 coriolis_rotation_rate=7.292115e-5, buoyancy=None,
                 gravitational_acceleration=9.80665, closure=None,
                 tracers=(), depth=None, prescribed_velocities=False,
                 cuda_graphs=True):
        """``depth``: barotropic layer depth for flat-z (Nz=1) grids
        (defaults to the z-axis extent). ``prescribed_velocities``: hold
        u, v, η fixed and step only the tracers (Oceananigans'
        PrescribedVelocityFields on the cubed sphere). ``cuda_graphs``:
        on the card, replay each Δt's step from a CUDA graph (bitwise the
        eager step: the same kernels)."""
        self.prescribed_velocities = bool(prescribed_velocities)
        self.cuda_graphs = bool(cuda_graphs)
        self._graphs = {}
        self.grid = grid
        self.depth = float(depth) if depth is not None else None
        self.momentum_advection = (momentum_advection
                                   if momentum_advection is not None
                                   else VectorInvariant())
        self.tracer_advection = (tracer_advection if tracer_advection is not None
                                 else CenteredSecondOrder())
        self.g = float(gravitational_acceleration)
        self.buoyancy = buoyancy
        self.closure = closure
        names = list(tracers)
        if buoyancy is not None:
            for t in buoyancy.required_tracers:
                if t not in names:
                    names.append(t)
        self.tracer_names = tuple(names)
        # Coriolis f = 2Ω sin φ at vorticity points (F,F) per face, from the
        # faces' true latitudes
        lat_ff = np.stack([
            np.degrees(np.arcsin(np.clip(
                grid._nodes(f, (F, F))[..., 2] /
                np.linalg.norm(grid._nodes(f, (F, F)), axis=-1), -1, 1)))
            for f in range(6)])
        self.f_ff = grid._tensor(2.0 * coriolis_rotation_rate
                                 * np.sin(np.radians(lat_ff))[..., None])

    # -- state -----------------------------------------------------------------
    def prognostic_names(self):
        return ("u", "v") + self.tracer_names

    def initial_state(self, u=None, v=None, eta=0.0, clock=None, **tracers):
        """u/v: callables p3d -> value (projected on face tangents) or
        (6,X,Y,Z) arrays; eta: callable p3d -> value or scalar."""
        g = self.grid
        shp = g.total_shape
        zeros = lambda: torch.zeros(shp, dtype=g.dtype, device=g.device)

        def vec_component(fn, loc2, axis):
            out = np.zeros(shp[:3])
            tangents = g._tangents(loc2, axis)
            for f in range(6):
                out[f] = (np.asarray(fn(g._nodes(f, loc2))) * tangents[f]).sum(-1)
            return g._tensor(out[..., None] * np.ones(shp[3:]))

        sol = {}
        if callable(u) or callable(v):
            vf = u if callable(u) else (lambda p: np.zeros(p.shape[:-1] + (3,)))
            sol["u"] = vec_component(vf, (F, C), 0)
            sol["v"] = vec_component(vf, (C, F), 1)
        else:
            sol["u"] = zeros() if u is None else g._tensor(_host(u))
            sol["v"] = zeros() if v is None else g._tensor(_host(v))
        for n in self.tracer_names:
            val = tracers.get(n, 0.0)
            if callable(val):
                pts = np.stack([g._nodes(f, (C, C)) for f in range(6)])
                # centres at each z level share horizontal position
                sol[n] = g._tensor(np.asarray(val(pts))[..., None] * np.ones(shp[3:]))
            else:
                sol[n] = torch.full(shp, val, dtype=g.dtype, device=g.device)
        if callable(eta):
            pts = np.stack([g._nodes(f, (C, C)) for f in range(6)])
            eta_arr = g._tensor(np.asarray(eta(pts))[..., None])
        else:
            eta_arr = torch.full(shp[:3] + (1,), eta, dtype=g.dtype, device=g.device)
        clock = clock or Clock(host_scalar(g.dtype, 0.0), 0)
        return dict(solution=sol, eta=eta_arr, clock=clock)

    # -- halo exchange ----------------------------------------------------------
    def exchange(self, state):
        g = self.grid
        sol = dict(state["solution"])
        sol["u"], sol["v"] = g.fill_halos(sol["u"], vector_pair=(sol["u"], sol["v"]))
        for n in self.tracer_names:
            sol[n] = g.fill_halos(sol[n])
        eta = g.fill_halos(state["eta"])
        return dict(state, solution=sol, eta=eta)

    # -- physics ----------------------------------------------------------------
    def _face_tendencies(self, fg, f_ff, u, v, eta, tracers):
        """Per-face tendencies (vmapped over the leading face axis)."""
        Hz, Nz = fg.Hz, fg.Nz
        # w from continuity (bottom-up integral of -divergence)
        div_h = (st.dxc(fg.Ay(U_LOC) * u) + st.dyc(fg.Ax(V_LOC) * v)) / fg.Az(CENTER)
        w = torch.zeros_like(u)
        if Nz > 1:
            dz = torch.broadcast_to(fg.dz(CENTER), div_h.shape)
            s = torch.cumsum((div_h * dz)[:, :, Hz:Hz + Nz], dim=2)
            # w's levels Hz+1 .. Hz+Nz, out of place (w.at[...].set(-s))
            w = torch.cat([w[:, :, :Hz + 1], -s, w[:, :, Hz + Nz + 1:]], dim=2)

        adv = self.momentum_advection
        Gu = -adv.U_dot_grad_u(fg, u, v, w)
        Gv = -adv.U_dot_grad_v(fg, u, v, w)
        # spherical coriolis, energy-conserving form with f at (F,F)
        dx_v = fg.dx((C, F, C)) * v
        dy_u = fg.dy((F, C, C)) * u
        Gu = Gu + st.iyc(f_ff * st.ixf(dx_v)) / fg.dx(U_LOC)
        Gv = Gv - st.ixc(f_ff * st.iyf(dy_u)) / fg.dy(V_LOC)
        # free-surface pressure gradient
        ge = self.g * eta
        Gu = Gu - st.dxf(ge) / fg.dx(U_LOC)
        Gv = Gv - st.dyf(ge) / fg.dy(V_LOC)

        # explicit free surface: ∂t η = −∇·U (vertical integral)
        if Nz > 1:
            dzc = torch.broadcast_to(fg.dz(U_LOC), u.shape)[:, :, Hz:Hz + Nz]
            U = torch.sum(u[:, :, Hz:Hz + Nz] * dzc, 2, keepdim=True)
            V = torch.sum(v[:, :, Hz:Hz + Nz] * dzc, 2, keepdim=True)
        else:
            Hdepth = (self.depth if self.depth is not None
                      else (fg._zaxis.extent if fg._zaxis.extent else 1.0))
            U = u * Hdepth
            V = v * Hdepth
        Geta = -(st.dxc(fg.Ay(U_LOC) * U) + st.dyc(fg.Ax(V_LOC) * V)) / fg.Az(CENTER)

        Gc = {name: -div_Uc(fg, self.tracer_advection, u, v, w, c)
              for name, c in tracers.items()}
        return Gu, Gv, Geta, Gc

    def tendencies(self, state):
        """(Gu, Gv, Gη, {tracer: G}) of every face, in one vmapped call."""
        sol = state["solution"]
        tracers = {n: sol[n] for n in self.tracer_names}
        return self.grid.vmap_faces(self._face_tendencies, self.f_ff, sol["u"],
                                    sol["v"], state["eta"], tracers)

    # -- stepping ---------------------------------------------------------------
    def rk3_update(self, state, G, prev, gamma, zeta, dt):
        """One RK3 stage's update of the solution and η (u, v and η held
        with ``prescribed_velocities``): u + (Δt·γ)·G on the first stage,
        u + Δt(γG + ζG⁻) after, the JAX trees."""
        Gu, Gv, Geta, Gc = G
        sol = dict(state["solution"])
        eta = state["eta"]
        if prev is None:
            dtg = scaled(gamma, dt)
            if not self.prescribed_velocities:
                sol["u"] = sol["u"] + dtg * Gu
                sol["v"] = sol["v"] + dtg * Gv
                eta = eta + dtg * Geta
            for n in self.tracer_names:
                sol[n] = sol[n] + dtg * Gc[n]
        else:
            pu, pv, pe, pc = prev
            if not self.prescribed_velocities:
                sol["u"] = sol["u"] + dt * (gamma * Gu + zeta * pu)
                sol["v"] = sol["v"] + dt * (gamma * Gv + zeta * pv)
                eta = eta + dt * (gamma * Geta + zeta * pe)
            for n in self.tracer_names:
                sol[n] = sol[n] + dt * (gamma * Gc[n] + zeta * pc[n])
        return dict(state, solution=sol, eta=eta)

    def _advance(self, fields, dt):
        """The step's tensors from ``fields`` = (u, v, η, *tracers): the
        exchange, then three stages of tendencies, update and exchange."""
        u, v, eta, *tracers = fields
        state = dict(solution=dict(u=u, v=v, **dict(zip(self.tracer_names, tracers))),
                     eta=eta)
        state = self.exchange(state)
        prev = None
        for gamma, zeta in zip(RK3_GAMMA, RK3_ZETA):
            G = self.tendencies(state)
            state = self.exchange(self.rk3_update(state, G, prev, gamma, zeta, dt))
            prev = G
        sol = state["solution"]
        return [sol["u"], sol["v"], state["eta"]] + [sol[n] for n in self.tracer_names]

    def _replay(self, fields, dt):
        """``_advance`` through a CUDA graph captured at the first step of
        each Δt: the same kernels, launched at once (the step is ~700
        small launches, so the host sets its pace otherwise). The inputs
        are copied into the graph's tensors and its outputs copied out."""
        key = (type(dt).__name__, float(dt), tuple(tuple(f.shape) for f in fields))
        if key not in self._graphs:
            static_in = [f.clone() for f in fields]
            side = torch.cuda.Stream(device=static_in[0].device)
            side.wait_stream(torch.cuda.current_stream(static_in[0].device))
            with torch.cuda.stream(side):
                self._advance(static_in, dt)  # the step's lazy set-up
            torch.cuda.current_stream(static_in[0].device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static_out = self._advance(static_in, dt)
            self._graphs[key] = (graph, static_in, static_out)
        graph, static_in, static_out = self._graphs[key]
        for a, b in zip(static_in, fields):
            a.copy_(b)
        graph.replay()
        return [o.clone() for o in static_out]

    def step(self, state, dt):
        """RK3 (Oceananigans' runge_kutta_3.jl γ/ζ table): the exchange,
        then three stages of tendencies, update and exchange; on the card
        through a CUDA graph of the step (``cuda_graphs``)."""
        sol = state["solution"]
        fields = [sol["u"], sol["v"], state["eta"]] + [sol[n] for n in self.tracer_names]
        if self.cuda_graphs and fields[0].is_cuda:
            out = self._replay([f.contiguous() for f in fields], dt)
        else:
            out = self._advance(fields, dt)
        u, v, eta, *tracers = out
        return dict(state, solution=dict(sol, u=u, v=v, **dict(zip(self.tracer_names, tracers))),
                    eta=eta, clock=state["clock"].tick(dt))


def _host(a):
    """An array (numpy or torch) as numpy."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
