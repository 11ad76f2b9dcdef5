"""Hydrostatic free-surface (primitive-equation) model.

Counterpart of ``clima_oceananigans_jl_tpu/models/hydrostatic.py``
(Oceananigans' ``HydrostaticFreeSurfaceModel``):

  ∂t u = G_u − g∂x η (explicit),  G_u = −U·∇u − f×u|x − ∂x pHY′ + ∇·τ
  ∂t c = −∇·(U c) + ∇·(κ∇c)
  w    = −∫_{-H}^z ∇h·u dz'          (continuity, diagnosed)
  ∂t η = −∇h·U                       (per the free-surface treatment)

State: the JAX package's keys and shapes on its plain path — ``solution``
(u, v, tracers; with-halo), ``eta`` (X, Y, 1), the diagnosed ``w`` and
``pHY`` (with-halo), ``G_prev`` (with-halo; with an ``eta`` entry under
an explicit free surface), a host ``clock`` and ``previous_dt``.

A quasi-AB2 step:

- implicit free surface (the default): K4b in its advance mode, the
  halo fills, the barotropic transport's divergence, the FFT or CG solve
  for η and the −gΔt∇η correction, then ``update_state``;
- split-explicit free surface: K4b in its advance mode (tendencies and
  the AB2 substep in one pass), the barotropic modes of the solution and
  of c₁G − c₂G⁻, the N barotropic substeps (K5), the barotropic
  corrector, then ``update_state``;
- explicit free surface: K4b's tendencies, −g∇η, G_η = −∇h·U, the AB2
  substep of the solution and η, then ``update_state``.

With forcing, flux-BC values, an immersed boundary or a closure K4b
does not take (or ``fused_advection=False``) the implicit and
split-explicit steps take the JAX package's two-stage route instead of
the fused advance (``fused_advance``, fixed at construction as the JAX
package fixes it): ``tendencies`` (K4b in its tendency form, then the
diffusion K4b does not take, the forcing, the boundary fluxes, the
immersed bottom's fluxes and the masking of the tendencies), then
``ab2_substep`` on the with-halo fields, then the free surface as above.
A vertically implicit closure then takes its z diffusion through T1
(``implicit_step_fields``, ``kernels["tridiagonal"]``) after the AB2
substep, under all three free surfaces, as the JAX step does.

Closures: a constant-coefficient ``ScalarDiffusivity`` (scalar or
per-tracer ν, κ; ``ops/fused_hydrostatic.py::kernel_closure``) enters K4b
on a grid without an immersed boundary; every other closure (arrays,
callables, biharmonic, the LES closures, the vertical-mixing closures
CATKE, convective adjustment and Ri-based mixing, GM/Redi, tuples) adds
its explicit diffusion (GM/Redi its rotated fluxes) as torch ops in
``tendencies``, with its diffusivities computed in ``update_state``;
CATKE adds its prognostic ``e`` to the tracers and its TKE sources to
G_e, and its dissipation enters e's column solve.

Buoyancy: ``BuoyancyTracer`` or ``SeawaterBuoyancy`` with any equation of
state (``buoyancy/nonlinear_eos.py``), gravity tilted or not: K4a
integrates −ĝ_z b into pHY′; as in the JAX package the hydrostatic model
has no x or y buoyancy term.

Immersed boundaries (``GridFittedBottom``, ``GridFittedBoundary``,
``PartialCellBottom``): the grid is wrapped in an ``ImmersedGrid`` after
its halos are set (the JAX plain path's halos); with partial cells its
Δz, Ax, Ay and V are 3D (K4a and K4b read the two Δz arrays, the
implicit vertical diffusion the z axis' row, as in the JAX package);
``update_state`` masks the solution after its fills,
``tendencies`` adds the immersed bottom's fluxes and masks the
tendencies, the column depths count fluid cells (K5 reads them as (X, Y)
planes), the implicit free surface's "auto" solve is "pcg", and K4b's
conditional fluxes read the solid masks as clear flags.

``update_state`` fills the halos of the solution and η in one launch of
K6, masks the solid, K4a rebuilds w and pHY′ column by column, and a
second K6 launch fills their halos; a closure's diffusivities follow.
The kernels' wrappers are taken from ``KERNELS``;
``step(..., kernels=PLAIN)`` runs their plain versions, and so does every
step of a model built with the JAX keyword ``fused_advection=False``. On
the card the constructor of a model that runs the kernels checks their
static gates, so a configuration they lack raises there and the wrappers
do not check again. Not ported here,
because they are TPU-only: the halo rounding to multiples of 4, the
(x, z, y) state layout, the MXU cumsum. Decomposed over a mesh of shards
(``parallel/distributed.py``, ``tendencies_overlapped``) each shard runs
the kernels on its local grid: K4a and K4b read a cut axis' exchanged
halos, K6 fills through the exchange, and K5 runs its cut form, one
launch a half-substep between the fills
(``ops/fused_barotropic.py::cut_sequence``). A
configuration the port cannot run raises ``NotImplementedError`` at
construction.

Lagrangian particles (``particles=``, a ``LagrangianParticles``) ride in
``state["particles"]``: after each step's ``update_state`` they are
advected in (u, v, the diagnosed w) and sample the tracers, as in the
JAX package.
"""
from __future__ import annotations

import torch

from ..advection.schemes import CenteredSecondOrder
from ..advection.vector_invariant import VectorInvariant
from ..boundary_conditions.bcs import (FluxBC, OpenBC, apply_flux_bcs,
                                       apply_immersed_flux_bcs, regularize_bcs)
from ..closures.implicit_vertical_diffusion import implicit_step_fields
from ..closures.scalar_diffusivity import (add_tke_tendency,
                                           cell_diffusion_timescale,
                                           compute_closure_diffusivities,
                                           momentum_diffusion, tracer_diffusion)
from ..fields.field import Field, new_field, set_field
from ..forcings.forcing import regularize_forcing
from ..grids.topology import BOUNDED, FLAT
from ..immersed.immersed import ImmersedGrid
from ..ops.fused_barotropic import fused_substep_eta, fused_substep_eta_reference
from ..ops.fused_barotropic import unsupported_reason as barotropic_unsupported_reason
from ..ops.fused_fill import fused_fill_halos, fused_fill_halos_reference
from ..ops.fused_fill import fields_unsupported_reason
from ..ops.fused_hydrostatic import (KERNEL_CORIOLIS,
                                     fused_hydrostatic_tendencies,
                                     fused_hydrostatic_tendencies_reference,
                                     hydrostatic_columns,
                                     hydrostatic_columns_reference,
                                     kernel_closure,
                                     supports_fused_hydro_advance)
from ..ops.fused_hydrostatic import unsupported_reason as kernel_unsupported_reason
from ..ops.fused_tendencies import KERNEL_SCHEMES
from ..solvers.tridiagonal import (solve_batched_tridiagonal,
                                   solve_batched_tridiagonal_reference)
from ..timesteppers.steppers import (Clock, ab2_coefficients, ab2_substep,
                                     dt_changed, host_scalar)
from ..utils.location import CENTER, U_LOC, V_LOC, W_LOC
from .free_surface import (ETA_LOC, ExplicitFreeSurface, ImplicitFreeSurface,
                           SplitExplicitFreeSurface, barotropic_mode,
                           div_xy_2d, fill2d, grad_x, grad_y)

#: the kernels' wrappers a step calls, by name: w and pHY′ (K4a), the
#: tendencies and AB2 advance (K4b), the barotropic substeps (K5), the
#: halo fills (K6), the implicit vertical diffusion's column solves (T1)
KERNELS = dict(columns=hydrostatic_columns,
               tendencies=fused_hydrostatic_tendencies,
               barotropic=fused_substep_eta, fill=fused_fill_halos,
               tridiagonal=solve_batched_tridiagonal)
#: their plain versions: ``step(..., kernels=PLAIN)`` runs a step without
#: the kernels on the card, as does a model built with
#: ``fused_advection=False``
PLAIN = dict(columns=hydrostatic_columns_reference,
             tendencies=fused_hydrostatic_tendencies_reference,
             barotropic=fused_substep_eta_reference,
             fill=fused_fill_halos_reference,
             tridiagonal=solve_batched_tridiagonal_reference)


def _unsupported_reason(model):
    """Why the port cannot run this configuration yet, or None."""
    fs = model.free_surface
    if isinstance(fs, ImplicitFreeSurface):
        if fs.resolve_method(model.grid) not in ("fft", "pcg", "matrix",
                                                 "multigrid"):
            return f"unknown ImplicitFreeSurface solver_method {fs.solver_method!r}"
        if fs.resolve_method(model.grid) == "fft" and (
                model.grid.curvilinear or not model.grid.hregular):
            return "the fft free-surface solve needs a horizontally regular grid"
    elif not isinstance(fs, (ExplicitFreeSurface, SplitExplicitFreeSurface)):
        return f"free surface {type(fs).__name__} is not ported"
    sch, ts = model.momentum_advection, model.tracer_advection
    if sch is not None and type(sch) not in (VectorInvariant, *KERNEL_SCHEMES):
        return (f"{type(sch).__name__} momentum advection is not ported (the "
                "vector-invariant form and the JAX package's eight schemes are)")
    if ts is not None and type(ts) not in KERNEL_SCHEMES:
        return (f"{type(ts).__name__} tracer advection is not ported (the JAX "
                "package's eight schemes are)")
    cor = model.coriolis
    if cor is not None and not isinstance(cor, KERNEL_CORIOLIS):
        return (f"{type(cor).__name__} Coriolis is not ported (the f- and "
                "β-planes, the spherical and the two Cartesian forms are)")
    return None


class HydrostaticFreeSurfaceModel:
    def __init__(self, grid, momentum_advection="default",
                 tracer_advection="default", free_surface=None, buoyancy=None,
                 coriolis=None, closure=None, tracers=None, forcing=None,
                 boundary_conditions=None, particles=None,
                 immersed_boundary=None, fused_advection="auto"):
        if grid.topology[2] is FLAT:
            raise ValueError("HydrostaticFreeSurfaceModel needs a z direction")
        # the JAX keyword: "auto" and True run the kernels, False their
        # plain versions (the state is the JAX plain path's either way)
        self.fused_advection = fused_advection is True or fused_advection == "auto"
        self.kernels = KERNELS if self.fused_advection else PLAIN
        # None disables a term (Oceananigans' `advection = nothing`)
        self.momentum_advection = (VectorInvariant()
                                   if momentum_advection == "default"
                                   else momentum_advection)
        self.tracer_advection = (CenteredSecondOrder()
                                 if tracer_advection == "default"
                                 else tracer_advection)
        names = list(tracers) if tracers is not None else []
        if buoyancy is not None:
            for t in buoyancy.required_tracers:
                if t not in names:
                    names.append(t)
        for cl in (closure if isinstance(closure, (tuple, list)) else (closure,)):
            for t in getattr(cl, "required_tracers", ()):
                if t not in names:
                    names.append(t)
        self.tracer_names = tuple(names)
        h = max(getattr(self.momentum_advection, "required_halo", 1),
                getattr(self.tracer_advection, "required_halo", 1), 1)
        self.grid = grid.with_halo((h, h, h))
        # an immersed boundary: its masks built on the final grid, which is
        # wrapped (Oceananigans' ImmersedBoundaryGrid)
        # (a PartialCellBoundary's Δz arrays become the grid's vertical
        # metrics)
        if immersed_boundary is not None and hasattr(immersed_boundary, "build"):
            immersed_boundary = immersed_boundary.build(self.grid)
        self.immersed_boundary = immersed_boundary
        if immersed_boundary is not None:
            self.grid = ImmersedGrid.wrap(self.grid, immersed_boundary)
        self.free_surface = (free_surface if free_surface is not None
                             else ImplicitFreeSurface())
        self.buoyancy = buoyancy
        self.coriolis = coriolis
        self.closure = closure
        self.forcing = {k: regularize_forcing(k, v)
                        for k, v in (forcing or {}).items()}
        self.ab2_chi = 0.1
        user_bcs = boundary_conditions or {}
        self.bcs = {n: regularize_bcs(self.grid, loc, user_bcs.get(n))
                    for n, loc in self._locs().items()}
        self.eta_bcs = regularize_bcs(self.grid, ETA_LOC, user_bcs.get("eta"))
        # w: zero at the bottom face, the diagnosed top face left as it is
        wb = regularize_bcs(self.grid, W_LOC, user_bcs.get("w"))
        if self.grid.topology[2] is BOUNDED:
            wb.bottom = OpenBC(0.0)
            wb.top = FluxBC()
        self.w_bcs = wb
        self.pressure_bcs = regularize_bcs(self.grid, CENTER, None)
        self.particles = particles
        reason = _unsupported_reason(self)
        if reason is None and self.grid.device.type == "cuda":
            reason = self.card_unsupported_reason()
        if reason is not None:
            raise NotImplementedError(reason)
        # K4b's fused advance (tendencies and the AB2 substep in one
        # launch) where no term is added to G after the kernel; otherwise
        # the two-stage route, as the JAX package fixes it
        self.fused_advance = supports_fused_hydro_advance(self)

    # -- state ----------------------------------------------------------------
    def _kernels(self, kernels):
        """The model's mapping (``KERNELS``, or ``PLAIN`` under
        ``fused_advection=False``) with the entries of ``kernels`` in place
        of its own."""
        return dict(self.kernels, **(kernels or {}))

    def prognostic_names(self):
        return ("u", "v") + self.tracer_names

    def _locs(self):
        locs = dict(u=U_LOC, v=V_LOC)
        for n in self.tracer_names:
            locs[n] = CENTER
        return locs

    def card_unsupported_reason(self):
        """Why the kernels' gates refuse this model on the card, or None
        (``DistributedModel`` asks it again of each shard's model, whose
        grid may be cut over a mesh)."""
        if not self.fused_advection:
            return None
        reason = kernel_unsupported_reason(self)
        if reason is None and isinstance(self.free_surface,
                                         SplitExplicitFreeSurface):
            reason = barotropic_unsupported_reason(self.grid, self.eta_bcs)
        if reason is None:
            reason = self._fill_unsupported_reason()
        return reason

    def _fill_unsupported_reason(self):
        """Why K6 cannot fill one of the model's fields, or None."""
        g = self.grid
        fields = [(self._locs()[n], self.bcs[n]) for n in self.prognostic_names()]
        fields += [(W_LOC, self.w_bcs), (CENTER, self.pressure_bcs)]
        return fields_unsupported_reason(
            g, [(loc, bcs, (0, 1, 2), g.total_shape) for loc, bcs in fields]
            + [(ETA_LOC, self.eta_bcs, (0, 1), g.total_shape[:2] + (1,))])

    @property
    def _explicit_fs(self):
        return isinstance(self.free_surface, ExplicitFreeSurface)

    def initial_state(self, clock=None, eta=0.0, **values):
        """A filled state with ``values`` (scalars, arrays or callables of
        the (x, y, z) or (λ, φ, z) nodes) on the named prognostic fields
        and ``eta`` (a scalar or a callable of the horizontal nodes)."""
        g = self.grid
        locs = self._locs()
        sol = {}
        for name in self.prognostic_names():
            f = new_field(g, locs[name], self.bcs[name])
            sol[name] = set_field(f, g, values.get(name, 0.0)).data
        eta_arr = g.zeros(g.total_shape[:2] + (1,))
        if callable(eta):
            x, y, _ = g.nodes(ETA_LOC, with_halo=True)
            eta_arr = eta_arr + torch.as_tensor(eta(x, y), dtype=g.dtype,
                                                device=g.device)
        else:
            eta_arr = eta_arr + eta
        fill2d(eta_arr, g, ETA_LOC, self.eta_bcs)
        G_prev = {k: torch.zeros_like(v) for k, v in sol.items()}
        if self._explicit_fs:
            G_prev["eta"] = torch.zeros_like(eta_arr)
        state = dict(solution=sol, eta=eta_arr,
                     clock=clock or Clock(host_scalar(g.dtype, 0.0), 0),
                     G_prev=G_prev, previous_dt=host_scalar(g.dtype, -1.0))
        if self.particles is not None:
            state["particles"] = self.particles
        return self.update_state(state)

    def fill_all_halos(self, sol, t=0.0, kernels=None, eta=None, axes=(0, 1, 2)):
        """Fill the halos of every solution field on ``axes``, and of
        ``eta`` (on its horizontal ones) when given, in place, in one call
        of ``kernels["fill"]`` (K6); returns ``sol``."""
        locs = self._locs()
        fields = [(arr, locs[name], self.bcs[name], axes, t)
                  for name, arr in sol.items()]
        if eta is not None:
            fields.append((eta, ETA_LOC, self.eta_bcs,
                           tuple(a for a in axes if a < 2), t))
        self._kernels(kernels)["fill"](self.grid, fields)
        return sol

    def _local_axes(self):
        """The axes that are not cut over a mesh of shards."""
        return tuple(a for a in (0, 1, 2) if self.grid.dist[a] is None)

    def _buoyancy_field(self, sol):
        """The b whose downward integral is pHY′ (K4a's input): −ĝ_z b under
        tilted gravity, as the JAX ``hydrostatic_pressure_anomaly`` forms
        it; the hydrostatic model has no x or y buoyancy term."""
        if self.buoyancy is None:
            return None
        b = self.buoyancy.buoyancy_perturbation(
            self.grid, {n: sol[n] for n in self.tracer_names})
        gz = self.buoyancy.gravity_unit_vector[2]
        return b if gz == -1.0 else -gz * b

    def compute_w(self, sol, kernels=None, axes=(0, 1, 2)):
        """w from continuity, integrated bottom-up, halos filled on
        ``axes`` (through ``kernels["columns"]``, K4a, and
        ``kernels["fill"]``, K6)."""
        kernels = self._kernels(kernels)
        w, _ = kernels["columns"](self.grid, sol["u"], sol["v"])
        kernels["fill"](self.grid, [(w, W_LOC, self.w_bcs, axes, 0.0)])
        return w

    def update_state(self, state, kernels=None):
        """Halo fills of the solution and η (in place, one K6 launch), the
        solid masked to zero (with an immersed boundary), then w and pHY′
        from K4a (``kernels["columns"]``) with their halos filled (a second
        K6 launch), then the closure's diffusivities (where it has any)."""
        kernels = self._kernels(kernels)
        if getattr(self, "halo_overlap", False):
            return self._deferred_update_state(state, kernels)
        t = state["clock"].time
        sol = self.fill_all_halos(state["solution"], t, kernels, eta=state["eta"])
        if self.immersed_boundary is not None:
            state = self.immersed_boundary.mask_state(self, dict(state, solution=sol))
        return self._aux_state(state, kernels)

    def _deferred_update_state(self, state, kernels):
        """``update_state`` under ``halo_overlap`` (set by
        ``DistributedModel``, JAX l.356-365): the local-axis fills, the
        cut axes' wall faces and the masking now; the exchange, w, pHY′ and
        the diffusivities in the next step's ``tendencies_overlapped``."""
        from ..boundary_conditions.bcs import impose_cut_wall_faces
        t = state["clock"].time
        locs = self._locs()
        sol = self.fill_all_halos(state["solution"], t, kernels,
                                  axes=self._local_axes())
        for name, arr in sol.items():
            impose_cut_wall_faces(arr, self.grid, locs[name], self.bcs[name], t)
        state = dict(state, solution=sol)
        if self.immersed_boundary is not None:
            state = self.immersed_boundary.mask_state(self, state)
        return state

    def _aux_state(self, state, kernels):
        """w and pHY′ from K4a with their halos filled, then the closure's
        diffusivities: the part of ``update_state`` after the fills."""
        t = state["clock"].time
        sol = state["solution"]
        w, ph = kernels["columns"](self.grid, sol["u"], sol["v"],
                                   self._buoyancy_field(sol))
        fields = [(w, W_LOC, self.w_bcs, (0, 1, 2), 0.0)]
        if ph is not None:
            fields.append((ph, CENTER, self.pressure_bcs, (0, 1, 2), t))
        kernels["fill"](self.grid, fields)
        state = dict(state, w=w)
        if ph is not None:
            state["pHY"] = ph
        diff = compute_closure_diffusivities(
            self.closure, self.grid, dict(sol, w=w), self.buoyancy,
            {n: sol[n] for n in self.tracer_names})
        if diff is not None:
            state["diffusivities"] = diff
        return state

    # -- tendencies ---------------------------------------------------------------
    def tendencies(self, state, kernels=None):
        """With-halo tendencies of every prognostic field, valid on the
        interior: K4b's core (``kernels["tendencies"]``, with the explicit
        diffusion of a ``kernel_closure``), −g∇η under an explicit free
        surface, the diffusion of any other closure, then per field its
        forcing, boundary fluxes and immersed-bottom fluxes, with
        ``fields`` the solution, w and η (a discrete-form BC or forcing
        may read them); with an immersed boundary the tendencies are then
        zero in the solid. A state without w (as the JAX package keeps it
        when its kernel rebuilds w) gets it rebuilt through
        ``kernels["columns"]`` (K4a) first, as the JAX step does."""
        grid = self.grid
        if state.get("w") is None:
            state = dict(state, w=self.compute_w(state["solution"], kernels))
        G = self._kernels(kernels)["tendencies"](self, state)
        if self._explicit_fs:
            g = self.free_surface.gravitational_acceleration
            G["u"] = G["u"] - g * grad_x(grid, state["eta"])
            G["v"] = G["v"] - g * grad_y(grid, state["eta"])
        sol = state["solution"]
        if self.closure is not None and kernel_closure(self) is None:
            diff = state.get("diffusivities")
            for name, loc in (("u", U_LOC), ("v", V_LOC)):
                G[name] = G[name] + momentum_diffusion(sol[name], grid, loc,
                                                       self.closure, diff)
            for name in self.tracer_names:
                G[name] = G[name] + tracer_diffusion(sol[name], grid, name,
                                                     self.closure, diff)
            if "e" in G:
                G["e"] = add_tke_tendency(G["e"], self.closure, grid,
                                          dict(sol, w=state["w"]), diff,
                                          self.tracer_names)
        clock = state["clock"]
        fields = dict(sol, w=state["w"], eta=state["eta"])
        locs = self._locs()
        for name in self.prognostic_names():
            if name in self.forcing:
                G[name] = G[name] + self.forcing[name](grid, clock, fields)
            G[name] = apply_flux_bcs(G[name], grid, locs[name], self.bcs[name],
                                     clock.time, fields)
            G[name] = apply_immersed_flux_bcs(G[name], grid, locs[name],
                                              self.bcs[name], clock.time, fields)
        if self.immersed_boundary is not None:
            G = {k: self.immersed_boundary.mask_tendency(self, k, g_arr)
                 for k, g_arr in G.items()}
        return G

    def tendencies_overlapped(self, state, kernels=None):
        """The halo-overlap tendencies of a shard (JAX l.405-480): the
        exchange of the solution and η and the deferred masking, w, pHY′
        and diffusivities; the tendencies from the solution whose cut-axis
        halos are the last step's (local axes filled, w diagnosed from it);
        then the H-wide strips along each cut axis recomputed on
        ``grid.subgrid_along`` from the exchanged fields and written over
        (``parallel/distributed.py::patch_edge_strips``), in JAX's order.
        Returns ``(G, state)`` with the exchanged fields."""
        k = self._kernels(kernels)
        t = state["clock"].time
        stale = state["solution"]
        eta = state["eta"].clone()
        sol_fresh = self.fill_all_halos({n: a.clone() for n, a in stale.items()},
                                        t, k, eta=eta)
        fresh = dict(state, solution=sol_fresh, eta=eta)
        if self.immersed_boundary is not None:
            fresh = self.immersed_boundary.mask_state(self, fresh)
        fresh = self._aux_state(fresh, k)
        local = self._local_axes()
        sol_local = self.fill_all_halos({n: a.clone() for n, a in stale.items()},
                                        t, k, axes=local)
        if self.immersed_boundary is not None:
            sol_local = self.immersed_boundary.mask_state(
                self, dict(state, solution=sol_local))["solution"]
        w_local = self.compute_w(sol_local, k, axes=local)
        G = self.tendencies(dict(fresh, solution=sol_local, w=w_local), k)
        from ..parallel.distributed import patch_edge_strips
        return patch_edge_strips(self, G, fresh,
                                 ("solution", "diffusivities", "pHY", "w", "eta"),
                                 k), fresh

    # -- stepping ---------------------------------------------------------------
    def step(self, state, dt, kernels=None):
        """One quasi-AB2 step with the free surface split out (Euler at
        iteration 0 and when Δt changed), through the model's mapping of
        the kernels' wrappers (``self.kernels``); ``kernels`` replaces some
        or all of them by name."""
        kernels = self._kernels(kernels)
        grid = self.grid
        fs = self.free_surface
        clock0 = state["clock"]
        tick, dt = dt, float(dt)
        euler = clock0.iteration == 0 or dt_changed(state["previous_dt"], tick)
        G_overlap = None
        if getattr(self, "halo_overlap", False):
            # the exchanged state from here on (JAX l.630-631)
            G_overlap, state = self.tendencies_overlapped(state, kernels)
        G_prev = state["G_prev"]
        sol0 = state["solution"]
        # a vertically implicit closure's z diffusion (T1), after the AB2
        # substep (a no-op for other closures)
        implicit = lambda s: implicit_step_fields(
            s, grid, self._locs(), self.closure, dt, state.get("diffusivities"),
            self.bcs, clock0.time, kernels["tridiagonal"])
        if self._explicit_fs:
            G = G_overlap if G_overlap is not None else self.tendencies(state, kernels)
            U, V = barotropic_mode(grid, sol0["u"], sol0["v"])
            G["eta"] = -div_xy_2d(grid, U, V)
            stepped = ab2_substep(dict(sol0, eta=state["eta"]), G, G_prev, dt,
                                  self.ab2_chi, euler)
            eta = stepped.pop("eta")
            sol = implicit(stepped)
        else:
            if G_overlap is not None:
                G = G_overlap
                sol = ab2_substep(sol0, G, G_prev, dt, self.ab2_chi, euler)
            elif self.fused_advance:
                sol, G = kernels["tendencies"](self, state, advance=(dt, euler))
            else:
                G = self.tendencies(state, kernels)
                sol = ab2_substep(sol0, G, G_prev, dt, self.ab2_chi, euler)
            if isinstance(fs, ImplicitFreeSurface):
                sol = self.fill_all_halos(implicit(sol), clock0.time, kernels)
                Qu, Qv = barotropic_mode(grid, sol["u"], sol["v"])
                g = fs.gravitational_acceleration
                rhs = (div_xy_2d(grid, Qu, Qv) - state["eta"] / dt) / (g * dt)
                eta = fs.solve(grid, self.eta_bcs, rhs, state["eta"], dt)
                sol = dict(sol, u=sol["u"] - g * dt * grad_x(grid, eta),
                           v=sol["v"] - g * dt * grad_y(grid, eta))
            else:  # split-explicit
                U0, V0 = barotropic_mode(grid, sol0["u"], sol0["v"])
                c1, c2 = ab2_coefficients(self.ab2_chi, euler)
                GU, GV = barotropic_mode(grid, c1 * G["u"] - c2 * G_prev["u"],
                                         c1 * G["v"] - c2 * G_prev["v"])
                eta, U_av, V_av = fs.substep_eta(grid, self.eta_bcs,
                                                 state["eta"], GU, GV, U0, V0,
                                                 dt, kernels["barotropic"])
                sol = implicit(sol)
                u, v = fs.corrector(grid, sol["u"], sol["v"], U_av, V_av)
                sol = dict(sol, u=u, v=v)
        new_state = dict(state, solution=sol, eta=eta, G_prev=G,
                         clock=clock0.tick(tick),
                         previous_dt=host_scalar(grid.dtype, tick))
        new_state = self.update_state(new_state, kernels)
        p = new_state.get("particles")
        if p is not None:  # in the updated (u, v, diagnosed w)
            sol = new_state["solution"]
            vels = dict(u=sol["u"], v=sol["v"], w=new_state["w"])
            fields = {n: sol[n] for n in self.tracer_names}
            new_state = dict(new_state, particles=p.step(grid, vels, dt, fields))
        return new_state

    # -- diagnostics ---------------------------------------------------------------
    def cell_diffusion_timescale(self, state):
        """min Δ²/max(ν, κ) over the model's closures (Oceananigans'
        turbulence_closure_diagnostics.jl); +inf when nothing limits."""
        return cell_diffusion_timescale(self.closure, self.grid,
                                        state.get("diffusivities"),
                                        self.tracer_names)

    def cell_advection_timescale(self, state):
        """min Δ/|u| over the interior, for u, v and w."""
        grid = self.grid
        sol = state["solution"]
        scales = []
        for arr, axis, loc in ((sol["u"], 0, U_LOC), (sol["v"], 1, V_LOC),
                               (state["w"], 2, W_LOC)):
            if grid.topology[axis] is FLAT:
                continue
            val = torch.broadcast_to(
                grid.spacing(axis, loc) / arr.abs().clamp_min(1e-30),
                grid.total_shape)
            scales.append(grid.interior(val).min())
        return torch.stack(scales).min()

    def fields(self, state):
        locs = self._locs()
        out = {name: Field(arr, locs[name], self.bcs[name])
               for name, arr in state["solution"].items()}
        out["w"] = Field(state["w"], W_LOC, self.w_bcs)
        out["eta"] = Field(state["eta"], ETA_LOC, self.eta_bcs)
        return out
