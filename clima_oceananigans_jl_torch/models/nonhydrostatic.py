"""Nonhydrostatic (incompressible Boussinesq) model.

Counterpart of ``clima_oceananigans_jl_tpu/models/nonhydrostatic.py``
(Oceananigans' ``NonhydrostaticModel``):

  ∂t u = G_u − ∂x pNHS,  G_u = −∇·(vu) − f×u|_x − ∂x pHY′ + ∇·(ν∇u) + Fu
  ∂t w = G_w − ∂z pNHS,  G_w = −∇·(vw) − f×u|_z + ∇·(ν∇w) + Fw
  (buoyancy and ∂z pHY′ cancel exactly in G_w, pHY′ = −∫ b̄ᶻ dz)
  ∂t c = −∇·(vc) + ∇·(κ∇c) + Fc
  ∇²pNHS = ∇·u*/Δt  (FFT eigenexpansion solve)

Time stepping, as the JAX package runs it on the TPU:

- quasi-AB2, fused branch (``fused_step``): the fused AB2 advance (kernel
  K1 on the GPU, its plain PyTorch version on the CPU), then either the
  roll-based projection on interiors and one pad, or (``general_route``:
  a stretched z, a vertically implicit closure, w walls that are not
  imposed values) the implicit step and ``project_velocities`` on the
  with-halo ψ′; then ``update_state``;
- quasi-AB2, general branch (a term K1 lacks: forcing, background
  fields, Stokes drift, tilted gravity, flux-BC values, an LES,
  biharmonic or array-valued closure, or a closure whose vertical part
  the kernel cannot take): ``tendencies`` → ``ab2_substep`` → implicit
  step → ``project_velocities``;
- RK3: three stages of ``tendencies`` → ``rk3_substep`` → implicit step →
  ``project_velocities`` → ``update_state``.

The implicit step (a vertically implicit closure) solves each field's
columns through ``solve_batched_tridiagonal`` (kernel T1 on the GPU).

``tendencies`` computes the advection of every field through
``fused_advective_tendencies`` (kernel K2 on the GPU) and adds, in the
JAX term order, the background cross terms, Coriolis, −∂pHY′ and the
tilted-gravity terms, the Stokes drift, diffusion, then per field its
forcing and boundary fluxes, with PyTorch ops. ``project_velocities``
takes the roll-based projection where the JAX package does (periodic x
and y, w walls that are imposed values), and otherwise the general
projection: halo fills, ``fused_divergence`` (K3b), the pressure solve
and ``fused_pressure_gradient`` (K3c). On a grid stretched in z alone the
pressure solve is the Fourier-tridiagonal one (its modes through T1); on
a grid stretched in x or y it is ``MultigridPoissonSolver``
(``solvers/stencil_matrix.py``: CG preconditioned by a geometric
multigrid V-cycle, PyTorch ops), K2 runs its stretched-x/y form (the x,
y and z rows of ``ops/metric_rows.py::axis_rows``), and the step takes
the general AB2 branch, as the JAX package's gate has it. On any
stretched axis the projection's divergence and gradient are the
whole-array PyTorch operators with the grid's per-index metrics, as the
JAX package runs them there.
``update_state`` and the general projection fill halos through
``fused_fill_halos`` (K6), two launches each, whatever the BCs' values
(scalars, planes, callables, gradients); ``update_state`` computes the
closure's diffusivities (the LES closures) between them. Periodic, bounded
and Flat axes all run: the kernels take bounded x and y and move a Flat
axis to their y (``ops/fused_tendencies.py::kernel_order``); a bounded x
or y, or a Flat y, keeps the AB2 step on the general branch, as the JAX
package's gate does. A grid-fitted immersed boundary (``GridFittedBottom``,
``GridFittedBoundary``) wraps the with-halo grid in an ``ImmersedGrid``:
K2 reads its clear flags (the conditional fluxes), ``update_state`` masks
the fields in the solid, ``tendencies`` adds the immersed bottom's fluxes
and masks the tendencies, and the step takes the general AB2 branch and
the general projection (the parent grid's solve of the masked
velocities' divergence), as in the JAX package. Lagrangian particles
(``particles=``) ride in ``state["particles"]`` and are advected after
each step in the updated velocities, sampling the tracers they track. Every one of the JAX
package's eight advection schemes runs for momentum and tracers, in K1 and
K2 alike (``PositiveWENO5``'s limiter included), and the scheme does not
choose the AB2 branch, as in the JAX package. A configuration the port
cannot run (other Coriolis or closures, ``PartialCellBottom``, ...) raises
``NotImplementedError`` at construction. The kernels' wrappers
come from ``KERNELS``; the JAX keyword ``fused_advection=False`` swaps in
``PLAIN`` and takes the general AB2 branch, as its JAX meaning has it.
Background fields take that branch too, as in the JAX package, with their
cross terms as PyTorch ops, but keep the kernels for the rest.
Decomposed over a mesh of shards (``parallel/distributed.py``) each
shard's model runs on its local grid, whose cut axes are
``FULLY_CONNECTED``: the fills exchange along them, K2, K3b and K3c read
their halos as on a periodic axis, the step takes the general AB2 branch
and the general projection with the pencil solver, and under
``halo_overlap`` ``update_state`` defers its exchange to
``tendencies_overlapped``, as in the JAX package.

State: the JAX package's keys and shapes. ``solution`` holds with-halo
tensors; ``G_prev`` is halo-free (nx, ny, nz) when ``g_interior`` holds
(the fused AB2 branch with z-halo-free walls), with-halo otherwise;
``pNHS`` and ``pHY`` are with-halo tensors; ``clock.time`` and
``previous_dt`` are numpy scalars of the grid's dtype, as the JAX package's
0-d arrays are.
"""
from __future__ import annotations

import torch

from ..advection.schemes import CenteredSecondOrder
from ..boundary_conditions.bcs import (_bvalue, apply_flux_bcs,
                                      apply_immersed_flux_bcs, regularize_bcs)
from ..advection.fluxes import div_Uc, div_vu, div_vv, div_vw
from ..buoyancy.buoyancy import (buoyancy_x_term, buoyancy_y_term,
                                 hydrostatic_pressure_anomaly)
from ..closures.implicit_vertical_diffusion import implicit_step_fields
from ..closures.scalar_diffusivity import (add_tke_tendency,
                                           cell_diffusion_timescale,
                                           compute_closure_diffusivities,
                                           momentum_diffusion,
                                           tracer_diffusion)
from ..fields.background import materialize_background
from ..fields.field import Field, new_field, set_field
from ..forcings.forcing import regularize_forcing
from ..grids.topology import BOUNDED, FLAT, PERIODIC
from ..immersed.immersed import ImmersedBoundary, ImmersedGrid, PartialCellBottom
from ..ops import stencil as st
from ..parallel.distributed_fft import DistributedFourierTridiagonalSolver
from ..ops.fused_fill import (fields_unsupported_reason, fused_fill_halos,
                              fused_fill_halos_reference)
from ..ops.fused_step import (fused_ab2_advance, fused_ab2_advance_reference,
                              fused_step_ok, general_route, unsupported_reason)
from ..ops.fused_tendencies import (fused_advective_tendencies,
                                    fused_advective_tendencies_reference,
                                    fused_divergence,
                                    fused_divergence_reference,
                                    fused_pressure_gradient,
                                    fused_pressure_gradient_reference,
                                    z_halo_free_ok)
from ..solvers.fft_poisson import FFTPoissonSolver
from ..solvers.fourier_tridiagonal import FourierTridiagonalSolver
from ..solvers.stencil_matrix import MultigridPoissonSolver
from ..solvers.tridiagonal import (fourier_tridiagonal,
                                   fourier_tridiagonal_reference,
                                   solve_batched_tridiagonal,
                                   solve_batched_tridiagonal_reference)
from ..timesteppers.steppers import (RK3_GAMMA, RK3_ZETA, Clock, ab2_substep,
                                     dt_changed, host_scalar, rk3_substep,
                                     scaled)
from ..utils.location import CENTER, U_LOC, V_LOC, W_LOC

#: the kernels' wrappers a step calls, by name: the fused AB2 advance (K1),
#: the advection of every ``tendencies`` call (K2), the general
#: projection's divergence (K3b) and gradient (K3c), the halo fills of
#: ``update_state`` and the general projection (K6), the implicit step's
#: column solves and the Fourier-tridiagonal pressure solve's (T1)
KERNELS = dict(advance=fused_ab2_advance, advect=fused_advective_tendencies,
               divergence=fused_divergence, gradient=fused_pressure_gradient,
               fill=fused_fill_halos, tridiagonal=solve_batched_tridiagonal,
               fourier=fourier_tridiagonal)
#: their plain versions: ``step(..., kernels=PLAIN)`` runs a step without
#: the kernels on the card, as does a model built with
#: ``fused_advection=False``
PLAIN = dict(advance=fused_ab2_advance_reference,
             advect=fused_advective_tendencies_reference,
             divergence=fused_divergence_reference,
             gradient=fused_pressure_gradient_reference,
             fill=fused_fill_halos_reference,
             tridiagonal=solve_batched_tridiagonal_reference,
             fourier=fourier_tridiagonal_reference)


def select_pressure_solver(grid):
    """A regular grid takes the FFT solve; a grid stretched in z only (x
    and y regular) the Fourier-tridiagonal one; a stretched x or y
    multigrid-preconditioned CG (``MultigridPoissonSolver``), as the JAX
    package builds it (tolerance 1e-9, at most 200 iterations)."""
    if grid.all_regular:
        return FFTPoissonSolver.build(grid)
    if grid.hregular:
        return FourierTridiagonalSolver.build(grid)
    return MultigridPoissonSolver.build(grid, tolerance=1e-9, maxiter=200)


class NonhydrostaticModel:
    def __init__(self, grid, advection=None, tracer_advection=None,
                 buoyancy=None, coriolis=None, stokes_drift=None,
                 closure=None, tracers=None, forcing=None,
                 background_fields=None, boundary_conditions=None,
                 timestepper="QuasiAdamsBashforth2", immersed_boundary=None,
                 particles=None, fused_advection="auto"):
        # the JAX keyword: "auto" and True run the kernels (on the card;
        # their plain versions on CPU tensors) and the fused AB2 branch
        # where fused_step_ok allows it; False runs the plain versions and
        # the branch the JAX package's False takes. Background fields take
        # that branch too (the JAX package runs their cross terms outside
        # its kernels, as the port runs them as PyTorch ops), while the
        # kernels still advect the fields themselves, project and fill:
        # each is bitwise its plain version. The TPU's rounding of the y
        # halo to a multiple of 4 has no counterpart here.
        kernels_on = fused_advection is True or fused_advection == "auto"
        self.fused_advection = kernels_on and not background_fields
        self.kernels = KERNELS if kernels_on else PLAIN
        self.advection = advection if advection is not None else CenteredSecondOrder()
        self.tracer_advection = (tracer_advection if tracer_advection is not None
                                 else self.advection)
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
        h = max(self.advection.required_halo,
                self.tracer_advection.required_halo, 1)
        self.grid = grid.with_halo((h, h, h))
        self.buoyancy = buoyancy
        self.coriolis = coriolis
        self.stokes_drift = stokes_drift
        self.closure = closure
        self.forcing = {k: regularize_forcing(k, v)
                        for k, v in (forcing or {}).items()}
        self.background_fields = background_fields or {}
        self.timestepper = timestepper
        # an immersed boundary: its masks built on the final (with-halo)
        # grid, which is wrapped in an ImmersedGrid (JAX l.100-108); a
        # PartialCellBottom, or anything else that builds no masks, stays as
        # it is and is refused below
        if (not isinstance(immersed_boundary, PartialCellBottom)
                and hasattr(immersed_boundary, "build")):
            immersed_boundary = immersed_boundary.build(self.grid)
        if isinstance(immersed_boundary, ImmersedBoundary):
            self.grid = ImmersedGrid(self.grid, immersed_boundary)
        self.immersed_boundary = immersed_boundary
        self.particles = particles
        self.ab2_chi = 0.1
        user_bcs = boundary_conditions or {}
        self.bcs = {n: regularize_bcs(self.grid, loc, user_bcs.get(n))
                    for n, loc in self._locs().items()}
        self.pressure_bcs = regularize_bcs(self.grid, CENTER, None)
        reason = unsupported_reason(self)
        if reason is None and self.grid.device.type == "cuda":
            reason = self.card_unsupported_reason()
        if reason is not None:
            raise NotImplementedError(reason)
        self.pressure_solver = select_pressure_solver(self.grid)
        # the general projection's divergence and gradient: K3b and K3c
        # on a regular grid (the kernels take one Δ an axis, as the JAX
        # package's fused ones take compile-time metrics); on a stretched
        # axis the whole-array operators with the per-index metrics, which
        # is where the JAX package itself runs XLA ops instead of its
        # Pallas kernels
        self.projection_kernels = self.grid.all_regular
        self.fused_step = fused_step_ok(self)

    # -- state ----------------------------------------------------------------
    @property
    def g_interior(self):
        """True when ``G_prev`` is stored halo-free (nx, ny, nz): the JAX
        package's layout of its fused AB2 branch with z-halo-free walls.
        Otherwise ``G_prev`` carries halos."""
        return self.fused_step and z_halo_free_ok(self.grid, self.bcs.get("w"))

    def prognostic_names(self):
        return ("u", "v", "w") + self.tracer_names

    def card_unsupported_reason(self):
        """Why the kernels' gates refuse this model on the card, or None:
        the fills run K6, whose gate decides (``DistributedModel`` asks it
        again of each shard's model)."""
        if self.kernels is not KERNELS:
            return None
        return self._fill_unsupported_reason()

    def _fill_unsupported_reason(self):
        """Why K6 cannot fill one of the model's fields or its pressure
        fields (pHY′, pNHS), or None."""
        g = self.grid
        fields = [(loc, self.bcs[n]) for n, loc in self._locs().items()]
        fields.append((CENTER, self.pressure_bcs))
        return fields_unsupported_reason(
            g, [(loc, bcs, (0, 1, 2), g.total_shape) for loc, bcs in fields])

    def _locs(self):
        locs = dict(u=U_LOC, v=V_LOC, w=W_LOC)
        for n in self.tracer_names:
            locs[n] = CENTER
        return locs

    def initial_state(self, clock=None, **values):
        """A filled state with ``values`` (scalars, arrays or callables of
        x, y, z) set on the named prognostic fields, zero elsewhere."""
        g = self.grid
        locs = self._locs()
        sol = {}
        for name in self.prognostic_names():
            f = new_field(g, locs[name], self.bcs[name])
            sol[name] = set_field(f, g, values.get(name, 0.0)).data
        g_shape = g.shape if self.g_interior else g.total_shape
        state = dict(solution=sol,
                     clock=clock or Clock(host_scalar(g.dtype, 0.0), 0),
                     G_prev={k: g.zeros(g_shape) for k in sol},
                     pNHS=g.zeros(), previous_dt=host_scalar(g.dtype, -1.0))
        if self.particles is not None:
            state["particles"] = self.particles
        return self.update_state(state)

    def _g_prev_in_layout(self, G_prev):
        """``G_prev`` in this model's layout, from either layout."""
        g = self.grid
        if self.g_interior:
            return {k: g.interior(x).contiguous() for k, x in G_prev.items()}
        return self._g_prev_with_halos(G_prev)

    def _g_prev_with_halos(self, G_prev):
        """``G_prev`` with halos (zero halos from the halo-free layout)."""
        g = self.grid
        return {k: x if tuple(x.shape) == g.total_shape else g.pad(x)
                for k, x in G_prev.items()}

    def update_state(self, state, kernels=None):
        """Halo fills on all three axes of every field (in place, one call
        of ``kernels["fill"]``: K6, or its plain version under ``PLAIN``),
        then the closure's diffusivities and pHY′ with its halos filled (a
        second call: pHY′ reads b's top z halo). With an immersed boundary
        every field is masked to 0 in the solid between the two, the JAX
        order. Unlike the JAX package's fused step, the z halos of u, v and
        passive tracers are filled too: the kernels read real z halos where
        the TPU kernels wrap z-halo-free blocks."""
        fill = self._kernels(kernels)["fill"]
        if getattr(self, "halo_overlap", False):
            return self._deferred_update_state(state, fill)
        self.fill_all_halos(state["solution"], state["clock"].time, fill)
        state = dict(state)
        if self.immersed_boundary is not None:
            state = self.immersed_boundary.mask_state(self, state)
        return self._aux_state(state, fill)

    def fill_all_halos(self, sol, t, fill, axes=(0, 1, 2)):
        """Fill the halos of every field of ``sol`` on ``axes`` in place, in
        one call of ``fill``; returns ``sol``."""
        locs = self._locs()
        fill(self.grid, [(arr, locs[name], self.bcs[name], axes, t)
                         for name, arr in sol.items()])
        return sol

    def _local_axes(self):
        """The axes that are not cut over a mesh of shards."""
        return tuple(a for a in (0, 1, 2) if self.grid.dist[a] is None)

    def _deferred_update_state(self, state, fill):
        """``update_state`` under ``halo_overlap`` (set by
        ``DistributedModel``): the exchange and the diffusivities and pHY′
        wait for the next step's ``tendencies_overlapped``. What needs no
        exchange runs now, so that every interior point is the plain
        step's: the fills of the local axes, the wall faces of a cut axis
        that is bounded globally, and the masking (JAX l.210-225)."""
        from ..boundary_conditions.bcs import impose_cut_wall_faces
        t = state["clock"].time
        locs = self._locs()
        sol = self.fill_all_halos(state["solution"], t, fill, self._local_axes())
        for name, arr in sol.items():
            impose_cut_wall_faces(arr, self.grid, locs[name], self.bcs[name], t)
        state = dict(state, solution=sol)
        if self.immersed_boundary is not None:
            state = self.immersed_boundary.mask_state(self, state)
        return state

    def _aux_state(self, state, fill):
        """The closure's diffusivities and pHY′ (its halos filled through
        ``fill``) from the state's filled solution: the part of
        ``update_state`` after the fills."""
        t = state["clock"].time
        sol = state["solution"]
        state = dict(state)
        tr = {n: sol[n] for n in self.tracer_names}
        diff = compute_closure_diffusivities(self.closure, self.grid, sol,
                                             self.buoyancy, tr)
        if diff is not None:
            state["diffusivities"] = diff
        if self.buoyancy is not None:
            ph = hydrostatic_pressure_anomaly(self.buoyancy, self.grid, tr)
            fill(self.grid, [(ph, CENTER, self.pressure_bcs, (0, 1, 2), t)])
            state["pHY"] = ph
        return state

    # -- tendencies ---------------------------------------------------------------
    def tendencies(self, state, kernels=None):
        """With-halo tendencies G of every prognostic field (valid on the
        interior), in the JAX term order: advection → background cross
        terms → Coriolis → −∂pHY′ and the tilted-gravity terms → Stokes
        drift → diffusion, then per field its forcing and boundary fluxes
        (with an immersed boundary, its bottom fluxes too, and every
        tendency masked in the solid). The advection of every field is one
        fused call through ``kernels["advect"]`` (``_kernels``), on every
        grid the port
        accepts (the JAX model makes it on the TPU where its
        ``supports_fused_advection`` holds, and the plain ``div_*`` fluxes
        elsewhere: the same numbers); the other terms are PyTorch ops."""
        advect = self._kernels(kernels)["advect"]
        grid = self.grid
        sol = state["solution"]
        clock = state["clock"]
        u, v, w = sol["u"], sol["v"], sol["w"]
        scheme = self.advection
        tracers = {n: sol[n] for n in self.tracer_names}
        adv = advect(grid, scheme, self.tracer_advection, u, v, w, tracers)
        Gu, Gv, Gw = adv["u"], adv["v"], adv["w"]
        bg = materialize_background(self.background_fields, grid, self._locs(),
                                    clock.time)
        if bg:
            bu = bg.get("u", torch.zeros_like(u))
            bv = bg.get("v", torch.zeros_like(v))
            bw = bg.get("w", torch.zeros_like(w))
            Gu = Gu - div_vu(grid, scheme, u, v, w, U=(bu, bv, bw)) \
                    - div_vu(grid, scheme, bu, bv, bw, U=(u, v, w))
            Gv = Gv - div_vv(grid, scheme, u, v, w, U=(bu, bv, bw)) \
                    - div_vv(grid, scheme, bu, bv, bw, U=(u, v, w))
            Gw = Gw - div_vw(grid, scheme, u, v, w, U=(bu, bv, bw)) \
                    - div_vw(grid, scheme, bu, bv, bw, U=(u, v, w))
        if self.coriolis is not None:
            Gu = Gu - self.coriolis.x_f_cross_U(grid, u, v, w)
            Gv = Gv - self.coriolis.y_f_cross_U(grid, u, v, w)
            Gw = Gw - self.coriolis.z_f_cross_U(grid, u, v, w)
        if self.buoyancy is not None and "pHY" in state:
            ph = state["pHY"]
            Gu = Gu - st.dxf(ph) / grid.dx(U_LOC)
            Gv = Gv - st.dyf(ph) / grid.dy(V_LOC)
            bx = buoyancy_x_term(self.buoyancy, grid, tracers)
            by = buoyancy_y_term(self.buoyancy, grid, tracers)
            if bx is not None:
                Gu = Gu + bx
            if by is not None:
                Gv = Gv + by
        sd = self.stokes_drift
        if sd is not None:
            Gu = Gu + sd.x_curl_Us_cross_U(grid, u, v, w, clock.time)
            Gv = Gv + sd.y_curl_Us_cross_U(grid, u, v, w, clock.time)
            Gw = Gw + sd.z_curl_Us_cross_U(grid, u, v, w, clock.time)
            Gu = Gu + sd.dt_us(grid, clock.time)
            Gv = Gv + sd.dt_vs(grid, clock.time)
            Gw = Gw + sd.dt_ws(grid, clock.time)
        diff = state.get("diffusivities")
        if self.closure is not None:
            Gu = Gu + momentum_diffusion(u, grid, U_LOC, self.closure, diff)
            Gv = Gv + momentum_diffusion(v, grid, V_LOC, self.closure, diff)
            Gw = Gw + momentum_diffusion(w, grid, W_LOC, self.closure, diff)
        G = dict(u=Gu, v=Gv, w=Gw)
        ts = self.tracer_advection
        for name, c in tracers.items():
            Gc = adv[name]
            # the background velocities advect c, and the full velocity
            # advects the background tracer
            if bg and any(k in bg for k in ("u", "v", "w")):
                Gc = Gc - div_Uc(grid, ts, bg.get("u", torch.zeros_like(u)),
                                 bg.get("v", torch.zeros_like(v)),
                                 bg.get("w", torch.zeros_like(w)), c)
            if bg and name in bg:
                Gc = Gc - div_Uc(grid, ts, u, v, w, bg[name])
            if self.closure is not None:
                Gc = Gc + tracer_diffusion(c, grid, name, self.closure, diff)
                if name == "e":
                    Gc = add_tke_tendency(Gc, self.closure, grid, sol, diff,
                                          self.tracer_names)
            G[name] = Gc
        fields = dict(sol)
        locs = self._locs()
        for name in self.prognostic_names():
            if name in self.forcing:
                G[name] = G[name] + self.forcing[name](grid, clock, fields)
            G[name] = apply_flux_bcs(G[name], grid, locs[name], self.bcs[name],
                                     clock.time, fields)
            if self.immersed_boundary is not None:
                G[name] = apply_immersed_flux_bcs(G[name], grid, locs[name],
                                                  self.bcs[name], clock.time,
                                                  fields)
        if self.immersed_boundary is not None:
            G = {k: self.immersed_boundary.mask_tendency(self, k, g)
                 for k, g in G.items()}
        return G

    def tendencies_overlapped(self, state, kernels=None):
        """The halo-overlap tendencies of a shard (JAX l.258-330, the
        nonblocking exchange of Oceananigans' halo_communication.jl): the
        exchange (``fill_all_halos`` on every axis) and the deferred
        masking, diffusivities and pHY′; the whole tendency from the
        solution whose cut-axis halos are those of the last step (its local
        axes filled), exact wherever a point is more than H from a cut
        shard edge; then the H-wide strips along each cut axis recomputed
        on ``grid.subgrid_along`` from the exchanged solution and written
        over (``parallel/distributed.py::patch_edge_strips``). The parts run
        in JAX's order, the exchange first: XLA overlaps them, while here
        the shards of one card share its stream, so the split gives the
        plain step's numbers, bit for bit, and no overlap. Returns ``(G,
        state)``, the state with the exchanged solution."""
        k = self._kernels(kernels)
        t = state["clock"].time
        sol_stale = state["solution"]
        sol_fresh = self.fill_all_halos({n: a.clone() for n, a in sol_stale.items()},
                                        t, k["fill"])
        fresh = dict(state, solution=sol_fresh)
        if self.immersed_boundary is not None:
            fresh = self.immersed_boundary.mask_state(self, fresh)
        fresh = self._aux_state(fresh, k["fill"])
        sol_local = self.fill_all_halos({n: a.clone() for n, a in sol_stale.items()},
                                        t, k["fill"], self._local_axes())
        if self.immersed_boundary is not None:
            sol_local = self.immersed_boundary.mask_state(
                self, dict(state, solution=sol_local))["solution"]
        G = self.tendencies(dict(fresh, solution=sol_local), kernels)
        from ..parallel.distributed import patch_edge_strips
        return patch_edge_strips(self, G, fresh, ("solution", "diffusivities", "pHY"),
                                 kernels), fresh

    # -- pressure projection --------------------------------------------------
    def _fast_projection_ok(self):
        """The roll-based projection applies: a regular grid, periodic x
        and y, periodic or bounded z, no immersed boundary, and w-wall BCs
        that are imposed values. Otherwise ``project_velocities`` takes the
        general projection."""
        g = self.grid
        if not (g.all_regular and self.immersed_boundary is None
                and g.dist == (None, None, None)  # one shard: the rolls wrap
                and g.topology[0] is PERIODIC
                and g.topology[1] is PERIODIC
                and g.topology[2] in (PERIODIC, BOUNDED)):
            return False
        if g.topology[2] is BOUNDED:
            for bc in (self.bcs["w"].bottom, self.bcs["w"].top):
                if bc is not None and bc.kind not in ("open", "value"):
                    return False
        return True

    def _wall_plane(self, bc, side, t):
        """w's wall-face BC value on the interior (Nx, Ny) plane (or a
        0-d tensor for a uniform value)."""
        g = self.grid
        val = _bvalue(bc, g, 2, side, W_LOC, t)
        if val.ndim == 0:
            return val
        k = g.Hz if side == 0 else g.Hz + g.Nz
        full = torch.broadcast_to(val, g.total_shape)
        return full[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny, k]

    def _fast_project_interior(self, ui, vi, wi, t, dt):
        """Projection on interior (Nx, Ny, Nz) tensors: divergence and
        gradient correction with periodic rolls, bounded-z wall faces
        imposed. Writes into none of its arguments; returns the corrected
        (u, v, w) interiors and φ = pNHS interior."""
        grid = self.grid
        ddx, ddy = grid.Lx / grid.Nx, grid.Ly / grid.Ny
        ddz = grid.Lz / grid.Nz
        z_bounded = grid.topology[2] is BOUNDED
        if z_bounded:
            plane = lambda v: torch.zeros_like(wi[:, :, :1]) + (
                v[..., None] if v.ndim else v)
            bot = plane(self._wall_plane(self.bcs["w"].bottom, 0, t))
            top = plane(self._wall_plane(self.bcs["w"].top, 1, t))
            wi = torch.cat([bot, wi[:, :, 1:]], 2)
            dwdz = (torch.cat([wi[:, :, 1:], top], 2) - wi) / ddz
        else:
            dwdz = (torch.roll(wi, -1, 2) - wi) / ddz
        div = ((torch.roll(ui, -1, 0) - ui) / ddx
               + (torch.roll(vi, -1, 1) - vi) / ddy + dwdz)
        phi = self.pressure_solver.solve(div / dt)
        gx = (phi - torch.roll(phi, 1, 0)) / ddx
        gy = (phi - torch.roll(phi, 1, 1)) / ddy
        if z_bounded:
            gz = torch.cat([torch.zeros_like(phi[:, :, :1]),
                            phi[:, :, 1:] - phi[:, :, :-1]], 2) / ddz
        else:
            gz = (phi - torch.roll(phi, 1, 2)) / ddz
        return ui - dt * gx, vi - dt * gy, wi - dt * gz, phi

    def project_velocities(self, state, dt, kernels=None):
        """Make (u, v, w) divergence-free; returns a new state and writes
        into none of its inputs. The roll-based projection on interior
        views where ``_fast_projection_ok`` holds: u, v, w are copies with
        corrected interiors (halos as they were), pNHS has zero halos.
        Otherwise ``_project_velocities_general`` with ``kernels``."""
        if not self._fast_projection_ok():
            return self._project_velocities_general(state, dt, kernels)
        grid = self.grid
        sol = dict(state["solution"])
        ui, vi, wi, phi = self._fast_project_interior(
            grid.interior(sol["u"]), grid.interior(sol["v"]),
            grid.interior(sol["w"]), state["clock"].time, dt)
        for name, x in (("u", ui), ("v", vi), ("w", wi)):
            sol[name] = sol[name].clone()
            sol[name][grid.interior_slices] = x
        return dict(state, solution=sol, pNHS=grid.pad(phi))

    def _project_velocities_general(self, state, dt, kernels=None):
        """The general projection: copies of u, v, w with their halos
        filled, their divergence through ``kernels["divergence"]`` (K3b),
        the pressure solve, pNHS with halos filled under ``pressure_bcs``,
        its gradient through ``kernels["gradient"]`` (K3c), and the
        correction over the with-halo arrays. The two fills go through
        ``kernels["fill"]`` (K6, or its plain version under ``PLAIN``). On
        a stretched z (``projection_kernels`` false) the divergence and
        gradient are the whole-array operators, and the Fourier-tridiagonal
        solve's modes go through ``kernels["fourier"]`` (T1)."""
        k = self._kernels(kernels)
        grid = self.grid
        sol = dict(state["solution"])
        u, v, w = self._filled_velocity_copies(sol, state["clock"].time,
                                               k["fill"])
        divergence, gradient = ((k["divergence"], k["gradient"])
                                if self.projection_kernels else
                                (fused_divergence_reference,
                                 fused_pressure_gradient_reference))
        phi = self._solve_pressure(divergence(grid, u, v, w) / dt, k)
        pNHS = self._filled_pressure(phi, k["fill"])
        gx, gy, gz = gradient(grid, pNHS)
        sol.update(u=u - dt * gx, v=v - dt * gy, w=w - dt * gz)
        return dict(state, solution=sol, pNHS=pNHS)

    def _solve_pressure(self, rhs, kernels):
        """∇²φ = rhs on the interior: the FFT solve, or the
        Fourier-tridiagonal one with its modes through
        ``kernels["fourier"]``."""
        if isinstance(self.pressure_solver, (FourierTridiagonalSolver,
                                             DistributedFourierTridiagonalSolver)):
            return self.pressure_solver.solve(rhs, tridiagonal=kernels["fourier"])
        return self.pressure_solver.solve(rhs)

    def _filled_velocity_copies(self, sol, t, fill):
        """Copies of u, v and w with their halos filled, in one call of
        ``fill``."""
        locs = self._locs()
        copies = [sol[n].clone() for n in ("u", "v", "w")]
        fill(self.grid, [(c, locs[n], self.bcs[n], (0, 1, 2), t)
                         for c, n in zip(copies, ("u", "v", "w"))])
        return copies

    def _filled_pressure(self, phi, fill):
        """pNHS: the interior ``phi`` padded, its halos filled under
        ``pressure_bcs`` in one call of ``fill``."""
        p = self.grid.pad(phi)
        fill(self.grid, [(p, CENTER, self.pressure_bcs, (0, 1, 2), 0.0)])
        return p

    # -- stepping ---------------------------------------------------------------
    def _kernels(self, kernels):
        """The model's mapping (``KERNELS``, or ``PLAIN`` under
        ``fused_advection=False``) with the entries of ``kernels`` in place
        of its own."""
        return dict(self.kernels, **(kernels or {}))

    def step(self, state, dt, kernels=None):
        """One step of the model's time stepper, through the model's
        mapping of the kernels' wrappers (``self.kernels``); ``kernels``
        replaces some or all of them by name (``PLAIN``: the plain
        versions)."""
        kernels = self._kernels(kernels)
        if self.timestepper == "RungeKutta3":
            return self._rk3_step(state, dt, kernels)
        return self._ab2_step(state, dt, kernels)

    def _ab2_step(self, state, dt, kernels):
        """One quasi-AB2 step (Euler at iteration 0 and when Δt changed).
        The clock and ``previous_dt`` take Δt as given (``dt_changed``,
        ``Clock.tick``); the kernels and tensors take ``float(dt)``."""
        grid = self.grid
        clock0 = state["clock"]
        tick, dt = dt, float(dt)
        euler = clock0.iteration == 0 or dt_changed(state["previous_dt"], tick)
        state = dict(state, G_prev=self._g_prev_in_layout(state["G_prev"]))
        if self.fused_step and not general_route(self):
            sol, G = kernels["advance"](self, state, dt, euler)
            ui, vi, wi, phi = self._fast_project_interior(
                sol["u"], sol["v"], sol["w"], clock0.time, dt)
            sol = dict(sol, u=ui, v=vi, w=wi)
            state = dict(state, solution={k: grid.pad(x) for k, x in sol.items()},
                         pNHS=grid.pad(phi))
        else:
            if self.fused_step:  # ψ′ with halos, as the JAX kernel pads it
                sol, G = kernels["advance"](self, state, dt, euler)
            elif getattr(self, "halo_overlap", False):
                G, state = self.tendencies_overlapped(state, kernels)
                sol = ab2_substep(state["solution"], G, state["G_prev"], dt,
                                  self.ab2_chi, euler)
            else:
                G = self.tendencies(state, kernels)
                sol = ab2_substep(state["solution"], G, state["G_prev"], dt,
                                  self.ab2_chi, euler)
            sol = implicit_step_fields(sol, grid, self._locs(), self.closure,
                                       dt, state.get("diffusivities"),
                                       self.bcs, clock0.time,
                                       kernels["tridiagonal"])
            state = self.project_velocities(dict(state, solution=sol), dt,
                                            kernels)
        state = dict(state, clock=clock0.tick(tick), G_prev=G,
                     previous_dt=host_scalar(grid.dtype, tick))
        return self._step_particles(self.update_state(state, kernels), dt)

    def _rk3_step(self, state, dt, kernels):
        """One low-storage RK3 step: three stages, each projected; the
        stage clock ticks by (γ+ζ)Δt formed as the JAX step forms it
        (``scaled``)."""
        clock0 = state["clock"]
        tick, dt = dt, float(dt)
        G_prev = None
        for gamma, zeta in zip(RK3_GAMMA, RK3_ZETA):
            if getattr(self, "halo_overlap", False):
                G, state = self.tendencies_overlapped(state, kernels)
            else:
                G = self.tendencies(state, kernels)
            sol = rk3_substep(state["solution"], G, G_prev, dt, gamma, zeta)
            stage_dt = (gamma + zeta) * dt
            sol = implicit_step_fields(sol, self.grid, self._locs(),
                                       self.closure, stage_dt,
                                       state.get("diffusivities"), self.bcs,
                                       clock0.time, kernels["tridiagonal"])
            state = self.project_velocities(dict(state, solution=sol),
                                            stage_dt, kernels)
            state = dict(state, clock=state["clock"].tick(
                scaled(gamma + zeta, tick), stage=True))
            state = self.update_state(state, kernels)
            G_prev = G
        state = dict(state, clock=clock0.tick(tick), G_prev=G_prev,
                     previous_dt=host_scalar(self.grid.dtype, tick))
        return self._step_particles(state, dt)

    def _step_particles(self, state, dt):
        """The particles advected in the updated velocities, the tracers
        they track sampled at their new positions."""
        p = state.get("particles")
        if p is None:
            return state
        sol = state["solution"]
        vels = {k: sol[k] for k in ("u", "v", "w")}
        fields = {n: sol[n] for n in self.tracer_names}
        return dict(state, particles=p.step(self.grid, vels, dt, fields))

    # -- diagnostics ---------------------------------------------------------------
    def cell_diffusion_timescale(self, state):
        """min Δ²/max(ν, κ) over this model's closures; +inf when nothing
        limits."""
        return cell_diffusion_timescale(self.closure, self.grid,
                                        state.get("diffusivities"),
                                        self.tracer_names)

    def cell_advection_timescale(self, state):
        """min Δ/|u| over the interior for u, v and w (|u| floored at
        1e-30), skipping Flat axes: a 0-d tensor on the grid's device."""
        sol = state["solution"]
        grid = self.grid
        scales = []
        for axis, (name, loc) in enumerate((("u", U_LOC), ("v", V_LOC),
                                            ("w", W_LOC))):
            if grid.topology[axis] is FLAT:
                continue
            val = grid.spacing(axis, loc) / sol[name].abs().clamp_min(1e-30)
            scales.append(grid.interior(val).min())
        return torch.stack(scales).min()

    def fields(self, state):
        """Fields of the prognostic tensors, pNHS and pHY′ (where the state
        has it), with their locations and BCs."""
        locs = self._locs()
        out = {name: Field(arr, locs[name], self.bcs[name])
               for name, arr in state["solution"].items()}
        out["pNHS"] = Field(state["pNHS"], CENTER, self.pressure_bcs)
        if "pHY" in state:
            out["pHY"] = Field(state["pHY"], CENTER, self.pressure_bcs)
        return out
