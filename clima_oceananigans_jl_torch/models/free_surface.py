"""Free-surface treatments of the hydrostatic model.

Counterpart of ``clima_oceananigans_jl_tpu/models/free_surface.py``
(Oceananigans' explicit_free_surface.jl and split_explicit_free_surface.jl):

- ``ExplicitFreeSurface``: ∂t η = −∇h·U in the same AB2 sweep, −g∂η in
  the momentum tendency;
- ``SplitExplicitFreeSurface``: barotropic substepping ∂τU = −gH∇η + Gᵁ,
  ∂τη = −∇·U over 2Δt with time-filtered averages (``substep_eta``, whose
  loop is the plain version of the kernel K5, ``ops/fused_barotropic.py``),
  then the barotropic corrector u += (U̅ − ∫u dz)/H;
- ``ImplicitFreeSurface``: solve [∇h·(H∇h) − 1/gΔt²] η = (∇h·Q★ − η/Δt)/(gΔt)
  by a 2D FFT/DCT eigen-solve on horizontally regular grids of constant
  depth ("fft") or matrix-free conjugate gradients ("pcg", lat-lon and
  immersed grids included), or CG on the assembled heptadiagonal
  couplings with a Jacobi preconditioner ("matrix") or a geometric
  multigrid V-cycle ("multigrid", ``solvers/stencil_matrix.py``), then
  uⁿ⁺¹ = u★ − gΔt ∂x η.

Every free-surface array (η, U̅, …) is a with-halo (X, Y, 1) tensor.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..boundary_conditions.bcs import fill_halos
from ..grids.topology import BOUNDED, FLAT, PERIODIC
from ..ops import stencil as st
from ..solvers.fft_poisson import dct2, idct2, poisson_eigenvalues
from ..solvers.pcg import cg_solve
from ..utils.location import C, CENTER, F, U_LOC, V_LOC

ETA_LOC = (C, C, F)  # η sits at the top face; horizontally at (C, C)


def fill2d(arr, grid, loc, bcs=None, t=0.0):
    """Fill the x and y halos of an (X, Y, 1) tensor in place."""
    return fill_halos(arr, grid, loc, bcs, t, axes=(0, 1))


def depth_integral(grid, q, loc):
    """∫ q dz over the interior z levels: a with-halo (X, Y, 1) tensor."""
    Hz, Nz = grid.Hz, grid.Nz
    qdz = q[:, :, Hz:Hz + Nz] * grid.dz(loc)[:, :, Hz:Hz + Nz]
    return qdz.sum(dim=2, keepdim=True)


def barotropic_mode(grid, u, v):
    """(U, V) = (∫u dz, ∫v dz)."""
    return depth_integral(grid, u, U_LOC), depth_integral(grid, v, V_LOC)


def column_depths(grid):
    """(Hᶠᶜ, Hᶜᶠ): the static water depths as (X, Y, 1) tensors, built once
    per grid (callers must not write into them). On a grid with an
    immersed boundary only fluid cells count, and a column that is solid
    throughout keeps 10⁻³ of the z extent, so that 1/H stays finite (its
    velocities are masked to zero anyway)."""
    if "column_depths" not in grid._cache:
        Hz, Nz = grid.Hz, grid.Nz
        one = torch.ones(grid.total_shape[:2] + (1,), dtype=grid.dtype,
                         device=grid.device)
        imm = getattr(grid, "immersed", None)

        def depth(loc):
            dz = torch.broadcast_to(grid.dz(loc), grid.total_shape)
            if imm is not None:
                dz = torch.where(imm.mask_for(loc),
                                 torch.zeros((), dtype=dz.dtype, device=dz.device), dz)
            h = dz[:, :, Hz:Hz + Nz].sum(dim=2, keepdim=True)
            if imm is not None:
                h = torch.clamp_min(h, torch.full(
                    (), grid._axes[2].extent * 1e-3, dtype=h.dtype, device=h.device))
            return one * h

        grid._cache["column_depths"] = (depth(U_LOC), depth(V_LOC))
    return grid._cache["column_depths"]


def div_xy_2d(grid, U, V):
    """∇h·(U, V) at centres: (δx(Δy U) + δy(Δx V))/Az."""
    return (st.dxc(grid.dy(U_LOC) * U) + st.dyc(grid.dx(V_LOC) * V)) / grid.Az(CENTER)


def grad_x(grid, eta):
    return st.dxf(eta) / grid.dx(U_LOC)


def grad_y(grid, eta):
    return st.dyf(eta) / grid.dy(V_LOC)


@dataclasses.dataclass(frozen=True)
class ExplicitFreeSurface:
    gravitational_acceleration: float = 9.80665


@dataclasses.dataclass(frozen=True)
class ImplicitFreeSurface:
    """``solver_method``: "fft" (horizontally regular rectilinear grids,
    constant depth), "pcg" (matrix-free CG, any grid, lat-lon included),
    "matrix" (Jacobi-preconditioned CG on the assembled heptadiagonal
    couplings), "multigrid" (geometric-multigrid-preconditioned CG on
    them) or "auto" (fft where it applies, else pcg)."""

    gravitational_acceleration: float = 9.80665
    solver_method: str = "auto"
    tolerance: float = 1e-10
    maxiter: int = 500

    def resolve_method(self, grid):
        """``solver_method``, with "auto" resolved: "fft" on a horizontally
        regular rectilinear grid of constant depth, else "pcg" (an immersed
        bottom makes the depth vary); "pcg" whatever the method on a grid
        cut over a mesh, as in the JAX package (l.138-141)."""
        if any(d is not None for d in getattr(grid, "dist", (None,) * 3)):
            return "pcg"  # cut over a mesh: CG with the inner products summed
        if self.solver_method != "auto":
            return self.solver_method
        if getattr(grid, "immersed", None) is not None:
            return "pcg"
        return "fft" if (not grid.curvilinear and grid.hregular) else "pcg"

    def solve(self, grid, eta_bcs, rhs, eta0, dt):
        """Solve [∇h·(H∇h) − 1/gΔt²] η = rhs; with-halo (X, Y, 1) tensors."""
        g = self.gravitational_acceleration
        method = self.resolve_method(grid)
        interior = (slice(grid.Hx, grid.Hx + grid.Nx),
                    slice(grid.Hy, grid.Hy + grid.Ny), slice(None))
        if method == "fft":
            # constant H: (∇²h − 1/gHΔt²) η = rhs / H
            H = float(grid.Lz)
            lam = [poisson_eigenvalues(n, grid._axes[a].extent, grid.topology[a],
                                       grid.dtype, grid.device)
                   for a, n in ((0, grid.Nx), (1, grid.Ny))]
            lx, ly = lam[0].reshape(-1, 1, 1), lam[1].reshape(1, -1, 1)
            b = rhs[interior] / H
            dct = [grid.topology[a] is BOUNDED for a in (0, 1)]
            for a in (0, 1):
                if dct[a]:
                    b = dct2(b, a)
            fft_axes = tuple(a for a in (0, 1)
                             if not dct[a] and grid.topology[a] is PERIODIC)
            if fft_axes:
                b = torch.fft.fftn(b, dim=fft_axes)
            m = 1.0 / (g * H * dt * dt)
            phi = b / (-(lx + ly) - m)
            if fft_axes:
                phi = torch.fft.ifftn(phi, dim=fft_axes)
            phi = phi.real if phi.is_complex() else phi
            for a in (1, 0):
                if dct[a]:
                    phi = idct2(phi, a)
            eta = torch.zeros_like(eta0)
            eta[interior] = phi.to(grid.dtype)
            return fill2d(eta, grid, ETA_LOC, eta_bcs)
        if method in ("matrix", "multigrid"):
            return self._solve_stencil(grid, eta_bcs, rhs, eta0, dt, method)
        if method != "pcg":
            raise ValueError(f"unknown solver_method {method!r}")
        # matrix-free CG on the negated, Az-symmetrised operator
        Hfc, Hcf = column_depths(grid)
        Az = grid.Az(CENTER)

        def matvec(eta_int):
            eta = torch.zeros_like(eta0)
            eta[interior] = eta_int
            fill2d(eta, grid, ETA_LOC, eta_bcs)
            lap = div_xy_2d(grid, Hfc * grad_x(grid, eta), Hcf * grad_y(grid, eta))
            return (-(Az * lap - Az * eta / (g * dt * dt)))[interior]

        axis_names = tuple(d[0] for d in getattr(grid, "dist", (None,) * 3)
                           if d is not None)
        x, _, _ = cg_solve(matvec, (-Az * rhs)[interior], eta0[interior],
                           reltol=self.tolerance, maxiter=self.maxiter,
                           axis_names=axis_names)
        eta = torch.zeros_like(eta0)
        eta[interior] = x
        return fill2d(eta, grid, ETA_LOC, eta_bcs)

    def _fs_stencil(self, grid):
        """The assembled couplings of the Az-symmetrised operator (Δy Hᶠᶜ/Δx
        at x faces, Δx Hᶜᶠ/Δy at y faces; 0 at a bounded axis' first face)
        as a ``StencilMatrix`` without its diagonal shift, and the interior
        Az; built once per grid."""
        from ..solvers.stencil_matrix import StencilMatrix
        if "fs_stencil" not in grid._cache:
            Hfc, Hcf = column_depths(grid)
            ii = (slice(grid.Hx, grid.Hx + grid.Nx),
                  slice(grid.Hy, grid.Hy + grid.Ny), slice(None))
            shp2 = grid.total_shape[:2] + (1,)
            L = [None, None, None]
            if grid.topology[0] is not FLAT:
                lx = torch.broadcast_to(grid.dy(U_LOC) * Hfc / grid.dx(U_LOC),
                                        shp2)[ii].clone()
                if grid.topology[0] is BOUNDED:
                    lx[0, :, :] = 0.0
                L[0] = lx
            if grid.topology[1] is not FLAT:
                ly = torch.broadcast_to(grid.dx(V_LOC) * Hcf / grid.dy(V_LOC),
                                        shp2)[ii].clone()
                if grid.topology[1] is BOUNDED:
                    ly[:, 0, :] = 0.0
                L[1] = ly
            Az_int = torch.broadcast_to(grid.Az(CENTER), shp2)[ii]
            grid._cache["fs_stencil"] = (StencilMatrix(tuple(L), None), Az_int)
        return grid._cache["fs_stencil"]

    def _stencil_solver(self, grid, dt, method):
        """The "matrix" or "multigrid" solver of this free surface, kept per
        grid and settings and built again when Δt changes (the multigrid
        levels depend on Δt through the diagonal −Az/(gΔt²); the matrix
        solver takes Δt at each solve)."""
        from ..solvers.stencil_matrix import (HeptadiagonalIterativeSolver,
                                              MultigridSolver, StencilMatrix)
        g = self.gravitational_acceleration
        key = ("fs_solver", method, g, self.tolerance, self.maxiter)
        cached = grid._cache.get(key)
        if cached is None or (method == "multigrid" and cached[0] != dt):
            A, Az_int = self._fs_stencil(grid)
            if method == "matrix":
                solver = HeptadiagonalIterativeSolver(
                    A, 0.0, -Az_int / g, tolerance=self.tolerance,
                    maxiter=self.maxiter)
            else:
                solver = MultigridSolver(
                    StencilMatrix(A.L, -Az_int / (g * dt * dt)),
                    (grid.Nx, grid.Ny, 1), tolerance=self.tolerance,
                    maxiter=self.maxiter)
            grid._cache[key] = (dt, solver)
        return grid._cache[key][1]

    def _solve_stencil(self, grid, eta_bcs, rhs, eta0, dt, method):
        """The "matrix" and "multigrid" solves on the assembled couplings
        (the right-hand side Az·rhs, the CG start η⁰)."""
        _, Az_int = self._fs_stencil(grid)
        interior = (slice(grid.Hx, grid.Hx + grid.Nx),
                    slice(grid.Hy, grid.Hy + grid.Ny), slice(None))
        b = (Az_int * rhs[interior]).to(grid.dtype)
        solver = self._stencil_solver(grid, dt, method)
        if method == "matrix":
            x = solver.solve(b, dt=dt, x0=eta0[interior])
        else:
            x = solver.solve(b, x0=eta0[interior])
        eta = torch.zeros_like(eta0)
        eta[interior] = x.to(grid.dtype)
        return fill2d(eta, grid, ETA_LOC, eta_bcs)


@dataclasses.dataclass(frozen=True)
class SplitExplicitFreeSurface:
    """Barotropic substepping with time-filtered averaging.

    ``velocity_weights`` / ``free_surface_weights``: optional per-substep
    averaging weights (normalised here); the default is the uniform
    1/substeps filter. ``with_hann_filter`` builds a raised-cosine
    (Hann) filter."""

    gravitational_acceleration: float = 9.80665
    substeps: int = 200
    velocity_weights: tuple = None
    free_surface_weights: tuple = None

    @classmethod
    def with_hann_filter(cls, gravitational_acceleration=9.80665, substeps=200):
        w = tuple(math.sin(math.pi * (k + 1) / (substeps + 1)) ** 2
                  for k in range(substeps))
        return cls(gravitational_acceleration, substeps, w, w)

    def _weight_vec(self, weights, like):
        if weights is None:
            return torch.full((self.substeps,), 1.0 / self.substeps,
                              dtype=like.dtype, device=like.device)
        w = torch.as_tensor(weights, dtype=like.dtype, device=like.device)
        return w / w.sum()

    def substep_eta(self, grid, eta_bcs, eta0, GU, GV, U0, V0, dt, kernel=None):
        """The barotropic substep loop over 2Δt → (η̅ filled, U̅, V̅),
        through ``kernel`` (default: the K5 wrapper
        ``ops/fused_barotropic.py::fused_substep_eta``)."""
        if kernel is None:
            from ..ops.fused_barotropic import fused_substep_eta as kernel
        n = self.substeps
        dtau = 2.0 * dt / n
        wv = self._weight_vec(self.velocity_weights, eta0)
        wf = self._weight_vec(self.free_surface_weights, eta0)
        Hfc, Hcf = column_depths(grid)
        return kernel(grid, eta_bcs, eta0, U0, V0, GU, GV, Hfc, Hcf,
                      self.gravitational_acceleration, dtau, wv, wf, n)

    def corrector(self, grid, u, v, U_av, V_av):
        """u += (U̅ − ∫u dz)/H, v likewise."""
        Hfc, Hcf = column_depths(grid)
        U, V = barotropic_mode(grid, u, v)
        return u + (U_av - U) / Hfc, v + (V_av - V) / Hcf
