"""Heptadiagonal stencil matrices: Krylov and geometric-multigrid solvers.

Counterpart of ``clima_oceananigans_jl_tpu/solvers/stencil_matrix.py``
(Oceananigans' ``HeptadiagonalIterativeSolver`` and ``MultigridSolver``).
A 7-diagonal matrix is its coefficient tensors: per-face couplings
applied matrix-free with ``torch.roll`` shifts, on interior (halo-free)
tensors, in the difference form

    (A x)ᵢ = Σ_axis [ Lᵢ (xᵢ₋₁ − xᵢ) + Lᵢ₊₁ (xᵢ₊₁ − xᵢ) ] + cᵢ xᵢ

where ``L[axis][i]`` is the coupling through the left face of cell ``i``
(``L[0]`` the wrap coupling of a periodic axis, 0 on a bounded one). The
form is symmetric and negative (semi-)definite for ``c ≤ 0``; the solvers
run ``solvers/pcg.py::cg_solve`` on ``N = −A``. The multigrid is
geometric, with Galerkin-coarsened couplings (factor-2 pooling, halved
across the coarse interfaces) and red-black Gauss-Seidel smoothing; its
V-cycle preconditions CG. Every elementwise step is the JAX package's
expression tree (the block sums add two values), so ``apply``, ``diag``,
``coarsen``, ``v_cycle`` and ``_rb_ssor`` give its bits; the solves'
reductions sum in another order. Unlike the JAX package, which rebuilds
the levels on every solve under jit, a ``MultigridSolver`` builds its
levels, their inverse diagonals and their checkerboards once.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.location import C, CENTER, F
from .pcg import cg_solve


#: the solves of ``HeptadiagonalIterativeSolver`` and ``MultigridSolver``
#: so far, their CG iterations and the largest final relative residual
#: |b − N x|/|b| (a caller that counts them sets all three to 0 first)
SOLVES = dict(solves=0, iterations=0, residual=0.0)


#: red-black Gauss-Seidel sweeps of a V-cycle: before and after each
#: restriction, and on the coarsest level (the JAX package's defaults)
N_PRE, N_POST, N_COARSE = 1, 1, 12


def _count(it, res2, b):
    SOLVES["solves"] += 1
    SOLVES["iterations"] += it
    SOLVES["residual"] = max(SOLVES["residual"],
                             (res2 / max(float(torch.sum(b * b)), 1e-300)) ** 0.5)


def _roll(x, shift, axis):
    return torch.roll(x, shift, axis)


@dataclasses.dataclass
class StencilMatrix:
    """Symmetric 7-diagonal operator in left-face coupling form.

    ``L``: per-axis coupling tensors (the shape of x) or None (a Flat
    axis); ``c``: an extra diagonal (a tensor broadcastable to x) or
    None."""

    L: tuple  # (Lx|None, Ly|None, Lz|None)
    c: object  # tensor | None
    #: the smoother's (inverse diagonal, red cells), by shape (``smoother``)
    _smoothers: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)

    def apply(self, x):
        out = self.c * x if self.c is not None else torch.zeros_like(x)
        for axis, L in enumerate(self.L):
            if L is None:
                continue
            R = _roll(L, -1, axis)  # coupling through the right face
            out = out + L * (_roll(x, 1, axis) - x) + R * (_roll(x, -1, axis) - x)
        return out

    def diag(self):
        d = 0.0
        for axis, L in enumerate(self.L):
            if L is None:
                continue
            d = d - (L + _roll(L, -1, axis))
        if self.c is not None:
            d = d + self.c
        return d

    def smoother(self, shape):
        """(1/diag of N = −A, 0 where the diagonal is 0; the red cells of
        ``shape``), built at the first call and kept."""
        key = tuple(shape)
        if key not in self._smoothers:
            self._smoothers[key] = (_safe_inv(-self.diag()),
                                    _checkerboard(shape, self._device()))
        return self._smoothers[key]

    def _device(self):
        return next(t.device for t in (*self.L, self.c)
                    if isinstance(t, torch.Tensor))

    # -- Galerkin coarsening -------------------------------------------------
    def coarsenable_axes(self, shape, min_size=4):
        return tuple(a for a in range(3)
                     if self.L[a] is not None
                     and shape[a] >= min_size and shape[a] % 2 == 0)

    def coarsen(self, shape, axes):
        """Pᵀ A P for piecewise-constant P over 2-blocks along ``axes``: the
        couplings summed over the pooled axes, those across a coarse
        interface (every second face plane) halved, as the JAX package
        halves the raw Galerkin coupling."""
        newL = []
        for a, L in enumerate(self.L):
            if L is None:
                newL.append(None)
                continue
            Lf = torch.broadcast_to(L, shape)
            if a in axes:
                idx = [slice(None)] * 3
                idx[a] = slice(0, None, 2)
                Lf = Lf[tuple(idx)]
                newL.append(0.5 * _block_sum(Lf, tuple(x for x in axes if x != a)))
            else:
                newL.append(_block_sum(Lf, axes))
        newc = (_block_sum(torch.broadcast_to(self.c, shape), axes)
                if self.c is not None else None)
        new_shape = tuple(n // 2 if a in axes else n for a, n in enumerate(shape))
        return StencilMatrix(tuple(newL), newc), new_shape


def _block_sum(arr, over):
    """Sum of each pair of neighbours along each axis of ``over``."""
    for a in over:
        s = list(arr.shape)
        s[a] //= 2
        s.insert(a + 1, 2)
        arr = arr.reshape(s).sum(dim=a + 1)
    return arr


def _prolong(x, axes):
    for a in axes:
        x = torch.repeat_interleave(x, 2, dim=a)
    return x


def _restrict(x, axes):
    return _block_sum(x, axes)


def build_levels(A, shape, min_size=4, max_levels=16):
    """[(StencilMatrix, shape, axes coarsened to build the next level), …]."""
    levels = []
    for _ in range(max_levels):
        axes = A.coarsenable_axes(shape, min_size)
        levels.append((A, shape, axes))
        if not axes:
            break
        A, shape = A.coarsen(shape, axes)
    else:
        levels[-1] = (levels[-1][0], levels[-1][1], ())
    return levels


def _safe_inv(d):
    zero = d == 0
    return torch.where(zero, torch.zeros_like(d),
                       1.0 / torch.where(zero, torch.ones_like(d), d))


def _checkerboard(shape, device=None):
    ix = torch.arange(shape[0], device=device).reshape(-1, 1, 1)
    iy = torch.arange(shape[1], device=device).reshape(1, -1, 1)
    iz = torch.arange(shape[2], device=device).reshape(1, 1, -1)
    return (ix + iy + iz) % 2 == 0


def _masked(mask, x):
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _rbgs(A, dinv, red, x, rhs, order, n):
    """Red-black Gauss-Seidel sweeps on N = −A (each colour's residual
    recomputed with the other colour's fresh values)."""
    for _ in range(n):
        for color in order:
            mask = red if color == "r" else ~red
            r = rhs + A.apply(x)  # rhs − N x
            x = x + _masked(mask, dinv * r)
    return x


def v_cycle(levels, b):
    """One V-cycle from x = 0 on N = −A: pre-smoothing red→black,
    post-smoothing black→red, so that the cycle is a symmetric linear
    operator in ``b`` (a CG preconditioner)."""
    rhss = [b]
    xs = []
    for (A, shape, axes) in levels[:-1]:
        dinv, red = A.smoother(shape)
        x = _rbgs(A, dinv, red, torch.zeros_like(rhss[-1]), rhss[-1],
                  ("r", "b"), N_PRE)
        xs.append(x)
        r = rhss[-1] + A.apply(x)  # rhs − N x
        rhss.append(_restrict(r, axes))
    A, shape, _ = levels[-1]
    dinv, red = A.smoother(shape)
    x = _rbgs(A, dinv, red, torch.zeros_like(rhss[-1]), rhss[-1],
              ("r", "b"), N_COARSE)
    for lev in range(len(levels) - 2, -1, -1):
        A, shape, axes = levels[lev]
        x = xs[lev] + _prolong(x, axes)
        dinv, red = A.smoother(shape)
        x = _rbgs(A, dinv, red, x, rhss[lev], ("b", "r"), N_POST)
    return x


def _rb_ssor(A, dinv, red, r):
    """Symmetric red-black SSOR M⁻¹r on N = −A from x = 0: a palindromic
    red→black→red Gauss-Seidel sweep (symmetric positive definite, a CG
    preconditioner; the JAX package's stand-in for an ILU)."""
    x = _masked(red, dinv * r)
    res = r + A.apply(x)  # r − N x
    x = x + _masked(~red, dinv * res)
    res = r + A.apply(x)
    return x + _masked(red, dinv * res)


@dataclasses.dataclass
class HeptadiagonalIterativeSolver:
    """Preconditioned CG on ``[A + (C + D/Δt²) I] x = b`` (the face
    couplings in A, cell tensors or scalars C and D).

    ``preconditioner``: "jacobi" (the diagonal, default), "ssor"
    (symmetric red-black Gauss-Seidel) or None."""

    A: StencilMatrix
    C: object  # tensor | scalar
    D: object  # tensor | scalar
    tolerance: float = 1e-10
    maxiter: int = 1000
    preconditioner: object = "jacobi"

    def _full(self, dt):
        c0 = self.A.c if self.A.c is not None else 0.0
        extra = self.C + (self.D / (dt * dt) if dt is not None else 0.0)
        return StencilMatrix(self.A.L, c0 + extra)

    def _M(self, A, shape):
        dinv = _safe_inv(-A.diag())
        if self.preconditioner == "ssor":
            red = _checkerboard(shape, dinv.device)
            return lambda r: _rb_ssor(A, dinv, red, r)
        if self.preconditioner == "jacobi":
            return lambda r: dinv * r
        return None

    def solve(self, b, dt=None, x0=None, return_stats=False):
        A = self._full(dt)
        x0 = torch.zeros_like(b) if x0 is None else x0
        x, it, res2 = cg_solve(lambda v: -A.apply(v), -b, x0,
                               M=self._M(A, b.shape),
                               reltol=self.tolerance, maxiter=self.maxiter)
        _count(it, res2, b)
        return (x, it, res2) if return_stats else x


@dataclasses.dataclass
class MultigridSolver:
    """Geometric-multigrid-preconditioned CG on a StencilMatrix.
    ``project_mean=True`` removes the constant null space (a pure
    Neumann or periodic Poisson problem). The levels are built at the
    first solve and kept."""

    A: StencilMatrix
    shape: tuple
    tolerance: float = 1e-10
    maxiter: int = 200
    project_mean: bool = False
    _levels: list = dataclasses.field(default=None, init=False, repr=False,
                                      compare=False)

    @property
    def levels(self):
        if self._levels is None:
            self._levels = build_levels(self.A, self.shape)
        return self._levels

    def solve(self, b, x0=None, return_stats=False):
        levels = self.levels

        def proj(x):
            return x - torch.mean(x) if self.project_mean else x

        def M(r):
            return proj(v_cycle(levels, proj(r)))

        x0 = torch.zeros_like(b) if x0 is None else x0
        rhs = proj(-b)
        x, it, res2 = cg_solve(lambda v: -self.A.apply(proj(v)), rhs, x0,
                               M=M, reltol=self.tolerance, maxiter=self.maxiter)
        _count(it, res2, rhs)
        return (proj(x), it, res2) if return_stats else proj(x)


# -- grid-derived operators ----------------------------------------------------

def poisson_stencil(grid):
    """The volume-symmetrised finite-volume Laplacian ``V ∇²φ`` on a
    rectilinear grid's interior: couplings L = A_face / d_face, any
    stretching on any axis."""
    from ..grids.topology import BOUNDED, FLAT

    ii = grid.interior_slices
    L = []
    for axis in range(3):
        if grid.topology[axis] is FLAT:
            L.append(None)
            continue
        floc = tuple(F if a == axis else C for a in range(3))
        area = 1.0
        for other in range(3):
            if other != axis and grid.topology[other] is not FLAT:
                area = area * grid.spacing(other, floc)
        d = grid.spacing(axis, floc)
        coef = torch.broadcast_to(area / d, grid.total_shape)[ii].clone()
        if grid.topology[axis] is BOUNDED:
            wall = [slice(None)] * 3
            wall[axis] = slice(0, 1)
            coef[tuple(wall)] = 0.0
        L.append(coef)
    return StencilMatrix(tuple(L), None)


@dataclasses.dataclass
class MultigridPoissonSolver:
    """The pressure solve on a grid stretched in x or y, where neither the
    FFT nor the Fourier-tridiagonal solve applies: interior rhs →
    interior φ of zero mean, as ``FFTPoissonSolver.solve``."""

    mg: MultigridSolver
    vol: torch.Tensor  # interior cell volumes (the rhs symmetrisation)
    dtype: object

    @classmethod
    def build(cls, grid, tolerance=1e-8, maxiter=100):
        A = poisson_stencil(grid)
        mg = MultigridSolver(A, grid.shape, tolerance=tolerance,
                             maxiter=maxiter, project_mean=True)
        vol = torch.broadcast_to(grid.V(CENTER), grid.total_shape)[grid.interior_slices]
        return cls(mg, vol, grid.dtype)

    def solve(self, rhs, m=0.0):
        return self.mg.solve(self.vol * rhs).to(self.dtype)
