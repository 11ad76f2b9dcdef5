"""Port parity: the stencil-matrix solvers, the multigrid pressure solve of
a grid stretched in x or y, and the implicit free surface's "matrix" and
"multigrid" methods.

The same numpy-seeded inputs go through the JAX package and the port in
float64:

- ``StencilMatrix.apply``, ``diag``, ``coarsen``, ``build_levels``,
  ``v_cycle`` and ``_rb_ssor`` bit for bit against the JAX functions run
  op by op (jitted, XLA's CPU backend contracts a·b + c into FMAs): each
  is elementwise stencil algebra whose block sums add two values; the
  solves and the models run jitted;
- ``HeptadiagonalIterativeSolver`` (each preconditioner) and
  ``MultigridSolver`` within 10× their tolerance of JAX's solution, their
  iteration counts within ±1 (the CG reductions sum in another order);
- ``MultigridPoissonSolver`` on the JAX suite's 16×16×8 grid stretched in
  every axis, against the discrete Laplacian's source;
- the implicit free surface's matrix and multigrid methods on a
  rectilinear and a lat-lon grid: 10 steps within ``RTOL`` of max|η|;
- the port's copy of validation/implicit_free_surface.py at N = 16
  against the JAX models built from the script's constants, and its own
  assertion.

``tests/test_torch_stretched_xy.py`` holds the nonhydrostatic model on a
stretched x or y and K2 there.
"""
import math

import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.solvers import stencil_matrix as tsm
from clima_oceananigans_jl_torch.validation import implicit_free_surface as tifs

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from clima_oceananigans_jl_tpu.models.free_surface import ImplicitFreeSurface as JIFS
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    from clima_oceananigans_jl_tpu.ops import operators as jop
    from clima_oceananigans_jl_tpu.solvers import stencil_matrix as jsm
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9


def stencil_arrays(shape, periodic, seed):
    """Numpy couplings (positive, 0 on a bounded axis' first face) and a
    negative diagonal shift: −A is symmetric positive definite."""
    rng = np.random.default_rng(seed)
    L = []
    for a in range(3):
        if shape[a] == 1:
            L.append(None)
            continue
        la = 0.5 + rng.uniform(size=shape)
        if not periodic[a]:
            idx = [slice(None)] * 3
            idx[a] = slice(0, 1)
            la[tuple(idx)] = 0.0
        L.append(la)
    return L, -(0.1 + rng.uniform(size=shape))


def both(L, c):
    """The JAX and the port StencilMatrix of the same arrays."""
    jA = jsm.StencilMatrix(tuple(None if x is None else jnp.asarray(x) for x in L),
                           None if c is None else jnp.asarray(c))
    tA = tsm.StencilMatrix(tuple(None if x is None else torch.as_tensor(x) for x in L),
                           None if c is None else torch.as_tensor(c))
    return jA, tA


def same(j, t):
    """Bit for bit."""
    a, b = np.asarray(j), t.numpy()
    assert a.shape == b.shape
    assert np.array_equal(a, b), np.abs(a - b).max()


CASES = {"PPP": ((8, 8, 4), (True, True, True)),
         "PBB": ((8, 12, 4), (True, False, False)),
         "BPF": ((16, 8, 1), (False, True, True))}


@pytest.mark.parametrize("case", ["PBB", "BPF"])
def test_stencil_operations_bitwise(case):
    """apply, diag, coarsen, build_levels, v_cycle and _rb_ssor against JAX
    bit for bit."""
    shape, periodic = CASES[case]
    L, c = stencil_arrays(shape, periodic, 1)
    jA, tA = both(L, c)
    x = np.random.default_rng(2).standard_normal(shape)
    same(jA.apply(jnp.asarray(x)), tA.apply(torch.as_tensor(x)))
    same(jA.diag(), tA.diag())
    axes = tA.coarsenable_axes(shape)
    assert axes == jA.coarsenable_axes(shape) and axes
    jC, jshape = jA.coarsen(shape, axes)
    tC, tshape = tA.coarsen(shape, axes)
    assert jshape == tshape
    for a in range(3):
        assert (jC.L[a] is None) == (tC.L[a] is None)
        if tC.L[a] is not None:
            same(jC.L[a], tC.L[a])
    same(jC.c, tC.c)
    jlev, tlev = jsm.build_levels(jA, shape), tsm.build_levels(tA, shape)
    assert [(s, ax) for _, s, ax in jlev] == [(s, ax) for _, s, ax in tlev]
    for (ja, _, _), (ta, _, _) in zip(jlev, tlev):
        same(ja.c, ta.c)
        for a in range(3):
            if ta.L[a] is not None:
                same(ja.L[a], ta.L[a])
    b = np.random.default_rng(3).standard_normal(shape)
    same(jsm.v_cycle(jlev, jnp.asarray(b)), tsm.v_cycle(tlev, torch.as_tensor(b)))
    jd = jsm._safe_inv(-jA.diag())
    td = tsm._safe_inv(-tA.diag())
    same(jd, td)
    same(jsm._checkerboard(shape), tsm._checkerboard(shape))
    same(jsm._rb_ssor(jA, jd, jsm._checkerboard(shape), jnp.asarray(b)),
         tsm._rb_ssor(tA, td, tsm._checkerboard(shape), torch.as_tensor(b)))
    # the prolongation and restriction by themselves
    same(jsm._prolong(jnp.asarray(b), axes), tsm._prolong(torch.as_tensor(b), axes))
    same(jsm._restrict(jnp.asarray(b), axes), tsm._restrict(torch.as_tensor(b), axes))


@pytest.mark.parametrize("pre", [None, "jacobi", "ssor"])
@pytest.mark.parametrize("case", ["PPP", "PBB"])
def test_heptadiagonal_solver_matches_jax(case, pre):
    """Each preconditioner: the solution within 10× the tolerance of JAX's
    (relative to max|x|), the iteration count within ±1; D/Δt² on the
    diagonal."""
    shape, periodic = CASES[case]
    L, c = stencil_arrays(shape, periodic, 4)
    rng = np.random.default_rng(5)
    D = -np.abs(rng.standard_normal(shape))
    b = rng.standard_normal(shape)
    tol = 1e-10
    jA, tA = both(L, None)
    js = jsm.HeptadiagonalIterativeSolver(jA, jnp.asarray(c), jnp.asarray(D),
                                          tolerance=tol, preconditioner=pre)
    ts = tsm.HeptadiagonalIterativeSolver(tA, torch.as_tensor(c), torch.as_tensor(D),
                                          tolerance=tol, preconditioner=pre)
    jx, jit_, _ = jax.jit(lambda r: js.solve(r, dt=jnp.float64(0.3),
                                             return_stats=True))(jnp.asarray(b))
    tx, tit, _ = ts.solve(torch.as_tensor(b), dt=0.3, return_stats=True)
    jx = np.asarray(jx)
    assert abs(int(jit_) - tit) <= 1, (int(jit_), tit)
    assert np.abs(tx.numpy() - jx).max() <= 10 * tol * np.abs(jx).max()
    # the port's x solves the system it was given
    full = tsm.StencilMatrix(tA.L, torch.as_tensor(c) + torch.as_tensor(D) / 0.09)
    r = full.apply(tx) - torch.as_tensor(b)
    assert float(r.abs().max()) <= 1e-8 * float(np.abs(b).max())


def jax_multigrid_stats(jmg, b):
    """JAX's ``MultigridSolver.solve`` with its CG's stats: its body (its
    ``cg_solve`` preconditioned by its ``v_cycle`` on its levels), jitted;
    returns (x, iterations, final relative residual)."""
    from clima_oceananigans_jl_tpu.solvers.pcg import cg_solve

    def solve(jb):
        levels = jsm.build_levels(jmg.A, jmg.shape)
        proj = (lambda x: x - jnp.mean(x)) if jmg.project_mean else (lambda x: x)
        rhs = proj(-jb)
        x, it, res2 = cg_solve(lambda v: -jmg.A.apply(proj(v)), rhs, jnp.zeros_like(jb),
                               M=lambda r: proj(jsm.v_cycle(levels, proj(r))),
                               reltol=jmg.tolerance, maxiter=jmg.maxiter)
        return proj(x), it, jnp.sqrt(res2 / jnp.sum(rhs * rhs))

    x, it, rel = jax.jit(solve)(jnp.asarray(b))
    return np.asarray(x), int(it), float(rel)


def test_multigrid_solver_matches_jax():
    """The multigrid-preconditioned CG on a pure periodic problem (its null
    space projected out) within 10× its tolerance of JAX's solution, its
    iteration count within ±1 of JAX's, the levels built once."""
    shape, periodic = (16, 16, 1), (True, True, True)
    L, c = stencil_arrays(shape, periodic, 6)
    project = all(periodic)
    jA, tA = both(L, None if project else c)
    b = np.random.default_rng(7).standard_normal(shape)
    if project:
        b = b - b.mean()
    tol = 1e-11
    jmg = jsm.MultigridSolver(jA, shape, tolerance=tol, maxiter=100, project_mean=project)
    tmg = tsm.MultigridSolver(tA, shape, tolerance=tol, maxiter=100, project_mean=project)
    jx = np.asarray(jax.jit(jmg.solve)(jnp.asarray(b)))
    tx, it, _ = tmg.solve(torch.as_tensor(b), return_stats=True)
    levels = tmg.levels
    tmg.solve(torch.as_tensor(b))
    assert tmg.levels is levels
    assert 0 < it < 100
    assert np.abs(tx.numpy() - jx).max() <= 10 * tol * np.abs(jx).max()
    _, jit_, _ = jax_multigrid_stats(jmg, b)
    assert abs(jit_ - it) <= 1, (jit_, it)


@pytest.mark.parametrize("size", [(16, 16, 8), (32, 32, 16)])
def test_channel_multigrid_iterations_follow_jax(size):
    """The stretched channel's pressure solve (x tanh-refined at both walls,
    z −cos, (Bounded, Periodic, Bounded); tolerance 1e-9 and maxiter 200 as
    the nonhydrostatic model builds it) on a random rhs: the port's CG
    iterations within ±1 of JAX's at each size, below the cap, and both
    final relative residuals within the tolerance. Their growth with the
    size is the algorithm's, not the port's."""
    grids = {pkg: stretched_grid(pkg, "xz", size=size) for pkg in (J, T)}
    ts = tsm.MultigridPoissonSolver.build(grids[T], tolerance=1e-9, maxiter=200)
    js = J.MultigridPoissonSolver.build(grids[J], tolerance=1e-9, maxiter=200)
    b = ts.vol.numpy() * np.random.default_rng(9).standard_normal(size)
    tsm.SOLVES.update(solves=0, iterations=0, residual=0.0)
    _, it, _ = ts.mg.solve(torch.as_tensor(b), return_stats=True)
    _, jit_, jrel = jax_multigrid_stats(js.mg, b)
    assert abs(jit_ - it) <= 1, (jit_, it)
    assert it < 200
    assert tsm.SOLVES["residual"] <= 1e-9 and jrel <= 1e-9


def stretched_grid(pkg, stretch, size=(16, 16, 8), topology=None, **kw):
    """The JAX suite's grids: x faces tanh-refined at both walls, y faces
    refined at one end, z faces −cos, on the axes named in ``stretch``."""
    n = size
    xf = np.tanh(np.linspace(-1.2, 1.2, n[0] + 1)) / np.tanh(1.2)
    yf = np.linspace(0.0, 1.0, n[1] + 1) ** 1.3
    zf = -np.cos(np.linspace(0, np.pi / 2, n[2] + 1))
    topology = topology or ("bounded", "periodic", "bounded")
    dtype = dict(dtype=jnp.float64) if pkg is J else dict(dtype=torch.float64,
                                                          device=DEVICE)
    return pkg.RectilinearGrid(
        size=n, x=xf if "x" in stretch else (-1.0, 1.0),
        y=yf if "y" in stretch else (0.0, 1.0),
        z=zf if "z" in stretch else (-1.0, 0.0), topology=topology, **dtype, **kw)


def test_multigrid_poisson_solver_on_a_grid_stretched_everywhere():
    """The JAX suite's case: the solve of the discrete Laplacian (JAX's
    operator) of a smooth φ on a 16×16×8 (Bounded, Bounded, Bounded) grid
    stretched in every axis gives φ back up to its mean (the model tests
    hold the solver against JAX's)."""
    topology = ("bounded", "bounded", "bounded")
    grids = {pkg: stretched_grid(pkg, "xyz", topology=topology, halo=(1, 1, 1))
             for pkg in (J, T)}
    from clima_oceananigans_jl_tpu.boundary_conditions.bcs import (fill_halos,
                                                                   regularize_bcs)
    jg = grids[J]
    xs, ys, zs = jg.nodes(J.CENTER, with_halo=True)
    phi = jnp.broadcast_to(jnp.cos(np.pi * xs) * jnp.cos(np.pi * ys)
                           * jnp.cos(np.pi * (zs + 1)), jg.total_shape)
    phi = fill_halos(phi, jg, J.CENTER, regularize_bcs(jg, J.CENTER))
    rhs = np.asarray(jg.interior(jop.laplacian(phi, jg, J.CENTER)))
    ts = tsm.MultigridPoissonSolver.build(grids[T], tolerance=1e-11, maxiter=300)
    ta = ts.solve(torch.as_tensor(np.array(rhs))).numpy()
    exp = np.asarray(jg.interior(phi))
    assert np.abs((ta - ta.mean()) - (exp - exp.mean())).max() < 1e-7


def fs_models(grid_of, method, kw):
    """The JAX and the port hydrostatic model under ImplicitFreeSurface of
    ``method``."""
    out = {}
    for pkg in (J, T):
        fs = (JIFS if pkg is J else T.ImplicitFreeSurface)(
            solver_method=method, tolerance=1e-12, maxiter=800)
        out[pkg] = (JH if pkg is J else T.HydrostaticFreeSurfaceModel)(
            grid=grid_of(pkg), free_surface=fs, **kw(pkg))
    return out


def rect_grid(pkg):
    dtype = dict(dtype=jnp.float64) if pkg is J else dict(dtype=torch.float64,
                                                          device=DEVICE)
    return pkg.RectilinearGrid(size=(12, 10, 4), x=(0, 1e5), y=(0, 8e4), z=(-100.0, 0),
                               topology=("periodic", "bounded", "bounded"), **dtype)


def latlon_grid(pkg):
    if pkg is J:
        return JLL(size=(16, 8, 4), longitude=(0, 360), latitude=(-60, 60),
                   z=(-1000.0, 0.0), dtype=jnp.float64)
    return T.LatitudeLongitudeGrid(size=(16, 8, 4), longitude=(0, 360),
                                   latitude=(-60, 60), z=(-1000.0, 0.0),
                                   dtype=torch.float64, device=DEVICE)


@pytest.mark.parametrize("method", ["matrix", "multigrid"])
@pytest.mark.parametrize("kind", ["rectilinear", "lat-lon"])
def test_stencil_free_surface_matches_jax(kind, method):
    """10 steps of the matrix and multigrid methods within RTOL of max|η|
    (and of each velocity) of the JAX model; the solves counted."""
    if kind == "rectilinear":
        models = fs_models(rect_grid, method, lambda pkg: {})
        eta = lambda m: (lambda x, y: 0.05 * m.sin(2 * math.pi * x / 1e5)
                         * m.cos(math.pi * y / 8e4))
        dt = 30.0
    else:
        models = fs_models(latlon_grid, method, lambda pkg: dict(
            coriolis=pkg.HydrostaticSphericalCoriolis()))
        eta = lambda m: (lambda lam, phi: 0.1 * m.sin(m.deg2rad(2 * lam))
                         * m.cos(m.deg2rad(3 * phi)))
        dt = 600.0
    jm, tm = models[J], models[T]
    js = jm.initial_state(eta=eta(jnp))
    ts = tm.initial_state(eta=eta(torch))
    step = jax.jit(jm.step)
    tsm.SOLVES.update(solves=0, iterations=0, residual=0.0)
    for _ in range(10):
        js, ts = step(js, jnp.float64(dt)), tm.step(ts, dt)
    assert tsm.SOLVES["solves"] == 10
    assert tsm.SOLVES["iterations"] > 0
    ref, got = np.asarray(js["eta"]), ts["eta"].numpy()
    assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max()
    for k in ("u", "v"):
        ref = np.asarray(jm.grid.interior(js["solution"][k]))
        got = tm.grid.interior(ts["solution"][k]).numpy()
        assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max(), k


def test_implicit_free_surface_copy_matches_jax():
    """The port's copy of validation/implicit_free_surface.py at N = 16: each
    method's η after the script's 50 steps within RTOL of a JAX model built
    from the script's constants, then the script's own assertion."""
    n = 16
    results = {}
    for method in tifs.METHODS:
        results[method] = tifs.run(method, n, DEVICE)
    grid = J.RectilinearGrid(size=(n, n, 8), x=(0, tifs.L), y=(0, tifs.L),
                             z=(-tifs.H, 0), topology=("periodic", "bounded", "bounded"),
                             dtype=jnp.float64)
    for method in ("fft", "multigrid"):
        jm = JH(grid=grid, free_surface=JIFS(solver_method=method, tolerance=1e-12,
                                            maxiter=800))
        js = jm.initial_state(eta=lambda x, y: 0.1 * jnp.sin(2 * jnp.pi * x / tifs.L)
                              * jnp.cos(jnp.pi * y / tifs.L))
        step = jax.jit(jm.step)
        for _ in range(tifs.N_STEPS):
            js = step(js, jnp.float64(tifs.DT))
        g = jm.grid
        ref = np.asarray(js["eta"])[g.Hx:g.Hx + n, g.Hy:g.Hy + n, 0]
        got = tifs.interior_eta(*results[method][:2])[..., 0]
        assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max(), method
    errs = tifs.differences(results)
    assert set(errs) == {"pcg", "matrix", "multigrid"}
    assert all(e < tifs.TOLERANCE for e in errs.values()), errs


def test_gates_take_the_new_configurations():
    """The constructions the port refused before: a stretched x or y in the
    nonhydrostatic model and the matrix and multigrid free surfaces build;
    PartialCellBottom stays refused and names ROADMAP Queue 1 item 7."""
    for stretch in ("x", "y"):
        m = T.NonhydrostaticModel(stretched_grid(T, stretch, (8, 8, 4)),
                                  advection=T.WENO5())
        assert isinstance(m.pressure_solver, tsm.MultigridPoissonSolver)
    for method in ("matrix", "multigrid"):
        fs_models(rect_grid, method, lambda pkg: {})
    grid = stretched_grid(T, "", (8, 8, 4))
    with pytest.raises(NotImplementedError, match="item 7"):
        T.NonhydrostaticModel(grid, immersed_boundary=T.PartialCellBottom(
            lambda x, y: -0.5 + 0 * x))
