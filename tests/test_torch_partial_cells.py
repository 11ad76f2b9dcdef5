"""Port parity: partial bottom cells (``PartialCellBottom``) in the
hydrostatic model.

Both packages get the same bottom: an array of bottom heights made with
numpy from a seed (a callable only where it is plain arithmetic, which
both packages round alike), so that no sliver splits on an ulp of a
sigmoid. In f32 and f64 on the CPU:

- ``PartialCellBoundary.from_bottom``'s masks, ``dz_ccc`` and ``dz_ccf``
  on a rectilinear and a lat-lon grid, for a callable, a constant and an
  array, at two ``minimum_fraction``s: bit for bit;
- ``ImmersedGrid``'s ``dz``, ``Ax``, ``Ay`` and ``V`` at every location:
  bit for bit; the column depths (sums over z, which XLA associates
  otherwise) within an ulp of their scale; ``z_rows`` refuses the grid,
  and ``dz3_pack`` holds its two 3D Δz arrays;
- the port's counterpart of the JAX suite's
  ``test_partial_cell_bottom_metrics_and_model``;
- K4a's plain version (w, pHY′) against the JAX model's w and pHY′, and
  K4b's (``hydrostatic_advective_core``) against the JAX core, on the
  partial-cell grids, within 1e-13 of max|ref| (the tolerance of
  ``tests/test_torch_immersed.py``; w and pHY′ are sums in another order);
- ten model steps on a 16×8×6 lat-lon grid with the near-global
  validation's closure and quadratic bottom drag under the default
  schemes and under WENO5, and one step under ``ImplicitFreeSurface``
  (pcg), within 1e-9 of max|ref| (the RTOL of
  ``tests/test_torch_hydrostatic.py``);
- the 1D-axis reads the port keeps as the JAX package does (the implicit
  vertical diffusion's bands, CATKE's wall distance, the
  Fourier-tridiagonal solver's Δz): on a partial-cell grid each is the
  parent grid's, bit for bit;
- the port's copy of ``validation/near_global_lat_lon.py`` at its own 3°
  in f64, 2 steps against the JAX script's model, within 1e-9.

The ``cuda`` cases hold K4a's and K4b's 3D-Δz forms bit for bit against
their plain versions on the card (``python -m pytest --noconftest -m cuda
tests/test_torch_partial_cells.py``), over NaN-filled outputs.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.closures.implicit_vertical_diffusion import (
    implicit_vertical_diffusion_step)
from clima_oceananigans_jl_torch.immersed.immersed import ImmersedGrid, PartialCellBoundary
from clima_oceananigans_jl_torch.models.free_surface import column_depths
from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh
from clima_oceananigans_jl_torch.ops import metric_rows as tmr
from clima_oceananigans_jl_torch.solvers.fourier_tridiagonal import FourierTridiagonalSolver
from clima_oceananigans_jl_torch.validation import near_global_lat_lon as tng

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection.vector_invariant import VectorInvariant as JVI
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JB
    from clima_oceananigans_jl_tpu.closures.implicit_vertical_diffusion import (
        implicit_vertical_diffusion_step as j_ivd)
    from clima_oceananigans_jl_tpu.coriolis.coriolis import (
        HydrostaticSphericalCoriolis as JSph)
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from clima_oceananigans_jl_tpu.immersed import immersed as jim
    from clima_oceananigans_jl_tpu.models import free_surface as jfs
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    from clima_oceananigans_jl_tpu.ops.fused_hydrostatic import (
        hydrostatic_advective_core as j_core)
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
OP_RTOL = 1e-13
C, F = T.C, T.F
ALL_LOCS = [(a, b, c) for a in (C, F) for b in (C, F) for c in (C, F)]
HALO = (3, 3, 3)
NEAR_GLOBAL = dict(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
                   time_discretization="vertically_implicit")


def zfaces(nz, depth=3000.0, p=1.8):
    k = np.arange(nz + 1)
    return -depth * (1.0 - k / nz) ** p


def grids(kind, dtype, size=None, device=DEVICE, jax_grid=True):
    """(JAX grid or None, port grid) of ``kind`` ("rect" or "latlon") in
    ``dtype`` ("f32" or "f64") with the halos of WENO5 (3 each)."""
    td = {"f32": torch.float32, "f64": torch.float64}[dtype]
    jd = getattr(jnp, {"f32": "float32", "f64": "float64"}[dtype]) if jax_grid else None
    if kind == "rect":
        kw = dict(size=size or (12, 10, 8), x=(0, 1e5), y=(0, 8e4), z=(-1e3, 0),
                  topology=("periodic", "bounded", "bounded"))
        tg = T.RectilinearGrid(dtype=td, device=device, **kw).with_halo(HALO)
        jg = J.RectilinearGrid(dtype=jd, **kw).with_halo(HALO) if jax_grid else None
    else:
        size = size or (16, 8, 6)
        kw = dict(size=size, longitude=(0, 360), latitude=(-75, 75), z=zfaces(size[2]))
        tg = T.LatitudeLongitudeGrid(dtype=td, device=device, **kw).with_halo(HALO)
        jg = JLL(dtype=jd, **kw).with_halo(HALO) if jax_grid else None
    return jg, tg


def bottom_array(kind, total_shape, seed=11):
    """A (X, Y, 1) with-halo array of bottom heights: random depths over the
    grid's whole column, a few land columns."""
    rng = np.random.default_rng(seed)
    depth = 1e3 if kind == "rect" else 3000.0
    h = -depth + 0.97 * depth * rng.random(total_shape[:2] + (1,))
    h[2:5, 3:5] = 0.1 * depth
    return h


def bottoms(kind, how, total_shape):
    """(JAX bottom, port bottom): a callable of plain arithmetic, a
    constant or the array of ``bottom_array``."""
    if how == "array":
        h = bottom_array(kind, total_shape)
        return jnp.asarray(h), torch.as_tensor(h)
    if how == "constant":
        c = -480.0 if kind == "rect" else -2000.0
        return c, c
    if kind == "rect":
        f = lambda x, y: -900.0 + 0.004 * x + 0.002 * y
    else:
        f = lambda lam, phi: -2900.0 + 5.0 * lam + 3.0 * phi
    return f, f


def same(ref, got):
    r, g = np.asarray(ref), got.numpy()
    return r.shape == g.shape and np.array_equal(r, g)


def close(ref, got, rtol, label=""):
    r, g = np.asarray(ref), got.numpy()
    assert r.shape == g.shape, label
    assert np.abs(r - g).max() <= rtol * np.abs(r).max(), (label, np.abs(r - g).max())


# -- the boundary and the grid's metrics ---------------------------------------------

@pytest.mark.parametrize("minimum_fraction", [0.2, 0.5])
@pytest.mark.parametrize("how", ["callable", "constant", "array"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kind", ["rect", "latlon"])
def test_partial_cell_boundary_matches_jax(kind, dtype, how, minimum_fraction):
    jg, tg = grids(kind, dtype)
    jb, tb = bottoms(kind, how, tg.total_shape)
    jpc = jim.PartialCellBoundary.from_bottom(jg, jb, minimum_fraction)
    tpc = PartialCellBoundary.from_bottom(tg, tb, minimum_fraction)
    for name in ("solid_ccc", "solid_fcc", "solid_cfc", "solid_ccf", "dz_ccc", "dz_ccf"):
        assert same(getattr(jpc, name), getattr(tpc, name)), name
    assert tpc.dz_ccc.dtype == tg.dtype and tpc.dz_ccf.dtype == tg.dtype
    # the cut cells are fractional, and none below the minimum fraction
    full = tg._axes[2].dc.reshape(1, 1, -1)
    frac = (tpc.dz_ccc / full)[~tpc.solid_ccc]
    assert bool((frac < 1).any()) and float(frac.min()) >= minimum_fraction * (1 - 1e-6)
    # the spec builds the same boundary
    spec = T.PartialCellBottom(tb, minimum_fraction).build(tg)
    assert torch.equal(spec.dz_ccc, tpc.dz_ccc) and torch.equal(spec.dz_ccf, tpc.dz_ccf)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kind", ["rect", "latlon"])
def test_immersed_grid_metrics_match_jax(kind, dtype):
    jg, tg = grids(kind, dtype)
    jb, tb = bottoms(kind, "array", tg.total_shape)
    jig = jim.ImmersedGrid.wrap(jg, jim.PartialCellBottom(jb).build(jg))
    tig = ImmersedGrid.wrap(tg, T.PartialCellBottom(tb).build(tg))
    assert tig.partial_cells and not ImmersedGrid(tg, tig.boundary).partial_cells
    for loc in ALL_LOCS:
        jl = tuple(J.C if a == C else J.F for a in loc)
        for name in ("dz", "Ax", "Ay", "V"):
            assert same(getattr(jig, name)(jl), getattr(tig, name)(loc)), (name, loc)
        for axis in range(3):
            assert same(jig.spacing(axis, jl), tig.spacing(axis, loc)), (axis, loc)
    # the column depths are sums over z, which XLA and torch associate
    # differently: within an ulp of their scale
    for r, g in zip(jfs.column_depths(jig), column_depths(tig)):
        close(r, g, 1e-14 if dtype == "f64" else 2e-7, "column depths")
    # the kernels' 3D pack; the z rows would be column (0, 0)'s
    pack = tmr.dz3_pack(tig)
    assert pack.shape == (2,) + tg.total_shape and pack.is_contiguous()
    assert torch.equal(pack[0], tig._dz_ccc) and torch.equal(pack[1], tig._dz_ccf)
    with pytest.raises(ValueError, match="3D"):
        tmr.z_rows(tig)
    rows = tmr.partial_cell_z_rows(tig, tables=not tg.z_regular)
    assert torch.isnan(rows[:2]).all()
    if not tg.z_regular:
        assert torch.equal(rows[2:], tmr.z_rows(tg, tables=True)[2:])


def test_partial_cell_bottom_metrics_and_model():
    """The JAX suite's case in the port: a 16×4×8 box over a sin² bump,
    the fluid column heights against the analytic depth, three steps."""
    n = 16
    g = T.RectilinearGrid(size=(n, 4, 8), x=(0, 1), y=(0, 1), z=(-1, 0),
                          topology=("periodic", "periodic", "bounded"),
                          dtype=torch.float64, device=DEVICE)
    bottom = lambda x, y: -1.0 + 0.45 * (x - x + 1) * torch.sin(np.pi * x) ** 2
    model = T.HydrostaticFreeSurfaceModel(g, immersed_boundary=T.PartialCellBottom(bottom),
                                          tracers=("c",))
    ig = model.grid
    assert isinstance(ig, ImmersedGrid) and ig.partial_cells
    ib = ig.immersed
    dz3 = (ig.dz(T.CENTER) * torch.where(ib.solid_ccc, 0.0, 1.0)).numpy()
    Hz, Nz = ig.Hz, ig.Nz
    col = dz3[:, :, Hz:Hz + Nz].sum(-1)
    x, y, _ = ig.nodes(T.CENTER, with_halo=True)
    depth = np.broadcast_to((-bottom(x, y)).numpy()[:, :, 0], col.shape)
    interior = (slice(ig.Hx, ig.Hx + ig.Nx), slice(ig.Hy, ig.Hy + ig.Ny))
    # exact wherever the sliver exceeds the minimum fraction (Δz = 0.125,
    # the smallest sliver 0.025)
    err = np.abs(col[interior] - depth[interior])
    assert np.median(err) < 0.025 + 1e-12
    assert (col[interior] > 0).all()
    state = model.initial_state(c=1.0)
    for _ in range(3):
        state = model.step(state, 10.0)
    for name, arr in state["solution"].items():
        assert bool(torch.isfinite(arr).all()), name


# -- the kernels' plain versions -----------------------------------------------------

def near_global_pair(size=(16, 8, 6), weno=False, free_surface="split", seed=11):
    """(JAX model, port model): the near-global validation's physics (its
    closure, wind and quadratic bottom drag) over ``PartialCellBottom`` of
    one array of bottom heights; with ``weno``, the ¼° flagship's schemes
    and T, S."""
    jg, tg = grids("latlon", "f64", size)
    # the bottom array on the model's with-halo grid (its schemes' halo)
    halo = 3 if weno else max(T.VectorInvariant().required_halo, 1)
    jg, tg = jg.with_halo((halo,) * 3), tg.with_halo((halo,) * 3)
    h = bottom_array("latlon", tg.total_shape, seed)
    drag = lambda lib, n: (lambda grid, t, f: -2.5e-3 * lib.sqrt(f["u"] ** 2 + f["v"] ** 2)
                           * f[n])
    wind = lambda lib: (lambda lam, phi, t: -1e-4 * lib.cos(3.0 * np.pi * phi / 180.0))
    jfsurf, tfsurf = {
        "split": (jfs.SplitExplicitFreeSurface(substeps=8),
                  T.SplitExplicitFreeSurface(substeps=8)),
        "implicit": (jfs.ImplicitFreeSurface(solver_method="pcg", tolerance=1e-13,
                                             maxiter=1000),
                     T.ImplicitFreeSurface(solver_method="pcg", tolerance=1e-13,
                                           maxiter=1000))}[free_surface]
    jkw = dict(free_surface=jfsurf, coriolis=JSph(), buoyancy=JB(),
               closure=J.ScalarDiffusivity(**NEAR_GLOBAL),
               immersed_boundary=jim.PartialCellBottom(jnp.asarray(h)),
               boundary_conditions={
                   "u": J.FieldBCs(top=J.FluxBC(wind(jnp)),
                                   immersed=J.FluxBC(drag(jnp, "u"), discrete=True)),
                   "v": J.FieldBCs(immersed=J.FluxBC(drag(jnp, "v"), discrete=True))},
               fused_advection=False)
    tkw = dict(free_surface=tfsurf, coriolis=T.HydrostaticSphericalCoriolis(),
               buoyancy=T.BuoyancyTracer(), closure=T.ScalarDiffusivity(**NEAR_GLOBAL),
               immersed_boundary=T.PartialCellBottom(torch.as_tensor(h)),
               boundary_conditions={
                   "u": T.FieldBCs(top=T.FluxBC(wind(torch)),
                                   immersed=T.FluxBC(drag(torch, "u"), discrete=True)),
                   "v": T.FieldBCs(immersed=T.FluxBC(drag(torch, "v"), discrete=True))})
    if weno:
        jkw.update(momentum_advection=JVI(scheme="weno_velocity"),
                   tracer_advection=J.WENO5(), tracers=("T", "S"))
        tkw.update(momentum_advection=T.VectorInvariant(scheme="weno_velocity"),
                   tracer_advection=T.WENO5(), tracers=("T", "S"))
    return JH(jg, **jkw), T.HydrostaticFreeSurfaceModel(tg, **tkw)


def initial_values(model, seed, random_b=False):
    rng = np.random.default_rng(seed)
    shape = model.grid.shape
    vals = dict(u=0.1 * rng.standard_normal(shape), v=0.05 * rng.standard_normal(shape),
                b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    if random_b:
        vals["b"] = 1e-3 * rng.standard_normal(shape)
    for n in ("T", "S"):
        if n in model.tracer_names:
            vals[n] = rng.standard_normal(shape)
    return vals


@pytest.mark.parametrize("weno", [False, True], ids=["default", "weno5"])
def test_plain_columns_and_core_match_jax(weno):
    """K4a's plain version (the port model's w and pHY′) against the JAX
    model's, and K4b's plain version against the JAX core on random
    fields, on the partial-cell grid."""
    jm, tm = near_global_pair(weno=weno)
    vals = initial_values(tm, 2, random_b=True)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    for key in ("w", "pHY"):
        close(js[key], ts[key], OP_RTOL, key)
    sol = ts["solution"]
    w, ph = tfh.hydrostatic_columns_reference(tm.grid, sol["u"], sol["v"], sol["b"])
    assert torch.equal(tm.grid.interior(ph), tm.grid.interior(ts["pHY"]))
    assert torch.equal(tm.compute_w(sol), ts["w"])
    rng = np.random.default_rng(9)
    names = tm.tracer_names
    f = {n: rng.standard_normal(tm.grid.total_shape) * s for n, s in
         [("u", 0.1), ("v", 0.1), ("w", 1e-3), ("pHY", 1.0)] + [(n, 1.0) for n in names]}
    ja = {k: jnp.asarray(v) for k, v in f.items()}
    ta = {k: torch.as_tensor(v) for k, v in f.items()}
    ref = j_core(jm.grid, jm.momentum_advection, jm.tracer_advection, jm.coriolis, names,
                 ja["u"], ja["v"], ja["w"], {n: ja[n] for n in names}, pHY=ja["pHY"])
    got = tfh.hydrostatic_advective_core(
        tm.grid, tm.momentum_advection, tm.tracer_advection, tm.coriolis, names,
        ta["u"], ta["v"], ta["w"], {n: ta[n] for n in names}, pHY=ta["pHY"])
    for n in ("u", "v") + names:
        close(jm.grid.interior(ref[n]), tm.grid.interior(got[n]), OP_RTOL, n)
    # the model's K4b plain version is that core on the state
    G = tfh.fused_hydrostatic_tendencies(tm, ts)
    G2 = tfh.hydrostatic_advective_core(
        tm.grid, tm.momentum_advection, tm.tracer_advection, tm.coriolis, names,
        sol["u"], sol["v"], ts["w"], {n: sol[n] for n in names}, pHY=ts["pHY"])
    assert all(torch.equal(G[n], G2[n]) for n in G)


# -- the model ---------------------------------------------------------------------

def run(jm, tm, vals, steps, dt):
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(steps):
        js, ts = step(js, dt), tm.step(ts, dt)
    return js, ts


def compare(jm, js, tm, ts, rtol=RTOL):
    for name in tm.prognostic_names():
        close(jm.grid.interior(js["solution"][name]),
              tm.grid.interior(ts["solution"][name]), rtol, name)
    hx, hy = tm.grid.Hx, tm.grid.Hy
    close(np.asarray(js["eta"])[hx:-hx, hy:-hy], ts["eta"][hx:-hx, hy:-hy], rtol, "eta")


def zero_at_solid_faces(tm, ts):
    imm, sol = tm.grid.immersed, ts["solution"]
    return all(float((sol[n] * imm.mask_for(loc)).abs().max()) == 0.0
               for n, loc in (("u", T.U_LOC), ("v", T.V_LOC)))


@pytest.mark.parametrize("weno", [False, True], ids=["default", "weno5"])
def test_ten_steps_match_jax(weno):
    jm, tm = near_global_pair(weno=weno)
    assert tm.grid.partial_cells and not tm.fused_advance
    assert tfh.kernel_closure(tm) is None and tfh.unsupported_reason(tm) is None
    js, ts = run(jm, tm, initial_values(tm, 1), steps=10, dt=600.0)
    compare(jm, js, tm, ts)
    assert zero_at_solid_faces(tm, ts)


def test_implicit_free_surface_step_matches_jax():
    jm, tm = near_global_pair(free_surface="implicit")
    assert tm.free_surface.resolve_method(tm.grid) == "pcg"
    js, ts = run(jm, tm, initial_values(tm, 3), steps=1, dt=60.0)
    compare(jm, js, tm, ts)


def test_one_dimensional_axis_reads_are_the_parent_grids():
    """The implicit vertical diffusion's bands, CATKE's wall distance and
    the Fourier-tridiagonal solver's Δz read the z axis' row on a
    partial-cell grid, as the JAX package does: each is the parent grid's,
    bit for bit (and the implicit step is the JAX one's)."""
    jg, tg = grids("rect", "f64")
    jb, tb = bottoms("rect", "array", tg.total_shape)
    jig = jim.ImmersedGrid.wrap(jg, jim.PartialCellBottom(jb).build(jg))
    tig = ImmersedGrid.wrap(tg, T.PartialCellBottom(tb).build(tg))
    data = np.random.default_rng(4).standard_normal(tg.total_shape)
    for loc in (T.CENTER, T.W_LOC):
        on_partial = implicit_vertical_diffusion_step(torch.as_tensor(data), tig, loc, 1e-2, 60.0)
        on_parent = implicit_vertical_diffusion_step(torch.as_tensor(data), tg, loc, 1e-2, 60.0)
        assert torch.equal(on_partial, on_parent), loc
        jl = tuple(J.C if a == C else J.F for a in loc)
        close(j_ivd(jnp.asarray(data), jig, jl, 1e-2, 60.0), on_partial, OP_RTOL, str(loc))
    catke = T.CATKEVerticalDiffusivity()
    assert torch.equal(catke._wall_distance(tig), catke._wall_distance(tg))
    a, b = FourierTridiagonalSolver.build(tig), FourierTridiagonalSolver.build(tg)
    for name in ("lower", "upper", "dzc"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# -- the validation copy -------------------------------------------------------------

def test_near_global_validation_copy_matches_the_jax_script_at_three_degrees():
    """The port's ``validation/near_global_lat_lon.py`` at its own 3°
    (120×50×24, 50 substeps, its GridFittedBottom), in f64, 2 steps of
    Δt = 1200 s against the JAX script's model built as the script builds
    it; the script's check that u and v are exactly 0 at solid faces."""
    tm = tng.model_for(3.0, torch.float64, DEVICE)
    size = tm.grid.shape
    jg = JLL(size=size, longitude=(0, 360), latitude=(-75, 75), z=zfaces(24),
             dtype=jnp.float64)

    def bathymetry(lam, phi):
        s = jax.nn.sigmoid
        block = lambda lo, hi, w=8.0: s((lam - lo) / w) * s((hi - lam) / w)
        band = lambda lo, hi, w=6.0: s((phi - lo) / w) * s((hi - phi) / w)
        land = jnp.clip(block(255.0, 300.0) * band(-55.0, 70.0)
                        + (block(0.0, 50.0) * band(-35.0, 70.0)
                           + block(25.0, 120.0) * band(10.0, 70.0))
                        + block(112.0, 154.0) * band(-40.0, -11.0), 0.0, 1.0)
        ridge = 1200.0 * jnp.exp(-((lam - 330.0) / 12.0) ** 2) * band(-60.0, 60.0)
        return jnp.where(land > 0.5, 100.0, -3000.0 + ridge)

    drag = lambda n: (lambda grid, t, f: -2.5e-3 * jnp.sqrt(f["u"] ** 2 + f["v"] ** 2) * f[n])
    jm = JH(jg, free_surface=jfs.SplitExplicitFreeSurface(substeps=50), coriolis=JSph(),
            buoyancy=JB(), closure=J.ScalarDiffusivity(**NEAR_GLOBAL),
            immersed_boundary=jim.GridFittedBottom(bathymetry),
            boundary_conditions={
                "u": J.FieldBCs(top=J.FluxBC(lambda lam, phi, t: -1e-4 * jnp.cos(
                    3.0 * jnp.pi * phi / 180.0)), immersed=J.FluxBC(drag("u"), discrete=True)),
                "v": J.FieldBCs(immersed=J.FluxBC(drag("v"), discrete=True))},
            fused_advection=False)
    jb = lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0 + 1e-6 * jnp.cos(jnp.pi * phi / 180.0)
    js = jm.initial_state(b=jb)
    ts = tng.initial_state(tm)
    step = jax.jit(jm.step)
    for _ in range(2):
        js, ts = step(js, tng.DT), tm.step(ts, tng.DT)
    compare(jm, js, tm, ts)
    assert zero_at_solid_faces(tm, ts)


# -- on the card -------------------------------------------------------------------

def _poison_cache(shape, dtype, n=8):
    """Leave n NaN-filled blocks of ``shape`` in the caching allocator, so
    that an output point a kernel does not write stays NaN."""
    blocks = [torch.full(shape, float("nan"), dtype=dtype, device="cuda")
              for _ in range(n)]
    del blocks


def _cuda_model(momentum, tracer, dtype, size=(45, 21, 12)):
    """A lat-lon model over partial cells on the card (sizes off K4a's
    32-column run and K4b's 16×8 tile), with a random state."""
    _, tg = grids("latlon", dtype, size, device="cuda", jax_grid=False)
    # the bottom array on the model's with-halo grid (its schemes' halo)
    halo = max(momentum.required_halo, tracer.required_halo, 1)
    tg = tg.with_halo((halo,) * 3)
    h = bottom_array("latlon", tg.total_shape)
    tm = T.HydrostaticFreeSurfaceModel(
        tg, momentum_advection=momentum, tracer_advection=tracer, tracers=("T",),
        free_surface=T.SplitExplicitFreeSurface(substeps=8),
        coriolis=T.HydrostaticSphericalCoriolis(), buoyancy=T.BuoyancyTracer(),
        immersed_boundary=T.PartialCellBottom(torch.as_tensor(h)))
    return tm, tm.initial_state(**initial_values(tm, 5, random_b=True))


CUDA_SCHEMES = {"default": (T.VectorInvariant, T.CenteredSecondOrder),
                "weno5": (lambda: T.VectorInvariant(scheme="weno_velocity"), T.WENO5),
                "ub5-bp": (T.UpwindBiasedFifthOrder, T.BoundsPreservingWENO5),
                "flux-weno5": (T.WENO5, T.WENO5)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("schemes", sorted(CUDA_SCHEMES))
def test_cuda_partial_cell_forms_are_bitwise_their_plain_versions(schemes, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mom, tr = CUDA_SCHEMES[schemes]
    tm, state = _cuda_model(mom(), tr(), dtype)
    g, sol = tm.grid, state["solution"]
    _poison_cache(g.total_shape, g.dtype)
    n0, m0 = tfh.hydrostatic_columns.launches, tfh.fused_hydrostatic_tendencies.launches
    got = tfh.hydrostatic_columns(g, sol["u"], sol["v"], sol["b"])
    ref = tfh.hydrostatic_columns_reference(g, sol["u"], sol["v"], sol["b"])
    for a, r in zip(got, ref):
        assert not torch.isnan(a).any() and torch.equal(a, r)
    for adv in (None, (600.0, False)):
        got = tfh.fused_hydrostatic_tendencies(tm, state, adv)
        ref = tfh.fused_hydrostatic_tendencies_reference(tm, state, adv)
        got, ref = ((got,), (ref,)) if adv is None else (got, ref)
        for gd, rd in zip(got, ref):
            for n in rd:
                assert torch.equal(g.interior(gd[n]), g.interior(rd[n])), n
                halo = gd[n].clone()
                halo[g.interior_slices] = 0
                assert not halo.any(), "K4b wrote a nonzero halo"
    assert tfh.hydrostatic_columns.launches == n0 + 1
    assert tfh.fused_hydrostatic_tendencies.launches == m0 + 2


@pytest.mark.cuda
def test_cuda_partial_cell_steps_match_the_plain_run():
    """Three steps with the kernels and three with their plain versions
    from the same state agree exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tm, state = _cuda_model(T.VectorInvariant(), T.CenteredSecondOrder(), "f64")
    from clima_oceananigans_jl_torch.models.hydrostatic import PLAIN
    a, b = state, state
    for _ in range(3):
        a, b = tm.step(a, 600.0), tm.step(b, 600.0, PLAIN)
    for n in tm.prognostic_names():
        assert torch.equal(a["solution"][n], b["solution"][n]), n
    assert torch.equal(a["eta"], b["eta"])
