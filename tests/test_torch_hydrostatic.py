"""Port parity: the hydrostatic free-surface model end to end.

The ¼° lat-lon flagship configuration of
``benchmark/bench_hydro_flagship.py`` (VectorInvariant weno_velocity
momentum, WENO5 tracers T and S, BuoyancyTracer, HydrostaticSphericalCoriolis,
split-explicit free surface, stretched z faces −3000(1 − k/Nz)^1.8,
longitude (0, 360) periodic, latitude (−75, 75) bounded, Δt = 600 s) is
built at 16×8×6 and 24×12×8 in both packages in f64 (8 barotropic
substeps) and stepped 10 times on the JAX plain path
(``fused_advection=False``) and on the port's CPU path (the kernels' plain
versions): u, v, T, S, b and η agree to ≤ 1e-9 of max|field|. The
differences are the reassociated sums (w and pHY′ in cumulative order,
the depth integrals) carried through 10 steps. The explicit free surface
likewise, and the implicit free surface with its FFT solve (a
horizontally regular rectilinear grid; torch.fft and the port's Makhoul
DCT against jnp.fft and jax.scipy's DCT) and its CG solve (lat-lon; both
CGs run to 1e-13, their inner products summed in different orders);
states pass between the packages both ways; what the port does not run
raises at construction (the matrix and multigrid free surfaces and
particles, which it now runs, build, and a partial-cell bottom builds and
steps), and seawater buoyancy and tilted gravity, which it runs, give the
JAX model's pHY′.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.interop import state_from_numpy, state_to_numpy

try:  # this file needs JAX; the guard keeps collection quiet without it
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection.vector_invariant import (
        VectorInvariant as JVI)
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JB
    from clima_oceananigans_jl_tpu.coriolis.coriolis import (
        HydrostaticSphericalCoriolis as JSph)
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from clima_oceananigans_jl_tpu.models.free_surface import (
        ExplicitFreeSurface as JExplicit, ImplicitFreeSurface as JImplicit,
        SplitExplicitFreeSurface as JSplit)
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    from clima_oceananigans_jl_tpu.timesteppers.steppers import Clock as JClock
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
DT = 600.0
RTOL = 1e-9


def zfaces(nz):
    k = np.arange(nz + 1)
    return -3000.0 * (1.0 - k / nz) ** 1.8


def models(size, free_surface="split", stretched=True):
    z = zfaces(size[2]) if stretched else (-3000.0, 0.0)
    jg = JLL(size=size, longitude=(0, 360), latitude=(-75, 75), z=z,
             dtype=jnp.float64)
    tg = T.LatitudeLongitudeGrid(size=size, longitude=(0, 360),
                                 latitude=(-75, 75), z=z, dtype=torch.float64,
                                 device=DEVICE)
    jfs, tfs = {"split": (JSplit(substeps=8), T.SplitExplicitFreeSurface(substeps=8)),
                "explicit": (JExplicit(), T.ExplicitFreeSurface())}[free_surface]
    jm = JH(jg, momentum_advection=JVI(scheme="weno_velocity"),
            tracer_advection=J.WENO5(), tracers=("T", "S"), free_surface=jfs,
            coriolis=JSph(), buoyancy=JB(), fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(
        tg, momentum_advection=T.VectorInvariant(scheme="weno_velocity"),
        tracer_advection=T.WENO5(), tracers=("T", "S"), free_surface=tfs,
        coriolis=T.HydrostaticSphericalCoriolis(), buoyancy=T.BuoyancyTracer())
    return jm, tm


def initial_values(shape, seed=0):
    """The flagship's u = 0.1·N(0,1) and b = 2e-5 (z+3000)/3000, plus a
    random T and S so every tracer carries signal."""
    rng = np.random.default_rng(seed)
    return dict(u=0.1 * rng.standard_normal(shape),
                T=rng.standard_normal(shape), S=0.5 * rng.standard_normal(shape),
                b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)


def compare(jm, js, tm, ts, rtol=RTOL):
    for name in ("u", "v", "T", "S", "b"):
        r = np.asarray(jm.grid.interior(js["solution"][name]))
        g = tm.grid.interior(ts["solution"][name]).numpy()
        assert np.abs(r - g).max() <= rtol * np.abs(r).max(), name
    h = tm.grid.Hx, tm.grid.Hy
    r = np.asarray(js["eta"])[h[0]:-h[0], h[1]:-h[1]]
    g = ts["eta"].numpy()[h[0]:-h[0], h[1]:-h[1]]
    assert np.abs(r - g).max() <= rtol * np.abs(r).max(), "eta"


@pytest.mark.parametrize("size,stretched", [((16, 8, 6), True),
                                            ((24, 12, 8), True),
                                            ((16, 8, 6), False)],
                         ids=["16x8x6", "24x12x8", "16x8x6-regular-z"])
def test_flagship_ten_split_explicit_steps_match_jax(size, stretched):
    jm, tm = models(size, stretched=stretched)
    assert tm.grid.halo == jm.grid.halo == (3, 3, 3)
    vals = initial_values(size)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    compare(jm, js, tm, ts, rtol=0.0)
    for _ in range(10):
        js = jm.step(js, DT)
        ts = tm.step(ts, DT)
    assert ts["clock"].iteration == 10 and ts["clock"].time == 10 * DT
    compare(jm, js, tm, ts)
    fields = tm.fields(ts)
    assert set(fields) == {"u", "v", "T", "S", "b", "w", "eta"}
    r = float(jm.cell_advection_timescale(js))
    assert abs(float(tm.cell_advection_timescale(ts)) - r) <= 1e-9 * r


def test_explicit_free_surface_ten_steps_match_jax():
    jm, tm = models((16, 8, 6), free_surface="explicit")
    vals = initial_values((16, 8, 6), seed=1)
    eta = lambda lam, phi: 0.1 * np.cos(np.deg2rad(lam)) * np.cos(np.deg2rad(phi))
    js = jm.initial_state(eta=eta, **vals)
    ts = tm.initial_state(eta=lambda lam, phi: 0.1 * torch.cos(torch.deg2rad(lam))
                          * torch.cos(torch.deg2rad(phi)), **vals)
    assert set(ts["G_prev"]) == {"u", "v", "T", "S", "b", "eta"}
    for _ in range(10):
        js = jm.step(js, 60.0)
        ts = tm.step(ts, 60.0)
    compare(jm, js, tm, ts)


@pytest.mark.parametrize("method", ["fft", "pcg"])
def test_implicit_free_surface_ten_steps_match_jax(method):
    size = (16, 8, 6)
    if method == "fft":
        kw = dict(size=size, x=(0, 2e6), y=(0, 1e6), z=zfaces(size[2]),
                  topology=("periodic", "bounded", "bounded"))
        jg = J.RectilinearGrid(dtype=jnp.float64, **kw)
        tg = T.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw)
        jc, tc = J.FPlane(f=1e-4), T.FPlane(f=1e-4)
        b = lambda x, y, z: 2e-5 * (z + 3000.0) / 3000.0
    else:
        jm, tm = models(size)
        jg, tg = jm.grid, tm.grid
        jc, tc = JSph(), T.HydrostaticSphericalCoriolis()
        b = initial_values(size)["b"]
    jm = JH(jg, momentum_advection=JVI(scheme="weno_velocity"),
            tracer_advection=J.WENO5(), tracers=("T",), coriolis=jc,
            free_surface=JImplicit(solver_method=method, tolerance=1e-13),
            buoyancy=JB(), fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(
        tg, momentum_advection=T.VectorInvariant(scheme="weno_velocity"),
        tracer_advection=T.WENO5(), tracers=("T",), coriolis=tc,
        free_surface=T.ImplicitFreeSurface(solver_method=method, tolerance=1e-13),
        buoyancy=T.BuoyancyTracer())
    assert tm.free_surface.resolve_method(tm.grid) == method
    rng = np.random.default_rng(7)
    vals = dict(u=0.1 * rng.standard_normal(size), v=0.1 * rng.standard_normal(size),
                T=rng.standard_normal(size), b=b)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    for _ in range(10):
        js = jm.step(js, DT)
        ts = tm.step(ts, DT)
    for name in ("u", "v", "T", "b"):
        r = np.asarray(jm.grid.interior(js["solution"][name]))
        g = tm.grid.interior(ts["solution"][name]).numpy()
        assert np.abs(r - g).max() <= RTOL * np.abs(r).max(), name
    r, g = np.asarray(js["eta"])[3:-3, 3:-3], ts["eta"].numpy()[3:-3, 3:-3]
    assert np.abs(r - g).max() <= RTOL * np.abs(r).max(), "eta"


def test_restart_from_a_jax_state_matches():
    size = (16, 8, 6)
    jm, tm = models(size)
    js = jm.initial_state(**initial_values(size, seed=2))
    for _ in range(3):
        js = jm.step(js, DT)
    ts = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
    assert ts["clock"].iteration == 3 and ts["previous_dt"] == DT
    compare(jm, js, tm, ts, rtol=0.0)  # the conversion itself is exact
    for key in ("w", "pHY"):
        assert np.array_equal(np.asarray(js[key]), ts[key].numpy()), key
    # an x/y-interior G_prev (the JAX fused advance's layout) goes in too
    gp = {n: np.asarray(g)[3:-3, 3:-3] for n, g in js["G_prev"].items()}
    other = state_from_numpy(tm, dict(jax.tree_util.tree_map(np.asarray, js),
                                      G_prev=gp))
    for n in gp:
        assert torch.equal(tm.grid.interior(other["G_prev"][n]),
                           tm.grid.interior(ts["G_prev"][n]))
    for _ in range(3):
        js = jm.step(js, DT)
        ts = tm.step(ts, DT)
    compare(jm, js, tm, ts)


def test_port_state_restarts_the_jax_model():
    size = (16, 8, 6)
    jm, tm = models(size, free_surface="explicit")
    ts = tm.initial_state(**initial_values(size, seed=3))
    for _ in range(2):
        ts = tm.step(ts, 60.0)
    ns = state_to_numpy(ts)
    js = jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in ns.items()
                                              if k != "clock"})
    js["clock"] = JClock(jnp.asarray(ns["clock"].time),
                         jnp.asarray(ns["clock"].iteration))
    assert js["eta"].shape == tm.grid.total_shape[:2] + (1,)
    assert js["G_prev"]["eta"].shape == js["eta"].shape
    back = state_from_numpy(tm, ns)
    compare(jm, js, tm, back, rtol=0.0)
    for _ in range(3):
        js = jm.step(js, 60.0)
        ts = tm.step(ts, 60.0)
    compare(jm, js, tm, ts)


def test_what_waits_is_refused_naming_its_roadmap_item():
    _, tm = models((8, 8, 4))
    g = tm.grid
    # the default free surface is implicit: CG on a lat-lon grid
    assert T.HydrostaticFreeSurfaceModel(g).free_surface.resolve_method(g) == "pcg"
    for method in ("matrix", "multigrid"):  # built on the lat-lon grid
        fs = T.ImplicitFreeSurface(solver_method=method)
        m = T.HydrostaticFreeSurfaceModel(g, free_surface=fs)
        assert m.free_surface.resolve_method(m.grid) == method
    with pytest.raises(NotImplementedError):  # fft needs a regular grid
        T.HydrostaticFreeSurfaceModel(
            g, free_surface=T.ImplicitFreeSurface(solver_method="fft"))
    split = T.SplitExplicitFreeSurface(substeps=4)
    zero = torch.zeros(2, dtype=torch.float64)
    m = T.HydrostaticFreeSurfaceModel(
        g, free_surface=split, particles=T.LagrangianParticles(zero, zero, zero))
    assert "particles" in m.initial_state()
    # partial bottom cells are ported: the model builds and steps
    m = T.HydrostaticFreeSurfaceModel(g, free_surface=split,
                                      immersed_boundary=T.PartialCellBottom(-500.0))
    assert m.grid.partial_cells
    s = m.step(m.initial_state(u=0.01), 60.0)
    assert bool(torch.isfinite(s["solution"]["u"]).all())
    with pytest.raises(NotImplementedError,
                       match="VectorInvariant tracer advection is not ported"):
        T.HydrostaticFreeSurfaceModel(g, free_surface=split,
                                      tracer_advection=T.VectorInvariant())
    # seawater buoyancy and tilted gravity are ported: pHY′ (−ĝ_z b
    # integrated) as the JAX model's
    jg = JLL(size=(8, 8, 4), longitude=(0, 360), latitude=(-75, 75), z=zfaces(4),
             dtype=jnp.float64)
    for jbuoy, tbuoy in ((J.SeawaterBuoyancy(), T.SeawaterBuoyancy()),
                         (JB(gravity_unit_vector=(0.6, 0.0, -0.8)),
                          T.BuoyancyTracer(gravity_unit_vector=(0.6, 0.0, -0.8)))):
        jm = JH(jg, free_surface=JSplit(substeps=4), buoyancy=jbuoy,
                fused_advection=False)
        tm2 = T.HydrostaticFreeSurfaceModel(g, free_surface=split, buoyancy=tbuoy)
        vals = {n: np.random.default_rng(5).standard_normal(g.shape)
                for n in tm2.tracer_names}
        js, ts = jm.initial_state(**vals), tm2.initial_state(**vals)
        r = np.asarray(jm.grid.interior(js["pHY"]))
        assert np.abs(r - tm2.grid.interior(ts["pHY"]).numpy()).max() <= 1e-13 * np.abs(r).max()
    # closures and grid-fitted immersed boundaries are ported
    for kw in (dict(closure=T.ScalarDiffusivity(nu=1e-3)),
               dict(immersed_boundary=T.GridFittedBottom(-500.0)),
               dict(immersed_boundary=T.GridFittedBoundary(lambda x, y, z: z < -900.0))):
        T.HydrostaticFreeSurfaceModel(g, free_surface=split, **kw)
    flat = T.RectilinearGrid(size=(8, 8, 1), extent=(1, 1),
                             topology=("periodic", "periodic", "flat"),
                             device=DEVICE)
    with pytest.raises(ValueError):
        T.HydrostaticFreeSurfaceModel(flat, free_surface=split)
