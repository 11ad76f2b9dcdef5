"""Port parity: the vertical-mixing closures (CATKE, convective adjustment,
Ri-based mixing) and GM/Redi, term by term and in both models.

In f64 on the CPU, through the JAX package's function and the port's on
the same numpy-seeded inputs:

- each closure's ``compute_diffusivities`` on a (Periodic, Periodic,
  Bounded) rectilinear grid and on a lat-lon grid; CATKE's
  ``tke_tendency`` without surface fluxes, with scalar and (x, y) plane
  momentum fluxes, a buoyancy flux with the convective length, and
  explicit dissipation; GM/Redi's ``tracer_tendency``; the diffusion
  timescale of each. Convective adjustment and GM/Redi are bit for bit.
  CATKE and the Ri-based closure go through ``tanh`` and ``sqrt`` (and
  ``x**0.75``, ``x**1.5``), which torch's vectorised CPU kernels round
  within an ulp where XLA's are exact or round otherwise, so they are held
  to 1e-13 of max|ref| per field;
- the implicit step (T1's plain version) with CATKE's Lᵉ folded into e's
  diagonal and its 3D (C, C, F) κ moved onto the u and v faces, within
  1e-12;
- 10 steps of the hydrostatic model within 1e-9: the JAX suite's
  ``column_model`` (Flat, Flat, Bounded) with each vertical-mixing closure
  and surface fluxes, GM/Redi on its (Periodic, Flat, Bounded) section,
  and a 12×8×6 lat-lon grid with a ``GridFittedBottom``, the tuple
  (``HorizontalScalarDiffusivity``, CATKE with a wind-stress plane) and
  TEOS-10; 10 RK3 steps of the nonhydrostatic model with a closure tuple
  holding CATKE;
- a CATKE state from the JAX model stepped in the port and back
  (``interop``);
- the JAX suite's closure physics tests (``tests/test_closures.py:86-213``)
  in the port.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.closures import implicit_vertical_diffusion as tivd
from clima_oceananigans_jl_torch.closures import scalar_diffusivity as tsd
from clima_oceananigans_jl_torch.interop import state_from_numpy, state_to_numpy
from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh

try:  # this file needs JAX; the guard keeps collection quiet without it
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.buoyancy import nonlinear_eos as jn
    from clima_oceananigans_jl_tpu.closures import implicit_vertical_diffusion as jivd
    from clima_oceananigans_jl_tpu.closures import isopycnal as jiso
    from clima_oceananigans_jl_tpu.closures import scalar_diffusivity as jsd
    from clima_oceananigans_jl_tpu.closures import vertical_mixing as jvm
    from clima_oceananigans_jl_tpu.immersed.immersed import GridFittedBottom as JGFB
    from clima_oceananigans_jl_tpu.timesteppers.steppers import Clock as JClock
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
#: the closures' fields through tanh, sqrt and powers (see the docstring)
ROUNDING = 1e-13


def same(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    ref = np.broadcast_to(ref, got.shape)
    assert np.array_equal(ref, got), np.abs(ref - got).max()


def jinit(jm, vals):
    """The JAX model's ``initial_state`` under ``jax.jit`` (one compile,
    where op-by-op dispatch takes seconds)."""
    return jax.jit(lambda: jm.initial_state(**vals))()


def close(ref, got, rtol):
    ref, got = np.asarray(ref), np.asarray(got)
    err, scale = np.abs(ref - got).max(), np.abs(ref).max()
    assert err <= rtol * scale, (err, scale)


def hold(ref, got, exact, rtol=ROUNDING):
    (same if exact else lambda r, g: close(r, g, rtol))(ref, got)


def zfaces(nz, depth=3000.0):
    k = np.arange(nz + 1)
    return -depth * (1.0 - k / nz) ** 1.8


def grids(latlon):
    if latlon:
        kw = dict(size=(12, 8, 6), longitude=(0, 360), latitude=(-75, 75), z=zfaces(6))
        return (J.LatitudeLongitudeGrid(dtype=jnp.float64, **kw),
                T.LatitudeLongitudeGrid(dtype=torch.float64, device=DEVICE, **kw))
    kw = dict(size=(8, 6, 5), x=(0.0, 64.0), y=(0.0, 48.0), z=zfaces(5, 100.0))
    return (J.RectilinearGrid(topology=("periodic", "periodic", "bounded"),
                              dtype=jnp.float64, **kw),
            T.RectilinearGrid(topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                              dtype=torch.float64, device=DEVICE, **kw))


def plane(grid, seed, scale):
    return scale * np.random.default_rng(seed).standard_normal(grid.total_shape[:2])


def closures(kind, tg=None):
    """(JAX closure, port closure, bit for bit?)."""
    if kind == "convective":
        kw = dict(convective_kappa_z=1.0, background_kappa_z=1e-5)
        return (jvm.ConvectiveAdjustmentVerticalDiffusivity(**kw),
                T.ConvectiveAdjustmentVerticalDiffusivity(**kw), True)
    if kind == "ri":
        return jvm.RiBasedVerticalDiffusivity(), T.RiBasedVerticalDiffusivity(), False
    if kind == "catke":
        return jvm.CATKEVerticalDiffusivity(), T.CATKEVerticalDiffusivity(), False
    if kind == "catke-convective":
        # the convective length (Cᴬ > 0) under a plane of buoyancy flux
        qb = np.abs(plane(tg, 5, 1e-7))[:, :, None]  # (x, y, 1), as JAX broadcasts it
        jml = jvm.MixingLength(Ca_c=2.0, Ca_e=1.5, Cas_c=0.3, Cas_e=0.2)
        tml = T.MixingLength(Ca_c=2.0, Ca_e=1.5, Cas_c=0.3, Cas_e=0.2)
        return (jvm.CATKEVerticalDiffusivity(mixing_length=jml,
                                             surface_buoyancy_flux=jnp.asarray(qb)),
                T.CATKEVerticalDiffusivity(mixing_length=tml,
                                           surface_buoyancy_flux=torch.as_tensor(qb)),
                False)
    if kind == "gm-redi":
        return (jiso.IsopycnalSkewSymmetricDiffusivity(),
                T.IsopycnalSkewSymmetricDiffusivity(), True)
    raise KeyError(kind)


def jstate(grid, seed=0):
    rng = np.random.default_rng(seed)
    sh = grid.total_shape
    z = np.broadcast_to(np.asarray(grid.nodes(J.CENTER, with_halo=True)[2]), sh)
    f = dict(u=0.1 * rng.standard_normal(sh), v=0.1 * rng.standard_normal(sh),
             w=1e-3 * rng.standard_normal(sh),
             b=1e-5 * z + 2e-5 * rng.standard_normal(sh),
             c=rng.standard_normal(sh), e=1e-4 * rng.uniform(0.0, 1.0, sh))
    return ({n: jnp.asarray(a) for n, a in f.items()},
            {n: torch.as_tensor(a) for n, a in f.items()})


def diffusivities(kind, latlon, seed=0):
    jg, tg = grids(latlon)
    jc, tc, exact = closures(kind, tg)
    jf, tf = jstate(jg, seed)
    jtr = {n: jf[n] for n in ("b", "c", "e")}
    ttr = {n: tf[n] for n in ("b", "c", "e")}
    jd = jc.compute_diffusivities(jg, jf, J.BuoyancyTracer(), jtr)
    td = tc.compute_diffusivities(tg, tf, T.BuoyancyTracer(), ttr)
    return jg, tg, jc, tc, jf, tf, jd, td, exact


@pytest.mark.parametrize("latlon", [False, True], ids=["rectilinear", "latlon"])
@pytest.mark.parametrize("kind", ["convective", "ri", "catke", "catke-convective",
                                  "gm-redi"])
def test_compute_diffusivities_match_jax(kind, latlon):
    jg, tg, jc, tc, jf, tf, jd, td, exact = diffusivities(kind, latlon)
    assert set(td) == set(jd)
    for key in jd:
        hold(jd[key], td[key], exact)
    names = ("b", "c", "e") if "catke" in kind else ("b", "c")
    r = float(jsd.cell_diffusion_timescale(jc, jg, jd, names))
    g = float(tsd.cell_diffusion_timescale(tc, tg, td, names))
    assert g == pytest.approx(r, rel=1e-12) or r == g == np.inf


@pytest.mark.parametrize("flux", ["none", "scalar", "plane", "buoyancy", "explicit"])
def test_catke_tke_tendency_matches_jax(flux):
    """Shear production, buoyancy flux and the surface TKE flux into the
    top cell; ``explicit`` also the dissipation e·Lᵉ."""
    jg, tg = grids(False)
    kw_j, kw_t = {}, {}
    if flux == "scalar":
        kw_j = kw_t = dict(surface_momentum_flux=(-1e-4, 2e-5))
    elif flux == "plane":
        tau = plane(tg, 6, 1e-4)
        kw_j = dict(surface_momentum_flux=(jnp.asarray(tau), 0.0))
        kw_t = dict(surface_momentum_flux=(torch.as_tensor(tau), 0.0))
    elif flux == "buoyancy":
        kw_j = kw_t = dict(surface_momentum_flux=(-1e-4, 0.0), surface_buoyancy_flux=3e-8)
    elif flux == "explicit":
        kw_j = kw_t = dict(time_discretization="explicit",
                           surface_momentum_flux=(-1e-4, 0.0))
    jc, tc = jvm.CATKEVerticalDiffusivity(**kw_j), T.CATKEVerticalDiffusivity(**kw_t)
    jf, tf = jstate(jg, 1)
    jtr, ttr = {n: jf[n] for n in ("b", "e")}, {n: tf[n] for n in ("b", "e")}
    jd = jc.compute_diffusivities(jg, jf, J.BuoyancyTracer(), jtr)
    td = tc.compute_diffusivities(tg, tf, T.BuoyancyTracer(), ttr)
    close(jc.tke_tendency(jg, jf, jd, jtr), tc.tke_tendency(tg, tf, td, ttr), ROUNDING)
    assert tc.implicit_linear_coefficient("e", td) is (
        td["Le"] if flux != "explicit" else None)
    assert tc.implicit_linear_coefficient("b", td) is None


@pytest.mark.parametrize("latlon", [False, True], ids=["rectilinear", "latlon"])
def test_gm_redi_tracer_tendency_is_bitwise_jax(latlon):
    jg, tg, jc, tc, jf, tf, jd, td, _ = diffusivities("gm-redi", latlon, seed=2)
    same(jc.tracer_tendency(jf["c"], jg, "c", jd), tc.tracer_tendency(tf["c"], tg, "c", td))
    # through the closures' dispatch, alone and in a tuple
    same(jsd.tracer_diffusion(jf["c"], jg, "c", jc, jd),
         tsd.tracer_diffusion(tf["c"], tg, "c", tc, td))
    hz = (J.HorizontalScalarDiffusivity(nu=1.0, kappa=2.0),
          T.HorizontalScalarDiffusivity(nu=1.0, kappa=2.0))
    same(jsd.tracer_diffusion(jf["c"], jg, "c", (hz[0], jc), (None, jd)),
         tsd.tracer_diffusion(tf["c"], tg, "c", (hz[1], tc), (None, td)))
    for name, jloc, tloc in (("u", J.U_LOC, T.U_LOC), ("v", J.V_LOC, T.V_LOC)):
        same(jsd.momentum_diffusion(jf[name], jg, jloc, jc, jd),
             tsd.momentum_diffusion(tf[name], tg, tloc, tc, td))


@pytest.mark.parametrize("kind", ["convective", "catke-explicit"])
def test_explicit_vertical_mixing_diffusion_matches_jax(kind):
    """An explicit vertical-mixing closure diffuses through its (C, C, F)
    κ in ``div_kappa_grad``."""
    jg, tg = grids(False)
    if kind == "convective":
        kw = dict(time_discretization="explicit")
        jc = jvm.ConvectiveAdjustmentVerticalDiffusivity(**kw)
        tc = T.ConvectiveAdjustmentVerticalDiffusivity(**kw)
    else:
        jc = jvm.CATKEVerticalDiffusivity(time_discretization="explicit")
        tc = T.CATKEVerticalDiffusivity(time_discretization="explicit")
    jf, tf = jstate(jg, 3)
    jtr, ttr = {n: jf[n] for n in ("b", "e")}, {n: tf[n] for n in ("b", "e")}
    jd = jc.compute_diffusivities(jg, jf, J.BuoyancyTracer(), jtr)
    td = tc.compute_diffusivities(tg, tf, T.BuoyancyTracer(), ttr)
    exact = kind == "convective"
    for name in ("b", "e"):
        hold(jsd.tracer_diffusion(jf[name], jg, name, jc, jd),
             tsd.tracer_diffusion(tf[name], tg, name, tc, td), exact)
    hold(jsd.momentum_diffusion(jf["u"], jg, J.U_LOC, jc, jd),
         tsd.momentum_diffusion(tf["u"], tg, T.U_LOC, tc, td), exact)
    r = float(jsd.cell_diffusion_timescale(jc, jg, jd, ("b", "e")))
    assert float(tsd.cell_diffusion_timescale(tc, tg, td, ("b", "e"))) == pytest.approx(
        r, rel=1e-12)


def test_implicit_step_with_le_and_3d_kappa_matches_jax():
    """CATKE's implicit step: Ku moved onto the u and v faces, Kc for b,
    Ke with Lᵉ on e's diagonal (a closure tuple applies in turn)."""
    jg, tg, jc, tc, jf, tf, jd, td, _ = diffusivities("catke", False, seed=4)
    hz = (J.HorizontalScalarDiffusivity(nu=1.0, kappa=2.0),
          T.HorizontalScalarDiffusivity(nu=1.0, kappa=2.0))
    names = ("u", "v", "b", "e")
    jlocs = dict(u=J.U_LOC, v=J.V_LOC, b=J.CENTER, e=J.CENTER)
    tlocs = dict(u=T.U_LOC, v=T.V_LOC, b=T.CENTER, e=T.CENTER)
    ref = jivd.implicit_step_fields({n: jf[n] for n in names}, jg, jlocs,
                                    (hz[0], jc), 600.0, (None, jd))
    got = tivd.implicit_step_fields({n: tf[n] for n in names}, tg, tlocs,
                                    (hz[1], tc), 600.0, (None, td))
    for n in names:
        close(jg.interior(ref[n]), tg.interior(got[n]).numpy(), 1e-12)


def column_models(closure_j, closure_t, nz=32, bcs=False):
    """The JAX suite's ``column_model``: (Flat, Flat, Bounded) 100 m, CG
    implicit free surface, no advection, BuoyancyTracer; with ``bcs`` the
    wind-mixing column's momentum and buoyancy fluxes."""
    kw = dict(size=(1, 1, nz), x=(0, 1), y=(0, 1), z=(-100.0, 0))
    jg = J.RectilinearGrid(topology=(J.FLAT, J.FLAT, J.BOUNDED), dtype=jnp.float64, **kw)
    tg = T.RectilinearGrid(topology=(T.FLAT, T.FLAT, T.BOUNDED), dtype=torch.float64,
                           device=DEVICE, **kw)
    extra_j, extra_t = {}, {}
    if bcs:
        extra_j = dict(boundary_conditions={"u": J.FieldBCs(top=J.FluxBC(-1e-4)),
                                            "b": J.FieldBCs(top=J.FluxBC(1e-8))})
        extra_t = dict(boundary_conditions={"u": T.FieldBCs(top=T.FluxBC(-1e-4)),
                                            "b": T.FieldBCs(top=T.FluxBC(1e-8))})
    jm = J.HydrostaticFreeSurfaceModel(
        grid=jg, free_surface=J.ImplicitFreeSurface(solver_method="pcg"),
        momentum_advection=None, tracer_advection=None, buoyancy=J.BuoyancyTracer(),
        closure=closure_j, fused_advection=False, **extra_j)
    tm = T.HydrostaticFreeSurfaceModel(
        grid=tg, free_surface=T.ImplicitFreeSurface(solver_method="pcg"),
        momentum_advection=None, tracer_advection=None, buoyancy=T.BuoyancyTracer(),
        closure=closure_t, **extra_t)
    return jm, tm


def compare(jm, js, tm, ts, rtol=RTOL, eta=True):
    for name in tm.prognostic_names():
        close(jm.grid.interior(js["solution"][name]),
              tm.grid.interior(ts["solution"][name]).numpy(), rtol)
    if eta:
        h = tm.grid.Hx, tm.grid.Hy
        r = np.asarray(js["eta"])[h[0]:js["eta"].shape[0] - h[0],
                                  h[1]:js["eta"].shape[1] - h[1]]
        g = ts["eta"].numpy()[h[0]:ts["eta"].shape[0] - h[0],
                              h[1]:ts["eta"].shape[1] - h[1]]
        assert np.abs(r - g).max() <= rtol * max(np.abs(r).max(), 1e-300)


def run(jm, tm, vals, steps, dt):
    js, ts = jinit(jm, vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(steps):
        js, ts = step(js, dt), tm.step(ts, dt)
    return js, ts


COLUMN = {
    "catke": lambda m: m.CATKEVerticalDiffusivity(surface_momentum_flux=(-1e-4, 0.0),
                                                 surface_buoyancy_flux=1e-8),
    "convective": lambda m: m.ConvectiveAdjustmentVerticalDiffusivity(
        convective_kappa_z=1.0, background_kappa_z=1e-5),
    "ri": lambda m: m.RiBasedVerticalDiffusivity(),
}


@pytest.mark.parametrize("kind", sorted(COLUMN))
def test_column_ten_steps_match_jax(kind):
    jm, tm = column_models(COLUMN[kind](jvm), COLUMN[kind](T), bcs=True)
    assert tm.tracer_names == jm.tracer_names
    vals = dict(b=lambda x, y, z: 1e-5 * (z + 100.0) / 100.0,
                u=lambda x, y, z: 0.2 * (z + 100.0) / 100.0)
    if kind == "catke":
        vals["e"] = 1e-7
    js, ts = run(jm, tm, vals, 10, 60.0)
    compare(jm, js, tm, ts, eta=False)
    for key in js["diffusivities"]:
        close(js["diffusivities"][key], ts["diffusivities"][key].numpy(), RTOL)


def test_gm_redi_section_ten_steps_match_jax():
    """The JAX suite's GM/Redi section: (Periodic, Flat, Bounded) 32×1×16,
    a lateral buoyancy gradient, a passive tracer."""
    kw = dict(size=(32, 1, 16), x=(0, 1e6), y=(0, 1), z=(-1000.0, 0))
    jg = J.RectilinearGrid(topology=(J.PERIODIC, J.FLAT, J.BOUNDED), dtype=jnp.float64, **kw)
    tg = T.RectilinearGrid(topology=(T.PERIODIC, T.FLAT, T.BOUNDED), dtype=torch.float64,
                           device=DEVICE, **kw)
    jm = J.HydrostaticFreeSurfaceModel(
        grid=jg, free_surface=J.ImplicitFreeSurface(solver_method="pcg", tolerance=1e-13),
        momentum_advection=None, tracer_advection=None, buoyancy=J.BuoyancyTracer(),
        closure=jiso.IsopycnalSkewSymmetricDiffusivity(), tracers=("c",),
        fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(
        grid=tg, free_surface=T.ImplicitFreeSurface(solver_method="pcg", tolerance=1e-13),
        momentum_advection=None, tracer_advection=None, buoyancy=T.BuoyancyTracer(),
        closure=T.IsopycnalSkewSymmetricDiffusivity(), tracers=("c",))
    rng = np.random.default_rng(7)
    vals = dict(b=1e-5 * np.linspace(-1, 0, 16)[None, None, :]
                + 1e-6 * rng.standard_normal((32, 1, 16)),
                c=rng.standard_normal((32, 1, 16)))
    js, ts = run(jm, tm, vals, 10, 3600.0)
    compare(jm, js, tm, ts, eta=False)


def continent(sigmoid, where):
    """benchmark/bench_near_global.py's bathymetry."""
    def bathymetry(lam, phi):
        land = (sigmoid((lam - 255.0) / 8.0) * sigmoid((300.0 - lam) / 8.0)
                * sigmoid((phi + 55.0) / 6.0) * sigmoid((70.0 - phi) / 6.0))
        return where(land > 0.5, 100.0, -3000.0)
    return bathymetry


def near_global_catke():
    """The near-global CATKE configuration at 12×8×6: the near-global
    run's grid, bottom, wind and default schemes, the closure
    (HorizontalScalarDiffusivity(1e4, 1e3), CATKE with the wind stress at
    the centres as an (x, y) with-halo plane), TEOS-10 with T, S and e."""
    jg, tg = grids(True)
    wind = lambda lib: (lambda lam, phi, t: -1e-4 * lib.cos(3.0 * np.pi * phi / 180.0))

    halo = T.HydrostaticFreeSurfaceModel(
        tg, free_surface=T.SplitExplicitFreeSurface(substeps=8)).grid.halo
    jg, tg = jg.with_halo(halo), tg.with_halo(halo)
    phi = tg.coord(1, T.C, with_halo=True).numpy()
    tau = np.broadcast_to(-1e-4 * np.cos(3.0 * np.pi * phi / 180.0)[None, :],
                          tg.total_shape[:2]).copy()
    jm = J.HydrostaticFreeSurfaceModel(
        jg, free_surface=J.SplitExplicitFreeSurface(substeps=8),
        coriolis=J.HydrostaticSphericalCoriolis(),
        buoyancy=J.SeawaterBuoyancy(equation_of_state=jn.TEOS10EquationOfState()),
        closure=(J.HorizontalScalarDiffusivity(nu=1e4, kappa=1e3),
                 jvm.CATKEVerticalDiffusivity(surface_momentum_flux=(jnp.asarray(tau), 0.0))),
        immersed_boundary=JGFB(continent(jax.nn.sigmoid, jnp.where)),
        boundary_conditions={"u": J.FieldBCs(top=J.FluxBC(wind(jnp)))},
        tracers=("T", "S"), fused_advection=False)
    full = lambda v: torch.tensor(v, dtype=torch.float64)
    tm = T.HydrostaticFreeSurfaceModel(
        tg, free_surface=T.SplitExplicitFreeSurface(substeps=8),
        coriolis=T.HydrostaticSphericalCoriolis(),
        buoyancy=T.SeawaterBuoyancy(equation_of_state=T.TEOS10EquationOfState()),
        closure=(T.HorizontalScalarDiffusivity(nu=1e4, kappa=1e3),
                 T.CATKEVerticalDiffusivity(surface_momentum_flux=(torch.as_tensor(tau), 0.0))),
        immersed_boundary=T.GridFittedBottom(
            continent(torch.sigmoid, lambda c, a, b: torch.where(c, full(a), full(b)))),
        boundary_conditions={"u": T.FieldBCs(top=T.FluxBC(wind(torch)))},
        tracers=("T", "S"))
    assert jm.grid.total_shape == tm.grid.total_shape
    return jm, tm


def near_global_values():
    return dict(T=lambda lam, phi, z: 2.0 + 18.0 * (1.0 + z / 3000.0) ** 4, S=35.0, e=1e-7)


@pytest.fixture(scope="module")
def near_global():
    """The near-global CATKE models and the JAX model's jitted step."""
    jm, tm = near_global_catke()
    return jm, tm, jax.jit(jm.step)


def test_near_global_catke_teos10_ten_steps_match_jax(near_global):
    jm, tm, step = near_global
    assert tm.tracer_names == jm.tracer_names == ("T", "S", "e")
    assert tfh.kernel_closure(tm) is None and not tm.fused_advance
    vals = near_global_values()
    js, ts = jinit(jm, vals), tm.initial_state(**vals)
    for _ in range(10):
        js, ts = step(js, 600.0), tm.step(ts, 600.0)
    compare(jm, js, tm, ts)
    e = tm.grid.interior(ts["solution"]["e"])
    assert float(e[:, :, -1].max()) > 1e-7  # the wind's TKE input
    r = float(jm.cell_diffusion_timescale(js))
    assert float(tm.cell_diffusion_timescale(ts)) == pytest.approx(r, rel=1e-12)


def test_catke_state_round_trips_through_interop(near_global):
    """A JAX CATKE state (its diffusivities a tuple (None, dict)) steps in
    the port, and the port's state steps in the JAX model."""
    jm, tm, step = near_global
    js = jinit(jm, near_global_values())
    for _ in range(3):
        js = step(js, 600.0)
    ts = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
    assert ts["diffusivities"][0] is None and set(ts["diffusivities"][1]) == {
        "Ku", "Kc", "Ke", "Le", "n2", "s2"}
    js2, ts2 = step(js, 600.0), tm.step(ts, 600.0)
    compare(jm, js2, tm, ts2)
    back = state_to_numpy(ts2)
    back["clock"] = JClock(jnp.asarray(back["clock"].time),
                           jnp.asarray(back["clock"].iteration))
    js3 = step(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, back), 600.0)
    compare(jm, js3, tm, tm.step(ts2, 600.0))


def test_nonhydrostatic_rk3_with_catke_matches_jax():
    """8³ (Periodic, Periodic, Bounded), a closure tuple (ScalarDiffusivity,
    CATKE with a surface momentum flux): K2's plain version, CATKE's TKE
    sources in G_e and the implicit step on every field."""
    kw = dict(size=(8, 8, 8), extent=(1, 1, 1))
    jg = J.RectilinearGrid(topology=("periodic", "periodic", "bounded"),
                           dtype=jnp.float64, **kw)
    tg = T.RectilinearGrid(topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                           dtype=torch.float64, device=DEVICE, **kw)
    cl = lambda m, v: (m.ScalarDiffusivity(nu=1e-5, kappa=1e-5),
                       v.CATKEVerticalDiffusivity(surface_momentum_flux=(-1e-5, 0.0)))
    jm = J.NonhydrostaticModel(jg, timestepper="RungeKutta3", buoyancy=J.BuoyancyTracer(),
                               closure=cl(J, jvm), fused_advection=False)
    tm = T.NonhydrostaticModel(tg, timestepper="RungeKutta3", buoyancy=T.BuoyancyTracer(),
                               closure=cl(T, T))
    assert tm.tracer_names == jm.tracer_names == ("b", "e")
    rng = np.random.default_rng(8)
    vals = dict(u=1e-2 * rng.standard_normal(tg.shape), b=lambda x, y, z: 1e-4 * z,
                e=1e-6 * rng.uniform(0.0, 1.0, tg.shape))
    js, ts = jinit(jm, vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(10):
        js, ts = step(js, 1e-2), tm.step(ts, 1e-2)
    for name in tm.prognostic_names():
        close(jg.interior(js["solution"][name]), tg.interior(ts["solution"][name]).numpy(),
              RTOL)


# -- the JAX suite's physics tests (tests/test_closures.py:86-213) in the port --

def column_model(closure, nz=32):
    g = T.RectilinearGrid(size=(1, 1, nz), x=(0, 1), y=(0, 1), z=(-100.0, 0),
                          topology=(T.FLAT, T.FLAT, T.BOUNDED), dtype=torch.float64,
                          device=DEVICE)
    return T.HydrostaticFreeSurfaceModel(
        grid=g, free_surface=T.ImplicitFreeSurface(solver_method="pcg"),
        momentum_advection=None, tracer_advection=None,
        buoyancy=T.BuoyancyTracer(), closure=closure)


def interior(model, state, name):
    return model.grid.interior(state["solution"][name])[0, 0].numpy()


def test_convective_adjustment_removes_instability():
    model = column_model(T.ConvectiveAdjustmentVerticalDiffusivity(
        convective_kappa_z=1.0, background_kappa_z=0.0))
    state = model.initial_state(b=lambda x, y, z: -1e-4 * (z + 100) / 100)
    for _ in range(50):
        state = model.step(state, 600.0)
    assert interior(model, state, "b").std() < 0.05 * 1e-4
    state2 = model.initial_state(b=lambda x, y, z: 1e-4 * (z + 100) / 100)
    b0 = interior(model, state2, "b")
    assert np.allclose(interior(model, model.step(state2, 600.0), "b"), b0, atol=1e-12)


def test_ri_based_mixes_low_richardson():
    closure = T.RiBasedVerticalDiffusivity()
    g = T.RectilinearGrid(size=(1, 1, 16), x=(0, 1), y=(0, 1), z=(-100.0, 0),
                          topology=(T.FLAT, T.FLAT, T.BOUNDED), dtype=torch.float64,
                          device=DEVICE)
    zc = g.coord(2, T.C, with_halo=True).reshape(1, 1, -1)
    b = torch.broadcast_to(1e-6 * zc, g.total_shape)
    shear = torch.broadcast_to(0.5 * zc, g.total_shape)
    zero = torch.zeros_like(shear)
    d_shear = closure.compute_diffusivities(g, dict(u=shear, v=zero), T.BuoyancyTracer(),
                                            {"b": b})
    d_calm = closure.compute_diffusivities(g, dict(u=zero, v=zero), T.BuoyancyTracer(),
                                           {"b": b})
    assert float(d_shear["kappa_z"].max()) > 10 * float(d_calm["kappa_z"].min())


def test_catke_adds_tke_tracer_and_grows_under_shear():
    model = column_model(T.CATKEVerticalDiffusivity())
    assert "e" in model.tracer_names
    state = model.initial_state(b=lambda x, y, z: 1e-6 * (z + 100) / 100,
                                u=lambda x, y, z: 0.2 * (z + 100) / 100, e=1e-7)
    e0 = interior(model, state, "e").sum()
    for _ in range(20):
        state = model.step(state, 60.0)
    e = interior(model, state, "e")
    assert np.all(np.isfinite(e)) and e.sum() > e0


def test_gm_redi_flattens_isopycnals():
    g = T.RectilinearGrid(size=(32, 1, 16), x=(0, 1e6), y=(0, 1), z=(-1000.0, 0),
                          topology=(T.PERIODIC, T.FLAT, T.BOUNDED), dtype=torch.float64,
                          device=DEVICE)
    model = T.HydrostaticFreeSurfaceModel(
        grid=g, free_surface=T.ImplicitFreeSurface(solver_method="pcg"),
        momentum_advection=None, tracer_advection=None, buoyancy=T.BuoyancyTracer(),
        closure=T.IsopycnalSkewSymmetricDiffusivity(
            kappa_skew=1000.0, kappa_symmetric=1000.0,
            slope_limiter=T.FluxTapering(1e-2)), tracers=("c",))
    state = model.initial_state(
        b=lambda x, y, z: 1e-5 * z / 1000 + 1e-6 * torch.sin(2 * np.pi * x / 1e6),
        c=lambda x, y, z: torch.sin(2 * np.pi * x / 1e6) + 0.0 * z)
    for _ in range(10):
        state = model.step(state, 3600.0)
    c = model.grid.interior(state["solution"]["c"]).numpy()
    assert np.all(np.isfinite(c))
    assert c.std(axis=2).mean() > 0
    assert np.abs(c).max() < 2.0


def test_catke_stability_scale_matches_reference_formula():
    cl = T.CATKEVerticalDiffusivity()
    ml = cl.mixing_length
    for ri in (-1.0, 0.0, 1.1, 5.0, 100.0):
        got = float(cl._stability_scale(torch.tensor(ri, dtype=torch.float64),
                                        ml.Ck_c_lo, ml.Ck_c_r))
        assert abs(got - (0.35 + 0.05 * (1 + np.tanh((ri - 1.1) / 30.0)))) < 1e-12
    assert (ml.Cb_u, ml.Cs_u, ml.Ck_e_r) == (1.55, 5.1, 17.0)
    assert cl.C_diss == 0.81


def test_catke_surface_tke_flux_injects_tke():
    model = column_model(T.CATKEVerticalDiffusivity(surface_momentum_flux=(-1e-4, 0.0)))
    state = model.initial_state(b=lambda x, y, z: 1e-5 * (z + 100) / 100, e=0.0)
    for _ in range(5):
        state = model.step(state, 60.0)
    e = interior(model, state, "e")
    assert np.all(np.isfinite(e))
    assert e[-1] > 1e-9 and e[-1] > 10 * abs(e[0])


def test_catke_implicit_dissipation_decays_tke():
    model = column_model(T.CATKEVerticalDiffusivity())
    state = model.initial_state(b=0.0, e=1e-4)
    e0 = interior(model, state, "e").max()
    for _ in range(10):
        state = model.step(state, 600.0)
    e = interior(model, state, "e")
    assert np.all(np.isfinite(e))
    assert e.max() < e0 and e.min() >= -1e-12
