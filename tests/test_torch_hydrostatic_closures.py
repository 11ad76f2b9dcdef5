"""Port parity: closures and immersed bottoms in the hydrostatic model, end
to end.

Each configuration is built in both packages in f64 and stepped on the
JAX plain path (``fused_advection=False``) and on the port's CPU path (the
kernels' plain versions): u, v, the tracers and η agree to ≤ 1e-9 of
max|field| after 10 steps, the tolerance of ``tests/test_torch_hydrostatic.py``
for the same reassociated sums (w and pHY′ in cumulative order, the
depth integrals, the column depths over the bottom, the order in which K4b
adds the diffusion). The configurations:

- ``benchmark/bench_near_global.py`` at 16×8×6 and 24×12×8 (8
  substeps): its grid and z faces, split-explicit free surface, spherical
  Coriolis, BuoyancyTracer, the default schemes (VectorInvariant and
  centred tracers), ``ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3,
  kappa_z=1e-4, time_discretization="vertically_implicit")``, the
  ``GridFittedBottom`` of its sigmoid continent, the wind ``FluxBC``;
- the same run with the ¼° flagship's schemes and tracers
  (``VectorInvariant(scheme="weno_velocity")``, ``WENO5()`` T and S):
  the conditional fluxes next to the bottom;
- the ¼° flagship with that closure on a flat bottom, under the
  split-explicit, explicit and implicit (CG to 1e-13) free surfaces, and
  the implicit one over the bottom (its "auto" solve is CG there);
- ``validation/near_global_lat_lon.py`` at its own 3° (120×50×24, 50
  substeps): its continents and ridge, the quadratic bottom drag through
  the bottom (a discrete immersed flux), Δt = 1200 s, 3 steps, and its own
  check that the velocities are exactly zero at solid faces;
- ``examples/baroclinic_adjustment.py``'s configuration at 32×32×8: a
  β-plane channel, flux-form WENO5, an explicit anisotropic
  ScalarDiffusivity (K4b's in-kernel closure with its z part) and the FFT
  implicit free surface;
- closures K4b does not take, as torch ops beside it (AMD with its
  diffusivities, a scalar and horizontal biharmonic tuple), 5 steps and a
  restart from the JAX state with its diffusivities;
- the JAX gates ``kernel_closure`` and ``_mask_locs`` and the diffusion
  timescale on a matrix of configurations.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh

try:  # this file needs JAX; the guard keeps collection quiet without it
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection.vector_invariant import (
        VectorInvariant as JVI)
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JB
    from clima_oceananigans_jl_tpu.coriolis.coriolis import (
        BetaPlane as JBeta, HydrostaticSphericalCoriolis as JSph)
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from clima_oceananigans_jl_tpu.immersed.immersed import GridFittedBottom as JGFB
    from clima_oceananigans_jl_tpu.models.free_surface import (
        ExplicitFreeSurface as JExplicit, ImplicitFreeSurface as JImplicit,
        SplitExplicitFreeSurface as JSplit)
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    from clima_oceananigans_jl_tpu.ops import fused_hydrostatic as jfh
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
NEAR_GLOBAL = dict(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
                   time_discretization="vertically_implicit")


def zfaces(nz):
    k = np.arange(nz + 1)
    return -3000.0 * (1.0 - k / nz) ** 1.8


def grids(size):
    jg = JLL(size=size, longitude=(0, 360), latitude=(-75, 75), z=zfaces(size[2]),
             dtype=jnp.float64)
    tg = T.LatitudeLongitudeGrid(size=size, longitude=(0, 360), latitude=(-75, 75),
                                 z=zfaces(size[2]), dtype=torch.float64, device=DEVICE)
    return jg, tg


def continent(lib, sigmoid, where):
    """benchmark/bench_near_global.py's bathymetry."""
    def bathymetry(lam, phi):
        land = (sigmoid((lam - 255.0) / 8.0) * sigmoid((300.0 - lam) / 8.0)
                * sigmoid((phi + 55.0) / 6.0) * sigmoid((70.0 - phi) / 6.0))
        return where(land > 0.5, 100.0, -3000.0)
    return bathymetry


J_CONTINENT = lambda: continent(jnp, jax.nn.sigmoid, jnp.where)
T_CONTINENT = continent(torch, torch.sigmoid,
                        lambda c, a, b: torch.where(c, torch.tensor(a, dtype=torch.float64),
                                                    torch.tensor(b, dtype=torch.float64)))


def wind(lib):
    return lambda lam, phi, t: -1e-4 * lib.cos(3.0 * np.pi * phi / 180.0)


def free_surfaces(kind, substeps=8):
    return {"split": (JSplit(substeps=substeps), T.SplitExplicitFreeSurface(substeps=substeps)),
            "explicit": (JExplicit(), T.ExplicitFreeSurface()),
            "implicit": (JImplicit(solver_method="pcg", tolerance=1e-13, maxiter=1000),
                         T.ImplicitFreeSurface(solver_method="pcg", tolerance=1e-13,
                                               maxiter=1000)),
            "implicit-auto": (JImplicit(tolerance=1e-13, maxiter=1000),
                              T.ImplicitFreeSurface(tolerance=1e-13, maxiter=1000))}[kind]


def near_global(size, weno=False, bottom=True, wind_stress=True, fs="split",
                closure=NEAR_GLOBAL):
    """(JAX model, port model) of the near-global run; ``weno``: with the
    flagship's schemes and tracers."""
    jg, tg = grids(size)
    jfs, tfs = free_surfaces(fs)
    jkw = dict(free_surface=jfs, coriolis=JSph(), buoyancy=JB(),
               closure=J.ScalarDiffusivity(**closure), fused_advection=False)
    tkw = dict(free_surface=tfs, coriolis=T.HydrostaticSphericalCoriolis(),
               buoyancy=T.BuoyancyTracer(), closure=T.ScalarDiffusivity(**closure))
    if bottom:
        jkw["immersed_boundary"] = JGFB(J_CONTINENT())
        tkw["immersed_boundary"] = T.GridFittedBottom(T_CONTINENT)
    if wind_stress:
        jkw["boundary_conditions"] = {"u": J.FieldBCs(top=J.FluxBC(wind(jnp)))}
        tkw["boundary_conditions"] = {"u": T.FieldBCs(top=T.FluxBC(wind(torch)))}
    if weno:
        jkw.update(momentum_advection=JVI(scheme="weno_velocity"),
                   tracer_advection=J.WENO5(), tracers=("T", "S"))
        tkw.update(momentum_advection=T.VectorInvariant(scheme="weno_velocity"),
                   tracer_advection=T.WENO5(), tracers=("T", "S"))
    return JH(jg, **jkw), T.HydrostaticFreeSurfaceModel(tg, **tkw)


def initial_values(shape, seed=0, tracers=()):
    rng = np.random.default_rng(seed)
    vals = dict(u=0.1 * rng.standard_normal(shape),
                b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    for n in tracers:
        vals[n] = rng.standard_normal(shape)
    return vals


def compare(jm, js, tm, ts, rtol=RTOL):
    for name in tm.prognostic_names():
        r = np.asarray(jm.grid.interior(js["solution"][name]))
        g = tm.grid.interior(ts["solution"][name]).numpy()
        assert np.abs(r - g).max() <= rtol * np.abs(r).max(), name
    h = tm.grid.Hx, tm.grid.Hy
    r = np.asarray(js["eta"])[h[0]:-h[0], h[1]:-h[1]]
    g = ts["eta"].numpy()[h[0]:-h[0], h[1]:-h[1]]
    assert np.abs(r - g).max() <= rtol * np.abs(r).max(), "eta"


def run(jm, tm, vals, steps=10, dt=600.0):
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(steps):
        js, ts = step(js, dt), tm.step(ts, dt)
    return js, ts


def zero_at_solid_faces(tm, ts):
    imm = tm.grid.immersed
    sol = ts["solution"]
    return (float((sol["u"] * imm.mask_for(T.U_LOC)).abs().max()) == 0.0
            and float((sol["v"] * imm.mask_for(T.V_LOC)).abs().max()) == 0.0)


@pytest.mark.parametrize("size", [(16, 8, 6), (24, 12, 8)], ids=["16x8x6", "24x12x8"])
def test_near_global_ten_steps_match_jax(size):
    jm, tm = near_global(size)
    assert not tm.fused_advance and tfh.kernel_closure(tm) is None
    assert tfh._mask_locs(tm) == ()
    js, ts = run(jm, tm, initial_values(size))
    compare(jm, js, tm, ts)
    assert zero_at_solid_faces(tm, ts)
    assert set(tm.fields(ts)) == {"u", "v", "b", "w", "eta"}
    r = float(jm.cell_diffusion_timescale(js))
    assert float(tm.cell_diffusion_timescale(ts)) == pytest.approx(r, rel=1e-12)


def test_near_global_weno_ten_steps_match_jax():
    size = (16, 8, 6)
    jm, tm = near_global(size, weno=True)
    assert tfh._mask_locs(tm) == (T.CENTER,)
    js, ts = run(jm, tm, initial_values(size, 1, ("T", "S")))
    compare(jm, js, tm, ts)
    assert zero_at_solid_faces(tm, ts)


@pytest.mark.parametrize("fs", ["split", "explicit", "implicit"])
def test_quarter_degree_diffusive_ten_steps_match_jax(fs):
    """The flagship with the near-global closure on a flat bottom: K4b's
    in-kernel closure (its horizontal part; the z part through T1)."""
    size = (16, 8, 6)
    jm, tm = near_global(size, weno=True, bottom=False, wind_stress=False, fs=fs)
    assert tfh.kernel_closure(tm) is tm.closure
    assert tm.fused_advance == (fs != "explicit")
    dt = 600.0 if fs == "split" else 60.0
    js, ts = run(jm, tm, initial_values(size, 2, ("T", "S")), dt=dt)
    compare(jm, js, tm, ts)


def test_implicit_free_surface_over_the_bottom_matches_jax():
    """"auto" resolves to CG over an immersed bottom, with the fluid
    column depths."""
    size = (16, 8, 6)
    jm, tm = near_global(size, fs="implicit-auto")
    assert tm.free_surface.resolve_method(tm.grid) == "pcg"
    js, ts = run(jm, tm, initial_values(size, 3), steps=5, dt=60.0)
    compare(jm, js, tm, ts)


def _validation_models():
    """validation/near_global_lat_lon.py at 3°: continents, a ridge, the
    quadratic bottom drag, 50 substeps."""
    size = (120, 50, 24)
    jg, tg = grids(size)

    def bathymetry(lib, sigmoid, clip, where):
        def f(lam, phi):
            block = lambda lo, hi, s=8.0: sigmoid((lam - lo) / s) * sigmoid((hi - lam) / s)
            band = lambda lo, hi, s=6.0: sigmoid((phi - lo) / s) * sigmoid((hi - phi) / s)
            americas = block(255.0, 300.0) * band(-55.0, 70.0)
            afr_eurasia = (block(0.0, 50.0) * band(-35.0, 70.0)
                           + block(25.0, 120.0) * band(10.0, 70.0))
            australia = block(112.0, 154.0) * band(-40.0, -11.0)
            land = clip(americas + afr_eurasia + australia, 0.0, 1.0)
            ridge = 1200.0 * lib.exp(-((lam - 330.0) / 12.0) ** 2) * band(-60.0, 60.0)
            return where(land > 0.5, 100.0, -3000.0 + ridge)
        return f

    def drag(lib, name):
        def d(grid, t, fields):
            sp = lib.sqrt(fields["u"] ** 2 + fields["v"] ** 2)
            return -2.5e-3 * sp * fields[name]
        return d

    tb = bathymetry(torch, torch.sigmoid, torch.clamp,
                    lambda c, a, b: torch.where(c, torch.tensor(a, dtype=torch.float64), b))
    jb = bathymetry(jnp, jax.nn.sigmoid, jnp.clip, jnp.where)
    jm = JH(jg, free_surface=JSplit(substeps=50), coriolis=JSph(), buoyancy=JB(),
            closure=J.ScalarDiffusivity(**NEAR_GLOBAL), immersed_boundary=JGFB(jb),
            boundary_conditions={
                "u": J.FieldBCs(top=J.FluxBC(wind(jnp)),
                                immersed=J.FluxBC(drag(jnp, "u"), discrete=True)),
                "v": J.FieldBCs(immersed=J.FluxBC(drag(jnp, "v"), discrete=True))},
            fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(
        tg, free_surface=T.SplitExplicitFreeSurface(substeps=50),
        coriolis=T.HydrostaticSphericalCoriolis(), buoyancy=T.BuoyancyTracer(),
        closure=T.ScalarDiffusivity(**NEAR_GLOBAL), immersed_boundary=T.GridFittedBottom(tb),
        boundary_conditions={
            "u": T.FieldBCs(top=T.FluxBC(wind(torch)),
                            immersed=T.FluxBC(drag(torch, "u"), discrete=True)),
            "v": T.FieldBCs(immersed=T.FluxBC(drag(torch, "v"), discrete=True))})
    return jm, tm


def test_near_global_validation_at_three_degrees_matches_jax():
    jm, tm = _validation_models()
    cos = lambda a: torch.cos(a) if isinstance(a, torch.Tensor) else jnp.cos(a)
    vals = dict(b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0
                + 1e-6 * cos(np.pi * phi / 180.0),
                u=0.05 * np.random.default_rng(4).standard_normal(tm.grid.shape))
    js, ts = run(jm, tm, vals, steps=3, dt=1200.0)
    compare(jm, js, tm, ts)
    assert zero_at_solid_faces(tm, ts)
    for name in ("u", "v", "b"):
        assert bool(torch.isfinite(ts["solution"][name]).all()), name


def test_baroclinic_adjustment_ten_steps_match_jax():
    """examples/baroclinic_adjustment.py at 32×32×8: K4b's in-kernel
    closure with its explicit z part, on flux-form WENO5 momentum."""
    km = 1e3
    kw = dict(size=(32, 32, 8), x=(0, 1000 * km), y=(-500 * km, 500 * km),
              z=(-1 * km, 0), topology=("periodic", "bounded", "bounded"))
    Omega, R = 7.292115e-5, 6.371e6
    f0, beta = 2 * Omega * np.sin(np.radians(-45.0)), 2 * Omega * np.cos(np.radians(-45.0)) / R
    aspect = (1 * km / 8) / (1000 * km / 32)
    cl = dict(nu=0.1, kappa=0.1, nu_z=aspect * 0.1, kappa_z=aspect * 0.1)
    jm = JH(J.RectilinearGrid(dtype=jnp.float64, **kw), coriolis=JBeta(f0=f0, beta=beta),
            buoyancy=JB(), closure=J.ScalarDiffusivity(**cl), momentum_advection=J.WENO5(),
            tracer_advection=J.WENO5(), free_surface=JImplicit(), fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(
        T.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw),
        coriolis=T.BetaPlane(f0=f0, beta=beta), buoyancy=T.BuoyancyTracer(),
        closure=T.ScalarDiffusivity(**cl), momentum_advection=T.WENO5(),
        tracer_advection=T.WENO5(), free_surface=T.ImplicitFreeSurface())
    assert tm.free_surface.resolve_method(tm.grid) == "fft"
    assert tfh.kernel_closure(tm) is tm.closure and tm.fused_advance
    rng = np.random.default_rng(5)
    _, yc, zc = (np.asarray(a) for a in tm.grid.nodes(T.CENTER))
    Db = 50 * km * 8e-8
    b0 = (4e-6 * zc + Db * np.clip(yc / (50 * km) + 0.5, 0.0, 1.0)
          + 1e-2 * Db * rng.standard_normal(tm.grid.shape))
    js, ts = run(jm, tm, dict(b=b0), dt=1200.0)
    compare(jm, js, tm, ts)


def _config(closure, bottom, momentum, tracers):
    """A (JAX, port) model pair on a small lat-lon grid for the gates."""
    jg, tg = grids((8, 8, 4))
    jcl, tcl = closure
    jkw = dict(closure=jcl, momentum_advection=momentum[0], tracer_advection=tracers[0],
               tracers=("T",), free_surface=JSplit(substeps=4), fused_advection=False)
    tkw = dict(closure=tcl, momentum_advection=momentum[1], tracer_advection=tracers[1],
               tracers=("T",), free_surface=T.SplitExplicitFreeSurface(substeps=4))
    if bottom:
        jkw["immersed_boundary"] = JGFB(-1500.0)
        tkw["immersed_boundary"] = T.GridFittedBottom(-1500.0)
    return JH(jg, **jkw), T.HydrostaticFreeSurfaceModel(tg, **tkw)


CLOSURES = {
    "none": lambda: (None, None),
    "explicit": lambda: (J.ScalarDiffusivity(nu=1e3, kappa=1e2),
                         T.ScalarDiffusivity(nu=1e3, kappa=1e2)),
    "implicit": lambda: (J.ScalarDiffusivity(**NEAR_GLOBAL), T.ScalarDiffusivity(**NEAR_GLOBAL)),
    "per-tracer": lambda: (J.ScalarDiffusivity(nu=1.0, kappa={"T": 2.0}, kappa_z={"T": 1e-3}),
                           T.ScalarDiffusivity(nu=1.0, kappa={"T": 2.0}, kappa_z={"T": 1e-3})),
    "callable": lambda: (J.ScalarDiffusivity(nu=1.0, kappa=1.0, kappa_z=lambda z: 1e-4,
                                             time_discretization="vertically_implicit"),
                         T.ScalarDiffusivity(nu=1.0, kappa=1.0, kappa_z=lambda z: 1e-4,
                                             time_discretization="vertically_implicit")),
    "biharmonic": lambda: (J.ScalarBiharmonicDiffusivity(nu=1e9),
                           T.ScalarBiharmonicDiffusivity(nu=1e9)),
}
SCHEMES = {"vi": lambda: (JVI(), T.VectorInvariant()),
           "weno5": lambda: (J.WENO5(), T.WENO5()),
           "centered": lambda: (J.CenteredSecondOrder(), T.CenteredSecondOrder())}


@pytest.mark.parametrize("closure", sorted(CLOSURES))
@pytest.mark.parametrize("bottom", [False, True], ids=["flat", "immersed"])
@pytest.mark.parametrize("momentum,tracers", [("vi", "centered"), ("vi", "weno5"),
                                              ("weno5", "centered"), ("weno5", "weno5")])
def test_kernel_closure_and_mask_locs_are_the_jax_gates(closure, bottom, momentum, tracers):
    jm, tm = _config(CLOSURES[closure](), bottom, SCHEMES[momentum](), SCHEMES[tracers]())
    jk, tk = jfh.kernel_closure(jm), tfh.kernel_closure(tm)
    assert (jk is None) == (tk is None)
    assert tk is None or tk is tm.closure
    assert [tuple(l) for l in jfh._mask_locs(jm)] == [tuple(l) for l in tfh._mask_locs(tm)]
    # the advance where every term lives in K4b
    assert tm.fused_advance == (not bottom and (closure == "none" or tk is not None))
    assert float(tm.cell_diffusion_timescale(tm.initial_state())) == pytest.approx(
        float(jm.cell_diffusion_timescale(jm.initial_state())), rel=1e-12)


@pytest.mark.parametrize("closure", ["amd", "tuple"])
def test_other_closures_and_their_diffusivities_match_jax(closure):
    """A closure K4b does not take, as torch ops beside it: AMD (its
    diffusivities computed in ``update_state``) and a tuple of a scalar
    and a biharmonic diffusivity, 5 steps; then a JAX state with its
    diffusivities restarts the port."""
    from clima_oceananigans_jl_torch.interop import state_from_numpy
    from clima_oceananigans_jl_tpu.closures.eddy_viscosity import (
        AnisotropicMinimumDissipation as JAMD)
    jcl, tcl = {"amd": (JAMD(), T.AnisotropicMinimumDissipation()),
                "tuple": ((J.ScalarDiffusivity(nu=1e3, kappa=1e2, nu_z=1e-3, kappa_z=1e-4),
                           J.ScalarBiharmonicDiffusivity(nu=1e9, formulation="horizontal")),
                          (T.ScalarDiffusivity(nu=1e3, kappa=1e2, nu_z=1e-3, kappa_z=1e-4),
                           T.ScalarBiharmonicDiffusivity(nu=1e9,
                                                         formulation="horizontal")))}[closure]
    size = (16, 8, 6)
    jg, tg = grids(size)
    kw = dict(free_surface=(JSplit(substeps=8), T.SplitExplicitFreeSurface(substeps=8)),
              coriolis=(JSph(), T.HydrostaticSphericalCoriolis()),
              buoyancy=(JB(), T.BuoyancyTracer()),
              momentum_advection=(JVI(scheme="weno_velocity"),
                                  T.VectorInvariant(scheme="weno_velocity")),
              tracer_advection=(J.WENO5(), T.WENO5()), closure=(jcl, tcl))
    jm = JH(jg, fused_advection=False, **{k: v[0] for k, v in kw.items()})
    tm = T.HydrostaticFreeSurfaceModel(tg, **{k: v[1] for k, v in kw.items()})
    assert tfh.kernel_closure(tm) is None and not tm.fused_advance
    js, ts = run(jm, tm, initial_values(size, 6), steps=5)
    compare(jm, js, tm, ts)
    assert max(float(ts["solution"][n].abs().max()) for n in ("u", "v")) < 10.0
    restarted = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
    jd = jax.tree_util.tree_leaves(js["diffusivities"])
    td = jax.tree_util.tree_leaves(restarted["diffusivities"])
    assert len(jd) == len(td) and bool(td) == (closure == "amd")
    for r, g in zip(jd, td):
        assert np.array_equal(np.asarray(jm.grid.interior(r)), tm.grid.interior(g).numpy())
    js, ts = jax.jit(jm.step)(js, 600.0), tm.step(restarted, 600.0)
    compare(jm, js, tm, ts)
