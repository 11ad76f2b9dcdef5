"""Port parity: the surface-forced ocean configurations end to end.

Three configurations that the port runs on the card at full width
(``chip_smoke.py``), here at 12×10×8 (lat-lon 8×8×4) in f64, built in both
packages from the same numpy-seeded state and stepped on the JAX plain
path (``fused_advection=False``) and on the port's CPU path:

- ``langmuir``: ``examples/langmuir_turbulence.py`` (Wagner et al. 2021
  §4) on its 64 m × 64 m × 32 m box: WENO5, ``BuoyancyTracer``,
  ``FPlane(1e-4)``, u top ``FluxBC(-3.72e-5)``, b top
  ``FluxBC(2.307e-8)``, b bottom ``GradientBC(1.936e-5)``, the
  ``UniformStokesDrift`` of a 0.8 m, 60 m wave; AMD replaced by
  ``ScalarDiffusivity(nu=1e-5, kappa=1e-5)`` (AMD is not ported);
- ``wind mixing``: ``examples/ocean_wind_mixing_and_convection.py``:
  ``SeawaterBuoyancy(LinearEquationOfState(2e-4, 8e-4))`` with T and S,
  ``FPlane(1e-4)``, u top ``FluxBC(Qu)``, T top ``FluxBC(QT)``, T bottom
  ``GradientBC(0.01)``, S top the discrete-form evaporation flux ``QS``;
  regular z (the stretched-z pressure solve is not ported), WENO5 (the
  upwind-biased scheme is not ported), the same scalar diffusivity;
- ``forced`` and ``background``: a sponge ``Relaxation`` on b with a
  ``GaussianMask`` and ``LinearTarget``, a ``Forcing`` with a field
  dependency, tilted gravity; and background fields of u and b;
- ``hydrostatic wind``: the ¼° flagship configuration at lat-lon (8, 8, 4)
  with the near-global run's wind stress, u top
  ``FluxBC((λ, φ, t) ↦ −1e-4 cos(3πφ/180))``, under the split-explicit,
  explicit and implicit (``pcg``) free surfaces.

The nonhydrostatic configurations take 10 RK3 steps and 10 quasi-AB2
steps (the general branch: the flux values and the Stokes drift keep the
fused advance out, as the JAX gate says); u, v, w, the tracers, pHY′ and
pNHS agree to ``RTOL = 1e-9`` of max|field|, as in ``test_torch_rk3.py``
(cumulative sums and FFTs sum in different orders, and the Stokes
profile's exp rounds differently in the two libraries); pNHS to 1e-9 of
max(|pNHS|, |pHY′|), since the rounding of the cumulative sum of pHY′
reaches it through −∂x pHY′. The hydrostatic
ones take 10 steps within 1e-9 too. The user callables (the Stokes
profile, the wind stress, the evaporation flux and discrete BCs) are
written twice, once with ``jnp`` and once with ``torch``.

The ``cuda`` cases run the configurations on the card with the kernels
and with their plain versions and hold them bitwise
(``python -m pytest --noconftest -m cuda tests/test_torch_surface_forced.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.interop import state_from_numpy, state_to_numpy
from clima_oceananigans_jl_torch.models import hydrostatic as thm
from clima_oceananigans_jl_torch.models import nonhydrostatic as tnm
from clima_oceananigans_jl_torch.ops import fused_fill as tff
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection.vector_invariant import VectorInvariant as JVI
    from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs
    from clima_oceananigans_jl_tpu.buoyancy import buoyancy as jbuoy
    from clima_oceananigans_jl_tpu.closures import scalar_diffusivity as jsd
    from clima_oceananigans_jl_tpu.coriolis import coriolis as jcor
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from clima_oceananigans_jl_tpu.models import free_surface as jfs
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel as JN
    from clima_oceananigans_jl_tpu.stokes_drift import UniformStokesDrift as JStokes
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
SIZE = (12, 10, 8)

# examples/langmuir_turbulence.py
G_EARTH = 9.80665
AMPLITUDE, WAVELENGTH = 0.8, 60.0
WAVENUMBER = 2 * np.pi / WAVELENGTH
FREQUENCY = np.sqrt(G_EARTH * WAVENUMBER)
VERTICAL_SCALE = WAVELENGTH / (4 * np.pi)
US0 = AMPLITUDE ** 2 * WAVENUMBER * FREQUENCY
QU_LANGMUIR, QB, N2 = -3.72e-5, 2.307e-8, 1.936e-5
# examples/ocean_wind_mixing_and_convection.py
QT = 200.0 / (1026.0 * 3991.0)
DTDZ = 0.01
QU_WIND = -1.225 / 1026.0 * 2.5e-3 * 10.0 * abs(10.0)
EVAPORATION = 1e-3 / 3600.0
DT = {"langmuir": 1.0, "wind mixing": 0.5, "forced": 1.0, "background": 1.0}


class Lib:
    """The names one configuration needs from a package (JAX or port), and
    the port's device."""

    def __init__(self, jax_side, device=DEVICE):
        self.jax, self.device = jax_side, device
        if jax_side:
            self.np, self.bcs, self.FPlane = jnp, jbcs, jcor.FPlane
            self.Model, self.Stokes = JN, JStokes
            self.BuoyancyTracer = jbuoy.BuoyancyTracer
            self.Seawater, self.EOS = jbuoy.SeawaterBuoyancy, jbuoy.LinearEquationOfState
            self.Diffusivity, self.WENO5 = jsd.ScalarDiffusivity, J.WENO5
            from clima_oceananigans_jl_tpu.fields.background import BackgroundField
            from clima_oceananigans_jl_tpu.forcings import forcing as jf
            self.forcing, self.BackgroundField = jf, BackgroundField
        else:
            self.np, self.bcs, self.FPlane = torch, T, T.FPlane
            self.Model, self.Stokes = T.NonhydrostaticModel, T.UniformStokesDrift
            self.BuoyancyTracer = T.BuoyancyTracer
            self.Seawater, self.EOS = T.SeawaterBuoyancy, T.LinearEquationOfState
            self.Diffusivity, self.WENO5 = T.ScalarDiffusivity, T.WENO5
            self.forcing, self.BackgroundField = T, T.BackgroundField

    def grid(self, size):
        kw = dict(size=size, x=(0, 64), y=(0, 64), z=(-32, 0))
        if self.jax:
            return J.RectilinearGrid(topology=("periodic", "periodic", "bounded"),
                                     dtype=jnp.float64, **kw)
        return T.RectilinearGrid(topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                                 dtype=torch.float64, device=self.device, **kw)


def langmuir(lib, size, timestepper):
    xp = lib.np
    stokes = lib.Stokes(
        dz_us=lambda z, t: US0 / VERTICAL_SCALE * xp.exp(z / VERTICAL_SCALE))
    return lib.Model(
        lib.grid(size), advection=lib.WENO5(), timestepper=timestepper,
        tracers=("b",), buoyancy=lib.BuoyancyTracer(), coriolis=lib.FPlane(f=1e-4),
        closure=lib.Diffusivity(nu=1e-5, kappa=1e-5), stokes_drift=stokes,
        boundary_conditions={
            "u": lib.bcs.FieldBCs(top=lib.bcs.FluxBC(QU_LANGMUIR)),
            "b": lib.bcs.FieldBCs(top=lib.bcs.FluxBC(QB),
                                  bottom=lib.bcs.GradientBC(N2))},
        **({"fused_advection": False} if lib.jax else {}))


def wind_mixing(lib, size, timestepper):
    def QS(grid, t, fields):
        return -EVAPORATION * fields["S"]
    return lib.Model(
        lib.grid(size), advection=lib.WENO5(), timestepper=timestepper,
        tracers=("T", "S"), coriolis=lib.FPlane(f=1e-4),
        buoyancy=lib.Seawater(equation_of_state=lib.EOS(
            thermal_expansion=2e-4, haline_contraction=8e-4)),
        closure=lib.Diffusivity(nu=1e-5, kappa=1e-5),
        boundary_conditions={
            "u": lib.bcs.FieldBCs(top=lib.bcs.FluxBC(QU_WIND)),
            "T": lib.bcs.FieldBCs(top=lib.bcs.FluxBC(QT),
                                  bottom=lib.bcs.GradientBC(DTDZ)),
            "S": lib.bcs.FieldBCs(top=lib.bcs.FluxBC(QS, discrete=True))},
        **({"fused_advection": False} if lib.jax else {}))


#: the tilt of the forced configuration's gravity (as in
#: examples/tilted_bottom_boundary_layer.py, on a (P, P, B) grid)
THETA = np.radians(3.0)


def forced(lib, size, timestepper):
    """The chip's ``forced`` hold: a sponge ``Relaxation(rate,
    GaussianMask(z), LinearTarget(N²z))`` on b, a ``Forcing`` with a field
    dependency on u (a linear drag), tilted gravity."""
    f = lib.forcing
    return lib.Model(
        lib.grid(size), advection=lib.WENO5(), timestepper=timestepper,
        buoyancy=lib.BuoyancyTracer(gravity_unit_vector=(np.sin(THETA), 0.0,
                                                         -np.cos(THETA))),
        coriolis=lib.FPlane(f=1e-4), closure=lib.Diffusivity(nu=1e-5, kappa=1e-5),
        forcing={"b": f.Relaxation(rate=1 / 60, mask=f.GaussianMask(center=-28.0, width=3.0),
                                   target=f.LinearTarget(gradient=N2)),
                 "u": f.Forcing(lambda x, y, z, t, u, r: -r * u, parameters=1e-3,
                                field_dependencies="u")},
        **({"fused_advection": False} if lib.jax else {}))


def background(lib, size, timestepper):
    """Background shear in u and stratification in b (their cross terms
    run outside the kernels in both packages)."""
    return lib.Model(
        lib.grid(size), advection=lib.WENO5(), timestepper=timestepper,
        buoyancy=lib.BuoyancyTracer(), coriolis=lib.FPlane(f=1e-4),
        background_fields={
            "u": lib.BackgroundField(lambda x, y, z, t, s: s * (z + 16.0), parameters=1e-3),
            "b": lambda x, y, z, t: N2 * z + 0.0 * x * y},
        **({"fused_advection": False} if lib.jax else {}))


BUILD = {"langmuir": langmuir, "wind mixing": wind_mixing, "forced": forced,
         "background": background}


def initial_values(config, grid, seed=0):
    """The example's initial state (numpy), its noise from a seeded
    generator: langmuir l.63-76, wind mixing l.77-86."""
    rng = np.random.default_rng(seed)
    zc = grid.nodes(T.CENTER, with_halo=False)[2].cpu().numpy().reshape(1, 1, -1)
    shape = grid.shape
    if config == "langmuir":
        decay = np.exp(zc / 4.0)
        ustar = np.sqrt(abs(QU_LANGMUIR))
        strat = np.where(zc < -8.0, N2 * zc, -N2 * 8.0)
        return dict(b=strat + 1e-1 * N2 * 32 * decay * rng.standard_normal(shape),
                    u=ustar * 1e-1 * decay * rng.standard_normal(shape),
                    w=ustar * 1e-1 * decay * rng.standard_normal(shape))
    if config in ("forced", "background"):
        return dict(b=N2 * zc + 1e-6 * rng.standard_normal(shape),
                    u=1e-2 * rng.standard_normal(shape),
                    w=1e-3 * rng.standard_normal(shape))
    noise = zc / 32.0 * (1 + zc / 32.0)
    ustar = np.sqrt(abs(QU_WIND))
    return dict(T=20.0 + DTDZ * zc + DTDZ * 32.0 * 1e-6 * noise * rng.standard_normal(shape),
                u=ustar * 1e-3 * noise * rng.standard_normal(shape),
                w=ustar * 1e-3 * noise * rng.standard_normal(shape), S=35.0)


def compare(jm, js, tm, ts, names, rtol=RTOL):
    for name in names:
        ref = np.asarray(jm.grid.interior(js["solution"][name]))
        got = tm.grid.interior(ts["solution"][name]).numpy()
        err, scale = np.abs(ref - got).max(), np.abs(ref).max()
        assert err <= rtol * scale, (name, err, scale)
    pHY = np.abs(np.asarray(jm.grid.interior(js["pHY"]))).max()
    for key in ("pHY", "pNHS"):
        ref = np.asarray(jm.grid.interior(js[key]))
        got = tm.grid.interior(ts[key]).numpy()
        # pNHS takes up the rounding of −∂x pHY′ (the cumulative sums'),
        # which scales with pHY′: under seawater buoyancy |pHY′| ~ 8 while
        # the nearly quiescent start gives |pNHS| ~ 1e-6
        err, scale = np.abs(ref - got).max(), max(np.abs(ref).max(), pHY)
        assert err <= rtol * scale, (key, err, scale)


@pytest.mark.parametrize("timestepper", ["RungeKutta3", "QuasiAdamsBashforth2"])
@pytest.mark.parametrize("config", ["langmuir", "wind mixing"])
def test_surface_forced_ten_steps_match_jax(config, timestepper):
    jm = BUILD[config](Lib(True), SIZE, timestepper)
    tm = BUILD[config](Lib(False), SIZE, timestepper)
    # the flux values (and the Stokes drift) keep the fused AB2 advance out
    assert not tm.fused_step and not jm.fused_step and not tm.g_interior
    vals = initial_values(config, tm.grid)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    compare(jm, js, tm, ts, tm.prognostic_names())
    step = jax.jit(jm.step)
    for _ in range(10):
        js = step(js, DT[config])
        ts = tm.step(ts, DT[config])
    assert ts["clock"].iteration == 10
    compare(jm, js, tm, ts, tm.prognostic_names())
    # the forcing moved the fields: the surface flux cooled/salted/stirred
    assert not np.allclose(tm.grid.interior(ts["solution"]["u"]).numpy(),
                           vals["u"])


@pytest.mark.parametrize("config", ["forced", "background"])
def test_forcing_tilted_gravity_and_background_ten_rk3_steps_match_jax(config):
    """The ``forced`` configuration (sponge, drag with a field dependency,
    tilted gravity) and background fields, 10 RK3 steps, at ``RTOL``
    (the sponge's mask goes through exp). Background fields take the
    plain versions (``fused_advection`` false), as in the JAX package."""
    jm = BUILD[config](Lib(True), SIZE, "RungeKutta3")
    tm = BUILD[config](Lib(False), SIZE, "RungeKutta3")
    assert tm.fused_advection == (config != "background")
    vals = initial_values(config, tm.grid, seed=3)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(10):
        js = step(js, DT[config])
        ts = tm.step(ts, DT[config])
    compare(jm, js, tm, ts, tm.prognostic_names())


def test_wind_mixing_state_passes_through_interop():
    """A state with T and S goes to numpy and back, and a step from it is
    the step from the original (``state_from_numpy`` needs nothing new:
    these modules hold no learned state)."""
    tm = wind_mixing(Lib(False), (8, 8, 6), "RungeKutta3")
    ts = tm.initial_state(**initial_values("wind mixing", tm.grid, seed=2))
    ts = tm.step(ts, 0.5)
    back = state_from_numpy(tm, state_to_numpy(ts))
    assert set(back["solution"]) == {"u", "v", "w", "T", "S"}
    a, b = tm.step(ts, 0.5), tm.step(back, 0.5)
    for n in tm.prognostic_names():
        assert torch.equal(a["solution"][n], b["solution"][n]), n


# -- the ¼° wind-stress configuration ---------------------------------------------

HSIZE = (8, 8, 4)


def zfaces(nz):
    k = np.arange(nz + 1)
    return -3000.0 * (1.0 - k / nz) ** 1.8


def hydro_models(free_surface, size=HSIZE, bcs=None):
    """The ¼° flagship with the near-global wind stress in both packages;
    the wind stress written with jnp and with torch."""
    jg = JLL(size=size, longitude=(0, 360), latitude=(-75, 75), z=zfaces(size[2]),
             dtype=jnp.float64)
    tg = T.LatitudeLongitudeGrid(size=size, longitude=(0, 360), latitude=(-75, 75),
                                 z=zfaces(size[2]), dtype=torch.float64, device=DEVICE)
    jwind = lambda lam, phi, t: -1e-4 * jnp.cos(3.0 * jnp.pi * phi / 180.0)
    twind = lambda lam, phi, t: -1e-4 * torch.cos(3.0 * torch.pi * phi / 180.0)
    fs = {"split": (jfs.SplitExplicitFreeSurface(substeps=30),
                    T.SplitExplicitFreeSurface(substeps=30)),
          "explicit": (jfs.ExplicitFreeSurface(), T.ExplicitFreeSurface()),
          "pcg": (jfs.ImplicitFreeSurface(solver_method="pcg"),
                  T.ImplicitFreeSurface(solver_method="pcg"))}[free_surface]
    jb = {"u": jbcs.FieldBCs(top=jbcs.FluxBC(jwind))}
    tb = {"u": T.FieldBCs(top=T.FluxBC(twind))}
    if bcs is not None:
        jb, tb = bcs
    jm = JH(jg, momentum_advection=JVI(scheme="weno_velocity"),
            tracer_advection=J.WENO5(), tracers=("T", "S"), free_surface=fs[0],
            coriolis=jcor.HydrostaticSphericalCoriolis(),
            buoyancy=jbuoy.BuoyancyTracer(), boundary_conditions=jb,
            fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(
        tg, momentum_advection=T.VectorInvariant(scheme="weno_velocity"),
        tracer_advection=T.WENO5(), tracers=("T", "S"), free_surface=fs[1],
        coriolis=T.HydrostaticSphericalCoriolis(), buoyancy=T.BuoyancyTracer(),
        boundary_conditions=tb)
    return jm, tm


def hydro_values(shape, seed=0):
    rng = np.random.default_rng(seed)
    return dict(u=0.1 * rng.standard_normal(shape),
                T=rng.standard_normal(shape), S=0.5 * rng.standard_normal(shape),
                b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)


def hydro_compare(jm, js, tm, ts, rtol=RTOL):
    for name in ("u", "v", "T", "S", "b"):
        r = np.asarray(jm.grid.interior(js["solution"][name]))
        g = tm.grid.interior(ts["solution"][name]).numpy()
        assert np.abs(r - g).max() <= rtol * np.abs(r).max(), name
    h = tm.grid.Hx, tm.grid.Hy
    r = np.asarray(js["eta"])[h[0]:-h[0], h[1]:-h[1]]
    g = ts["eta"].numpy()[h[0]:-h[0], h[1]:-h[1]]
    assert np.abs(r - g).max() <= rtol * np.abs(r).max(), "eta"


@pytest.mark.parametrize("free_surface,dt", [("split", 600.0), ("explicit", 60.0),
                                             ("pcg", 600.0)])
def test_quarter_degree_wind_stress_ten_steps_match_jax(free_surface, dt):
    jm, tm = hydro_models(free_surface)
    # the flux value puts the step on the two-stage route, as in JAX
    assert not tm.fused_advance and not jm.fused_advance
    vals = hydro_values(HSIZE)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    for _ in range(10):
        js = jm.step(js, dt)
        ts = tm.step(ts, dt)
    hydro_compare(jm, js, tm, ts)


def test_hydrostatic_discrete_flux_bc_reading_w_matches_jax():
    """A discrete-form bottom drag on u that reads ``fields["w"]`` (the
    counterpart of the JAX package's
    ``test_wphy_in_kernel_with_discrete_flux_bc_rebuilds_w``): the BC
    reads the w that ``update_state`` rebuilt with K4a's plain version, or,
    from a state without w, the one ``tendencies`` rebuilds."""
    jdrag = lambda grid, t, f: -1e-3 * f["u"] * jnp.abs(f["w"])
    tdrag = lambda grid, t, f: -1e-3 * f["u"] * torch.abs(f["w"])
    bcs = ({"u": jbcs.FieldBCs(bottom=jbcs.FluxBC(jdrag, discrete=True))},
           {"u": T.FieldBCs(bottom=T.FluxBC(tdrag, discrete=True))})
    jm, tm = hydro_models("split", bcs=bcs)
    seen = []
    orig = tm.bcs["u"].bottom.value
    tm.bcs["u"].bottom.value = lambda grid, t, f: seen.append(f["w"]) or orig(grid, t, f)
    vals = hydro_values(HSIZE, seed=4)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    for _ in range(5):
        js = jm.step(js, 600.0)
        ts = tm.step(ts, 600.0)
    hydro_compare(jm, js, tm, ts)
    assert len(seen) == 5 and float(seen[-1].abs().max()) > 0
    # a state without w (the JAX layout when its kernel rebuilds w and
    # pHY′): the step rebuilds it for K4b and the BC, and agrees exactly
    ref = tm.step(ts, 600.0)
    got = tm.step({k: v for k, v in ts.items() if k != "w"}, 600.0)
    assert torch.equal(got["w"], ref["w"]) and len(seen) == 7
    for n in ref["solution"]:
        assert torch.equal(got["solution"][n], ref["solution"][n]), n


def test_hydrostatic_forcing_matches_jax():
    """A ``Forcing`` on u and a ``Relaxation`` on T in the hydrostatic
    model (the two-stage route), 5 split-explicit steps."""
    from clima_oceananigans_jl_tpu.forcings import forcing as jf
    jg = JLL(size=HSIZE, longitude=(0, 360), latitude=(-75, 75), z=zfaces(4),
             dtype=jnp.float64)
    tg = T.LatitudeLongitudeGrid(size=HSIZE, longitude=(0, 360), latitude=(-75, 75),
                                 z=zfaces(4), dtype=torch.float64, device=DEVICE)
    common = dict(tracers=("T",), buoyancy=None)
    jm = JH(jg, free_surface=jfs.SplitExplicitFreeSurface(substeps=8),
            forcing={"u": jf.Forcing(lambda x, y, z, t, u: -1e-5 * u,
                                     field_dependencies="u"),
                     "T": jf.Relaxation(rate=1e-4, target=1.0)},
            fused_advection=False, **common)
    tm = T.HydrostaticFreeSurfaceModel(
        tg, free_surface=T.SplitExplicitFreeSurface(substeps=8),
        forcing={"u": T.Forcing(lambda x, y, z, t, u: -1e-5 * u,
                                field_dependencies="u"),
                 "T": T.Relaxation(rate=1e-4, target=1.0)}, **common)
    assert tm.forcing["T"].field_name == "T" and not tm.fused_advance
    rng = np.random.default_rng(5)
    vals = dict(u=0.1 * rng.standard_normal(HSIZE), T=rng.standard_normal(HSIZE))
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    for _ in range(5):
        js = jm.step(js, 600.0)
        ts = tm.step(ts, 600.0)
    for name in ("u", "v", "T"):
        r = np.asarray(jm.grid.interior(js["solution"][name]))
        g = tm.grid.interior(ts["solution"][name]).numpy()
        assert np.abs(r - g).max() <= RTOL * np.abs(r).max(), name


# -- on the card --------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("config", ["langmuir", "wind mixing", "forced"])
def test_cuda_surface_forced_steps_match_plain_versions(config):
    """Three RK3 steps of each nonhydrostatic configuration at 24×20×16
    f64 on the card with K2 and K6 and with their plain versions: bitwise,
    with 3 K2 and 6 K6 launches a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def run(kernels):
        tm = BUILD[config](Lib(False, "cuda"), (24, 20, 16), "RungeKutta3")
        ts = tm.initial_state(**initial_values(config, tm.grid, seed=6))
        n2, n6 = tft.fused_advective_tendencies.launches, tff.fused_fill_halos.launches
        for _ in range(3):
            ts = tm.step(ts, DT[config], kernels)
        torch.cuda.synchronize()
        return ts, (tft.fused_advective_tendencies.launches - n2,
                    tff.fused_fill_halos.launches - n6)

    got, launches = run(None)
    assert launches == (9, 18)
    ref, none = run(tnm.PLAIN)
    assert none == (0, 0)
    for n in got["solution"]:
        assert torch.equal(got["solution"][n], ref["solution"][n]), n
    for key in ("pHY", "pNHS"):
        assert torch.equal(got[key], ref[key]), key


@pytest.mark.cuda
def test_cuda_quarter_degree_wind_steps_match_plain_versions():
    """The ¼° wind-stress configuration at lat-lon (48, 24, 6) f64 on the
    card: three split-explicit steps of the two-stage route with K4a, K4b
    (tendency form), K5 and K6 and with their plain versions, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    size = (48, 24, 6)

    def run(kernels):
        tg = T.LatitudeLongitudeGrid(size=size, longitude=(0, 360), latitude=(-75, 75),
                                     z=zfaces(size[2]), dtype=torch.float64,
                                     device="cuda")
        tm = T.HydrostaticFreeSurfaceModel(
            tg, momentum_advection=T.VectorInvariant(scheme="weno_velocity"),
            tracer_advection=T.WENO5(), tracers=("T", "S"),
            free_surface=T.SplitExplicitFreeSurface(substeps=30),
            coriolis=T.HydrostaticSphericalCoriolis(), buoyancy=T.BuoyancyTracer(),
            boundary_conditions={"u": T.FieldBCs(top=T.FluxBC(
                lambda lam, phi, t: -1e-4 * torch.cos(3.0 * torch.pi * phi / 180.0)))})
        assert not tm.fused_advance
        vals = hydro_values(size, seed=7)
        ts = tm.initial_state(**vals)
        for _ in range(3):
            ts = tm.step(ts, 600.0, kernels)
        torch.cuda.synchronize()
        return ts

    got, ref = run(None), run(thm.PLAIN)
    for n in got["solution"]:
        assert torch.equal(got["solution"][n], ref["solution"][n]), n
    assert torch.equal(got["eta"], ref["eta"])
