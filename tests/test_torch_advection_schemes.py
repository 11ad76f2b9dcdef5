"""Port parity: the four advection schemes that came last, in the
nonhydrostatic and shallow-water models and in K1, K2 and K3a:
``CenteredFourthOrder`` (C4), ``UpwindBiasedFirstOrder`` (UB1),
``UpwindBiasedThirdOrder`` (UB3) and ``BoundsPreservingWENO5`` (BP).

Held against the JAX package in float64 on grids of 32 points or fewer an
axis, the JAX side on its plain path (``fused_advection=False``):

- each scheme's reconstructions and ``transport``, to faces and to
  centres, on every axis, periodic, bounded (C4's and UB3's near-wall
  reduction within 2 cells, BP's within 3), with a Flat y, on a stretched
  z (BP's table route, clipped before the selects) and next to an
  immersed bottom, bit for bit on every with-halo point;
- K2's plain version against the JAX ``div_*`` fluxes with each scheme
  and with mixed buffers on bounded axes (a WENO5 momentum with UB3
  tracers needs two sets of near-wall bounds), on the interior and the
  velocities' wall faces, bit for bit, also over an immersed bottom;
- K3a's plain version against the JAX ``_core_tendencies`` with each
  scheme and UB5, bit for bit;
- 10 RK3 steps and 10 quasi-AB2 steps of the nonhydrostatic model (the
  AB2 steps on its fused branch: K1's plain version) and 10 shallow-water
  steps, within 1e-9 of max|field|;
- the port's ``examples/internal_wave.py`` at 32×1×32 and
  ``validation/periodic_advection.py`` at N = 32 against the JAX scripts'
  models stepped as the scripts step them, within 1e-9;
- the kernels' scheme codes and per-scheme near-wall bounds, the z rows'
  tables for BP, and the hydrostatic model's refusals by name.

The ``cuda`` cases hold K1, K2 and K3a with each new scheme against their
plain versions on the card bit for bit over NaN-filled outputs
(``python -m pytest --noconftest -m cuda tests/test_torch_advection_schemes.py``).
"""
import math

import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.advection import schemes as tsch
from clima_oceananigans_jl_torch.examples import internal_wave as tiw
from clima_oceananigans_jl_torch.immersed.immersed import ImmersedGrid
from clima_oceananigans_jl_torch.ops import fused_step as tfs
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft
from clima_oceananigans_jl_torch.validation import periodic_advection as tpa
from test_torch_flat_bounded import (card_fields, grid_pair, hold_k2, needs_card,
                                     poison_cache, wall_mask)

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection import fluxes as jfl
    from clima_oceananigans_jl_tpu.advection import schemes as jsch
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JBuoyancy
    from clima_oceananigans_jl_tpu.immersed.immersed import GridFittedBottom as JGFB
    from clima_oceananigans_jl_tpu.immersed.immersed import ImmersedGrid as JIG
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel as JN
    from clima_oceananigans_jl_tpu.models.shallow_water import (
        ShallowWaterModel as JShallowWaterModel, _core_tendencies as j_core)
    from clima_oceananigans_jl_tpu.simulation.simulation import Simulation as JSimulation
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
NEW = ("CenteredFourthOrder", "UpwindBiasedFirstOrder", "UpwindBiasedThirdOrder",
       "BoundsPreservingWENO5")
SHORT = {"C4": "CenteredFourthOrder", "UB1": "UpwindBiasedFirstOrder",
         "UB3": "UpwindBiasedThirdOrder", "BP": "BoundsPreservingWENO5",
         "UB5": "UpwindBiasedFifthOrder", "WENO5": "WENO5", "C2": "CenteredSecondOrder"}
#: (momentum, tracers): each new scheme alone, then mixed buffers
PAIRS = {**{s: (s, s) for s in ("C4", "UB1", "UB3", "BP")},
         "WENO5/UB3": ("WENO5", "UB3"), "C4/WENO5": ("C4", "WENO5"),
         "UB3/C4": ("UB3", "C4"), "BP/UB1": ("BP", "UB1")}
SIZES = {"PPP": (11, 10, 9), "BBB": (9, 8, 7), "PFB": (13, 1, 11), "PPB": (11, 10, 9),
         "PFF": (14, 1, 1)}


def schemes(short):
    """The same scheme in both packages."""
    return getattr(J, SHORT[short])(), getattr(T, SHORT[short])()


def same(ref, got):
    ref, got = np.asarray(ref), got.numpy()
    assert ref.shape == got.shape
    assert np.array_equal(ref, got), np.abs(ref - got).max()


def stretched_pair(size):
    """A (P, P, B) grid with a stretched z in both packages."""
    z = np.cumsum(np.r_[-0.9, np.linspace(0.05, 0.15, size[2])])
    kw = dict(size=size, x=(0.0, 1.3), y=(0.0, 0.7), z=z,
              topology=("periodic", "periodic", "bounded"), halo=(3, 3, 3))
    return (J.RectilinearGrid(dtype=jnp.float64, **kw),
            T.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw))


def bottom(xp):
    return lambda x, y: -0.9 + 0.5 * xp.exp(-((x - 0.65) ** 2 + (y - 0.35) ** 2) / 0.08)


def immersed_pair(code):
    jg, tg = grid_pair(code, SIZES[code])
    return (JIG.wrap(jg, JGFB(bottom(jnp)).build(jg)),
            ImmersedGrid(tg, T.GridFittedBottom(bottom(torch)).build(tg)))


# -- the schemes -------------------------------------------------------------------

METHODS = {"CenteredFourthOrder": ("sym_to_f", "sym_to_c"),
           "UpwindBiasedFirstOrder": ("left_to_f", "right_to_f", "left_to_c", "right_to_c"),
           "UpwindBiasedThirdOrder": ("left_to_f", "right_to_f", "left_to_c", "right_to_c"),
           "BoundsPreservingWENO5": ("left_right_to_f", "left_right_to_c")}


@pytest.mark.parametrize("name", NEW)
def test_reconstructions_match_jax_bitwise(name):
    """Each scheme's reconstructions alone on every axis (BP's clipped
    pair, and its clip)."""
    c = np.random.default_rng(7).standard_normal((12, 11, 10))
    js, ts = getattr(J, name)(), getattr(T, name)()
    for axis in range(3):
        for method in METHODS[name]:
            ref = getattr(js, method)(jnp.asarray(c), axis)
            got = getattr(ts, method)(torch.as_tensor(c), axis)
            for r, g in zip(*((ref, got) if isinstance(ref, tuple) else ((ref,), (got,)))):
                same(r, g)
        if name == "BoundsPreservingWENO5":
            rec = 1.5 * np.random.default_rng(axis).standard_normal(c.shape)
            for to_f in (True, False):
                same(js._clip(jnp.asarray(rec), jnp.asarray(c), axis, to_f),
                     ts._clip(torch.as_tensor(rec), torch.as_tensor(c), axis, to_f))


@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("code", ["PPP", "BBB", "PFB"])
@pytest.mark.parametrize("name", NEW)
def test_transport_matches_jax_bitwise(name, code, axis, to_f):
    """Periodic axes, bounded walls (each scheme's own near-wall bounds)
    and a Flat y (every stencil reads the cell itself)."""
    jg, tg = grid_pair(code, SIZES[code])
    vel, c = np.random.default_rng(axis).standard_normal((2,) + tg.total_shape)
    ref = jsch.transport(getattr(J, name)(), jnp.asarray(vel), jnp.asarray(c),
                         axis, to_f, jg)
    got = tsch.transport(getattr(T, name)(), torch.as_tensor(vel), torch.as_tensor(c),
                         axis, to_f, tg)
    same(ref, got)


@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
@pytest.mark.parametrize("name", NEW)
def test_transport_on_a_stretched_z_matches_jax_bitwise(name, to_f):
    """BP takes WENO5's tables on the stretched z (JAX tests
    ``isinstance(scheme, WENO5)``) and clips L and R before the selects;
    the fixed-stencil schemes keep their uniform forms."""
    jg, tg = stretched_pair((10, 9, 12))
    for axis in range(3):
        vel, c = np.random.default_rng(3 + axis).standard_normal((2,) + tg.total_shape)
        ref = jsch.transport(getattr(J, name)(), jnp.asarray(vel), jnp.asarray(c),
                             axis, to_f, jg)
        got = tsch.transport(getattr(T, name)(), torch.as_tensor(vel),
                             torch.as_tensor(c), axis, to_f, tg)
        same(ref, got)


@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
@pytest.mark.parametrize("name", NEW)
def test_transport_next_to_an_immersed_bottom_matches_jax_bitwise(name, to_f):
    """C4 drops to the centred mean where its stencil reaches the solid,
    UB3 and BP to first-order upwind; UB1 reads no cell beyond its two."""
    jg, tg = immersed_pair("PPB")
    for axis in range(3):
        vel, c = np.random.default_rng(11 + axis).standard_normal((2,) + tg.total_shape)
        ref = jsch.transport(getattr(J, name)(), jnp.asarray(vel), jnp.asarray(c),
                             axis, to_f, jg, J.CENTER)
        got = tsch.transport(getattr(T, name)(), torch.as_tensor(vel),
                             torch.as_tensor(c), axis, to_f, tg, T.CENTER)
        same(ref, got)


# -- the kernels' plain versions ---------------------------------------------------

def k2_pair(jg, tg, momentum, tracer, seed=1):
    """(JAX −div_* fluxes, K2's plain version) of random fields."""
    rng = np.random.default_rng(seed)
    u, v, w, c = (rng.standard_normal(tg.total_shape) for _ in range(4))
    (jm, tm), (jt, tt) = schemes(momentum), schemes(tracer)
    ju = tuple(map(jnp.asarray, (u, v, w)))
    ref = dict(u=-jfl.div_vu(jg, jm, *ju), v=-jfl.div_vv(jg, jm, *ju),
               w=-jfl.div_vw(jg, jm, *ju), c=-jfl.div_Uc(jg, jt, *ju, jnp.asarray(c)))
    got = tft.fused_advective_tendencies_reference(
        tg, tm, tt, *map(torch.as_tensor, (u, v, w)), {"c": torch.as_tensor(c)})
    return ref, got


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("code", ["PPB", "BBB", "PFB", "PFF"])
def test_k2_plain_version_matches_jax(code, pair):
    """On the interior and the velocities' wall faces, bit for bit."""
    jg, tg = grid_pair(code, SIZES[code])
    ref, got = k2_pair(jg, tg, *PAIRS[pair])
    for name, r in ref.items():
        mask = wall_mask(tg, name).numpy()
        assert np.array_equal(np.asarray(r)[mask], got[name].numpy()[mask]), name


@pytest.mark.parametrize("pair", ["C4/UB3", "UB3/C4", "BP/UB1", "WENO5/BP"])
@pytest.mark.parametrize("code", ["PPB", "PFB"])
def test_k2_plain_version_over_an_immersed_bottom_matches_jax(code, pair):
    jg, tg = immersed_pair(code)
    ref, got = k2_pair(jg, tg, *pair.split("/"), seed=5)
    for name, r in ref.items():
        same(tg.interior(r), tg.interior(got[name]))


@pytest.mark.parametrize("pair", ["C4", "UB1", "UB3", "BP", "UB5", "WENO5/UB3", "UB3/C4"])
@pytest.mark.parametrize("topo", ["pp", "bb"])
def test_k3a_plain_version_matches_jax_bitwise(topo, pair):
    """K3a's plain version (two tracers, bathymetry) against the JAX
    ``_core_tendencies`` on a 24×16 grid, bounded x and y included."""
    momentum, tracer = (pair.split("/") * 2)[:2]
    pick = lambda mod: {"p": mod.PERIODIC, "b": mod.BOUNDED}
    kw = dict(size=(24, 16, 1), x=(0, 2 * np.pi), y=(0, 1.5))
    jg = J.RectilinearGrid(topology=tuple(pick(J)[t] for t in topo) + (J.FLAT,),
                           dtype=jnp.float64, **kw)
    tg = T.RectilinearGrid(topology=tuple(pick(T)[t] for t in topo) + (T.FLAT,),
                           dtype=torch.float64, device=DEVICE, **kw)
    (jm_s, tm_s), (jt_s, tt_s) = schemes(momentum), schemes(tracer)
    jm = JShallowWaterModel(jg, advection=jm_s, tracer_advection=jt_s)
    tm = T.ShallowWaterModel(tg, advection=tm_s, tracer_advection=tt_s)
    assert tm.grid.total_shape == jm.grid.total_shape
    rng = np.random.default_rng(2)
    shape = tm.grid.total_shape
    uh, vh = (0.1 * rng.standard_normal(shape) for _ in range(2))
    h = 1.0 + 0.1 * rng.standard_normal(shape)
    trs = [rng.standard_normal(shape) for _ in range(2)]
    hB = 0.1 * rng.standard_normal(shape)
    ja, ta = jnp.asarray, torch.as_tensor
    ref = j_core(jm.grid, jm_s, jt_s, 9.5, ja(uh), ja(vh), ja(h), [ja(c) for c in trs],
                 ja(hB))
    got = tft.fused_shallow_water_tendencies_reference(
        tm.grid, tm_s, tt_s, 9.5, ta(uh), ta(vh), ta(h), [ta(c) for c in trs], ta(hB))
    for r, g in zip(ref, got):
        same(jm.grid.interior(r), tm.grid.interior(g))


# -- whole models ------------------------------------------------------------------

def compare(jm, js, tm, ts, what):
    for name in tm.prognostic_names():
        ref = np.asarray(jm.grid.interior(js["solution"][name]))
        got = tm.grid.interior(ts["solution"][name]).numpy()
        scale = max(np.abs(ref).max(), 1e-300)
        assert np.abs(ref - got).max() <= RTOL * scale, (what, name, np.abs(ref - got).max())


#: each branch's grid: RK3 on (B, F, B), so both walls reduce; AB2 on
#: (P, P, B), the JAX gate's fused branch (K1's plain version on the CPU)
BRANCHES = {"RK3": ("RungeKutta3", "BFB", (12, 1, 10)),
            "AB2": ("QuasiAdamsBashforth2", "PPB", (8, 8, 6))}


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("pair", ["C4", "UB1", "UB3", "BP", "WENO5/UB3"])
def test_nonhydrostatic_ten_steps_match_jax(pair, branch):
    momentum, tracer = (pair.split("/") * 2)[:2]
    stepper, code, size = BRANCHES[branch]
    jg, tg = grid_pair(code, size)
    models = []
    for P, g, buoy, extra in ((J, jg, JBuoyancy, dict(fused_advection=False)),
                              (T, tg, T.BuoyancyTracer, {})):
        Model = JN if P is J else T.NonhydrostaticModel
        models.append(Model(g, advection=getattr(P, SHORT[momentum])(),
                            tracer_advection=getattr(P, SHORT[tracer])(),
                            timestepper=stepper, buoyancy=buoy(), tracers=("b", "c"),
                            coriolis=P.FPlane(f=0.5),
                            closure=P.ScalarDiffusivity(nu=1e-3, kappa=1e-3), **extra))
    jm, tm = models
    if branch == "AB2":
        assert tm.fused_step
    rng = np.random.default_rng(4)
    vals = {n: 1e-2 * rng.standard_normal(tm.grid.shape) for n in ("u", "v", "w", "b", "c")}
    js = jm.initial_state(**{k: jnp.asarray(v) for k, v in vals.items()})
    ts = tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(10):
        js, ts = step(js, 0.05), tm.step(ts, 0.05)
    compare(jm, js, tm, ts, (pair, branch))


@pytest.mark.parametrize("pair", ["C4", "UB1", "UB3", "BP", "UB5", "UB3/BP"])
def test_shallow_water_ten_steps_match_jax(pair):
    """The conservative form on a bounded-y grid with a tracer."""
    momentum, tracer = (pair.split("/") * 2)[:2]
    kw = dict(size=(16, 12, 1), x=(0, 2 * np.pi), y=(0, 1.5))
    models = []
    for P in (J, T):
        dev = {} if P is J else dict(device=DEVICE)
        g = P.RectilinearGrid(topology=(P.PERIODIC, P.BOUNDED, P.FLAT),
                              dtype=jnp.float64 if P is J else torch.float64, **kw, **dev)
        Model = JShallowWaterModel if P is J else T.ShallowWaterModel
        models.append(Model(g, gravitational_acceleration=10.0,
                            advection=getattr(P, SHORT[momentum])(),
                            tracer_advection=getattr(P, SHORT[tracer])(),
                            coriolis=P.FPlane(f=1.0), tracers=("c",)))
    jm, tm = models
    rng = np.random.default_rng(6)
    shape = tm.grid.shape
    vals = dict(uh=0.1 * rng.standard_normal(shape), vh=0.1 * rng.standard_normal(shape),
                h=1.0 + 0.05 * rng.standard_normal(shape), c=rng.standard_normal(shape))
    js = jm.initial_state(**{k: jnp.asarray(v) for k, v in vals.items()})
    ts = tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(10):
        js, ts = step(js, 1e-2), tm.step(ts, 1e-2)
    compare(jm, js, tm, ts, pair)


# -- the two scripts ---------------------------------------------------------------

def jax_internal_wave(N):
    """examples/internal_wave.py's model and wave packet at N×1×N, on the
    JAX plain path."""
    grid = J.RectilinearGrid(size=(N, 1, N), x=(-np.pi, np.pi), y=(0, 1),
                             z=(-np.pi, np.pi), topology=(J.PERIODIC, J.FLAT, J.PERIODIC),
                             dtype=jnp.float64)
    B = J.BackgroundField(lambda x, y, z, t, N: N ** 2 * z, parameters=1.0)
    model = JN(grid, coriolis=J.FPlane(f=0.2), advection=J.CenteredFourthOrder(),
               timestepper="RungeKutta3", closure=J.ScalarDiffusivity(nu=1e-6, kappa=1e-6),
               buoyancy=JBuoyancy(), background_fields={"b": B}, fused_advection=False)
    m, k, f, Nb = 16, 8, 0.2, 1.0
    omega2 = (Nb ** 2 * k ** 2 + f ** 2 * m ** 2) / (k ** 2 + m ** 2)
    omega = np.sqrt(omega2)
    a = lambda x, z: 1e-9 * jnp.exp(-(x ** 2 + z ** 2) / (2 * (2 * np.pi / 15) ** 2))
    state = model.initial_state(
        u=lambda x, y, z: a(x, z) * k * omega / (omega2 - f ** 2) * jnp.cos(k * x + m * z),
        v=lambda x, y, z: a(x, z) * k * f / (omega2 - f ** 2) * jnp.sin(k * x + m * z),
        w=lambda x, y, z: a(x, z) * m * omega / (omega2 - Nb ** 2) * jnp.cos(k * x + m * z),
        b=lambda x, y, z: a(x, z) * m * Nb ** 2 / (omega2 - Nb ** 2) * jnp.sin(k * x + m * z))
    return model, state, 0.02 * 2 * np.pi / omega


def test_internal_wave_matches_the_jax_script():
    """The port's script at 32×1×32, 10 iterations of its ``Simulation``,
    against the JAX script's model stepped by the JAX ``Simulation``."""
    jm, js, jdt = jax_internal_wave(32)
    assert jdt == tiw.DT
    jsim = JSimulation(jm, state=js, dt=jdt, stop_iteration=10)
    jsim.run()
    got = tiw.run(32, DEVICE, iterations=10)
    tm = got["simulation"].model
    compare(jm, jsim.state, tm, got["simulation"].state, "internal wave")
    assert got["time"] == pytest.approx(float(jsim.model_time()), rel=1e-12)
    E0 = tiw.energy(tm, tiw.initial_state(tm))
    assert 0 < got["drift"] < 3e-2 and math.isfinite(E0)


@pytest.mark.parametrize("scheme", [n for n, _ in tpa.SCHEMES])
def test_periodic_advection_matches_the_jax_script(scheme):
    """Each scheme's model as the JAX script builds it at N = 32, both
    profiles, 20 RK3 steps of the script's Δt (one period is 160)."""
    N = 32
    grid = J.RectilinearGrid(size=(N, 1, 1), x=(0, 1), y=(0, 1),
                             topology=(J.PERIODIC, J.FLAT, J.FLAT), halo=(4, 1, 1),
                             dtype=jnp.float64)
    jscheme = getattr(jsch, type(dict(tpa.SCHEMES)[scheme]).__name__)()
    jm = JN(grid, tracers=("c",), tracer_advection=jscheme,
            advection=J.CenteredSecondOrder(), timestepper="RungeKutta3",
            fused_advection=False)
    step = jax.jit(jm.step)
    profiles = {"gaussian": lambda x: jnp.exp(-((x - 0.5) / 0.1) ** 2),
                "square": lambda x: jnp.where((x > 0.3) & (x < 0.7), 1.0, 0.0)}
    for profile, f in profiles.items():
        tm, ts, dt, steps = tpa.setup(profile, dict(tpa.SCHEMES)[scheme], N, DEVICE)
        assert steps == round(1.0 / (0.2 / N)) and dt == 1.0 / steps
        js = jm.initial_state(u=tpa.U, c=lambda x, y, z: f(x))
        for _ in range(20):
            js, ts = step(js, jnp.float64(dt)), tm.step(ts, dt)
        compare(jm, js, tm, ts, (scheme, profile))


# -- the kernels' arguments and the refusals -------------------------------------

def test_kernel_codes_and_per_scheme_bounds():
    codes = {n: tft.kernel_scheme(getattr(T, n)())[0]
             for n in (*SHORT.values(), "PositiveWENO5")}
    assert codes == {"CenteredFourthOrder": 4, "UpwindBiasedFirstOrder": 5,
                     "UpwindBiasedThirdOrder": 6, "BoundsPreservingWENO5": 7,
                     "UpwindBiasedFifthOrder": 2, "WENO5": 1, "CenteredSecondOrder": 0,
                     "PositiveWENO5": 3}
    assert tft.kernel_scheme(T.BoundsPreservingWENO5())[1] == 1e-6
    _, tg = grid_pair("BBB", (9, 8, 7))
    H, n = tg.halo[0], tg.shape[0]
    # C4 reduces within 2 cells by its symmetric region, UB1 nowhere
    assert tft.axis_bounds(tg, 0, T.CenteredFourthOrder()) == (1, H + 2, H + n - 3,
                                                               H + 2, H + n - 3)
    assert tft.axis_bounds(tg, 0, T.UpwindBiasedFirstOrder())[0] == 0
    # WENO5 momentum (3 cells) and UB3 tracers (2): two sets of bounds
    ints, _ = tft.advection_args(tg, T.WENO5(), T.UpwindBiasedThirdOrder(), 4)
    assert len(ints) == 43 and (ints[7], ints[8]) == (1, 6)
    assert tuple(ints[9:14]) == tft.axis_bounds(tg, 0, T.WENO5()) == (1, H + 3, H + n - 3,
                                                                     H + 2, H + n - 4)
    assert tuple(ints[28:33]) == tft.axis_bounds(tg, 0, T.UpwindBiasedThirdOrder()) == (
        1, H + 2, H + n - 2, H + 1, H + n - 3)
    sw = T.ShallowWaterModel(T.RectilinearGrid(size=(9, 8, 1), extent=(1, 1),
                                               topology=(T.BOUNDED, T.BOUNDED, T.FLAT),
                                               device=DEVICE),
                             advection=T.UpwindBiasedThirdOrder(),
                             tracer_advection=T.BoundsPreservingWENO5(), tracers=("c",))
    args = tft.shallow_water_args(sw.grid, sw.advection, sw.tracer_advection, 4, 9.8)
    assert len(args) == 36 and args[5:7] == (6, 7)
    assert args[32:] == (0.0, 0.0, 0.0, 0.0)  # no PositiveWENO5: no bounds
    assert args[7:12] == tft.axis_bounds(sw.grid, 0, T.UpwindBiasedThirdOrder())
    assert args[17:22] == tft.axis_bounds(sw.grid, 0, T.BoundsPreservingWENO5())


def test_z_rows_carry_tables_for_bounds_preserving_weno():
    _, st = stretched_pair((8, 7, 9))
    assert tft.z_rows_arg(st, T.CenteredSecondOrder(), T.BoundsPreservingWENO5())[1] == 1
    assert tft.z_rows_arg(st, T.CenteredFourthOrder(), T.UpwindBiasedThirdOrder())[1] == 0


@pytest.mark.parametrize("name", NEW)
def test_models_take_each_scheme_with_its_halo(name):
    """The nonhydrostatic model's halo is the schemes' required_halo;
    the shallow-water model builds with each."""
    _, tg = grid_pair("PPB", (8, 8, 6), halo=1)
    m = T.NonhydrostaticModel(tg, advection=getattr(T, name)())
    assert m.grid.halo == (getattr(T, name)().required_halo,) * 3
    assert tfs.unsupported_reason(m) is None
    g2 = T.RectilinearGrid(size=(8, 8, 1), extent=(1, 1),
                           topology=(T.PERIODIC, T.PERIODIC, T.FLAT), device=DEVICE)
    T.ShallowWaterModel(g2, advection=getattr(T, name)())


@pytest.mark.parametrize("name", NEW)
def test_hydrostatic_model_refuses_each_scheme_by_name(name):
    """K4 once refused a Flat y with these schemes; its Flat-y layout takes
    it now: the model builds with each as flux-form momentum and as the
    tracer scheme, and K4's gate passes (the schemes themselves on 3D
    grids: ``test_hydrostatic_model_takes_each_scheme``)."""
    from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh
    g = T.RectilinearGrid(size=(8, 1, 4), extent=(1, 1, 1), dtype=torch.float64,
                          topology=(T.PERIODIC, T.FLAT, T.BOUNDED), device=DEVICE)
    for kw in (dict(momentum_advection=getattr(T, name)()),
               dict(tracer_advection=getattr(T, name)(), tracers=("b",))):
        m = T.HydrostaticFreeSurfaceModel(g, free_surface=T.ExplicitFreeSurface(), **kw)
        assert m.grid.halo[1] == 0
        assert tfh.unsupported_reason(m) is None


@pytest.mark.parametrize("name", NEW + ("UpwindBiasedFifthOrder", "PositiveWENO5"))
def test_hydrostatic_model_takes_each_scheme(name):
    """The hydrostatic model with the scheme as flux-form momentum and as
    the tracer scheme builds with its required halo, passes K4's gate, and
    matches the JAX model (its plain path) after 2 steps within RTOL."""
    from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh
    from clima_oceananigans_jl_tpu.models.free_surface import ExplicitFreeSurface as JEFS
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    size = (10, 8, 5)
    kw = dict(size=size, x=(0, 1e5), y=(0, 8e4), z=(-1e3, 0),
              topology=("periodic", "bounded", "bounded"))
    jg = J.RectilinearGrid(dtype=jnp.float64, **kw)
    tg = T.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw)
    jsc, tsc = getattr(jsch, name)(), getattr(T, name)()
    jm = JH(jg, momentum_advection=jsc, tracer_advection=jsc, buoyancy=JBuoyancy(),
            tracers=("c",), coriolis=J.FPlane(f=1e-4), free_surface=JEFS(),
            fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(
        tg, momentum_advection=tsc, tracer_advection=tsc, buoyancy=T.BuoyancyTracer(),
        tracers=("c",), coriolis=T.FPlane(f=1e-4), free_surface=T.ExplicitFreeSurface())
    assert tm.grid.halo == (tsc.required_halo,) * 3 == jm.grid.halo
    assert tfh.unsupported_reason(tm) is None
    rng = np.random.default_rng(31)
    vals = dict(u=0.1 * rng.standard_normal(size), v=0.1 * rng.standard_normal(size),
                b=1e-3 * rng.standard_normal(size), c=rng.uniform(0.0, 1.0, size))
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    for _ in range(2):
        js, ts = jm.step(js, 20.0), tm.step(ts, 20.0)
    for k in ("u", "v", "b", "c"):
        ref = np.asarray(jm.grid.interior(js["solution"][k]))
        got = tm.grid.interior(ts["solution"][k]).numpy()
        assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max(), (name, k)


# -- on the card ---------------------------------------------------------------------

#: sizes off the kernels' tiles
CARD = {"PPB": (30, 27, 45), "BBB": (27, 25, 19), "PFB": (100, 1, 45), "PFF": (300, 1, 1)}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("code", list(CARD))
def test_cuda_k2_matches_plain_version(code, pair, dtype):
    needs_card()
    _, tg = grid_pair(code, CARD[code], dtype=DTYPES[dtype], device="cuda")
    momentum, tracer = (getattr(T, SHORT[s])() for s in PAIRS[pair])
    hold_k2(tg, momentum, tracer, card_fields(tg, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(PAIRS))
def test_cuda_k1_matches_plain_version(pair):
    """The fused AB2 advance on (P, P, B), Euler and AB2, bit for bit over
    NaN-filled outputs."""
    needs_card()
    _, tg = grid_pair("PPB", CARD["PPB"], dtype=torch.float32, device="cuda")
    momentum, tracer = (getattr(T, SHORT[s])() for s in PAIRS[pair])
    model = T.NonhydrostaticModel(tg, advection=momentum, tracer_advection=tracer,
                                  buoyancy=T.BuoyancyTracer(), tracers=("b", "c"),
                                  coriolis=T.FPlane(f=0.3),
                                  closure=T.ScalarDiffusivity(nu=1e-3, kappa=2e-3))
    assert model.fused_step
    gen = torch.Generator(device="cuda").manual_seed(6)
    rand = lambda shape: 1e-2 * torch.randn(shape, generator=gen, dtype=tg.dtype, device="cuda")
    state = model.initial_state(**{n: rand(model.grid.shape) for n in model.prognostic_names()})
    state = dict(state, G_prev={k: rand(tuple(g.shape)) for k, g in state["G_prev"].items()})
    for euler in (True, False):
        poison_cache(model.grid, 2 * len(model.prognostic_names()))
        psi, g = tfs.fused_ab2_advance(model, state, 1e-3, euler)
        ref_psi, ref_g = tfs.fused_ab2_advance_reference(model, state, 1e-3, euler)
        for name in psi:
            assert torch.equal(psi[name], ref_psi[name]), name
            assert torch.equal(g[name], ref_g[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["C4", "UB1", "UB3", "BP", "UB5", "WENO5/UB3", "UB3/C4"])
@pytest.mark.parametrize("topo", [("periodic", "periodic"), ("bounded", "bounded")])
def test_cuda_k3a_matches_plain_version(topo, pair):
    needs_card()
    momentum, tracer = (getattr(T, SHORT[s])() for s in (pair.split("/") * 2)[:2])
    g = T.RectilinearGrid(size=(1000, 777, 1), extent=(1, 1), topology=topo + ("flat",),
                          device="cuda")
    m = T.ShallowWaterModel(g, advection=momentum, tracer_advection=tracer, tracers=("c",))
    shape = m.grid.total_shape
    gen = torch.Generator(device="cuda").manual_seed(2)
    rand = lambda s: torch.randn(shape, generator=gen, device="cuda") * s
    uh, vh, c, hB = rand(0.1), rand(0.1), rand(1.0), rand(0.1)
    h = 1.0 + rand(0.05)
    args = (m.grid, momentum, tracer, 9.8, uh, vh, h, [c], hB)
    poison_cache(m.grid, 4)
    got = tft.fused_shallow_water_tendencies(*args)
    ref = tft.fused_shallow_water_tendencies_reference(*args)
    for a, b in zip(got, ref):
        assert torch.equal(m.grid.interior(a), m.grid.interior(b))
