"""Port parity: the simulation loop, its schedules, the adaptive Δt, the
CFL diagnostics and the clock.

The same configuration is built in both packages from the same
numpy-seeded fields (the JAX side on its plain path,
``fused_advection=False``) and driven by each package's ``Simulation``:

- the seven schedules, driven by one stub simulation on an fp32 clock
  with uneven steps: the same firings, ``collecting`` windows and
  ``aligned_time_step`` values, bit for bit;
- ``cell_advection_timescale`` bit for bit on (P, P, B), (B, F, B),
  (P, P, F) and an immersed grid, the hydrostatic and shallow-water ones
  and every model's ``fields`` too; the CFL diagnostics;
- the ``TimeStepWizard``'s Δt over 20 iterations of the RK3 flagship, the
  quasi-AB2 bench configuration (Euler steps whenever Δt changed), the
  lat-lon hydrostatic model and shallow water, within rtol 1e-12 (the
  states differ by reassociated sums);
- a run to a ``stop_time`` with ``TimeInterval`` and ``SpecifiedTimes``
  callbacks: the same iterations and firing times, the end state within
  1e-9 of max|field| (``test_torch_rk3.py``'s end-to-end tolerance);
- the NaN checker stopping a run, or raising;
- the clock: 20 steps of Δt = 0.1 in fp32 and fp64 for each model kind
  and time stepper give bit for bit the JAX ``clock.time`` and
  ``previous_dt``, which the JAX package keeps as 0-d arrays of the
  grid's dtype.
"""
import types

import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.utils import schedules as tsched

try:  # this file needs JAX; the guard keeps collection quiet without it
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.utils import schedules as jsched
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
BOX = ("periodic", "periodic", "bounded")


def P(side):
    return J if side == "jax" else T


def grid(side, size, topology=BOX, dtype="float64", latlon=False, **axes):
    kw = dict(size=size, dtype=jnp.dtype(dtype) if side == "jax" else getattr(torch, dtype))
    if side == "torch":
        kw["device"] = DEVICE
    if latlon:
        return P(side).LatitudeLongitudeGrid(longitude=(0, 360), latitude=(-75, 75),
                                             z=(-3000.0, 0.0), **kw)
    axes = axes or dict(x=(0, 1), y=(0, 1), z=(-1, 0))
    return P(side).RectilinearGrid(topology=topology, **kw, **axes)


def nonhydrostatic(side, g, flagship=False, **kw):
    """WENO5 with a buoyancy tracer b (a passive b on a Flat z); the RK3
    flagship adds an f-plane and a scalar diffusivity."""
    p = P(side)
    if flagship:
        kw = dict(coriolis=p.FPlane(f=1e-4),
                  closure=p.ScalarDiffusivity(nu=1e-5, kappa=1e-5),
                  timestepper="RungeKutta3", **kw)
    kw = dict(advection=p.WENO5(), **kw)
    if g.topology[2] is P(side).FLAT:
        kw["tracers"] = ("b",)
    else:
        kw["buoyancy"] = p.BuoyancyTracer()
    if side == "jax":
        return J.NonhydrostaticModel(g, fused_advection=False, **kw)
    return T.NonhydrostaticModel(g, **kw)


def hydrostatic(side, g):
    p = P(side)
    kw = dict(momentum_advection=p.VectorInvariant(scheme="weno_velocity"),
              tracer_advection=p.WENO5(), tracers=("T",),
              free_surface=p.SplitExplicitFreeSurface(substeps=8),
              coriolis=p.HydrostaticSphericalCoriolis(), buoyancy=p.BuoyancyTracer())
    if side == "jax":
        return J.HydrostaticFreeSurfaceModel(g, fused_advection=False, **kw)
    return T.HydrostaticFreeSurfaceModel(g, **kw)


def shallow_water(side, g):
    return P(side).ShallowWaterModel(g, gravitational_acceleration=10.0,
                                     advection=P(side).WENO5())


def values(shape, names, scale=0.05, seed=0):
    rng = np.random.default_rng(seed)
    return {n: scale * rng.standard_normal(shape) for n in names}


def build(side, kind, dtype="float64", seed=0):
    """(model, state) of one of the configurations above."""
    if kind in ("flagship", "ab2"):
        m = nonhydrostatic(side, grid(side, (8, 8, 8), dtype=dtype),
                           flagship=kind == "flagship")
        return m, m.initial_state(**values(m.grid.shape, ("u", "v", "w", "b"), seed=seed))
    if kind == "hydrostatic":
        m = hydrostatic(side, grid(side, (16, 8, 4), dtype=dtype, latlon=True))
        v = values(m.grid.shape, ("u", "v", "T"), 0.1, seed)
        return m, m.initial_state(b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0, **v)
    m = shallow_water(side, grid(side, (16, 16, 1), ("periodic", "periodic", "flat"), dtype,
                                 x=(0, 2 * np.pi), y=(0, 2 * np.pi), z=(0, 1)))
    v = values(m.grid.shape, ("uh", "vh"), 0.1, seed)
    return m, m.initial_state(h=1.0 + 0.05 * values(m.grid.shape, ("h",), 1.0, seed + 1)["h"],
                              **v)


def interior(side, model, arr):
    a = model.grid.interior(arr)
    return np.asarray(a) if side == "jax" else a.numpy()


def compare_states(jm, js, tm, ts, rtol=RTOL):
    for name in tm.prognostic_names():
        ref, got = interior("jax", jm, js["solution"][name]), interior("torch", tm, ts["solution"][name])
        assert np.abs(ref - got).max() <= rtol * max(np.abs(ref).max(), 1e-300), name


# -- schedules ---------------------------------------------------------------------------
class Stub:
    """A simulation's clock and nothing else."""

    def __init__(self):
        self.t, self.i = 0.0, 0

    def model_time(self):
        return self.t

    def model_iteration(self):
        return self.i


def schedules(mod):
    return {
        "TimeInterval": mod.TimeInterval(0.25),
        "AveragedTimeInterval": mod.AveragedTimeInterval(0.5, window=0.2, stride=2),
        "IterationInterval": mod.IterationInterval(3),
        "WallTimeInterval": mod.WallTimeInterval(1.0),
        "SpecifiedTimes": mod.SpecifiedTimes(0.1, 0.35, 0.7),
        "AndSchedule": mod.AndSchedule(mod.IterationInterval(2), mod.TimeInterval(0.3)),
        "OrSchedule": mod.OrSchedule(mod.IterationInterval(5), mod.SpecifiedTimes(0.42)),
    }


@pytest.mark.parametrize("name", list(schedules(tsched)))
def test_schedules_fire_and_align_as_jax(name, monkeypatch):
    wall = [0.0]
    for mod in (jsched, tsched):
        monkeypatch.setattr(mod, "_time", types.SimpleNamespace(monotonic=lambda: wall[0]))
    js, ts = schedules(jsched)[name], schedules(tsched)[name]
    rng = np.random.default_rng(1)
    sim, clock = Stub(), np.float32(0.0)
    seen = []
    for k in range(80):
        dt = float(rng.uniform(0.005, 0.06))
        assert js.aligned_time_step(sim.t, dt) == ts.aligned_time_step(sim.t, dt)
        step = np.float32(min(dt, ts.aligned_time_step(sim.t, dt)))
        clock = clock + step
        sim.t, sim.i = float(clock), k + 1
        wall[0] += 0.3
        fired = (js(sim), ts(sim))
        assert fired[0] == fired[1], (k, sim.t)
        seen.append(fired[1])
        if name == "AveragedTimeInterval":
            assert js.collecting(sim.t) == ts.collecting(sim.t)
            assert js.previous_actuation_time == ts.previous_actuation_time
    assert any(seen) and not all(seen)


# -- cell_advection_timescale, fields and the CFL diagnostics -------------------------------
TIMESCALE_CASES = {
    "P,P,B": dict(size=(8, 8, 8), topology=BOX),
    "B,F,B": dict(size=(8, 1, 8), topology=("bounded", "flat", "bounded")),
    "P,P,F": dict(size=(8, 8, 1), topology=("periodic", "periodic", "flat")),
    "immersed": dict(size=(8, 8, 8), topology=BOX, immersed=True),
}


def timescale_models(case):
    c = TIMESCALE_CASES[case]
    out = []
    for side in ("jax", "torch"):
        xp = jnp if side == "jax" else torch
        kw = {}
        if c.get("immersed"):
            kw["immersed_boundary"] = P(side).GridFittedBottom(
                lambda x, y: -0.9 + 0.4 * xp.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.05))
        m = nonhydrostatic(side, grid(side, c["size"], c["topology"]), **kw)
        s = m.initial_state(**values(m.grid.shape, ("u", "v", "w", "b"), seed=4))
        out += [m, s]
    return out


@pytest.mark.parametrize("case", list(TIMESCALE_CASES))
def test_nonhydrostatic_cell_advection_timescale_is_bitwise_jax(case):
    jm, js, tm, ts = timescale_models(case)
    got = tm.cell_advection_timescale(ts)
    assert got.dtype == torch.float64 and got.ndim == 0
    assert float(got) == float(jm.cell_advection_timescale(js))
    # the CFL diagnostics divide by it (and by the diffusive timescale)
    assert T.AdvectiveCFL()(tm, ts, dt=0.01) == J.AdvectiveCFL()(jm, js, dt=0.01)


@pytest.mark.parametrize("case", ["P,P,B", "immersed"])
def test_nonhydrostatic_fields_are_jax_fields(case):
    jm, js, tm, ts = timescale_models(case)
    jf, tf = jm.fields(js), tm.fields(ts)
    assert list(jf) == list(tf) == ["u", "v", "w", "b", "pNHS", "pHY"]
    for name, f in tf.items():
        assert f.loc == jf[name].loc and f.bcs is tm.bcs.get(name, tm.pressure_bcs)
        ref = interior("jax", jm, jf[name].data)
        got = interior("torch", tm, f.data)
        tol = 1e-13 * np.abs(ref).max() if name == "pHY" else 0.0  # a cumulative sum
        assert np.abs(ref - got).max() <= tol, name


@pytest.mark.parametrize("kind", ["hydrostatic", "shallow water"])
def test_hydrostatic_and_shallow_water_timescale_and_fields_are_jax(kind):
    jm, js = build("jax", kind)
    tm, ts = build("torch", kind)
    ref, got = float(jm.cell_advection_timescale(js)), float(tm.cell_advection_timescale(ts))
    # the hydrostatic w comes from a cumulative sum in both packages
    assert got == pytest.approx(ref, rel=1e-13 if kind == "hydrostatic" else 0.0)
    jf, tf = jm.fields(js), tm.fields(ts)
    assert list(jf) == list(tf)
    g = tm.grid
    for name, f in tf.items():
        assert f.loc == jf[name].loc and f.bcs is not None
        if name == "eta":  # (X, Y, 1)
            cut = lambda a: np.asarray(a)[g.Hx:-g.Hx, g.Hy:-g.Hy]
            ref, got = cut(jf[name].data), cut(f.data.numpy())
        else:
            ref, got = interior("jax", jm, jf[name].data), interior("torch", tm, f.data)
        assert np.abs(ref - got).max() <= 1e-13 * max(np.abs(ref).max(), 1e-300), name


def test_diffusive_cfl_is_jax():
    out = []
    for side in ("jax", "torch"):
        m, s = build(side, "flagship")
        sim = P(side).Simulation(m, state=s, dt=0.02)
        out.append((P(side).DiffusiveCFL()(sim), P(side).DiffusiveCFL(dt=0.5)(sim),
                    P(side).CFL()(sim)))
    assert out[0] == out[1] and out[1][0] > 0


# -- the wizard --------------------------------------------------------------------------------
WIZARD = {"flagship": 0.05, "ab2": 0.05, "hydrostatic": 600.0, "shallow water": 0.02}


def wizard_dts(side, kind, cfl, steps=20):
    m, s = build(side, kind)
    p = P(side)
    sim = p.Simulation(m, state=s, dt=WIZARD[kind], stop_iteration=steps)
    dts = []
    sim.callbacks["wizard"] = p.Callback(p.TimeStepWizard(cfl=cfl, max_change=1.2),
                                         p.IterationInterval(1))
    sim.callbacks["record"] = p.Callback(lambda q: dts.append(q.dt), p.IterationInterval(1))
    sim.run()
    return np.array(dts), m, sim.state


@pytest.mark.parametrize("kind", list(WIZARD))
def test_wizard_dt_sequence_matches_jax(kind):
    tm, ts = build("torch", kind)
    # a CFL that puts the wizard's first Δt at the configuration's Δt, so
    # the advective bound (and not max_change) sets every later one
    cfl = WIZARD[kind] / float(tm.cell_advection_timescale(ts))
    ref, jm, js = wizard_dts("jax", kind, cfl)
    got, tm, ts = wizard_dts("torch", kind, cfl)
    assert len(got) == len(ref) == 21 and len(set(got)) > 10
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    assert ts["clock"].iteration == int(js["clock"].iteration) == 20
    compare_states(jm, js, tm, ts)


# -- a run to a stop time ------------------------------------------------------------------------
def stop_time_run(side):
    m, s = build(side, "flagship")
    p = P(side)
    sim = p.Simulation(m, state=s, dt=0.07, stop_time=1.0, stop_iteration=1000)
    fired = {"interval": [], "specified": []}
    sim.callbacks["interval"] = p.Callback(
        lambda q: fired["interval"].append((q.model_iteration(), q.model_time())),
        p.TimeInterval(0.25))
    sim.callbacks["specified"] = p.Callback(
        lambda q: fired["specified"].append((q.model_iteration(), q.model_time())),
        p.SpecifiedTimes(0.1, 0.33))
    sim.run()
    return m, sim, fired


def test_run_to_stop_time_fires_as_jax():
    jm, jsim, jfired = stop_time_run("jax")
    tm, tsim, tfired = stop_time_run("torch")
    assert tfired == jfired and len(tfired["interval"]) == 5
    assert tsim.model_iteration() == jsim.model_iteration()
    assert tsim.model_time() == jsim.model_time() == pytest.approx(1.0, abs=1e-12)
    assert tsim.dt == jsim.dt and not tsim.running
    compare_states(jm, jsim.state, tm, tsim.state)


# -- the NaN checker ------------------------------------------------------------------------------
def poisoned_run(side, erroring=False):
    m, s = build(side, "flagship")
    p = P(side)
    sim = p.Simulation(m, state=s, dt=0.02, stop_iteration=10)
    sim.callbacks["nan_checker"] = p.Callback(p.NaNChecker(m.prognostic_names(), erroring),
                                              p.IterationInterval(1))

    def poison(q):
        if q.model_iteration() == 3:
            u = q.state["solution"]["u"]
            if side == "jax":
                u = u.at[4, 4, 4].set(jnp.nan)
            else:
                u = u.clone()
                u[4, 4, 4] = float("nan")
            q.state = dict(q.state, solution=dict(q.state["solution"], u=u))
    sim.callbacks["poison"] = p.Callback(poison, p.IterationInterval(1))
    sim.run()
    return sim


def test_nan_checker_stops_the_run_as_jax():
    jsim, tsim = poisoned_run("jax"), poisoned_run("torch")
    assert tsim.model_iteration() == jsim.model_iteration() == 4
    assert not tsim.running
    with pytest.raises(FloatingPointError, match="NaN found in field"):
        poisoned_run("torch", erroring=True)


# -- the clock -------------------------------------------------------------------------------
CLOCK_CASES = [(kind, dtype) for kind in ("flagship", "ab2", "hydrostatic", "shallow water")
               for dtype in ("float32", "float64")]


@pytest.mark.parametrize("kind,dtype", CLOCK_CASES)
def test_clock_rounds_in_the_grid_dtype(kind, dtype):
    """20 steps of Δt = 0.1 through each package's Simulation: the clock
    and previous_dt bit for bit, in the grid's dtype."""
    out = []
    for side in ("jax", "torch"):
        m, s = build(side, kind, dtype)
        sim = P(side).Simulation(m, state=s, dt=0.1, stop_iteration=20)
        sim.run()
        out.append((np.asarray(sim.state["clock"].time),
                    np.asarray(sim.state.get("previous_dt", np.nan))))
    (jt, jp), (tt, tp) = out
    assert tt.dtype == jt.dtype == np.dtype(dtype)
    assert tt.tobytes() == jt.tobytes()
    assert tp.tobytes() == jp.tobytes()
    if kind != "shallow water":
        assert tp.dtype == np.dtype(dtype) and float(tp) == float(np.dtype(dtype).type(0.1))
    # in fp32 the clock parts from a clock of Python floats
    python = 0.0
    for _ in range(20):
        python += 0.1
    assert (float(tt) != python) == (dtype == "float32")
