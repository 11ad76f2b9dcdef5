"""Port parity: the prescribed-velocity model, ensembles, and the port's
copy of validation/biogeochemistry.py.

The same numpy inputs go through the JAX package and the port, in
float64:

- ``PrescribedVelocityModel`` on the JAX suite's configurations (the
  advected Gaussian under WENO5, the square wave under
  BoundsPreservingWENO5, and more schemes), bitwise against the JAX step
  op by op, then the suite's own checks on the port's full runs;
- the biogeochemistry copy's reacting column (its two forcings, the
  ``AdvectiveForcing`` slip velocities and the closure) against the JAX
  model built from the script's constants, 10 steps within ``RTOL_BGC``
  (the initial ``exp`` of each package may differ by an ulp);
- ensembles on the JAX suite's column (``test_ensemble_vmap_mode``):
  against JAX's vmapped, jitted ensemble within ``RTOL`` (the pcg sums in
  another order there), bitwise against the port's members stepped
  alone, with a shared and a per-member Δt;
- interop of prescribed and batched ensemble states, both ways.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.forcings.forcing import MultipleForcings
from clima_oceananigans_jl_torch.interop import state_from_numpy, state_to_numpy
from clima_oceananigans_jl_torch.validation import biogeochemistry

import jax
import jax.numpy as jnp

import clima_oceananigans_jl_tpu as J
from clima_oceananigans_jl_tpu.forcings.forcing import (AdvectiveForcing as JAF,
                                                        Forcing as JForcing)
from clima_oceananigans_jl_tpu.models import ensemble as jens
from clima_oceananigans_jl_tpu.models.prescribed import (
    PrescribedVelocityFields as JPF, PrescribedVelocityModel as JPM)
from clima_oceananigans_jl_tpu.timesteppers.steppers import Clock as JClock

torch.set_num_threads(1)

DEVICE = "cpu"
RTOL = 1e-9
RTOL_BGC = 1e-12
P_ = ("periodic", "flat", "flat")
MEMBERS = (1e-5, 2e-5, 3e-5)


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def line(P, n):
    dtype = jnp.float64 if P is J else torch.float64
    extra = {} if P is J else {"device": DEVICE}
    return P.RectilinearGrid(size=(n, 1, 1), x=(0, 1), y=(0, 1), topology=P_,
                             dtype=dtype, **extra)


def prescribed_pair(n, scheme):
    jm = JPM(line(J, n), JPF(u=lambda x, y, z, t: 1.0 + 0 * x), tracers=("c",),
             tracer_advection=getattr(J, scheme)())
    tm = T.PrescribedVelocityModel(line(T, n), T.PrescribedVelocityFields(
        u=lambda x, y, z, t: 1.0 + 0 * x), tracers=("c",),
        tracer_advection=getattr(T, scheme)())
    return jm, tm


def centres(n):
    return (np.arange(n) + 0.5) / n


PROFILES = {"gaussian": lambda x: np.exp(-((x - 0.5) ** 2) / 0.01),
            "square": lambda x: np.where((x > 0.25) & (x < 0.5), 1.0, 0.0)}


@pytest.mark.parametrize("scheme, n, profile, dt", [
    ("WENO5", 32, "gaussian", 1e-3),
    ("BoundsPreservingWENO5", 64, "square", 2e-3),
    ("CenteredSecondOrder", 32, "gaussian", 1e-3),
    ("UpwindBiasedThirdOrder", 64, "square", 2e-3)])
def test_prescribed_steps_bitwise(scheme, n, profile, dt):
    """The JAX suite's configurations, 10 steps, bitwise, Euler first and
    AB2 after, with the clock and ``previous_dt``."""
    jm, tm = prescribed_pair(n, scheme)
    c0 = PROFILES[profile](centres(n))[:, None, None]
    js, ts = jm.initial_state(c=c0), tm.initial_state(c=c0)
    assert np.array_equal(host(js["solution"]["c"]), host(ts["solution"]["c"]))
    with jax.disable_jit():
        for _ in range(10):
            js = jm.step(js, dt)
    for _ in range(10):
        ts = tm.step(ts, dt)
    for k in ("solution", "G_prev"):
        assert np.array_equal(host(js[k]["c"]), host(ts[k]["c"])), k
    assert float(ts["previous_dt"]) == float(js["previous_dt"]) == dt
    assert ts["clock"].iteration == 10


def test_prescribed_velocity_tracer_advection():
    """The JAX suite's check on the port: 100 steps carry the Gaussian
    peak to x = 0.6."""
    _, tm = prescribed_pair(32, "WENO5")
    state = tm.initial_state(c=lambda x, y, z: torch.exp(-((x - 0.5) ** 2) / 0.01))
    for _ in range(100):
        state = tm.step(state, 1e-3)
    c = host(tm.grid.interior(state["solution"]["c"]))[:, 0, 0]
    x = host(tm.grid.coord(0, "c"))
    assert np.argmax(c) == np.argmin(np.abs(x - 0.6))


def test_bounds_preserving_weno_limits_overshoot():
    _, tm = prescribed_pair(64, "BoundsPreservingWENO5")
    state = tm.initial_state(c=PROFILES["square"](centres(64))[:, None, None])
    for _ in range(200):
        state = tm.step(state, 2e-3)
    c = host(tm.grid.interior(state["solution"]["c"]))
    assert c.min() >= -1e-3 and c.max() <= 1.0 + 1e-3
    assert c.max() > 0.5


def jax_reacting(nz=128):
    s = biogeochemistry
    grid = J.RectilinearGrid(size=(1, 1, nz), x=(0, 1), y=(0, 1), z=(-10, 10),
                             topology=("flat", "flat", "bounded"), dtype=jnp.float64)
    return JPM(grid, JPF(), tracers=("a", "b"), tracer_advection=J.WENO5(),
               closure=J.ScalarDiffusivity(kappa=1e-2),
               forcing={"a": (JForcing(lambda x, y, z, t, a, b: -a * b,
                                       field_dependencies=("a", "b")),
                              JAF(J.WENO5(), w=-1.0)),
                        "b": (JForcing(lambda x, y, z, t, a, b: +a * b,
                                       field_dependencies=("a", "b")),
                              JAF(J.WENO5(), w=+1.0))}), s.DT1


def test_biogeochemistry_column_matches_jax():
    """The copy's reacting column against the JAX model built from the
    script's constants, 10 steps within ``RTOL_BGC``; its forcing binds
    as the JAX package's does."""
    tm = biogeochemistry.reacting_model(DEVICE)
    assert isinstance(tm.forcing["a"], MultipleForcings)
    assert tm.forcing["a"].parts[1].field_name == "a"
    jm, dt = jax_reacting()
    ts = biogeochemistry.reacting_state(tm)
    js = jm.initial_state(a=lambda x, y, z: jnp.exp(-(z - 4.0) ** 2),
                          b=lambda x, y, z: jnp.exp(-(z + 4.0) ** 2))
    step = jax.jit(jm.step)
    for _ in range(10):
        js, ts = step(js, dt), tm.step(ts, dt)
    for k in ("a", "b"):
        ref = np.asarray(jm.grid.interior(js["solution"][k]))
        got = host(tm.grid.interior(ts["solution"][k]))
        assert np.abs(ref - got).max() <= RTOL_BGC * np.abs(ref).max(), k
    r1 = biogeochemistry.run_reacting(DEVICE, steps=10)
    tot0, tot1 = (r1["a0"] + r1["b0"]).sum(), (r1["a1"] + r1["b1"]).sum()
    assert abs(tot1 - tot0) <= 1e-10 * tot0


def test_biogeochemistry_sinking_slice_runs():
    """Case 2's slice on the plain path (``fused_advection=False``), a
    few steps: finite, and P produced where the light is."""
    r2 = biogeochemistry.run_sinking(DEVICE, steps=5)
    assert np.isfinite(r2["P"]).all() and r2["P"].max() > 0


# -- ensembles ----------------------------------------------------------------
def column(P):
    dtype = jnp.float64 if P is J else torch.float64
    extra = {} if P is J else {"device": DEVICE}
    g = P.RectilinearGrid(size=(1, 1, 16), x=(0, 1), y=(0, 1), z=(-10, 0),
                          topology=("flat", "flat", "bounded"), dtype=dtype, **extra)
    return P.HydrostaticFreeSurfaceModel(
        grid=g, free_surface=P.ImplicitFreeSurface(solver_method="pcg"),
        momentum_advection=None, tracer_advection=None, buoyancy=P.BuoyancyTracer(),
        closure=P.ScalarDiffusivity(kappa_z=0.01, nu_z=0.01,
                                    time_discretization="vertically_implicit"))


def member_inits():
    return [dict(b=lambda x, y, z, s=s: s * (z + 10) / 10) for s in MEMBERS]


@pytest.fixture(scope="module")
def jax_ensemble():
    jm = column(J)
    batched = jens.ensemble_initial_state(jm, member_inits())
    step = jens.ensemble_step(jm)
    states = [batched]
    for _ in range(3):
        states.append(step(states[-1], jnp.float64(10.0)))
    return jm, states


def test_ensemble_matches_jax_and_members_alone(jax_ensemble):
    jm, jstates = jax_ensemble
    tm = column(T)
    batched = T.ensemble_initial_state(tm, member_inits())
    step = T.ensemble_step(tm)
    for _ in range(3):
        batched = step(batched, 10.0)
    for i, s in enumerate(MEMBERS):
        got = T.member(batched, i)
        ref = jens.member(jstates[-1], i)
        for k in ("u", "v", "b"):
            a, b = np.asarray(ref["solution"][k]), host(got["solution"][k])
            assert np.abs(a - b).max() <= RTOL * max(np.abs(a).max(), 1e-300), (i, k)
        b = host(got["solution"]["b"])
        assert np.isfinite(b).all() and abs(b.max() - s) < s
        alone = tm.initial_state(**member_inits()[i])
        for _ in range(3):
            alone = tm.step(alone, 10.0)
        for k, x in alone["solution"].items():
            assert torch.equal(x, got["solution"][k]), (i, k)
        assert torch.equal(alone["eta"], got["eta"])
        assert alone["clock"] == got["clock"]


def test_ensemble_dt_per_member():
    tm = column(T)
    batched = T.ensemble_initial_state(tm, member_inits())
    dts = np.array([5.0, 10.0, 20.0])
    step = T.ensemble_step(tm, dt_per_member=True)
    for _ in range(2):
        batched = step(batched, dts)
    for i, dt in enumerate(dts):
        alone = tm.initial_state(**member_inits()[i])
        for _ in range(2):
            alone = tm.step(alone, dts[i])
        assert all(torch.equal(x, T.member(batched, i)["solution"][k])
                   for k, x in alone["solution"].items())
        assert float(T.member(batched, i)["clock"].time) == 2 * dt
    assert T.stack_states([T.member(batched, i) for i in range(3)])["solution"][
        "b"].shape == (3,) + tm.grid.total_shape


def test_interop_batched_states(jax_ensemble):
    """A JAX batched state converts member by member into the port's, and
    steps on there as the JAX ensemble does; the port's batched state
    goes back to numpy with its member axis."""
    jm, jstates = jax_ensemble
    tm = column(T)
    batched = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jstates[2]))
    assert batched["solution"]["b"].shape == (3,) + tm.grid.total_shape
    batched = T.ensemble_step(tm)(batched, 10.0)
    for i in range(3):
        ref = np.asarray(jens.member(jstates[3], i)["solution"]["b"])
        got = host(T.member(batched, i)["solution"]["b"])
        assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max()
    back = state_to_numpy(batched)
    assert back["solution"]["b"].shape == (3,) + tm.grid.total_shape
    assert np.asarray(back["clock"].time).shape == (3,)
    assert list(np.asarray(back["clock"].iteration)) == [3, 3, 3]


def test_interop_prescribed_state():
    jm, tm = prescribed_pair(32, "WENO5")
    c0 = PROFILES["gaussian"](centres(32))[:, None, None]
    js = jm.initial_state(c=c0)
    with jax.disable_jit():
        for _ in range(2):
            js = jm.step(js, 1e-3)
        ts = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
        js = jm.step(js, 1e-3)
        back = state_to_numpy(ts)
        jb = dict(solution={k: jnp.asarray(v) for k, v in back["solution"].items()},
                  G_prev={k: jnp.asarray(v) for k, v in back["G_prev"].items()},
                  previous_dt=jnp.asarray(back["previous_dt"]),
                  clock=JClock(jnp.asarray(back["clock"].time),
                               jnp.asarray(back["clock"].iteration)))
        jb = jm.step(jb, 1e-3)
    ts = tm.step(ts, 1e-3)
    assert np.array_equal(host(js["solution"]["c"]), host(ts["solution"]["c"]))
    assert np.array_equal(host(jb["solution"]["c"]), host(ts["solution"]["c"]))
