"""Port parity: the nonlinear equations of state and seawater buoyancy.

In f64 on the CPU, through the JAX package's function and the port's on
the same numpy-seeded inputs:

- ``density_anomaly`` of ``RoquetIdealizedEquationOfState`` and
  ``PolynomialEquationOfState`` (integer powers up to 5, formed as JAX's
  ``integer_pow`` forms them) on random (T, S, z), bit for bit, and of
  ``TEOS10EquationOfState`` (the 55-term polyTEOS10-bsq, every term in
  JAX's order) within 1e-14 of ρ₀: torch's vectorised CPU ``sqrt`` of
  float64 is not correctly rounded (it is 1 ulp off on some inputs, where
  XLA's and numpy's are exact), and the polynomial multiplies that ulp of
  s = √((S+ΔS)/SAu) by ∂ρ/∂s ~ 10³ (on the card sqrt is IEEE); TEOS-10's
  published check value ρ(30 g/kg, 10 °C, −1000 m) = 1027.45140 kg/m³ and
  its expansion and contraction coefficients by autograd, Roquet's
  cabbeling (the JAX suite's ``tests/test_misc_components.py:36-59,
  176-183`` in the port);
- ``SeawaterBuoyancy.buoyancy_perturbation`` with each equation of state
  (and a constant salinity) on a rectilinear and a lat-lon grid, bit for
  bit (TEOS-10's b within 1e-14·g, its ρ′ bound carried through −gρ′/ρ₀),
  and pHY′ (cumulative sums in different orders: 1e-13 of max|ref|);
- the hydrostatic model with each equation of state and under tilted
  gravity: pHY′ after ``initial_state`` (K4a's plain version against the
  JAX integral, 1e-13) and 10 steps within 1e-9, as
  ``tests/test_torch_hydrostatic.py`` holds the flagship;
- 10 RK3 steps of the nonhydrostatic model under Roquet and TEOS-10 within
  1e-9;
- an equation of state without ``density_anomaly`` refused at
  construction, naming what is missing.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.buoyancy import buoyancy as tb

try:  # this file needs JAX; the guard keeps collection quiet without it
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.buoyancy import buoyancy as jb
    from clima_oceananigans_jl_tpu.buoyancy import nonlinear_eos as jn
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
POLY = {(0, 0, 0): 0.3, (1, 0, 0): -0.2, (0, 1, 0): 0.8, (2, 1, 1): 1e-3,
        (3, 0, 2): 1e-7, (5, 0, 0): 1e-6, (0, 0, 4): 1e-15}


def eos_pair(kind):
    return {"roquet": (jn.RoquetIdealizedEquationOfState(),
                       T.RoquetIdealizedEquationOfState()),
            "teos10": (jn.TEOS10EquationOfState(), T.TEOS10EquationOfState()),
            "polynomial": (jn.PolynomialEquationOfState.from_dict(POLY),
                           T.PolynomialEquationOfState.from_dict(POLY)),
            "linear": (jb.LinearEquationOfState(2e-4, 8e-4),
                       T.LinearEquationOfState(2e-4, 8e-4))}[kind]


def same(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    ref = np.broadcast_to(ref, got.shape)
    assert np.array_equal(ref, got), np.abs(ref - got).max()


def within(ref, got, atol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert np.abs(ref - got).max() <= atol, np.abs(ref - got).max()


def jinit(jm, vals):
    """The JAX model's ``initial_state`` under ``jax.jit`` (one compile,
    where op-by-op dispatch takes seconds)."""
    return jax.jit(lambda: jm.initial_state(**vals))()


def close(ref, got, rtol):
    ref, got = np.asarray(ref), np.asarray(got)
    err, scale = np.abs(ref - got).max(), np.abs(ref).max()
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("kind", ["roquet", "teos10", "polynomial"])
def test_density_anomaly_is_bitwise_jax(kind):
    je, te = eos_pair(kind)
    rng = np.random.default_rng(0)
    shape = (9, 7, 6)
    Tn, Sn = rng.uniform(-2.0, 30.0, shape), rng.uniform(30.0, 40.0, shape)
    zn = rng.uniform(-5000.0, 0.0, shape)
    ref = je.density_anomaly(jnp.asarray(Tn), jnp.asarray(Sn), jnp.asarray(zn))
    got = te.density_anomaly(torch.as_tensor(Tn), torch.as_tensor(Sn),
                             torch.as_tensor(zn))
    hold = (lambda r, g: within(r, g, 1e-14 * je.reference_density)
            if kind == "teos10" else same)
    hold(ref, got)
    assert te.reference_density == je.reference_density
    # numbers as well as tensors
    hold(je.density_anomaly(12.0, 34.0, -200.0),
         te.density_anomaly(12.0, 34.0, -200.0))


def test_teos10_check_value_and_coefficients():
    eos = T.TEOS10EquationOfState()
    rho = float(eos.density(torch.tensor(10.0, dtype=torch.float64),
                            torch.tensor(30.0, dtype=torch.float64),
                            torch.tensor(-1000.0, dtype=torch.float64)))
    assert abs(rho - 1027.45140) < 1e-4
    T15 = torch.tensor(15.0, dtype=torch.float64, requires_grad=True)
    S35 = torch.tensor(35.0, dtype=torch.float64, requires_grad=True)
    eos.density(T15, S35, torch.tensor(0.0, dtype=torch.float64)).backward()
    alpha, beta = -float(T15.grad) / 1025.0, float(S35.grad) / 1025.0
    assert 1.5e-4 < alpha < 3e-4
    assert 7e-4 < beta < 8e-4


def test_roquet_cabbeling_and_polynomial():
    eos = T.RoquetIdealizedEquationOfState()
    T1, T2, S, z = 5.0, 15.0, 35.0, -100.0
    r1, r2 = eos.density_anomaly(T1, S, z), eos.density_anomaly(T2, S, z)
    assert eos.density_anomaly(0.5 * (T1 + T2), S, z) > 0.5 * (r1 + r2)
    poly = T.PolynomialEquationOfState.from_dict({(1, 0, 0): -0.2, (0, 1, 0): 0.8})
    assert np.isclose(poly.density_anomaly(2.0, 1.0, 0.0), -0.4 + 0.8)


def grids(latlon):
    if latlon:
        k = np.arange(7)
        kw = dict(size=(12, 8, 6), longitude=(0, 360), latitude=(-75, 75),
                  z=-3000.0 * (1.0 - k / 6) ** 1.8)
        return (J.LatitudeLongitudeGrid(dtype=jnp.float64, **kw),
                T.LatitudeLongitudeGrid(dtype=torch.float64, device=DEVICE, **kw))
    kw = dict(size=(8, 6, 5), x=(0.0, 64.0), y=(0.0, 48.0), z=(-320.0, 0.0))
    return (J.RectilinearGrid(topology=("periodic", "periodic", "bounded"),
                              dtype=jnp.float64, **kw),
            T.RectilinearGrid(topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                              dtype=torch.float64, device=DEVICE, **kw))


@pytest.mark.parametrize("latlon", [False, True], ids=["rectilinear", "latlon"])
@pytest.mark.parametrize("kind", ["roquet", "teos10", "polynomial", "salinity"])
def test_seawater_buoyancy_matches_jax(kind, latlon):
    """b bit for bit and pHY′ within 1e-13, each equation of state; the
    "salinity" case is TEOS-10 with a constant salinity."""
    jg, tg = grids(latlon)
    je, te = eos_pair("teos10" if kind == "salinity" else kind)
    cs = 35.0 if kind == "salinity" else None
    jbuoy = jb.SeawaterBuoyancy(equation_of_state=je, constant_salinity=cs)
    tbuoy = T.SeawaterBuoyancy(equation_of_state=te, constant_salinity=cs)
    assert tbuoy.required_tracers == jbuoy.required_tracers
    rng = np.random.default_rng(1)
    f = dict(T=rng.uniform(0.0, 25.0, tg.total_shape),
             S=rng.uniform(33.0, 37.0, tg.total_shape))
    jt = {n: jnp.asarray(a) for n, a in f.items()}
    tt = {n: torch.as_tensor(a) for n, a in f.items()}
    ref = jbuoy.buoyancy_perturbation(jg, jt)
    got = tbuoy.buoyancy_perturbation(tg, tt)
    if kind in ("teos10", "salinity"):
        within(ref, got, 1e-14 * jbuoy.gravitational_acceleration)
    else:
        same(ref, got)
    close(jb.hydrostatic_pressure_anomaly(jbuoy, jg, jt),
          tb.hydrostatic_pressure_anomaly(tbuoy, tg, tt), 1e-13)


def test_equation_of_state_without_density_anomaly_is_refused():
    with pytest.raises(TypeError, match="density_anomaly"):
        T.SeawaterBuoyancy(equation_of_state=object())
    T.SeawaterBuoyancy(equation_of_state=T.TEOS10EquationOfState())


def hydro_models(kind, gravity=(0.0, 0.0, -1.0)):
    """The near-global run's default schemes (VectorInvariant, centred
    tracers) at 12×8×6 on a lat-lon grid (split-explicit, 8 substeps) with
    seawater buoyancy of ``kind``."""
    jg, tg = grids(True)
    je, te = eos_pair(kind)
    jm = J.HydrostaticFreeSurfaceModel(
        jg, coriolis=J.HydrostaticSphericalCoriolis(),
        free_surface=J.SplitExplicitFreeSurface(substeps=8),
        buoyancy=jb.SeawaterBuoyancy(equation_of_state=je,
                                     gravity_unit_vector=gravity),
        fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(
        tg, coriolis=T.HydrostaticSphericalCoriolis(),
        free_surface=T.SplitExplicitFreeSurface(substeps=8),
        buoyancy=T.SeawaterBuoyancy(equation_of_state=te, gravity_unit_vector=gravity))
    return jm, tm


def hydro_values(shape, seed):
    rng = np.random.default_rng(seed)
    return dict(u=0.05 * rng.standard_normal(shape),
                T=lambda lam, phi, z: 2.0 + 18.0 * (1.0 + z / 3000.0) ** 2,
                S=35.0 + 0.1 * rng.standard_normal(shape))


@pytest.mark.parametrize("kind,gravity", [
    ("roquet", (0.0, 0.0, -1.0)), ("teos10", (0.0, 0.0, -1.0)),
    ("polynomial", (0.0, 0.0, -1.0)),
    ("teos10", (np.sin(0.05), 0.0, -np.cos(0.05))),
    ("linear", (0.0, np.sin(0.1), -np.cos(0.1)))],
    ids=["roquet", "teos10", "polynomial", "teos10-tilted-x", "linear-tilted-y"])
def test_hydrostatic_seawater_buoyancy_matches_jax(kind, gravity):
    """pHY′ after ``initial_state`` (K4a's plain version) within 1e-13 and
    10 steps within 1e-9; tilted gravity enters through −ĝ_z b only."""
    jm, tm = hydro_models(kind, gravity)
    assert tm.tracer_names == jm.tracer_names == ("T", "S")
    vals = hydro_values(tm.grid.shape, 3)
    js, ts = jinit(jm, vals), tm.initial_state(**vals)
    close(jm.grid.interior(js["pHY"]), tm.grid.interior(ts["pHY"]).numpy(), 1e-13)
    step = jax.jit(jm.step)
    for _ in range(10):
        js, ts = step(js, 600.0), tm.step(ts, 600.0)
    for name in ("u", "v", "T", "S"):
        close(jm.grid.interior(js["solution"][name]),
              tm.grid.interior(ts["solution"][name]).numpy(), 1e-9)
    close(js["eta"], ts["eta"].numpy(), 1e-9)


@pytest.mark.parametrize("kind", ["roquet", "teos10"])
def test_nonhydrostatic_rk3_with_nonlinear_eos_matches_jax(kind):
    """The JAX suite's ``test_nonlinear_eos_in_model_runs`` configuration
    (8³, its default centred advection, RK3 here), 10 steps within 1e-9."""
    je, te = eos_pair(kind)
    kw = dict(size=(8, 8, 8), extent=(1, 1, 1))
    jg = J.RectilinearGrid(topology=("periodic", "periodic", "bounded"),
                           dtype=jnp.float64, **kw)
    tg = T.RectilinearGrid(topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                           dtype=torch.float64, device=DEVICE, **kw)
    jm = J.NonhydrostaticModel(jg, timestepper="RungeKutta3",
                               buoyancy=jb.SeawaterBuoyancy(equation_of_state=je),
                               fused_advection=False)
    tm = T.NonhydrostaticModel(tg, timestepper="RungeKutta3",
                               buoyancy=T.SeawaterBuoyancy(equation_of_state=te))
    rng = np.random.default_rng(4)
    vals = dict(T=lambda x, y, z: 12.0 + z, S=35.0,
                u=1e-2 * rng.standard_normal(tg.shape))
    js, ts = jinit(jm, vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(10):
        js, ts = step(js, 1e-3), tm.step(ts, 1e-3)
    for name in ("u", "v", "w", "T", "S"):
        close(jg.interior(js["solution"][name]),
              tg.interior(ts["solution"][name]).numpy(), 1e-9)
