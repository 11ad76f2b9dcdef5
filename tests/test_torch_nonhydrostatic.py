"""Port parity: the nonhydrostatic step end to end.

The ``bench.py`` configuration (WENO5 momentum and buoyancy tracer,
``BuoyancyTracer``, quasi-AB2, (Periodic, Periodic, Bounded)), at 16³ and
24×16×12 in f64, built in both packages from the same numpy-seeded
initial fields and stepped 10 times; the JAX side is the plain path
(``fused_advection=False``). u, v, w, b interiors, pHY′ and pNHS must
agree to max|Δ| ≤ 1e-9·max|ref|: besides XLA's contraction (see the
other parity files), the FFT libraries and the pHY′ cumulative sum sum
in different orders, and ten steps carry those differences forward.
A restart case hands a 3-step JAX state to the port through
``state_from_numpy`` and steps both 3 more times.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
import clima_oceananigans_jl_tpu as J
from clima_oceananigans_jl_torch.interop import state_from_numpy, state_to_numpy
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
from clima_oceananigans_jl_tpu.timesteppers.steppers import Clock as JClock

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"

RTOL = 1e-9
DT = 1e-3


def models(size):
    jg = J.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                           topology=("periodic", "periodic", "bounded"),
                           dtype=jnp.float64)
    tg = T.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                           topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                           dtype=torch.float64, device=DEVICE)
    jm = NonhydrostaticModel(jg, advection=J.WENO5(), buoyancy=BuoyancyTracer(),
                             timestepper="QuasiAdamsBashforth2",
                             fused_advection=False)
    tm = T.NonhydrostaticModel(tg, advection=T.WENO5(),
                               buoyancy=T.BuoyancyTracer(),
                               timestepper="QuasiAdamsBashforth2")
    return jm, tm


def initial_values(size, seed=0):
    rng = np.random.default_rng(seed)
    return dict(u=1e-2 * rng.standard_normal(size),
                v=1e-2 * rng.standard_normal(size),
                b=1e-4 * rng.standard_normal(size))


def compare(jm, js, tm, ts, rtol=RTOL):
    for name in ("u", "v", "w", "b"):
        ref = np.asarray(jm.grid.interior(js["solution"][name]))
        got = tm.grid.interior(ts["solution"][name]).numpy()
        err, scale = np.abs(ref - got).max(), np.abs(ref).max()
        assert err <= rtol * scale, (name, err, scale)
    for key in ("pHY", "pNHS"):
        ref = np.asarray(jm.grid.interior(js[key]))
        got = tm.grid.interior(ts[key]).numpy()
        err, scale = np.abs(ref - got).max(), np.abs(ref).max()
        assert err <= rtol * scale, (key, err, scale)
    assert ts["clock"].iteration == int(js["clock"].iteration)
    assert ts["clock"].time == pytest.approx(float(js["clock"].time), rel=1e-12)


@pytest.mark.parametrize("size", [(16, 16, 16), (24, 16, 12)])
def test_bench_configuration_ten_steps_match(size):
    jm, tm = models(size)
    vals = initial_values(size)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    compare(jm, js, tm, ts)
    step = jax.jit(jm.step)
    for _ in range(10):
        js = step(js, DT)
        ts = tm.step(ts, DT)
    compare(jm, js, tm, ts)
    for a in ts["solution"].values():
        assert a.shape == tm.grid.total_shape and bool(torch.isfinite(a).all())
    assert set(ts["G_prev"]) == {"u", "v", "w", "b"}
    assert all(g.shape == tm.grid.shape for g in ts["G_prev"].values())


def test_restart_from_jax_state_matches():
    size = (16, 16, 16)
    jm, tm = models(size)
    js = jm.initial_state(**initial_values(size, seed=1))
    step = jax.jit(jm.step)
    for _ in range(3):
        js = step(js, DT)
    ts = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
    assert ts["clock"].iteration == 3 and ts["previous_dt"] == DT
    compare(jm, js, tm, ts, rtol=0.0)  # the conversion itself is exact
    for _ in range(3):
        js = step(js, DT)
        ts = tm.step(ts, DT)
    compare(jm, js, tm, ts)


def test_port_state_restarts_the_jax_model():
    """state_to_numpy keeps the port's layout (halo 3, halo-free G_prev),
    which the JAX plain step accepts."""
    size = (12, 10, 8)
    jm, tm = models(size)
    ts = tm.initial_state(**initial_values(size, seed=2))
    for _ in range(2):
        ts = tm.step(ts, DT)
    ns = state_to_numpy(ts)
    js = jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in ns.items()
                                              if k != "clock"})
    js["clock"] = JClock(jnp.asarray(ns["clock"].time),
                         jnp.asarray(ns["clock"].iteration))
    assert js["G_prev"]["u"].shape == size
    back = state_from_numpy(tm, ns)
    for k in ("u", "v", "w", "b"):
        assert torch.equal(back["solution"][k], ts["solution"][k])
        assert torch.equal(back["G_prev"][k], ts["G_prev"][k])
    js = jm.step(js, DT)
    ts = tm.step(ts, DT)
    compare(jm, js, tm, ts)


def test_euler_on_first_step_and_dt_change():
    """The Euler-or-AB2 choice is made on the host from the clock."""
    size = (8, 8, 8)
    _, tm = models(size)
    calls = []

    def spy(model, state, dt, euler):
        calls.append(euler)
        from clima_oceananigans_jl_torch.ops.fused_step import (
            fused_ab2_advance_reference)
        return fused_ab2_advance_reference(model, state, dt, euler)

    ts = tm.initial_state(**initial_values(size))
    for dt in (DT, DT, DT / 2, DT / 2):
        ts = tm.step(ts, dt, kernels={"advance": spy})
    assert calls == [True, False, True, False]
    assert ts["clock"].iteration == 4 and ts["previous_dt"] == DT / 2


@pytest.mark.parametrize("kind", ["default", "scalar", "plane", "callable"])
def test_w_wall_plane_matches(kind):
    """The w wall values the projection imposes, for each kind of value a
    w wall BC can carry."""
    from clima_oceananigans_jl_torch.boundary_conditions import bcs as tbcs
    from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs
    size = (12, 10, 8)
    value = {"default": None, "scalar": 1e-3,
             "plane": 1e-3 * np.random.default_rng(5).standard_normal((12, 10)),
             "callable": lambda x, y, t: 1e-3 * x * y + t}[kind]
    jb = tb = None
    if value is not None:
        jb = {"w": jbcs.FieldBCs(top=jbcs.ValueBC(value))}
        tb = {"w": tbcs.FieldBCs(top=tbcs.ValueBC(value))}
    jm = NonhydrostaticModel(
        J.RectilinearGrid(size=size, extent=(1, 1, 1), dtype=jnp.float64),
        advection=J.WENO5(), buoyancy=BuoyancyTracer(),
        boundary_conditions=jb, fused_advection=False)
    tm = T.NonhydrostaticModel(
        T.RectilinearGrid(size=size, extent=(1, 1, 1), dtype=torch.float64,
                          device=DEVICE),
        advection=T.WENO5(), buoyancy=T.BuoyancyTracer(),
        boundary_conditions=tb)
    for side, name in ((0, "bottom"), (1, "top")):
        ref = jm._wall_plane(getattr(jm.bcs["w"], name), side, 0.5)
        got = tm._wall_plane(getattr(tm.bcs["w"], name), side, 0.5)
        assert np.array_equal(np.asarray(ref), got.numpy())
    vals = initial_values(size)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    compare(jm, jax.jit(jm.step)(js, DT), tm, tm.step(ts, DT))
