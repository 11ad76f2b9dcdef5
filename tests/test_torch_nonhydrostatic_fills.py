"""Port parity: the nonhydrostatic model's halo fills through K6.

The model's ``update_state`` and general projection fill halos through
``kernels["fill"]``: ``fused_fill_halos`` (K6) whatever the BCs' values
(scalars, planes, callables, gradients), and K6's plain version,
``fill_halos`` field by field, only under ``fused_advection=False``
(``PLAIN``). Here, in f64 on the CPU (where K6's wrapper runs its plain
version):

- the ``fill`` entries of ``KERNELS`` and ``PLAIN``, and that the
  constructor puts K6 in ``kernels["fill"]`` for every configuration,
  gradient BCs and plane and callable values included;
- two calls of ``kernels["fill"]`` in ``update_state`` (u, v, w and the
  tracers, then pHY′) and two in the general projection (the copies of
  u, v, w, then pNHS), so 2 a step on AB2, 6 on RK3 and 12 on RK3 with
  the general projection;
- ``update_state`` and the general projection against the JAX package's
  (its plain path, ``fused_advection=False``): the filled fields bitwise,
  pHY′ to 1e-13 of max|ref| and the projection to 1e-12 (the cumulative
  sums and the FFTs round differently);
- flux BCs with values: accepted, filled by K6 and stepped as the JAX
  package steps them.

The ``cuda`` case runs the same steps on the card through K6 and through
its plain version and holds them bitwise
(``python -m pytest --noconftest -m cuda tests/test_torch_nonhydrostatic_fills.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.boundary_conditions import bcs as tbcs
from clima_oceananigans_jl_torch.models import nonhydrostatic as tnm
from clima_oceananigans_jl_torch.ops import fused_fill as tff

try:  # the cuda case also runs on a machine without JAX
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
    from clima_oceananigans_jl_tpu.closures import scalar_diffusivity as jsd
    from clima_oceananigans_jl_tpu.coriolis import coriolis as jcor
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
SIZE = (16, 12, 10)
DT = 1e-3

#: (timestepper, flagship options, w walls, b's top wall) of each
#: configuration: the bench AB2, the RK3 flagship, the flagship with FluxBC
#: w walls (the general projection), and with a gradient on b's top wall
CONFIGS = {
    "ab2": ("QuasiAdamsBashforth2", False, None, None),
    "rk3": ("RungeKutta3", True, None, None),
    "flux walls": ("RungeKutta3", True, "flux", None),
    "gradient": ("RungeKutta3", True, "flux", "gradient"),
}
#: each configuration's fill route and fill calls a step
ROUTES = {"ab2": ("K6", 2), "rk3": ("K6", 6), "flux walls": ("K6", 12),
          "gradient": ("K6", 12)}


def boundary_conditions(mod, walls, b_top):
    out = {}
    if walls == "flux":
        out["w"] = mod.FieldBCs(bottom=mod.FluxBC(), top=mod.FluxBC())
    if b_top == "gradient":
        out["b"] = mod.FieldBCs(top=mod.GradientBC(1e-3))
    elif b_top == "callable":
        out["b"] = mod.FieldBCs(top=mod.ValueBC(lambda x, y, t: 1e-4 + 0 * x))
    elif b_top == "plane":
        out["b"] = mod.FieldBCs(top=mod.ValueBC(1e-4 * np.ones(SIZE[:2])))
    elif b_top == "flux":
        out["b"] = mod.FieldBCs(top=mod.FluxBC(1e-5))
        out["u"] = mod.FieldBCs(top=mod.FluxBC(lambda x, y, t: -1e-4 + 0 * x * y))
    return out


def torch_model(config, device=DEVICE, size=SIZE, b_top=None, **kw):
    timestepper, flagship, walls, b_top0 = CONFIGS[config]
    b_top = b_top or b_top0
    grid = T.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                             topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                             dtype=torch.float64, device=device)
    extra = dict(coriolis=T.FPlane(f=1e-4),
                 closure=T.ScalarDiffusivity(nu=1e-5, kappa=1e-5)) if flagship else {}
    return T.NonhydrostaticModel(
        grid, advection=T.WENO5(), buoyancy=T.BuoyancyTracer(),
        boundary_conditions=boundary_conditions(tbcs, walls, b_top),
        timestepper=timestepper, **extra, **kw)


def jax_model(config):
    timestepper, flagship, walls, b_top = CONFIGS[config]
    grid = J.RectilinearGrid(size=SIZE, extent=(1.0, 1.0, 1.0),
                             topology=("periodic", "periodic", "bounded"),
                             dtype=jnp.float64)
    extra = dict(coriolis=jcor.FPlane(f=1e-4),
                 closure=jsd.ScalarDiffusivity(nu=1e-5, kappa=1e-5)) if flagship else {}
    return NonhydrostaticModel(
        grid, advection=J.WENO5(), buoyancy=BuoyancyTracer(),
        boundary_conditions=boundary_conditions(jbcs, walls, b_top),
        timestepper=timestepper, fused_advection=False, **extra)


def spy(calls, fill):
    """``fill`` that records the number of fields of each call."""
    def run(grid, fields):
        calls.append(len(fields))
        return fill(grid, fields)
    return run


def random_solution(shape, seed):
    """Random with-halo u, v, w, b (numpy), halos included."""
    rng = np.random.default_rng(seed)
    return {n: s * rng.standard_normal(shape)
            for n, s in (("u", 1e-2), ("v", 1e-2), ("w", 1e-3), ("b", 1e-4))}


def close(ref, got, rtol, what):
    ref, got = np.asarray(ref), np.asarray(got)
    err, scale = np.abs(ref - got).max(), np.abs(ref).max()
    assert err <= rtol * scale, (what, err, scale)


def test_fill_entries_are_k6_and_its_plain_version():
    assert tnm.KERNELS["fill"] is tff.fused_fill_halos
    assert tnm.PLAIN["fill"] is tff.fused_fill_halos_reference
    assert set(tnm.KERNELS) == set(tnm.PLAIN)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_the_constructor_fixes_the_fill_route(config):
    """Every configuration fills through K6 (``KERNELS``), a gradient wall
    included."""
    model = torch_model(config)
    assert ROUTES[config][0] == "K6"
    assert model.kernels is tnm.KERNELS
    assert model.kernels["fill"] is tff.fused_fill_halos
    assert model._fill_unsupported_reason() is None
    assert not hasattr(model, "fill_route")


@pytest.mark.parametrize("kw", [dict(fused_advection=False)],
                         ids=["fused_advection=False"])
def test_other_configurations_keep_fill_halos(kw):
    """fused_advection=False runs every plain version, the fills too."""
    model = torch_model("rk3", **kw)
    assert model.kernels is tnm.PLAIN
    assert model.kernels["fill"] is tff.fused_fill_halos_reference
    model.step(model.initial_state(b=1e-4), DT)


@pytest.mark.parametrize("b_top", ["gradient", "callable", "plane"])
def test_k6_takes_gradients_and_plane_and_callable_values(b_top):
    """A gradient, a callable value and a plane value on b's top wall: the
    model fills through K6 (its gate takes them), and a step runs."""
    model = torch_model("rk3", b_top=b_top)
    assert model._fill_unsupported_reason() is None
    assert model.kernels["fill"] is tff.fused_fill_halos
    state = model.step(model.initial_state(b=1e-4), DT)
    assert all(torch.isfinite(a).all() for a in state["solution"].values())


@pytest.mark.parametrize("config", list(CONFIGS))
def test_fill_calls_a_step(config):
    model = torch_model(config)
    state = model.initial_state(u=1e-2, b=1e-4)
    calls = []
    fill = spy(calls, model.kernels["fill"])
    model.step(state, DT, {"fill": fill})
    assert len(calls) == ROUTES[config][1]
    # update_state: u, v, w, b in one call, then pHY′
    assert calls[-2:] == [4, 1]
    if config in ("flux walls", "gradient"):
        # the general projection: the copies of u, v, w, then pNHS
        assert calls[:2] == [3, 1]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_update_state_through_the_fill_entry_matches_jax(config):
    jm, tm = jax_model(config), torch_model(config)
    sol = random_solution(tm.grid.total_shape, seed=11)
    ts = tm.initial_state()
    ts["solution"] = {n: torch.as_tensor(a.copy()) for n, a in sol.items()}
    js = jm.initial_state()
    js["solution"] = {n: jnp.asarray(a) for n, a in sol.items()}
    calls = []
    tout = tm.update_state(ts, {"fill": spy(calls, tm.kernels["fill"])})
    jout = jm.update_state(js)
    assert calls == [4, 1]
    for n in ("u", "v", "w", "b"):
        assert np.array_equal(np.asarray(jout["solution"][n]),
                              tout["solution"][n].numpy()), n
    close(jout["pHY"], tout["pHY"].numpy(), 1e-13, "pHY with halos")


@pytest.mark.parametrize("config", ["flux walls", "gradient"])
def test_general_projection_through_the_fill_entry_matches_jax(config):
    jm, tm = jax_model(config), torch_model(config)
    assert not tm._fast_projection_ok() and not jm._fast_projection_ok()
    sol = random_solution(tm.grid.total_shape, seed=12)
    ts = dict(tm.initial_state(), solution={n: torch.as_tensor(a.copy())
                                            for n, a in sol.items()})
    js = dict(jm.initial_state(), solution={n: jnp.asarray(a)
                                            for n, a in sol.items()})
    calls = []
    tout = tm.project_velocities(ts, DT, {"fill": spy(calls, tm.kernels["fill"])})
    jout = jm._project_velocities_general(js, DT)
    assert calls == [3, 1]
    for n in ("u", "v", "w"):
        close(jm.grid.interior(jout["solution"][n]),
              tm.grid.interior(tout["solution"][n]).numpy(), 1e-12, n)
        # the projection writes into none of its inputs
        assert np.array_equal(ts["solution"][n].numpy(), sol[n]), n
    close(jout["pNHS"], tout["pNHS"].numpy(), 1e-12, "pNHS with halos")


@pytest.mark.parametrize("timestepper", ["RungeKutta3", "QuasiAdamsBashforth2"])
def test_flux_bcs_with_values_fill_through_k6_and_match_jax(timestepper):
    """A scalar flux on b's top wall and a callable wind stress on u's
    (written with torch and with jnp): accepted, filled through K6, off
    the fused AB2 advance (the JAX gate), and three steps agree with the
    JAX package's to 1e-9 of max|field| (the cumulative sums and FFTs)."""
    tgrid = T.RectilinearGrid(size=SIZE, extent=(1.0, 1.0, 1.0),
                              topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                              dtype=torch.float64, device=DEVICE)
    tm = T.NonhydrostaticModel(tgrid, advection=T.WENO5(), buoyancy=T.BuoyancyTracer(),
                               boundary_conditions=boundary_conditions(tbcs, None, "flux"),
                               timestepper=timestepper)
    jgrid = J.RectilinearGrid(size=SIZE, extent=(1.0, 1.0, 1.0),
                              topology=("periodic", "periodic", "bounded"),
                              dtype=jnp.float64)
    jb = {"b": jbcs.FieldBCs(top=jbcs.FluxBC(1e-5)),
          "u": jbcs.FieldBCs(top=jbcs.FluxBC(lambda x, y, t: -1e-4 + 0 * x * y))}
    jm = NonhydrostaticModel(jgrid, advection=J.WENO5(), buoyancy=BuoyancyTracer(),
                             boundary_conditions=jb, timestepper=timestepper,
                             fused_advection=False)
    assert tm.kernels["fill"] is tff.fused_fill_halos and not tm.fused_step
    sol = random_solution(tm.grid.total_shape, seed=14)
    vals = {n: a[3:-3, 3:-3, 3:-3] for n, a in sol.items()}
    ts, js = tm.initial_state(**vals), jm.initial_state(**vals)
    for _ in range(3):
        ts, js = tm.step(ts, DT), jm.step(js, DT)
    for n in ("u", "v", "w", "b"):
        close(jm.grid.interior(js["solution"][n]),
              tm.grid.interior(ts["solution"][n]).numpy(), 1e-9, n)


def test_k6_counts_no_launch_on_cpu():
    model = torch_model("flux walls")
    n0 = tff.fused_fill_halos.launches
    model.step(model.initial_state(u=1e-2, b=1e-4), DT)
    assert tff.fused_fill_halos.launches == n0


# -- on the card --------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("config", list(CONFIGS))
def test_cuda_steps_through_k6_match_its_plain_version(config):
    """Three steps of each configuration on the card with the model's
    fills (K6 on its K6 route) and with K6's plain version: bitwise, with
    the K6 launches ``ROUTES`` gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def run(fill):
        model = torch_model(config, device="cuda", size=(20, 14, 12))
        state = model.initial_state(**{n: a[3:-3, 3:-3, 3:-3] for n, a in
                                       random_solution((26, 20, 18), 13).items()})
        n0 = tff.fused_fill_halos.launches
        for _ in range(3):
            state = model.step(state, DT, None if fill is None else {"fill": fill})
        torch.cuda.synchronize()
        return state, tff.fused_fill_halos.launches - n0

    got, launches = run(None)
    route, per_step = ROUTES[config]
    assert launches == (3 * per_step if route == "K6" else 0)
    ref, _ = run(tff.fused_fill_halos_reference)
    for n in ("u", "v", "w", "b"):
        assert torch.equal(got["solution"][n], ref["solution"][n]), n
    for key in ("pHY", "pNHS"):
        assert torch.equal(got[key], ref[key]), key
