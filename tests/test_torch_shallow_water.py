"""Port parity: the shallow-water model and its fused core (K3a).

The JAX side is the plain path (``fused_advection`` stays False on the
CPU). K3a's plain version, ``fused_shallow_water_tendencies_reference``,
is held against the JAX ``_core_tendencies`` on 24×16 grids (so a swapped
axis cannot pass), one case each for periodic, bounded-x and bounded-y
grids, 0 and 2 tracers, and with and without bathymetry: bitwise, the
expression trees are the same. Whole models step 10 times in both
packages, the conservative form with ``FPlane`` and
``ScalarDiffusivity`` and the vector-invariant form with each of its four
schemes: ≤ 1e-12 of max|ref|, since XLA's compiled step reassociates a
little where eager PyTorch does not. Σh is conserved, and states pass
between the packages both ways.

The ``cuda`` cases hold the CUDA kernel against the plain version on the
card (``python -m pytest --noconftest -m cuda
tests/test_torch_shallow_water.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.interop import state_from_numpy, state_to_numpy
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection.vector_invariant import (
        VectorInvariant as JVectorInvariant)
    from clima_oceananigans_jl_tpu.closures.scalar_diffusivity import (
        ScalarDiffusivity as JScalarDiffusivity)
    from clima_oceananigans_jl_tpu.coriolis.coriolis import FPlane as JFPlane
    from clima_oceananigans_jl_tpu.models.shallow_water import (
        ShallowWaterModel as JShallowWaterModel, _core_tendencies as j_core)
    from clima_oceananigans_jl_tpu.timesteppers.steppers import Clock as JClock
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"


RTOL = 1e-12
DT = 1e-2
G = 9.5
TOPOLOGIES = {"periodic": "pp", "bounded-x": "bp", "bounded-y": "pb"}


def grids(topo="pp", size=(24, 16)):
    """The same 2D grid in both packages (x and y of different extents)."""
    pick = lambda mod, t: {"p": mod.PERIODIC, "b": mod.BOUNDED}[t]
    jg = J.RectilinearGrid(size=size + (1,), x=(0, 2 * np.pi), y=(0, 1.5),
                           topology=tuple(pick(J, t) for t in topo) + (J.FLAT,),
                           dtype=jnp.float64)
    tg = T.RectilinearGrid(size=size + (1,), x=(0, 2 * np.pi), y=(0, 1.5),
                           topology=tuple(pick(T, t) for t in topo) + (T.FLAT,),
                           dtype=torch.float64, device=DEVICE)
    return jg, tg


def core_inputs(shape, ntracers, bathymetry, seed=0):
    rng = np.random.default_rng(seed)
    uh, vh = (0.1 * rng.standard_normal(shape) for _ in range(2))
    h = 1.0 + 0.1 * rng.standard_normal(shape)
    tracers = [rng.standard_normal(shape) for _ in range(ntracers)]
    hB = 0.1 * rng.standard_normal(shape) if bathymetry else None
    return uh, vh, h, tracers, hB


def interiors(grid, outs):
    return [np.asarray(grid.interior(o)) for o in outs]


@pytest.mark.parametrize("bathymetry", [False, True], ids=["flat", "bathymetry"])
@pytest.mark.parametrize("ntracers", [0, 2])
@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_core_plain_version_matches_jax_bitwise(topo, ntracers, bathymetry):
    jg, tg = grids(TOPOLOGIES[topo])
    jm = JShallowWaterModel(jg, gravitational_acceleration=G, advection=J.WENO5())
    tm = T.ShallowWaterModel(tg, gravitational_acceleration=G, advection=T.WENO5())
    assert tm.grid.total_shape == jm.grid.total_shape == (30, 22, 1)
    uh, vh, h, trs, hB = core_inputs(tm.grid.total_shape, ntracers, bathymetry)
    ja, ta = jnp.asarray, torch.as_tensor
    ref = j_core(jm.grid, J.WENO5(), J.WENO5(), G, ja(uh), ja(vh), ja(h),
                 [ja(c) for c in trs], None if hB is None else ja(hB))
    got = tft.fused_shallow_water_tendencies_reference(
        tm.grid, T.WENO5(), T.WENO5(), G, ta(uh), ta(vh), ta(h),
        [ta(c) for c in trs], None if hB is None else ta(hB))
    assert len(got) == 3 + ntracers
    for r, g in zip(interiors(jm.grid, ref), interiors(tm.grid, got)):
        assert np.array_equal(r, g)


@pytest.mark.parametrize("schemes", ["weno5/centered", "centered/weno5"])
def test_core_plain_version_mixed_schemes_match_jax(schemes):
    jg, tg = grids("bp")
    pick = {"weno5": (J.WENO5(), T.WENO5()),
            "centered": (J.CenteredSecondOrder(), T.CenteredSecondOrder())}
    (jm_s, tm_s), (jt_s, tt_s) = (pick[s] for s in schemes.split("/"))
    tm = T.ShallowWaterModel(tg, advection=tm_s, tracer_advection=tt_s)
    jm = JShallowWaterModel(jg, advection=jm_s, tracer_advection=jt_s)
    uh, vh, h, trs, hB = core_inputs(tm.grid.total_shape, 1, True, seed=1)
    ja, ta = jnp.asarray, torch.as_tensor
    ref = j_core(jm.grid, jm_s, jt_s, G, ja(uh), ja(vh), ja(h), [ja(trs[0])],
                 ja(hB))
    got = tft.fused_shallow_water_tendencies_reference(
        tm.grid, tm_s, tt_s, G, ta(uh), ta(vh), ta(h), [ta(trs[0])], ta(hB))
    for r, g in zip(interiors(jm.grid, ref), interiors(tm.grid, got)):
        assert np.array_equal(r, g)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    _, tg = grids("pb")
    tm = T.ShallowWaterModel(tg)
    args = [torch.as_tensor(a) for a in core_inputs(tm.grid.total_shape, 0,
                                                      False)[:3]]
    before = tft.fused_shallow_water_tendencies.launches
    got = tft.fused_shallow_water_tendencies(tm.grid, T.WENO5(), T.WENO5(), G,
                                             *args)
    ref = tft.fused_shallow_water_tendencies_reference(tm.grid, T.WENO5(),
                                                       T.WENO5(), G, *args)
    assert tft.fused_shallow_water_tendencies.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_kernel_arguments_refuse_what_the_kernel_does_not_take():
    _, tg = grids("bb")
    grid = T.ShallowWaterModel(tg).grid
    with pytest.raises(ValueError):
        tft.shallow_water_args(grid, T.WENO5(), T.WENO5(), 17, G)
    with pytest.raises(ValueError):
        tft.shallow_water_args(grid, object(), T.WENO5(), 3, G)
    flat_z = T.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1), device=DEVICE)
    with pytest.raises(ValueError):
        tft.shallow_water_args(flat_z, T.WENO5(), T.WENO5(), 3, G)
    # both bounded axes carry WENO5's bounds; the tracers' scheme flag is 0
    args = tft.shallow_water_args(grid, T.WENO5(), T.CenteredSecondOrder(),
                                  4, G)
    nx, ny, hx, hy = args[1:5]
    assert args[5:7] == (1, 0)
    # (masked, left lo/hi, right lo/hi) of reduced_order_masks, x then y
    assert args[7:12] == (1, hx + 3, hx + nx - 3, hx + 2, hx + nx - 4)
    assert args[12:17] == (1, hy + 3, hy + ny - 3, hy + 2, hy + ny - 4)
    assert args[31] == G and args[32:] == (0.0, 0.0, 0.0, 0.0)
    _, periodic = grids("pp")
    periodic = T.ShallowWaterModel(periodic).grid
    assert tft.shallow_water_args(periodic, T.WENO5(), T.WENO5(), 3,
                                  G)[7:17] == (0, 0, -1, 0, -1) * 2


def conservative_models(size=(24, 16), **kw):
    jg, tg = grids("pp", size)
    jm = JShallowWaterModel(jg, gravitational_acceleration=10.0,
                            coriolis=JFPlane(f=1.0),
                            closure=JScalarDiffusivity(nu=1e-3, kappa=1e-3),
                            tracers=("c",), **kw)
    tm = T.ShallowWaterModel(tg, gravitational_acceleration=10.0,
                             coriolis=T.FPlane(f=1.0),
                             closure=T.ScalarDiffusivity(nu=1e-3, kappa=1e-3),
                             tracers=("c",), **kw)
    return jm, tm


def initial_values(model, seed=0):
    rng = np.random.default_rng(seed)
    shape = model.grid.shape
    un, vn = model.prognostic_names()[:2]
    return {un: 0.1 * rng.standard_normal(shape),
            vn: 0.1 * rng.standard_normal(shape),
            "h": 1.0 + 0.05 * rng.standard_normal(shape),
            "c": rng.standard_normal(shape)}


def compare(jm, js, tm, ts, rtol=RTOL):
    for name in tm.prognostic_names():
        ref = np.asarray(jm.grid.interior(js["solution"][name]))
        got = tm.grid.interior(ts["solution"][name]).numpy()
        err, scale = np.abs(ref - got).max(), np.abs(ref).max()
        assert err <= rtol * scale, (name, err, scale)
    assert ts["clock"].iteration == int(js["clock"].iteration)
    assert ts["clock"].time == pytest.approx(float(js["clock"].time), rel=1e-12)


def run_both(jm, tm, steps, js, ts):
    step = jax.jit(jm.step)
    for _ in range(steps):
        js = step(js, DT)
        ts = tm.step(ts, DT)
    return js, ts


def test_conservative_fplane_diffusion_ten_steps_match():
    jm, tm = conservative_models()
    assert not jm.fused_advection
    assert tm.grid.halo == jm.grid.halo == (3, 3, 0)
    vals = initial_values(tm)
    js = jm.initial_state(**{k: jnp.asarray(v) for k, v in vals.items()})
    ts = tm.initial_state(**vals)
    assert set(ts) == {"solution", "clock"}
    js, ts = run_both(jm, tm, 10, js, ts)
    compare(jm, js, tm, ts)
    assert ts["clock"].stage == 0
    for a in ts["solution"].values():
        assert a.shape == tm.grid.total_shape and bool(torch.isfinite(a).all())


@pytest.mark.parametrize("scheme", ["enstrophy", "energy", "weno",
                                    "weno_velocity"])
def test_vector_invariant_ten_steps_match(scheme):
    jg, tg = grids("pp")
    jm = JShallowWaterModel(jg, gravitational_acceleration=10.0,
                            formulation="vector_invariant",
                            advection=JVectorInvariant(scheme),
                            coriolis=JFPlane(f=1.0),
                            closure=JScalarDiffusivity(nu=1e-3, kappa=1e-3),
                            tracers=("c",))
    tm = T.ShallowWaterModel(tg, gravitational_acceleration=10.0,
                             formulation="vector_invariant",
                             advection=T.VectorInvariant(scheme),
                             coriolis=T.FPlane(f=1.0),
                             closure=T.ScalarDiffusivity(nu=1e-3, kappa=1e-3),
                             tracers=("c",))
    assert tm.prognostic_names() == ("u", "v", "h", "c")
    assert tm.grid.halo == jm.grid.halo
    vals = initial_values(tm, seed=1)
    js = jm.initial_state(**{k: jnp.asarray(v) for k, v in vals.items()})
    ts = tm.initial_state(**vals)
    js, ts = run_both(jm, tm, 10, js, ts)
    compare(jm, js, tm, ts)


def test_vector_invariant_refuses_an_unknown_scheme():
    with pytest.raises(ValueError):
        T.VectorInvariant("upwind")


def test_total_height_is_conserved():
    _, tm = conservative_models()
    ts = tm.initial_state(**initial_values(tm, seed=2))
    total = lambda s: float(tm.grid.interior(s["solution"]["h"]).sum())
    vol0 = total(ts)
    for _ in range(10):
        ts = tm.step(ts, DT)
    assert abs(total(ts) - vol0) <= 1e-12 * abs(vol0)


@pytest.mark.parametrize("topo", ["bounded-x", "bounded-y"])
def test_bounded_with_bathymetry_matches(topo):
    jg, tg = grids(TOPOLOGIES[topo], (16, 24))
    shape = (16 + 6, 24 + 6, 1)
    hB = 0.05 * np.random.default_rng(3).standard_normal(shape)
    jm = JShallowWaterModel(jg, gravitational_acceleration=10.0,
                            bathymetry=jnp.asarray(hB), tracers=("c",))
    tm = T.ShallowWaterModel(tg, gravitational_acceleration=10.0,
                             bathymetry=hB, tracers=("c",))
    vals = initial_values(tm, seed=4)
    js = jm.initial_state(**{k: jnp.asarray(v) for k, v in vals.items()})
    ts = tm.initial_state(**vals)
    js, ts = run_both(jm, tm, 5, js, ts)
    compare(jm, js, tm, ts)


def test_state_round_trip_through_numpy():
    jm, tm = conservative_models()
    vals = initial_values(tm, seed=5)
    js = jm.initial_state(**{k: jnp.asarray(v) for k, v in vals.items()})
    js = jax.jit(jm.step)(js, DT)
    ts = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
    assert set(ts) == {"solution", "clock"} and ts["clock"].iteration == 1
    compare(jm, js, tm, ts, rtol=0.0)  # the conversion itself is exact
    js, ts = run_both(jm, tm, 3, js, ts)
    compare(jm, js, tm, ts)
    back = state_to_numpy(ts)
    assert set(back) == {"solution", "clock"}
    jstate = dict(solution={k: jnp.asarray(v) for k, v in back["solution"].items()},
                  clock=JClock(jnp.asarray(back["clock"].time),
                               jnp.asarray(back["clock"].iteration)))
    js2 = jax.jit(jm.step)(jstate, DT)
    ts2 = tm.step(ts, DT)
    compare(jm, js2, tm, ts2)


def test_diagnostics_match():
    jm, tm = conservative_models()
    vals = initial_values(tm, seed=6)
    js = jm.initial_state(**{k: jnp.asarray(v) for k, v in vals.items()})
    ts = tm.initial_state(**vals)
    assert tm.cell_advection_timescale(ts) == pytest.approx(
        float(jm.cell_advection_timescale(js)), rel=1e-14)
    assert tm.cell_diffusion_timescale(ts) == pytest.approx(
        float(jm.cell_diffusion_timescale(js)), rel=1e-14)
    for k in ("u", "v"):
        assert np.array_equal(np.asarray(jm.grid.interior(jm.velocities(js)[k])),
                              tm.grid.interior(tm.velocities(ts)[k]).numpy())
    assert set(tm.fields(ts)) == {"uh", "vh", "h", "c"}


def test_forcing_and_particles_are_refused():
    """Forcing builds (it was refused before the shallow-water forcing came);
    so do particles (refused before they were ported), which ride in the
    state and move with the flow."""
    _, tg = grids("pp")
    m = T.ShallowWaterModel(tg, forcing={"uh": lambda *a: 0.0})
    assert set(m.forcing) == {"uh"}
    x = torch.full((4,), 0.5, dtype=tg.dtype)
    p = T.LagrangianParticles(x, x.clone(), torch.zeros_like(x))
    mp = T.ShallowWaterModel(tg, particles=p)
    state = mp.initial_state(uh=1.0)
    assert state["particles"] is p
    assert torch.all(mp.step(state, 0.01)["particles"].x > 0.5)
    three_d = T.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1), device=DEVICE)
    with pytest.raises(ValueError):
        T.ShallowWaterModel(three_d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,topo,ntracers,bathymetry,rtol", [
    (torch.float64, "pp", 0, False, 1e-13),
    (torch.float64, "bb", 2, True, 1e-13),
    (torch.float32, "pb", 1, True, 1e-6)],
    ids=["f64-periodic", "f64-bounded-tracers-bathymetry", "f32-bounded-y"])
def test_cuda_kernel_matches_plain_version(dtype, topo, ntracers, bathymetry,
                                           rtol):
    """K3a against its plain version on the card, at the chip_smoke
    tolerances (PyTorch's CUDA division by a Python scalar multiplies by
    the reciprocal, so the two agree to rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tg = T.RectilinearGrid(size=(48, 40, 1), x=(0, 2 * np.pi), y=(0, 1.5),
                           topology=tuple({"p": T.PERIODIC, "b": T.BOUNDED}[t]
                                          for t in topo) + (T.FLAT,),
                           dtype=dtype, device="cuda").with_halo((3, 3, 0))
    uh, vh, h, trs, hB = core_inputs(tg.total_shape, ntracers, bathymetry)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    args = (tg, T.WENO5(), T.WENO5(), G, as_t(uh), as_t(vh), as_t(h),
            [as_t(c) for c in trs], None if hB is None else as_t(hB))
    before = tft.fused_shallow_water_tendencies.launches
    got = tft.fused_shallow_water_tendencies(*args)
    torch.cuda.synchronize()
    assert tft.fused_shallow_water_tendencies.launches == before + 1
    ref = tft.fused_shallow_water_tendencies_reference(*args)
    for g, r in zip(got, ref):
        halo = g.clone()
        halo[tg.interior_slices] = 0
        assert not halo.any(), "the kernel wrote outside the interior"
        gi, ri = g[tg.interior_slices], r[tg.interior_slices]
        assert float((gi - ri).abs().max()) <= rtol * float(ri.abs().max())


def smooth_or_zero_inputs(shape, kind, ntracers, bathymetry):
    """The path's kind of fields: smooth (uh ~ 0.1, vh ~ 1e-7, h ~ 1), where
    WENO5's weights fall to ~1e-24, or zero (h = 1); numpy, with halos."""
    i = np.arange(shape[0])[:, None, None] * (2 * np.pi / shape[0])
    j = np.arange(shape[1])[None, :, None] * (2 * np.pi / shape[1])
    ones = np.ones(shape)
    if kind == "zero":
        z = 0.0 * ones
        return (z, z, ones, [z] * ntracers, z if bathymetry else None)
    uh = 0.1 * np.sin(i) * np.cos(j) * ones
    vh = 1e-7 * np.sin(i) * np.sin(j) * ones
    h = 1.0 + 1e-5 * np.cos(i) * np.cos(j) * ones
    tracers = [np.cos(i + m) * ones for m in range(ntracers)]
    hB = 0.01 * np.sin(j) * ones if bathymetry else None
    return uh, vh, h, tracers, hB


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("fields,topo,size,ntracers,bathymetry", [
    ("smooth", "bp", (70, 45), 2, True),
    ("zero", "pb", (33, 130), 1, True),
    ("smooth", "bb", (17, 65), 0, False),
    ("zero", "pp", (40, 70), 2, False)],
    ids=["smooth-bounded-x", "zero-bounded-y", "smooth-bounded-xy", "zero-periodic"])
def test_cuda_kernel_is_bitwise_its_plain_version(dtype, fields, topo, size,
                                                  ntracers, bathymetry):
    """K3a bit for bit against its plain version on the card, on smooth and
    all-zero fields (where IEEE division would take its slow path), on
    sizes that are not multiples of its 16×64 tile, with a bounded wall on
    each axis; the halos are zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tg = T.RectilinearGrid(size=size + (1,), x=(0, 2 * np.pi), y=(0, 1.5),
                           topology=tuple({"p": T.PERIODIC, "b": T.BOUNDED}[t]
                                          for t in topo) + (T.FLAT,),
                           dtype=dtype, device="cuda").with_halo((3, 3, 0))
    uh, vh, h, trs, hB = smooth_or_zero_inputs(tg.total_shape, fields, ntracers,
                                               bathymetry)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    args = (tg, T.WENO5(), T.WENO5(), G, as_t(uh), as_t(vh), as_t(h),
            [as_t(c) for c in trs], None if hB is None else as_t(hB))
    got = tft.fused_shallow_water_tendencies(*args)
    ref = tft.fused_shallow_water_tendencies_reference(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        halo = g.clone()
        halo[tg.interior_slices] = 0
        assert not halo.any(), "the kernel wrote a nonzero halo"
        assert torch.equal(g[tg.interior_slices], r[tg.interior_slices])
