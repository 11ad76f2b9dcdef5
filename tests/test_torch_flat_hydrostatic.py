"""Port parity: the hydrostatic model on Flat x and y axes, K4b's Cartesian
Coriolis forms, shallow-water forcing, and the port's copies of three
validations that need them.

The JAX package builds and steps hydrostatic models whose x, y or both are
Flat (its gate keeps them off its Pallas kernels and runs
``hydrostatic_advective_core`` in jnp); the port runs them through K4a,
K4b and K5, whose plain versions these tests hold against the JAX package
in float64, the same numpy-seeded inputs through both:

- the five Flat topologies (F,P,B), (F,B,B), (P,F,B), (B,F,B), (F,F,B),
  each under the explicit, the pcg and the split-explicit free surface,
  built from one dict of keywords in both packages (WENO5 or
  vector-invariant momentum, WENO5 tracers, buoyancy, a constant
  ``ScalarDiffusivity``), the explicit one under
  ``ConstantCartesianCoriolis`` and the pcg one under
  ``NonTraditionalBetaPlane`` (w is not zero: the velocities are random):
  5 steps within ``RTOL`` of max|ref|;
- the shallow-water model with the Stommel gyre's two forcing callables on
  (Bounded, Bounded, Flat), 20 RK3 steps within ``RTOL``;
- the port's copies of validation/vertical_mixing_closures.py (each
  closure), wind_mixing_column.py and barotropic_gyre.py at reduced size,
  a few steps, against JAX models built from the scripts' constants (the
  JAX scripts themselves are not run);
- the gates: K4's, K5's and K6's take every new configuration.

The ``cuda`` cases hold K4a, K4b (both forms) and K5 on each Flat
topology, and K4b with each Cartesian Coriolis form, against their plain
versions on the card bit for bit over NaN-filled outputs (``python -m
pytest --noconftest -m cuda tests/test_torch_flat_hydrostatic.py``).
"""
import math

import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.ops import fused_barotropic as tfb
from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh
from clima_oceananigans_jl_torch.validation import (barotropic_gyre,
                                                    vertical_mixing_closures,
                                                    wind_mixing_column)

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JB
    from clima_oceananigans_jl_tpu.closures import vertical_mixing as jvm
    from clima_oceananigans_jl_tpu.models import free_surface as jfs
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    from clima_oceananigans_jl_tpu.models.shallow_water import ShallowWaterModel as JSW
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
F_, P_, B_ = "flat", "periodic", "bounded"
#: the Flat topologies and their sizes here
TOPOLOGIES = {"FPB": ((F_, P_, B_), (1, 12, 6)), "FBB": ((F_, B_, B_), (1, 11, 5)),
              "PFB": ((P_, F_, B_), (12, 1, 6)), "BFB": ((B_, F_, B_), (11, 1, 5)),
              "FFB": ((F_, F_, B_), (1, 1, 8))}
#: free surface, momentum and Coriolis of each case
CASES = {"explicit": ("WENO5", "cartesian"), "pcg": ("VectorInvariant", "non-traditional"),
         "split": ("WENO5", "beta")}


def coriolis(kind, pkg):
    return {"cartesian": lambda: pkg.ConstantCartesianCoriolis(fx=2e-5, fy=5e-5, fz=1e-4),
            "non-traditional": lambda: pkg.NonTraditionalBetaPlane(
                fz0=1e-4, fy0=5e-5, beta=1.6e-11, gamma=-1e-11),
            "beta": lambda: pkg.BetaPlane(f0=1e-4, beta=1.6e-11)}[kind]()


def free_surface(kind, jax_pkg):
    mod = jfs if jax_pkg else T
    return {"explicit": lambda: mod.ExplicitFreeSurface(),
            "pcg": lambda: mod.ImplicitFreeSurface(solver_method="pcg"),
            "split": lambda: mod.SplitExplicitFreeSurface(substeps=8)}[kind]()


def model_kw(topo, fs, pkg):
    """One dict of keywords for either package's hydrostatic model."""
    topology, size = TOPOLOGIES[topo]
    momentum, cor = CASES[fs]
    jax_pkg = pkg is not T
    grid = pkg.RectilinearGrid(size=size, x=(0, 2e6), y=(0, 1e6), z=(-1000, 0),
                               topology=topology,
                               **(dict(dtype=jnp.float64) if jax_pkg
                                  else dict(dtype=torch.float64, device=DEVICE)))
    return dict(grid=grid, momentum_advection=getattr(pkg, momentum)(),
                tracer_advection=pkg.WENO5(), tracers=("T",),
                buoyancy=JB() if jax_pkg else T.BuoyancyTracer(),
                coriolis=coriolis(cor, pkg),
                closure=pkg.ScalarDiffusivity(nu=1e2, kappa=1e1, nu_z=1e-3, kappa_z=1e-4),
                free_surface=free_surface(fs, jax_pkg))


def random_values(shape, seed):
    rng = np.random.default_rng(seed)
    return dict(u=0.1 * rng.standard_normal(shape), v=0.1 * rng.standard_normal(shape),
                T=rng.standard_normal(shape), b=1e-3 * rng.standard_normal(shape))


def assert_close(jg, js, tg, ts, names, rtol=RTOL):
    for k in names:
        ref = np.asarray(jg.interior(js["solution"][k]))
        got = tg.interior(ts["solution"][k]).numpy()
        assert np.isfinite(got).all(), k
        assert np.abs(ref - got).max() <= rtol * np.abs(ref).max(), (
            k, np.abs(ref - got).max(), np.abs(ref).max())


@pytest.mark.parametrize("fs", list(CASES))
@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_flat_models_match_jax(topo, fs):
    """5 steps of each Flat topology under each free surface (the explicit
    one with ConstantCartesianCoriolis, the pcg one with
    NonTraditionalBetaPlane) against the JAX model, within RTOL; w is not
    zero, so the Cartesian forms' w terms take part."""
    jm = JH(**model_kw(topo, fs, J), fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(**model_kw(topo, fs, T))
    assert tm.grid.halo == jm.grid.halo
    vals = random_values(tm.grid.shape, 7)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    # w from continuity is not zero where a horizontal axis is not Flat
    assert (float(ts["w"].abs().max()) > 0) == (topo != "FFB")
    step = jax.jit(jm.step)
    for _ in range(5):
        js, ts = step(js, 60.0), tm.step(ts, 60.0)
    assert_close(jm.grid, js, tm.grid, ts, ("u", "v", "T", "b"))
    ref, got = np.asarray(js["eta"]), ts["eta"].numpy()
    assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_gates_take_the_flat_topologies(topo):
    """K4's, K5's and K6's gates take each Flat topology under every free
    surface and every Coriolis form the cases use."""
    for fs in CASES:
        m = T.HydrostaticFreeSurfaceModel(**model_kw(topo, fs, T))
        assert tfh.unsupported_reason(m) is None, fs
        assert tfb.unsupported_reason(m.grid, m.eta_bcs) is None, fs
        assert m._fill_unsupported_reason() is None, fs
    g = T.RectilinearGrid(size=(8, 6, 4), x=(0, 1), y=(0, 1), z=(-1, 0),
                          topology=(P_, B_, B_), device=DEVICE)
    for kind in ("cartesian", "non-traditional"):
        m = T.HydrostaticFreeSurfaceModel(g, coriolis=coriolis(kind, T))
        assert tfh.unsupported_reason(m) is None
        assert tfh._coriolis_code(m.coriolis) == (4 if kind == "cartesian" else 5)


def j_wind_drag_u(grid, clock, fields):
    bg = barotropic_gyre
    _, y, _ = grid.nodes(("f", "c", "c"), with_halo=True)
    tau = -bg.TAU0 * jnp.cos(jnp.pi * y / bg.L)
    return (tau - bg.R * fields["uh"]) * jnp.ones_like(fields["uh"])


def j_drag_v(grid, clock, fields):
    return -barotropic_gyre.R * fields["vh"]


def jax_gyre(n):
    bg = barotropic_gyre
    grid = J.RectilinearGrid(size=(n, n, 1), x=(0.0, bg.L), y=(0.0, bg.L),
                             topology=(B_, B_, F_), dtype=jnp.float64)
    return JSW(grid=grid, gravitational_acceleration=bg.G,
               coriolis=J.BetaPlane(f0=bg.F0, beta=bg.BETA),
               forcing={"uh": j_wind_drag_u, "vh": j_drag_v})


@pytest.mark.parametrize("n, steps", [(12, 20), (16, 10)], ids=["forcing", "gyre copy"])
def test_shallow_water_forcing_matches_jax(n, steps):
    """The shallow-water model with the Stommel gyre's two forcing
    callables, built by the port's copy of validation/barotropic_gyre.py,
    against the JAX model with the same callables in jnp: ``steps`` RK3
    steps from rest at the copy's Δt, within RTOL (forcing "gyre copy" at
    the copy's reduced N = 16)."""
    bg = barotropic_gyre
    jm, tm = jax_gyre(n), bg.model_for(n, DEVICE)
    assert set(tm.forcing) == {"uh", "vh"}
    dt = bg.time_step(n)[0]
    js, ts = jm.initial_state(h=bg.H), tm.initial_state(h=bg.H)
    step = jax.jit(jm.step)
    for _ in range(steps):
        js, ts = step(js, dt), tm.step(ts, dt)
    assert float(ts["solution"]["uh"].abs().max()) > 0
    assert_close(jm.grid, js, tm.grid, ts, ("uh", "vh", "h"))


def jax_column(closure, nz):
    vmc = vertical_mixing_closures
    grid = J.RectilinearGrid(size=(1, 1, nz), x=(0, 1), y=(0, 1), z=(-vmc.H, 0.0),
                             topology=(F_, F_, B_), dtype=jnp.float64)
    return JH(grid=grid, buoyancy=JB(), momentum_advection=None, tracer_advection=None,
              closure=closure, free_surface=jfs.ImplicitFreeSurface(solver_method="pcg"),
              boundary_conditions={"b": J.FieldBCs(top=J.FluxBC(vmc.B0))})


JAX_CLOSURES = {"CATKE": lambda: jvm.CATKEVerticalDiffusivity(),
                "convective_adjustment": lambda: jvm.ConvectiveAdjustmentVerticalDiffusivity(
                    convective_kappa_z=1.0, background_kappa_z=1e-5),
                "Ri_based": lambda: jvm.RiBasedVerticalDiffusivity()}


@pytest.mark.parametrize("name", [n for n, _ in vertical_mixing_closures.CLOSURES])
def test_vertical_mixing_copy_matches_jax(name):
    """The copy's column (nz = 16) under the closure, 5 steps of its Δt,
    against the JAX model built from the script's constants, within RTOL;
    the copy's budget and gradient checks pass on its own 5 steps."""
    vmc, nz, steps = vertical_mixing_closures, 16, 5
    make = dict(vmc.CLOSURES)[name]
    tm = vmc.model_for(make(), nz, DEVICE)
    jm = jax_column(JAX_CLOSURES[name](), nz)
    ts = vmc.initial_state(tm)
    init = {"b": lambda x, y, z: vmc.N2 * z}
    if "e" in jm.tracer_names:
        init["e"] = 1e-7
    js = jm.initial_state(**init)
    step = jax.jit(jm.step)
    for _ in range(steps):
        js, ts = step(js, vmc.DT), tm.step(ts, vmc.DT)
    assert_close(jm.grid, js, tm.grid, ts, ("u", "v") + tm.tracer_names)
    _, budget, _, _, _ = vmc.run_closure(name, make(), nz, DEVICE, steps=steps,
                                         log=lambda *a: None)
    assert abs(budget - 1.0) < 0.02


def test_wind_mixing_copy_matches_jax():
    """The copy's ``Simulation`` (nz = 16, 5 iterations) against 5 steps of
    the JAX model built from the script's constants, within RTOL; the wind
    drives the top layer's u against the sign of the stress."""
    wmc, nz, steps = wind_mixing_column, 16, 5
    sim = wmc.simulation(nz, DEVICE, stop_iteration=steps, log=lambda *a: None)
    sim.run()
    grid = J.RectilinearGrid(size=(1, 1, nz), x=(0, 1), y=(0, 1), z=wmc.z_faces(nz),
                             topology=(F_, F_, B_), dtype=jnp.float64)
    jm = JH(grid=grid, free_surface=jfs.ImplicitFreeSurface(solver_method="pcg"),
            momentum_advection=None, tracer_advection=None, buoyancy=JB(),
            closure=jvm.CATKEVerticalDiffusivity(
                surface_momentum_flux=(wmc.WIND_STRESS, 0.0)),
            boundary_conditions={"u": J.FieldBCs(top=J.FluxBC(wmc.WIND_STRESS))})
    js = jm.initial_state(b=lambda x, y, z: 1e-5 * (z + 100.0) / 100.0, e=1e-7)
    step = jax.jit(jm.step)
    for _ in range(steps):
        js = step(js, wmc.DT)
    assert_close(jm.grid, js, sim.model.grid, sim.state, ("u", "v", "b", "e"))
    u_top = float(sim.model.grid.interior(sim.state["solution"]["u"])[0, 0, -1])
    assert u_top * wmc.WIND_STRESS < 0
    assert (wmc.tke_profile(sim) > 0).all()


def test_gyre_copy_checks_its_scores():
    """The copy's Stommel solution and scores on a state whose vh is the
    analytic transport itself: correlation 1, amplitude 1 within the
    cumulative sum's discretisation, the western current the stronger."""
    bg, n = barotropic_gyre, 32
    model = bg.model_for(n, DEVICE)
    state = model.initial_state(h=bg.H)
    _, psi_ana, _ = bg.stommel(model, state)
    vh = np.diff(np.concatenate([np.zeros((1, n)), psi_ana]), axis=0) / (bg.L / n)
    g = model.grid
    g.interior(state["solution"]["vh"])[:, :, 0] = torch.as_tensor(vh)
    corr, amp, ratio = bg.scores(model, state)
    assert corr == pytest.approx(1.0, abs=1e-12) and amp == pytest.approx(1.0, abs=1e-12)
    bg.check(corr, amp, ratio)
    assert math.isclose(bg.time_step(64)[0], 0.25 * (bg.L / 64) / math.sqrt(bg.G * bg.H))


# -- on the card ---------------------------------------------------------------------

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def card_model(topology, size, dtype, momentum, cor):
    grid = T.RectilinearGrid(size=size, x=(0, 2e6), y=(0, 1e6), z=(-1000, 0),
                             topology=topology, dtype=dtype, device="cuda")
    return T.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=momentum, tracer_advection=T.WENO5(), tracers=("T",),
        buoyancy=T.BuoyancyTracer(), coriolis=cor,
        closure=T.ScalarDiffusivity(nu=1e2, kappa=1e1, nu_z=1e-3, kappa_z=1e-4),
        free_surface=T.SplitExplicitFreeSurface(substeps=8))


def card_state(model, seed):
    g = model.grid
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda s: s * torch.randn(g.shape, generator=gen, dtype=g.dtype, device="cuda")
    state = model.initial_state(u=rand(0.1), v=rand(0.1), T=rand(1.0), b=rand(1e-3))
    state["G_prev"] = {k: torch.zeros_like(v) + 1e-6 for k, v in state["solution"].items()}
    return state


def poison(shape, dtype, n):
    blocks = [torch.full(shape, float("nan"), dtype=dtype, device="cuda") for _ in range(n)]
    del blocks


def hold_k4b(model, state):
    g = model.grid
    for adv in (None, (60.0, False)):
        poison(g.total_shape, g.dtype, 12)
        got = tfh.fused_hydrostatic_tendencies(model, state, adv)
        ref = tfh.fused_hydrostatic_tendencies_reference(model, state, adv)
        got, ref = (got, ref) if adv else ((got,), (ref,))
        for a, b in zip(got, ref):
            for n in b:
                assert torch.equal(g.interior(a[n]), g.interior(b[n])), (adv, n)
                halo = a[n].clone()
                halo[g.interior_slices] = 0
                assert not halo.isnan().any() and not halo.any(), (adv, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_cuda_flat_kernels_match_plain_versions(topo, dtype):
    """K4b (both forms, both momentum forms), K4a (with b and w only) and
    K5 on the Flat topology at a size off the layouts' lines, bit for bit
    over NaN-filled outputs, one launch a call."""
    needs_card()
    topology, _ = TOPOLOGIES[topo]
    size = tuple(1 if t == F_ else n for t, n in zip(topology, (131, 133, 37)))
    for momentum in (T.WENO5(), T.VectorInvariant()):
        m = card_model(topology, size, DTYPES[dtype], momentum,
                       coriolis("cartesian", T))
        state = card_state(m, 5)
        before = tfh.fused_hydrostatic_tendencies.launches
        hold_k4b(m, state)
        assert tfh.fused_hydrostatic_tendencies.launches == before + 2
    g, sol = m.grid, state["solution"]
    for b in (sol["b"], None):
        poison(g.total_shape, g.dtype, 12)
        got = tfh.hydrostatic_columns(g, sol["u"], sol["v"], b)
        ref = tfh.hydrostatic_columns_reference(g, sol["u"], sol["v"], b)
        for x, y in zip(got, ref):
            assert (x is None and y is None) or torch.equal(x, y)
    gen = torch.Generator(device="cuda").manual_seed(9)
    shape = g.total_shape[:2] + (1,)
    rand = lambda s: s * torch.randn(shape, generator=gen, dtype=g.dtype, device="cuda")
    eta = T.models.free_surface.fill2d(rand(0.1), g, T.models.free_surface.ETA_LOC,
                                       m.eta_bcs)
    wv = m.free_surface._weight_vec(None, eta)
    depths = T.models.free_surface.column_depths(g)
    args = (g, m.eta_bcs, eta, rand(10.0), rand(10.0), rand(1e-3), rand(1e-3), *depths,
            9.80665, 40.0, wv, wv, 8)
    poison(shape, g.dtype, 20)
    for x, y in zip(tfb.fused_substep_eta(*args), tfb.fused_substep_eta_reference(*args)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["cartesian", "non-traditional"])
def test_cuda_cartesian_coriolis_matches_plain_version(kind, dtype):
    """K4b with the Cartesian Coriolis form on (Periodic, Bounded, Bounded)
    at a size off the 16×8 tiles, both momentum forms and both K4b forms,
    bit for bit; 3 model steps with the kernels against 3 plain."""
    needs_card()
    for momentum in (T.WENO5(), T.VectorInvariant()):
        m = card_model((P_, B_, B_), (37, 21, 9), DTYPES[dtype], momentum,
                       coriolis(kind, T))
        state = card_state(m, 6)
        hold_k4b(m, state)
        a = b = state
        for _ in range(3):
            a, b = m.step(a, 60.0), m.step(b, 60.0, kernels=T.models.hydrostatic.PLAIN)
        for n in a["solution"]:
            assert torch.equal(a["solution"][n], b["solution"][n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("topo", ["FBB", "BFB"])
def test_cuda_flat_k4b_over_a_bottom_matches_plain_version(topo, dtype):
    """K4b in a Flat layout over an immersed bottom (the clear flags of U,
    V and CENTER: UB5 momentum, WENO5 tracers), both forms, bit for bit."""
    needs_card()
    topology, _ = TOPOLOGIES[topo]
    size = tuple(1 if t == F_ else n for t, n in zip(topology, (131, 133, 21)))
    grid = T.RectilinearGrid(size=size, x=(0, 2e6), y=(0, 1e6), z=(-1000, 0),
                             topology=topology, dtype=DTYPES[dtype], device="cuda")
    along = (lambda x, y: y - 5e5) if topology[0] == F_ else (lambda x, y: x - 1e6)
    m = T.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=T.UpwindBiasedFifthOrder(), tracer_advection=T.WENO5(),
        tracers=("T",), buoyancy=T.BuoyancyTracer(), coriolis=coriolis("beta", T),
        free_surface=T.ExplicitFreeSurface(),
        immersed_boundary=T.GridFittedBottom(
            lambda x, y: -1000.0 + 600.0 * torch.exp(-(along(x, y) / 2e5) ** 2)))
    assert tfh._mask_locs(m)
    hold_k4b(m, card_state(m, 8))
