"""Port parity: immersed boundaries in the nonhydrostatic model.

The JAX side is the plain path (``fused_advection=False``, which an
immersed JAX model takes in any case), in float64 on grids of 64 points or
fewer an axis, the same numpy-seeded inputs through both packages:

- ``clear_flags`` (``immersed/immersed.py``, K2's and K4b's input) at the
  four locations the model advects, CENTER, U, V and W, against the JAX
  ``_immersed_clear`` of every axis, bit by bit, on (Periodic, Periodic,
  Bounded) and on a Flat y (whose rolls read the cell itself);
- K2's plain version on an immersed grid against the JAX ``div_*``
  fluxes bit for bit (the interior; w's top wall face);
- ``mask_state`` and ``mask_tendency`` at every location of the model;
- the gates: the immersed model takes the general AB2 branch and the
  general projection (the JAX ``fused_step_ok`` and
  ``_fast_projection_ok``), K6 takes its fill groups, and
  ``PartialCellBottom`` is refused by name, particles build;
- the JAX suite's immersed nonhydrostatic cases (``tests/test_immersed.py``)
  in the port: the 16³ seamount stepped by quasi-AB2 and RK3 with WENO5,
  with centred advection (``advection=None``) and with ``PositiveWENO5``
  tracers, against the JAX step within ``RTOL = 1e-9`` of max|field| (the
  FFT solve and pHY′'s sums round differently), with the tracer budget
  of conditional advection; a uniform tracer under diffusion alone; the
  immersed ``FluxBC`` budget; the discrete bottom drag;
- ``validation/seamount.py`` at 64×1×32 for 20 steps: the two packages
  agree within ``RTOL`` and the validation's three checks hold in the
  port (Σc over the fluid conserved to 1e-3, |c| ≤ 1e-10 in the solid, c
  within [−1e-9, 1 + 1e-9]);
- an immersed JAX state carried into the port by ``interop`` steps as the
  port's own state does, and back into JAX as the JAX step does.

The ``cuda`` cases hold K2 on an immersed grid against its plain version
on the card bit for bit over NaN-filled outputs (fp32 and fp64, sizes off
the tiles, the 3D seamount on (Periodic, Periodic, Bounded) and the Flat
(Periodic, Flat, Bounded) layout, WENO5, UB5 and centred momentum, WENO5
and PositiveWENO5 tracers) and steps the small seamount with the kernels
and with their plain versions to exact agreement (``python -m pytest
--noconftest -m cuda tests/test_torch_immersed_nonhydrostatic.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.advection import schemes as tsch
from clima_oceananigans_jl_torch.immersed.immersed import ImmersedGrid, clear_flags
from clima_oceananigans_jl_torch.interop import state_from_numpy, state_to_numpy
from clima_oceananigans_jl_torch.models import nonhydrostatic as tnh
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection import fluxes as jfl
    from clima_oceananigans_jl_tpu.advection import schemes as jsch
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JBuoyancy
    from clima_oceananigans_jl_tpu.closures.scalar_diffusivity import (
        ScalarDiffusivity as JSD)
    from clima_oceananigans_jl_tpu.immersed import immersed as jim
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel as JN
    from clima_oceananigans_jl_tpu.timesteppers.steppers import Clock as JClock
    from clima_oceananigans_jl_tpu.utils import location as jloc
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
LOCS = {"ccc": T.CENTER, "fcc": T.U_LOC, "cfc": T.V_LOC, "ccf": T.W_LOC}


class Lib:
    """The names a configuration needs from one package."""

    def __init__(self, jax_side, device=DEVICE, dtype=None):
        self.jax, self.device = jax_side, device
        self.P = J if jax_side else T
        self.np = jnp if jax_side else torch
        self.dtype = dtype or (jnp.float64 if jax_side else torch.float64)
        self.GridFittedBottom = jim.GridFittedBottom if jax_side else T.GridFittedBottom
        self.PositiveWENO5 = jsch.PositiveWENO5 if jax_side else T.PositiveWENO5
        self.ScalarDiffusivity = JSD if jax_side else T.ScalarDiffusivity
        self.BuoyancyTracer = JBuoyancy if jax_side else T.BuoyancyTracer

    def grid(self, size, topology, **axes):
        kw = dict(size=size, topology=topology, dtype=self.dtype, **axes)
        if not self.jax:
            kw["device"] = self.device
        return self.P.RectilinearGrid(**kw)

    def model(self, grid, **kw):
        if self.jax:
            return JN(grid, fused_advection=False, **kw)
        return T.NonhydrostaticModel(grid, **kw)


def seamount_16(L, size=(16, 16, 16), **kw):
    """``tests/test_immersed.py``'s 16³ seamount on (P, P, B)."""
    xp = L.np
    g = L.grid(size, ("periodic", "periodic", "bounded"), x=(0, 1), y=(0, 1), z=(-1, 0))
    seamount = lambda x, y: -1.0 + 0.6 * xp.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02)
    return L.model(g, immersed_boundary=L.GridFittedBottom(seamount), **kw)


def seamount_validation(L, n=64):
    """``validation/seamount.py`` at n×1×n/2."""
    xp = L.np
    Lx, Lz = 10_000.0, 1_000.0
    g = L.grid((n, 1, n // 2), ("periodic", "flat", "bounded"), x=(0.0, Lx),
               y=(0.0, 1.0), z=(-Lz, 0.0))
    seamount = lambda x, y: -Lz + 500.0 * xp.exp(-((x - 0.5 * Lx) / 2000.0) ** 2)
    return L.model(g, advection=L.P.WENO5(),
                   tracer_advection=L.PositiveWENO5(bounds=(0.0, 1.0)),
                   tracers=("c",), buoyancy=L.BuoyancyTracer(),
                   closure=L.ScalarDiffusivity(nu=1e-3, kappa=1e-4),
                   immersed_boundary=L.GridFittedBottom(seamount))


def seamount_initial(L):
    xp = L.np
    return dict(u=0.1, b=lambda x, y, z: 1e-5 * (z + 1000.0),
                c=lambda x, y, z: xp.exp(-((x - 2500.0) / 800.0) ** 2
                                         - ((z + 500.0) / 150.0) ** 2))


def compare(jstate, tstate, what, rtol=RTOL):
    """Fields, pHY′ and pNHS within ``rtol`` of max|field| (pNHS of
    max(|pNHS|, |pHY′|))."""
    for name, ref in jstate["solution"].items():
        ref, got = np.asarray(ref), tstate["solution"][name].numpy()
        assert ref.shape == got.shape, (what, name)
        scale = max(np.abs(ref).max(), 1e-300)
        assert np.abs(ref - got).max() <= rtol * scale, (what, name, np.abs(ref - got).max())
    scale = max(np.abs(np.asarray(jstate["pNHS"])).max(),
                np.abs(np.asarray(jstate.get("pHY", 0.0))).max(), 1e-300)
    for key in ("pHY", "pNHS"):
        if key in jstate:
            err = np.abs(np.asarray(jstate[key]) - tstate[key].numpy()).max()
            assert err <= rtol * scale, (what, key, err, scale)


# -- the flags, K2's plain version, the masks ----------------------------------------

@pytest.mark.parametrize("loc", list(LOCS))
@pytest.mark.parametrize("flat", [False, True], ids=["ppb", "pfb"])
def test_clear_flags_are_the_jax_conditional_fluxes(loc, flat):
    """Bit a of the flags at ``loc`` is the JAX ``_immersed_clear`` of
    axis a, in the direction ``advection/fluxes.py`` transports that
    location along it (to centres along its own staggered axis)."""
    if flat:
        jm, tm = seamount_validation(Lib(True), 16), seamount_validation(Lib(False), 16)
    else:
        jm, tm = seamount_16(Lib(True)), seamount_16(Lib(False))
    flags = clear_flags(tm.grid, LOCS[loc], 2)
    assert flags.dtype == torch.uint8 and clear_flags(tm.grid, LOCS[loc], 2) is flags
    jl = tuple(jloc.F if c == "f" else jloc.C for c in loc)
    for axis in range(3):
        to_f = loc[axis] == "c"
        ref = np.asarray(jsch._immersed_clear(jm.grid.immersed, jl, axis, to_f, 2))
        assert np.array_equal(ref, ((flags >> axis) & 1).bool().numpy()), axis


@pytest.mark.parametrize("schemes", ["weno5", "centred", "positive", "ub5"])
def test_k2_plain_version_on_an_immersed_grid_matches_jax(schemes):
    jm, tm = seamount_16(Lib(True), (12, 11, 10)), seamount_16(Lib(False), (12, 11, 10))
    pick = {"weno5": ("WENO5", "WENO5"), "centred": ("CenteredSecondOrder", "WENO5"),
            "positive": ("WENO5", "PositiveWENO5"),
            "ub5": ("UpwindBiasedFifthOrder", "UpwindBiasedFifthOrder")}[schemes]
    js, jt = (getattr(jsch, n)() for n in pick)
    ts, tt = (getattr(tsch, n)() for n in pick)
    rng = np.random.default_rng(2)
    u, v, w = (rng.standard_normal(tm.grid.total_shape) for _ in range(3))
    c = rng.uniform(-0.1, 1.1, tm.grid.total_shape)
    ju = tuple(map(jnp.asarray, (u, v, w)))
    jg = jm.grid
    ref = dict(u=-jfl.div_vu(jg, js, *ju), v=-jfl.div_vv(jg, js, *ju),
               w=-jfl.div_vw(jg, js, *ju), c=-jfl.div_Uc(jg, jt, *ju, jnp.asarray(c)))
    got = tft.fused_advective_tendencies_reference(
        tm.grid, ts, tt, *map(torch.as_tensor, (u, v, w)), {"c": torch.as_tensor(c)})
    g = tm.grid
    top = (slice(g.Hx, g.Hx + g.Nx), slice(g.Hy, g.Hy + g.Ny), g.Hz + g.Nz)
    for name, r in ref.items():
        assert np.array_equal(np.asarray(g.interior(r)), g.interior(got[name]).numpy()), name
    assert np.array_equal(np.asarray(ref["w"])[top], got["w"].numpy()[top])


def test_masks_match_at_every_location_of_the_model():
    jm = seamount_16(Lib(True), tracers=("c",))
    tm = seamount_16(Lib(False), tracers=("c",))
    rng = np.random.default_rng(4)
    sol = {n: rng.standard_normal(tm.grid.total_shape) for n in ("u", "v", "w", "c")}
    ref = jm.immersed_boundary.mask_state(jm, {"solution": {k: jnp.asarray(v) for k, v in sol.items()}})
    got = tm.immersed_boundary.mask_state(tm, {"solution": {k: torch.as_tensor(v) for k, v in sol.items()}})
    for n in sol:
        assert np.array_equal(np.asarray(ref["solution"][n]), got["solution"][n].numpy()), n
        assert np.array_equal(
            np.asarray(jm.immersed_boundary.mask_tendency(jm, n, jnp.asarray(sol[n]))),
            tm.immersed_boundary.mask_tendency(tm, n, torch.as_tensor(sol[n])).numpy()), n


def test_gates_and_refusals():
    """The general AB2 branch and the general projection, K6's fill
    groups; PartialCellBottom refused by name; particles (now ported) ride
    in the immersed model's state."""
    tm = seamount_16(Lib(False), advection=T.WENO5(), tracers=("c",))
    jm = seamount_16(Lib(True), advection=J.WENO5(), tracers=("c",))
    assert isinstance(tm.grid, ImmersedGrid) and tm.grid.immersed is tm.immersed_boundary
    assert not tm.fused_step and not jm.fused_step and not tm.g_interior
    assert not tm._fast_projection_ok() and not jm._fast_projection_ok()
    assert tm._fill_unsupported_reason() is None
    assert tm.kernels is tnh.KERNELS
    g = T.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1), dtype=torch.float64,
                          device=DEVICE, topology=("periodic", "periodic", "bounded"))
    with pytest.raises(NotImplementedError, match="PartialCellBottom.*item 7"):
        T.NonhydrostaticModel(g, immersed_boundary=T.PartialCellBottom(-0.5))
    zero = torch.zeros(2, dtype=torch.float64)
    p = T.LagrangianParticles(zero + 0.5, zero + 0.5, zero + 0.5)
    mp = seamount_16(Lib(False), tracers=("c",))
    mp.particles = p
    assert mp.initial_state()["particles"] is p
    assert T.NonhydrostaticModel(g, particles=p).particles is p


# -- the JAX suite's immersed cases ---------------------------------------------------

STEPS = {"QuasiAdamsBashforth2": 4, "RungeKutta3": 3}
SCHEMES = {"weno5": lambda L: dict(advection=L.P.WENO5(), tracer_advection=L.P.WENO5()),
           "centred": lambda L: dict(advection=None),
           "positive": lambda L: dict(advection=L.P.WENO5(),
                                      tracer_advection=L.PositiveWENO5(bounds=(0.0, 1.0)))}


@pytest.mark.parametrize("timestepper", list(STEPS))
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_seamount_16_steps_match_jax(scheme, timestepper):
    """``test_conditional_advection_conserves_fluid_tracer``'s setup (u =
    0.1, a Gaussian tracer) with a buoyancy tracer and a diffusivity, so
    every immersed term runs: the two packages agree, and Σc over the
    fluid is kept."""
    kw = dict(timestepper=timestepper, tracers=("c",))
    jm = seamount_16(Lib(True), **SCHEMES[scheme](Lib(True)), **kw,
                          buoyancy=JBuoyancy(), closure=JSD(nu=1e-4, kappa=1e-4))
    tm = seamount_16(Lib(False), **SCHEMES[scheme](Lib(False)), **kw,
                          buoyancy=T.BuoyancyTracer(),
                          closure=T.ScalarDiffusivity(nu=1e-4, kappa=1e-4))
    x, y, z = (np.asarray(a) for a in jm.grid.nodes(jloc.CENTER, with_halo=True))
    c0 = np.broadcast_to(np.exp(-((x - 0.3) ** 2 + (y - 0.5) ** 2) / 0.02), tm.grid.total_shape)
    b0 = np.broadcast_to(1e-2 * (z + 1.0), tm.grid.total_shape)
    ii = tm.grid.interior_slices
    js = jm.initial_state(u=0.1, c=jnp.asarray(c0[ii]), b=jnp.asarray(b0[ii]))
    ts = tm.initial_state(u=0.1, c=torch.as_tensor(c0[ii].copy()), b=torch.as_tensor(b0[ii].copy()))
    ig = tm.grid
    fluid_w = torch.where(ig.immersed.solid_ccc, 0.0, 1.0) * ig.V(T.CENTER)
    total = lambda s: float(ig.interior(s["solution"]["c"] * fluid_w).sum())
    t0 = total(ts)
    for _ in range(STEPS[timestepper]):
        js, ts = jm.step(js, 1e-3), tm.step(ts, 1e-3)
    compare(js, ts, (scheme, timestepper))
    assert abs(total(ts) - t0) < 1e-9 * abs(t0)


def test_uniform_tracer_stays_uniform_under_diffusion():
    """Solid cells (masked to 0) must not act as a value wall."""
    tm = seamount_16(Lib(False), closure=T.ScalarDiffusivity(nu=1e-2, kappa=1e-2),
                          tracers=("c",))
    state = tm.initial_state(c=1.0)
    for _ in range(5):
        state = tm.step(state, 1e-3)
    g = tm.grid
    c = g.interior(state["solution"]["c"])
    fluid = ~g.interior(g.immersed.solid_ccc)
    assert float((c[fluid] - 1.0).abs().max()) <= 1e-12


def _flat_bottom(L, size, **kw):
    g = L.grid(size, ("periodic", "periodic", "bounded"), x=(0, kw.pop("Lx", 1.0)),
               y=(0, kw.pop("Ly", 1.0)), z=(-1.0, 0))
    return L.model(g, immersed_boundary=L.GridFittedBottom(-0.5), **kw)


def test_immersed_flux_budget_and_jax():
    """FieldBCs(immersed=FluxBC(q)) adds exactly q·A_bottom·t to the
    budget (``test_immersed_boundary_condition_flux_budget``); 40 steps
    against JAX."""
    Lx, Ly, q = 2.0, 3.0, 0.7
    jm = _flat_bottom(Lib(True), (8, 8, 16), Lx=Lx, Ly=Ly, tracers=("c",), advection=None,
                      boundary_conditions={"c": J.FieldBCs(immersed=J.FluxBC(q))})
    tm = _flat_bottom(Lib(False), (8, 8, 16), Lx=Lx, Ly=Ly, tracers=("c",), advection=None,
                      boundary_conditions={"c": T.FieldBCs(immersed=T.FluxBC(q))})
    js, ts = jm.initial_state(c=1.0), tm.initial_state(c=1.0)
    dt, n = 1e-2, 40
    for _ in range(n):
        js, ts = jm.step(js, dt), tm.step(ts, dt)
    compare(js, ts, "flux budget")
    gi = tm.grid
    vol = torch.broadcast_to(gi.V(T.CENTER), gi.total_shape)
    total = float(gi.interior(ts["solution"]["c"] * vol * ~gi.immersed.solid_ccc).sum())
    assert total == pytest.approx(1.0 * Lx * Ly * 0.5 + q * Lx * Ly * n * dt, rel=1e-12)


def test_discrete_bottom_drag_and_jax():
    """A linear drag −r u through the immersed bottom decays the bottom
    fluid cell at r/Δz (``test_discrete_form_immersed_bottom_drag``);
    100 steps against JAX."""
    r = 0.05
    jm = _flat_bottom(Lib(True), (4, 4, 16), advection=None, boundary_conditions={
        "u": J.FieldBCs(immersed=J.FluxBC(lambda g, t, f: -r * f["u"], discrete=True))})
    tm = _flat_bottom(Lib(False), (4, 4, 16), advection=None, boundary_conditions={
        "u": T.FieldBCs(immersed=T.FluxBC(lambda g, t, f: -r * f["u"], discrete=True))})
    js, ts = jm.initial_state(u=0.3), tm.initial_state(u=0.3)
    dt, n = 1e-2, 100
    for _ in range(n):
        js, ts = jm.step(js, dt), tm.step(ts, dt)
    compare(js, ts, "drag")
    u = tm.grid.interior(ts["solution"]["u"]).mean((0, 1)).numpy()
    assert abs(u[8] - 0.3 * np.exp(-r * n * dt / (1.0 / 16))) < 0.01, u[8]
    assert np.allclose(u[9:], 0.3, atol=1e-12)
    assert np.all(u[:8] == 0.0)


# -- validation/seamount.py -------------------------------------------------------------

def seamount_totals(model, state):
    """(Σc·V over the fluid, max|c| in the solid, min c, max c) on the
    interior, as the validation computes them."""
    g = model.grid
    c = g.interior(state["solution"]["c"])
    fluid = ~g.interior(g.immersed.solid_ccc)
    vol = g.interior(torch.broadcast_to(g.V(T.CENTER), g.total_shape))
    return (float((c * vol * fluid).sum()), float((c * ~fluid).abs().max()),
            float(c.min()), float(c.max()))


def test_seamount_validation_matches_jax_and_holds():
    n = 64
    jm, tm = seamount_validation(Lib(True), n), seamount_validation(Lib(False), n)
    js = jm.initial_state(**seamount_initial(Lib(True)))
    ts = tm.initial_state(**seamount_initial(Lib(False)))
    tot0 = seamount_totals(tm, ts)[0]
    dt = min(60.0, 0.25 * (10_000.0 / n))
    for _ in range(20):
        js, ts = jm.step(js, dt), tm.step(ts, dt)
    compare(js, ts, "seamount")
    tot, solid, cmin, cmax = seamount_totals(tm, ts)
    assert abs(tot / tot0 - 1) < 1e-3
    assert solid < 1e-10
    assert cmin > -1e-9 and cmax < 1.0 + 1e-9
    assert all(bool(torch.isfinite(v).all()) for v in ts["solution"].values())


def test_immersed_state_passes_through_interop():
    """A JAX seamount state into the port steps as the port's own state
    does; the port's state back into JAX steps as the JAX state does."""
    n, dt = 32, 60.0
    jm, tm = seamount_validation(Lib(True), n), seamount_validation(Lib(False), n)
    js = jm.initial_state(**seamount_initial(Lib(True)))
    ts = tm.initial_state(**seamount_initial(Lib(False)))
    for _ in range(2):
        js, ts = jm.step(js, dt), tm.step(ts, dt)
    back = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
    for name, ref in js["solution"].items():  # filled, then masked
        assert np.array_equal(np.asarray(ref), back["solution"][name].numpy()), name
    a, b = tm.step(ts, dt), tm.step(back, dt)
    for name in a["solution"]:
        x, y = a["solution"][name].numpy(), b["solution"][name].numpy()
        assert np.abs(x - y).max() <= RTOL * max(np.abs(x).max(), 1e-300), name
    ns = state_to_numpy(ts)
    js2 = jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in ns.items() if k != "clock"})
    js2["clock"] = JClock(jnp.asarray(ns["clock"].time), jnp.asarray(ns["clock"].iteration))
    compare(jm.step(js2, dt), a, "into JAX")


# -- on the card ---------------------------------------------------------------------

DTYPES = {"f32": torch.float32, "f64": torch.float64}
#: (topology, size off the tiles) of the card's holds
CARD = {"ppb": (("periodic", "periodic", "bounded"), (30, 27, 45)),
        "pfb": (("periodic", "flat", "bounded"), (100, 1, 45))}
CARD_SCHEMES = {"weno5/positive": ("WENO5", "PositiveWENO5"), "weno5": ("WENO5", "WENO5"),
                "centred/weno5": ("CenteredSecondOrder", "WENO5"),
                "ub5": ("UpwindBiasedFifthOrder", "UpwindBiasedFifthOrder")}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def card_model(code, dtype, momentum="WENO5", tracer="WENO5", **kw):
    """The seamount's bottom, scaled to the box, on the card."""
    topology, size = CARD[code]
    g = T.RectilinearGrid(size=size, x=(0.0, 1.3), y=(0.0, 0.7), z=(-0.9, 0.0),
                          topology=topology, dtype=dtype, device="cuda")
    bottom = lambda x, y: -0.9 + 0.5 * torch.exp(-((x - 0.65) ** 2 + (y - 0.35) ** 2) / 0.08)
    tracer_scheme = getattr(tsch, tracer)
    return T.NonhydrostaticModel(
        g, advection=getattr(tsch, momentum)(),
        tracer_advection=(tracer_scheme(bounds=(0.0, 1.0)) if tracer == "PositiveWENO5"
                          else tracer_scheme()),
        immersed_boundary=T.GridFittedBottom(bottom), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("schemes", list(CARD_SCHEMES))
@pytest.mark.parametrize("code", list(CARD))
def test_cuda_k2_on_an_immersed_grid_matches_plain_version(code, schemes, dtype):
    needs_card()
    model = card_model(code, DTYPES[dtype], *CARD_SCHEMES[schemes], tracers=("b", "c"))
    g = model.grid
    gen = torch.Generator(device="cuda").manual_seed(8)
    vel = [torch.randn(g.total_shape, generator=gen, dtype=g.dtype, device="cuda")
           for _ in range(3)]
    tr = [1.2 * torch.rand(g.total_shape, generator=gen, dtype=g.dtype, device="cuda") - 0.1
          for _ in range(2)]
    sol = model.immersed_boundary.mask_state(
        model, {"solution": dict(zip(("u", "v", "w", "b", "c"), vel + tr))})["solution"]
    args = (g, model.advection, model.tracer_advection, sol["u"], sol["v"], sol["w"],
            {"b": sol["b"], "c": sol["c"]})
    blocks = [torch.full(g.total_shape, float("nan"), dtype=g.dtype, device="cuda")
              for _ in range(7)]
    del blocks
    before = tft.fused_advective_tendencies.launches
    got = tft.fused_advective_tendencies(*args)
    torch.cuda.synchronize()
    assert tft.fused_advective_tendencies.launches == before + 1
    ref = tft.fused_advective_tendencies_reference(*args)
    top = (slice(g.Hx, g.Hx + g.Nx), slice(g.Hy, g.Hy + g.Ny), g.Hz + g.Nz)
    for name in ref:
        assert torch.equal(g.interior(got[name]), g.interior(ref[name])), name
        rest = got[name].clone()
        rest[g.interior_slices] = 0
        if name == "w":
            assert torch.equal(got["w"][top], ref["w"][top])
            rest[top] = 0
        assert not rest.isnan().any() and not rest.any(), f"{name}: halo"


@pytest.mark.cuda
@pytest.mark.parametrize("code", list(CARD))
def test_cuda_seamount_steps_with_kernels_equal_plain_versions(code):
    """Quasi-AB2 steps of the card's seamount with a buoyancy tracer and a
    diffusivity: the kernels (K2, K3b, K3c, K6) against their plain
    versions, exactly, with the launches a step."""
    needs_card()
    runs = []
    for plain in (False, True):
        model = card_model(code, torch.float64, "WENO5", "PositiveWENO5", tracers=("c",),
                           buoyancy=T.BuoyancyTracer(),
                           closure=T.ScalarDiffusivity(nu=1e-4, kappa=1e-4))
        state = model.initial_state(u=0.1, c=lambda x, y, z: torch.exp(-((x - 0.4) / 0.1) ** 2),
                                    b=lambda x, y, z: 1e-2 * (z + 0.9))
        before = tft.fused_advective_tendencies.launches
        for _ in range(3):
            state = model.step(state, 1e-3, tnh.PLAIN if plain else None)
        torch.cuda.synchronize()
        assert tft.fused_advective_tendencies.launches == before + (0 if plain else 3)
        runs.append(state)
    for name in runs[0]["solution"]:
        assert torch.equal(runs[0]["solution"][name], runs[1]["solution"][name]), name
