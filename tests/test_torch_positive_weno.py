"""Port parity: ``PositiveWENO5``, WENO5 with the Zhang-Shu flux limiter.

JAX's ``transport`` gives ``PositiveWENO5``'s to-faces transports the
two-sided route (``left_right_to_f``, the JAX ``_weno_lr``), the near-wall
selects, the immersed first-order fallback, ``limit_lr`` and the upwind
product; to centres it is WENO5's stream. Held against the JAX package in
float64, the same numpy-seeded inputs through both:

- ``left_right_to_f``, ``left_right_to_c`` and ``limit_lr`` bit for bit;
- ``transport`` on every axis, to faces and to centres, bit for bit on
  every point of the with-halo result: periodic, near a bounded wall, on a
  Flat y, on a stretched z (the tables route), and next to an immersed
  bottom (the clear flags), with the validation's bounds (0, 1) and the
  default (0, ∞);
- K2's plain version with ``PositiveWENO5`` tracers against the JAX
  ``div_*`` fluxes, bit for bit on the interior;
- the JAX suite's bounds case (``tests/test_convergence.py``: a [0, 1]
  square wave carried once around a periodic 96-cell line at CFL 0.2 by
  RK3) in the port: strictly inside [0, 1] where plain WENO5 overshoots,
  at WENO5's L1 accuracy, and the port's run equals the JAX one within
  ``RTOL`` after 20 steps;
- as the momentum scheme: ``div_vu``, ``div_vv`` and ``div_vw`` (a
  velocity's to-faces transports limited with ``c`` the velocity and the
  bounds (0, ∞), as JAX's ``transport`` does) bit for bit on (P, P, B),
  (B, B, B) and a stretched z;
- K2's plain version on a stretched z (the limiter on the two-sided table
  form) and K3a's (uh, vh and the tracers), bit for bit;
- the gates: as JAX's ``fused_step_ok``, which never looks at the scheme,
  ``PositiveWENO5`` keeps quasi-AB2 on the fused branch (K1's limiter),
  and 10 steps of that branch match the JAX plain path within ``RTOL``
  with it as the tracer scheme and as both; every kernel takes its code
  and bounds, and nothing refuses it.

The ``cuda`` cases hold each kernel form against its plain version on the
card bit for bit over NaN-filled outputs, fp32 and fp64, sizes off the
kernels' tiles: K2 with ``PositiveWENO5`` tracers on (Periodic, Periodic,
Bounded) and the Flat (Periodic, Flat, Bounded) layout, bounds (0, 1) and
(0, ∞), and on a stretched z; K2 with it as momentum too, also on
(B, B, B) and a stretched z; K1 with it as tracers and as both, on a
regular and a stretched z; K3a with it for uh, vh and a tracer
(``python -m pytest --noconftest -m cuda tests/test_torch_positive_weno.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.advection import fluxes as tfl
from clima_oceananigans_jl_torch.advection import schemes as tsch
from clima_oceananigans_jl_torch.advection.schemes import PositiveWENO5
from clima_oceananigans_jl_torch.immersed.immersed import ImmersedGrid
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft

try:  # the cuda cases also run on a machine without JAX
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection import fluxes as jfl
    from clima_oceananigans_jl_tpu.advection import schemes as jsch
    from clima_oceananigans_jl_tpu.immersed.immersed import GridFittedBottom as JGFB
    from clima_oceananigans_jl_tpu.immersed.immersed import ImmersedGrid as JIG
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel as JN
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
NAMES = {"P": "periodic", "B": "bounded", "F": "flat"}
BOUNDS = {"unit": (0.0, 1.0), "positive": (0.0, float("inf"))}


def grid_pair(code, size, stretched=False, dtype=torch.float64, device=DEVICE):
    """The same with-halo (3) grid in both packages (the JAX one None off
    the CPU); ``stretched``: a stretched z."""
    z = (np.cumsum(np.r_[-0.9, np.linspace(0.05, 0.15, size[2])]) if stretched
         else (-0.9, 0.0))
    kw = dict(size=size, x=(0.0, 1.3), y=(0.0, 0.7), z=z,
              topology=tuple(NAMES[c] for c in code), halo=(3, 3, 3))
    tg = T.RectilinearGrid(dtype=dtype, device=device, **kw)
    jg = J.RectilinearGrid(dtype=jnp.float64, **kw) if device == DEVICE else None
    return jg, tg


def bottom(xp):
    return lambda x, y: -0.9 + 0.5 * xp.exp(-((x - 0.65) ** 2 + (y - 0.35) ** 2) / 0.08)


def immersed_pair(code, size):
    """The grids wrapped with a GridFittedBottom in both packages."""
    jg, tg = grid_pair(code, size)
    return (JIG.wrap(jg, JGFB(bottom(jnp)).build(jg)),
            ImmersedGrid(tg, T.GridFittedBottom(bottom(torch)).build(tg)))


def tracer_fields(shape, seed):
    """A velocity of either sign and a tracer mostly inside [0, 1] with
    excursions past both bounds, so the limiter acts both ways."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.uniform(-0.1, 1.1, shape)


def same(ref, got):
    ref, got = np.asarray(ref), got.numpy()
    assert ref.shape == got.shape
    assert np.array_equal(ref, got), np.abs(ref - got).max()


def test_reconstructions_and_limiter_match_jax_bitwise():
    """left_right_to_f (the JAX ``_weno_lr``), its to-centres shift and
    limit_lr, alone, on every axis."""
    _, c = tracer_fields((12, 11, 10), 7)
    js, ts = jsch.PositiveWENO5(bounds=(0.0, 1.0)), PositiveWENO5(bounds=(0.0, 1.0))
    for axis in range(3):
        for name in ("left_right_to_f", "left_right_to_c"):
            for r, g in zip(getattr(js, name)(jnp.asarray(c), axis),
                            getattr(ts, name)(torch.as_tensor(c), axis)):
                same(r, g)
        L, R = js.left_right_to_f(jnp.asarray(c), axis)
        tL, tR = ts.left_right_to_f(torch.as_tensor(c), axis)
        for r, g in zip(js.limit_lr(jnp.asarray(c), L, R, axis),
                        ts.limit_lr(torch.as_tensor(c), tL, tR, axis)):
            same(r, g)


@pytest.mark.parametrize("bounds", list(BOUNDS))
@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("code", ["PPP", "BBB", "PFB"])
def test_transport_matches_jax_bitwise(code, axis, to_f, bounds):
    """Periodic axes, bounded walls (the near-wall selects before the
    limiter) and a Flat y (every stencil reads the cell itself)."""
    size = (11, 1, 9) if code == "PFB" else (11, 10, 9)
    jg, tg = grid_pair(code, size)
    vel, c = tracer_fields(tg.total_shape, axis)
    b = BOUNDS[bounds]
    ref = jsch.transport(jsch.PositiveWENO5(bounds=b), jnp.asarray(vel),
                         jnp.asarray(c), axis, to_f, jg)
    got = tsch.transport(PositiveWENO5(bounds=b), torch.as_tensor(vel),
                         torch.as_tensor(c), axis, to_f, tg)
    same(ref, got)


@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_transport_on_a_stretched_z_matches_jax_bitwise(axis, to_f):
    """A stretched z takes the tables route, the limiter after it."""
    jg, tg = grid_pair("PPB", (10, 9, 12), stretched=True)
    vel, c = tracer_fields(tg.total_shape, 3 + axis)
    ref = jsch.transport(jsch.PositiveWENO5(bounds=(0.0, 1.0)), jnp.asarray(vel),
                         jnp.asarray(c), axis, to_f, jg)
    got = tsch.transport(PositiveWENO5(bounds=(0.0, 1.0)), torch.as_tensor(vel),
                         torch.as_tensor(c), axis, to_f, tg)
    same(ref, got)


@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("code", ["PPB", "PFB"])
def test_transport_next_to_an_immersed_bottom_matches_jax_bitwise(code, axis, to_f):
    """The clear flags drop (L, R) to first-order upwind before the
    limiter."""
    size = (13, 1, 10) if code == "PFB" else (13, 11, 10)
    jg, tg = immersed_pair(code, size)
    vel, c = tracer_fields(tg.total_shape, 11 + axis)
    ref = jsch.transport(jsch.PositiveWENO5(bounds=(0.0, 1.0)), jnp.asarray(vel),
                         jnp.asarray(c), axis, to_f, jg, J.CENTER)
    got = tsch.transport(PositiveWENO5(bounds=(0.0, 1.0)), torch.as_tensor(vel),
                         torch.as_tensor(c), axis, to_f, tg, T.CENTER)
    same(ref, got)


@pytest.mark.parametrize("immersed", [False, True], ids=["regular", "immersed"])
@pytest.mark.parametrize("code", ["PPB", "PFB", "BBB"])
def test_k2_plain_version_with_positive_tracers_matches_jax(code, immersed):
    """K2's plain version: WENO5 momentum, PositiveWENO5 tracers, against
    the JAX ``div_*`` fluxes bit for bit on the interior."""
    size = (12, 1, 9) if code == "PFB" else (11, 10, 9)
    jg, tg = immersed_pair(code, size) if immersed else grid_pair(code, size)
    rng = np.random.default_rng(5)
    u, v, w = (rng.standard_normal(tg.total_shape) for _ in range(3))
    c = rng.uniform(-0.1, 1.1, tg.total_shape)
    jm, tm = J.WENO5(), T.WENO5()
    jt, tt = jsch.PositiveWENO5(bounds=(0.0, 1.0)), PositiveWENO5(bounds=(0.0, 1.0))
    ju = tuple(map(jnp.asarray, (u, v, w)))
    ref = dict(u=-jfl.div_vu(jg, jm, *ju), v=-jfl.div_vv(jg, jm, *ju),
               w=-jfl.div_vw(jg, jm, *ju), c=-jfl.div_Uc(jg, jt, *ju, jnp.asarray(c)))
    got = tft.fused_advective_tendencies_reference(
        tg, tm, tt, *map(torch.as_tensor, (u, v, w)), {"c": torch.as_tensor(c)})
    for name, r in ref.items():
        same(tg.interior(r), tg.interior(got[name]))


# -- the JAX suite's bounds case ---------------------------------------------------

def _square_wave_model(P, scheme, n=96, jax_side=False):
    kw = dict(size=(n, 1, 1), x=(0, 1), y=(0, 1),
              topology=("periodic", "flat", "flat"), halo=(4, 1, 1))
    if jax_side:
        g = P.RectilinearGrid(dtype=jnp.float64, **kw)
        extra = dict(fused_advection=False)
        M = JN
    else:
        g = P.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw)
        extra = {}
        M = P.NonhydrostaticModel
    return M(g, tracers=("c",), tracer_advection=scheme,
             advection=P.CenteredSecondOrder(), timestepper="RungeKutta3", **extra)


def _square(x):
    return ((x > 0.3) & (x < 0.7)).to(torch.float64)


def test_square_wave_stays_inside_its_bounds():
    """``tests/test_convergence.py``'s PositiveWENO5 case in the port: one
    revolution of a [0, 1] square wave at CFL 0.2 stays strictly inside
    [0, 1] (plain WENO5 overshoots) at WENO5's L1 accuracy."""
    n = 96
    dt = 0.2 / n
    results = {}
    for name, scheme in (("weno5", T.WENO5()),
                         ("positive", PositiveWENO5(bounds=(0.0, 1.0)))):
        model = _square_wave_model(T, scheme, n)
        g = model.grid
        state = model.initial_state(u=1.0, c=lambda x, y, z: _square(x))
        cmin, cmax = 0.0, 1.0
        for _ in range(round(1.0 / dt)):
            state = model.step(state, dt)
            ci = g.interior(state["solution"]["c"])
            cmin, cmax = min(cmin, float(ci.min())), max(cmax, float(ci.max()))
        got = g.interior(state["solution"]["c"])[:, 0, 0]
        x, _, _ = g.nodes(T.CENTER)
        exact = _square(x[:, 0, 0])
        results[name] = (cmin, cmax, float((got - exact).abs().mean()))
    assert results["positive"][0] > -1e-10
    assert results["positive"][1] < 1.0 + 1e-10
    assert results["weno5"][1] > 1.0 + 1e-5
    assert results["positive"][2] < 1.2 * results["weno5"][2]


def test_square_wave_matches_jax_over_twenty_steps():
    """The same run, 20 RK3 steps in both packages, within RTOL."""
    n, dt = 96, 0.2 / 96
    jm = _square_wave_model(J, jsch.PositiveWENO5(bounds=(0.0, 1.0)), n, jax_side=True)
    tm = _square_wave_model(T, PositiveWENO5(bounds=(0.0, 1.0)), n)
    js = jm.initial_state(u=1.0, c=lambda x, y, z: jnp.where((x > 0.3) & (x < 0.7), 1.0, 0.0))
    ts = tm.initial_state(u=1.0, c=lambda x, y, z: _square(x))
    for _ in range(20):
        js, ts = jm.step(js, dt), tm.step(ts, dt)
    ref, got = np.asarray(js["solution"]["c"]), ts["solution"]["c"].numpy()
    assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max()


# -- momentum, a stretched z, the shallow-water core ----------------------------------

@pytest.mark.parametrize("field", ["u", "v", "w"])
@pytest.mark.parametrize("code", ["PPB", "BBB", "PPB-stretched"])
def test_momentum_fluxes_match_jax_bitwise(code, field):
    """``PositiveWENO5`` as the momentum scheme: JAX's ``transport`` limits
    a velocity's to-faces transports with ``c`` the velocity itself and the
    default bounds (0, ∞), its own axis' to-centres transport is WENO5's
    stream; the port's ``div_vu``/``div_vv``/``div_vw`` bit for bit on the
    interior, near the walls and on a stretched z (the tables route)."""
    topo, _, stretched = code.partition("-")
    jg, tg = grid_pair(topo, (11, 10, 9), stretched=bool(stretched))
    rng = np.random.default_rng(17)
    u, v, w = (rng.standard_normal(tg.total_shape) for _ in range(3))
    name = {"u": "div_vu", "v": "div_vv", "w": "div_vw"}[field]
    ref = getattr(jfl, name)(jg, jsch.PositiveWENO5(), *map(jnp.asarray, (u, v, w)))
    got = getattr(tfl, name)(tg, PositiveWENO5(), *map(torch.as_tensor, (u, v, w)))
    same(tg.interior(ref), tg.interior(got))


@pytest.mark.parametrize("momentum", ["weno5", "positive"])
def test_k2_plain_version_on_a_stretched_z_matches_jax(momentum):
    """K2's plain version with ``PositiveWENO5`` tracers (and momentum) on a
    stretched z: the limiter on the two-sided table form, bit for bit."""
    jg, tg = grid_pair("PPB", (10, 9, 12), stretched=True)
    rng = np.random.default_rng(19)
    u, v, w = (rng.standard_normal(tg.total_shape) for _ in range(3))
    c = rng.uniform(-0.1, 1.1, tg.total_shape)
    jm, tm = ((J.WENO5(), T.WENO5()) if momentum == "weno5"
              else (jsch.PositiveWENO5(), PositiveWENO5()))
    jt, tt = jsch.PositiveWENO5(bounds=(0.0, 1.0)), PositiveWENO5(bounds=(0.0, 1.0))
    ju = tuple(map(jnp.asarray, (u, v, w)))
    ref = dict(u=-jfl.div_vu(jg, jm, *ju), v=-jfl.div_vv(jg, jm, *ju),
               w=-jfl.div_vw(jg, jm, *ju), c=-jfl.div_Uc(jg, jt, *ju, jnp.asarray(c)))
    got = tft.fused_advective_tendencies_reference(
        tg, tm, tt, *map(torch.as_tensor, (u, v, w)), {"c": torch.as_tensor(c)})
    for name, r in ref.items():
        same(tg.interior(r), tg.interior(got[name]))


@pytest.mark.parametrize("topo", ["pp", "bb"])
def test_k3a_plain_version_matches_jax_bitwise(topo):
    """K3a's plain version with ``PositiveWENO5`` for uh, vh and the tracers
    (the JAX ``_core_tendencies`` calls ``transport``: uh along y and vh
    along x limited, as the tracers), against JAX bit for bit."""
    from clima_oceananigans_jl_tpu.models.shallow_water import _core_tendencies
    pick = {"p": "periodic", "b": "bounded"}
    kw = dict(size=(20, 14, 1), x=(0, 2 * np.pi), y=(0, 1.5),
              topology=(pick[topo[0]], pick[topo[1]], "flat"), halo=(3, 3, 0))
    jg = J.RectilinearGrid(dtype=jnp.float64, **kw)
    tg = T.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw)
    rng = np.random.default_rng(23)
    shape = tg.total_shape
    uh, vh = (0.1 * rng.standard_normal(shape) for _ in range(2))
    h = 1.0 + 0.1 * rng.standard_normal(shape)
    cs = [rng.uniform(-0.1, 1.1, shape) for _ in range(2)]
    hB = 0.1 * rng.standard_normal(shape)
    ja, ta = jnp.asarray, torch.as_tensor
    ref = _core_tendencies(jg, jsch.PositiveWENO5(), jsch.PositiveWENO5(bounds=(0.0, 1.0)),
                           9.5, ja(uh), ja(vh), ja(h), [ja(c) for c in cs], ja(hB))
    got = tft.fused_shallow_water_tendencies_reference(
        tg, PositiveWENO5(), PositiveWENO5(bounds=(0.0, 1.0)), 9.5, ta(uh), ta(vh),
        ta(h), [ta(c) for c in cs], ta(hB))
    assert len(got) == 5
    for r, g in zip(ref, got):
        same(tg.interior(r), tg.interior(g))


# -- the gates -------------------------------------------------------------------------

def test_positive_tracers_keep_ab2_on_the_general_branch():
    """No longer: as JAX's ``fused_step_ok``, which never looks at the
    scheme, a ``PositiveWENO5`` tracer (or momentum) scheme keeps quasi-AB2
    on the fused branch, whose K1 carries the limiter. (The name is the
    test's from when K1 had none.)"""
    from clima_oceananigans_jl_tpu.ops.fused_step import fused_step_ok as j_gate
    jg, tg = grid_pair("PPB", (8, 8, 8))
    for adv, tadv in ((T.WENO5(), PositiveWENO5(bounds=(0.0, 1.0))),
                      (PositiveWENO5(), PositiveWENO5())):
        tm = T.NonhydrostaticModel(tg, advection=adv, tracers=("c",),
                                   tracer_advection=tadv)
        jm = JN(jg, advection=getattr(jsch, type(adv).__name__)(), tracers=("c",),
                tracer_advection=jsch.PositiveWENO5(bounds=tadv.bounds),
                fused_advection=True)
        assert tm.fused_step and tm.g_interior
        assert j_gate(jm) and jm.fused_step and jm.g_interior


@pytest.mark.parametrize("which", ["tracers", "momentum-and-tracers"])
def test_fused_ab2_ten_steps_match_jax(which):
    """10 quasi-AB2 steps on the port's fused branch (K1's plain version)
    against the JAX plain path, within ``RTOL``: ``PositiveWENO5`` as the
    tracer scheme, and as both schemes."""
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JB
    size = (12, 10, 8)
    jg, tg = grid_pair("PPB", size)
    pos = which != "tracers"
    tm = T.NonhydrostaticModel(tg, advection=PositiveWENO5() if pos else T.WENO5(),
                               tracer_advection=PositiveWENO5(bounds=(0.0, 1.0)),
                               buoyancy=T.BuoyancyTracer(), tracers=("c",))
    jm = JN(jg, advection=jsch.PositiveWENO5() if pos else J.WENO5(),
            tracer_advection=jsch.PositiveWENO5(bounds=(0.0, 1.0)), buoyancy=JB(),
            tracers=("c",), fused_advection=False)
    assert tm.fused_step
    rng = np.random.default_rng(29)
    vals = dict(u=0.1 * rng.standard_normal(size), v=0.1 * rng.standard_normal(size),
                b=1e-3 * rng.standard_normal(size), c=rng.uniform(0.0, 1.0, size))
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    import jax
    step = jax.jit(jm.step)
    for _ in range(10):
        js, ts = step(js, 2e-2), tm.step(ts, 2e-2)
    for name in ("u", "v", "w", "b", "c"):
        ref = np.asarray(jm.grid.interior(js["solution"][name]))
        got = tm.grid.interior(ts["solution"][name]).numpy()
        assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max(), name


def test_positive_momentum_and_other_kernels_are_refused_by_name():
    """What still waits: no PositiveWENO5 refusal is left. It is the
    momentum scheme in both models and every kernel's code (3) with its
    bounds in the double arguments; K4's gate takes a Flat y with it too
    (K4's Flat layouts)."""
    from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh
    _, tg = grid_pair("PPB", (8, 8, 8))
    T.NonhydrostaticModel(tg, advection=PositiveWENO5())
    m = T.HydrostaticFreeSurfaceModel(tg, momentum_advection=PositiveWENO5(),
                                      tracer_advection=PositiveWENO5(), tracers=("c",))
    assert tfh.unsupported_reason(m) is None
    assert tft.kernel_scheme(PositiveWENO5()) == (3, 1e-6)
    ints, doubles = tft.advection_args(tg, PositiveWENO5(), PositiveWENO5(bounds=(0.0, 1.0)), 4)
    assert (ints[7], ints[8]) == (3, 3)
    assert list(doubles)[5:] == [0.0, float("inf"), 0.0, 1.0]
    sw = T.RectilinearGrid(size=(8, 8, 1), extent=(1, 1),
                           topology=(T.PERIODIC, T.PERIODIC, T.FLAT), device=DEVICE)
    args = tft.shallow_water_args(sw, PositiveWENO5(), T.WENO5(), 3, 9.8)
    assert args[5:7] == (3, 1) and args[-4:] == (0.0, float("inf"), 0.0, 0.0)
    flat_y = T.RectilinearGrid(size=(8, 1, 8), extent=(1, 1, 1), device=DEVICE,
                               topology=(T.PERIODIC, T.FLAT, T.BOUNDED))
    m = T.HydrostaticFreeSurfaceModel(flat_y, tracer_advection=PositiveWENO5(),
                                      tracers=("c",))
    assert tfh.unsupported_reason(m) is None


# -- on the card ---------------------------------------------------------------------

#: sizes off K2's 8×12×32 tiles (and 96×1 in the Flat layout)
CARD = {"PPB": (30, 27, 45), "PFB": (100, 1, 45)}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def hold_k2_on_card(grid, scheme, tracer_scheme, fields):
    """K2 against its plain version bit for bit on the interior (and the
    velocities' wall faces), every other halo point exactly 0, over
    NaN-filled memory; one launch."""
    args = (grid, scheme, tracer_scheme, *fields[:3],
            {f"c{i}": c for i, c in enumerate(fields[3:])})
    blocks = [torch.full(grid.total_shape, float("nan"), dtype=grid.dtype,
                         device="cuda") for _ in range(len(fields) + 2)]
    del blocks
    before = tft.fused_advective_tendencies.launches
    got = tft.fused_advective_tendencies(*args)
    torch.cuda.synchronize()
    assert tft.fused_advective_tendencies.launches == before + 1
    ref = tft.fused_advective_tendencies_reference(*args)
    for name in ref:
        mask = torch.zeros(grid.total_shape, dtype=torch.bool, device="cuda")
        mask[grid.interior_slices] = True
        axis = {"u": 0, "v": 1, "w": 2}.get(name)
        if axis is not None and grid.topology[axis] is T.BOUNDED:
            sl = list(grid.interior_slices)
            sl[axis] = grid.halo[axis] + grid.shape[axis]
            mask[tuple(sl)] = True
        assert torch.equal(got[name][mask], ref[name][mask]), name
        rest = got[name][~mask]
        assert not rest.isnan().any() and not rest.any(), f"{name}: halo"


def poison(grid, n):
    """Fill the caching allocator's blocks with NaN, so that a point a
    kernel leaves unwritten shows."""
    blocks = [torch.full(grid.total_shape, float("nan"), dtype=grid.dtype, device="cuda")
              for _ in range(n)]
    del blocks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("topo", [("periodic", "periodic"), ("bounded", "bounded")])
def test_cuda_k3a_with_positive_weno_matches_plain_version(topo, dtype):
    """K3a with ``PositiveWENO5`` for uh, vh and a tracer (bounds (0, 1)),
    bit for bit, sizes off its 16×64 tiles."""
    needs_card()
    g = T.RectilinearGrid(size=(300, 277, 1), extent=(1, 1), topology=topo + ("flat",),
                          dtype=DTYPES[dtype], device="cuda")
    tracer = PositiveWENO5(bounds=(0.0, 1.0))
    m = T.ShallowWaterModel(g, advection=PositiveWENO5(), tracer_advection=tracer,
                            tracers=("c",))
    shape = m.grid.total_shape
    gen = torch.Generator(device="cuda").manual_seed(2)
    rand = lambda: torch.randn(shape, generator=gen, dtype=g.dtype, device="cuda")
    uh, vh, hB = 0.1 * rand(), 0.1 * rand(), 0.1 * rand()
    c = 1.2 * torch.rand(shape, generator=gen, dtype=g.dtype, device="cuda") - 0.1
    h = 1.0 + 0.05 * rand()
    args = (m.grid, PositiveWENO5(), tracer, 9.8, uh, vh, h, [c], hB)
    poison(m.grid, 4)
    before = tft.fused_shallow_water_tendencies.launches
    got = tft.fused_shallow_water_tendencies(*args)
    assert tft.fused_shallow_water_tendencies.launches == before + 1
    ref = tft.fused_shallow_water_tendencies_reference(*args)
    for a, b in zip(got, ref):
        assert torch.equal(m.grid.interior(a), m.grid.interior(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("code", ["PPB", "BBB", "PFB", "PPB-stretched"])
def test_cuda_k2_with_positive_momentum_matches_plain_version(code, dtype):
    """K2 with ``PositiveWENO5`` momentum and tracers (bounds (0, 1)), on
    bounded walls, the Flat layout and a stretched z."""
    needs_card()
    topo, _, stretched = code.partition("-")
    size = {"PPB": (30, 27, 45), "BBB": (27, 25, 19), "PFB": (100, 1, 45)}[topo]
    _, tg = grid_pair(topo, size, stretched=bool(stretched), dtype=DTYPES[dtype],
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    vel = [torch.randn(tg.total_shape, generator=gen, dtype=tg.dtype, device="cuda")
           for _ in range(3)]
    c = 1.2 * torch.rand(tg.total_shape, generator=gen, dtype=tg.dtype, device="cuda") - 0.1
    hold_k2_on_card(tg, PositiveWENO5(), PositiveWENO5(bounds=(0.0, 1.0)), vel + [c])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bounds", list(BOUNDS))
def test_cuda_k2_with_positive_tracers_on_a_stretched_z_matches_plain_version(bounds,
                                                                             dtype):
    needs_card()
    _, tg = grid_pair("PPB", (30, 27, 45), stretched=True, dtype=DTYPES[dtype],
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    vel = [torch.randn(tg.total_shape, generator=gen, dtype=tg.dtype, device="cuda")
           for _ in range(3)]
    tracers = [1.2 * torch.rand(tg.total_shape, generator=gen, dtype=tg.dtype,
                                device="cuda") - 0.1 for _ in range(2)]
    hold_k2_on_card(tg, T.WENO5(), PositiveWENO5(bounds=BOUNDS[bounds]), vel + tracers)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("which", ["tracers", "momentum-and-tracers", "stretched"])
def test_cuda_k1_with_positive_weno_matches_plain_version(which, dtype):
    """K1 with ``PositiveWENO5`` tracers (and momentum), Euler and AB2, bit
    for bit over NaN-filled outputs; on a stretched z its general
    instantiation."""
    from clima_oceananigans_jl_torch.ops import fused_step as tfs
    needs_card()
    _, tg = grid_pair("PPB", (30, 27, 45), stretched=which == "stretched",
                      dtype=DTYPES[dtype], device="cuda")
    model = T.NonhydrostaticModel(
        tg, advection=T.WENO5() if which == "tracers" else PositiveWENO5(),
        tracer_advection=PositiveWENO5(bounds=(0.0, 1.0)), buoyancy=T.BuoyancyTracer(),
        tracers=("c",), coriolis=T.FPlane(f=0.3),
        closure=T.ScalarDiffusivity(nu=1e-3, kappa=2e-3))
    assert model.fused_step
    gen = torch.Generator(device="cuda").manual_seed(9)
    rand = lambda shape: 1e-2 * torch.randn(shape, generator=gen, dtype=tg.dtype,
                                            device="cuda")
    state = model.initial_state(**{n: rand(model.grid.shape)
                                   for n in model.prognostic_names()})
    state = dict(state, G_prev={k: rand(tuple(g.shape)) for k, g in state["G_prev"].items()})
    for euler in (True, False):
        poison(model.grid, 2 * len(model.prognostic_names()))
        psi, g = tfs.fused_ab2_advance(model, state, 1e-3, euler)
        ref_psi, ref_g = tfs.fused_ab2_advance_reference(model, state, 1e-3, euler)
        for name in psi:
            assert torch.equal(psi[name], ref_psi[name]), name
            assert torch.equal(g[name], ref_g[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", list(BOUNDS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("code", list(CARD))
def test_cuda_k2_with_positive_tracers_matches_plain_version(code, dtype, bounds):
    needs_card()
    _, tg = grid_pair(code, CARD[code], dtype=DTYPES[dtype], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    vel = [torch.randn(tg.total_shape, generator=gen, dtype=tg.dtype, device="cuda")
           for _ in range(3)]
    tracers = [1.2 * torch.rand(tg.total_shape, generator=gen, dtype=tg.dtype,
                                device="cuda") - 0.1 for _ in range(2)]
    hold_k2_on_card(tg, T.WENO5(), PositiveWENO5(bounds=BOUNDS[bounds]), vel + tracers)
