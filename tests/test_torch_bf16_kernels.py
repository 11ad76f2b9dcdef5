"""Port parity: the plain versions of K1, K2, K3a and K4b under WENO5's
bf16 options, against the JAX package on the CPU, and the kernels' bf16
forms against the plain versions on the card.

The kernels compute ``fast_bf16`` and ``bf16_smoothness`` in their ANY
instantiations (``csrc/weno5_advection.cuh``, the bf16 forms), bit for bit
their plain versions, which round each bf16 operation as torch's CUDA
kernels round it. Both packages round every bf16 operation to nearest
even; they differ where a Python constant enters one (13/12, the weights
0.1, 0.6, 0.3): JAX rounds it to bf16, torch takes its fp32 value. So
the two answers differ by bf16 roundings, about as much as either differs
from the fp32 answer, and each comparison below is held three ways, on
numpy-seeded fields, against the port's fp32 answer (the same scheme
without the option) on the same inputs:

- the largest |JAX − port| of a case, as a share of each field's max|ref|,
  within ``MARGIN`` of its reading on these inputs (``MEASURED``); a zero
  advection misses it by orders of magnitude;
- ``bf16_smoothness`` rounds only the smoothness indicators and weights, so
  the port's answer is nearer JAX's than the fp32 answer is: its mean
  |JAX − port| (as a share of max|ref|, summed over the fields) at most
  1/``SMOOTH_RATIO`` of the fp32 answer's;
- ``fast_bf16`` rounds every operation: where no constant's rounding
  changes a bf16 result the packages agree to fp32 rounding, which an fp32
  reconstruction almost never does: the share of points that agree within
  ``AGREE_ULPS`` fp32 units of max|ref| is at least ``AGREE_SHARE`` and
  ``AGREE_RATIO`` times the fp32 answer's.

The cases, fp32 under each option, on grids of 32³ or less (2D: 64² or
less): K2's plain version against the JAX ``div_*`` on a regular and a
stretched z (the table form), WENO5 momentum and PositiveWENO5 tracers; K1's
through one quasi-AB2 step of its general route (a stretched z, PositiveWENO5
tracers), its ``G_prev``; K3a's against the JAX ``_core_tendencies``; K4b's
advective core against the JAX ``hydrostatic_advective_core`` on a small
lat-lon grid with flux-form WENO5 and BoundsPreservingWENO5. Each model
step (RK3 on K2's grids, the K1 step, a shallow-water step, a hydrostatic
step on a regional lat-lon grid) runs at a Δt at which advection moves each
advected field by more than ``MOVED`` times ``STEP_GATE`` of its scale, and
must end within ``STEP_GATE`` of it of the JAX state (the gate of
``tests/test_bf16_smoothness.py``).

The ``cuda`` cases hold each bf16 form of K1, K2, K3a and K4b against its
plain version on the card bit for bit over NaN-filled outputs, fp32 under
both options and fp64 under ``fast_bf16``, with an fp64 field on the
boundary where a direct round to bf16 and torch's round through fp32
differ, K2 also on (Bounded, Bounded, Bounded) and over an immersed bottom
and K1 on a Flat x; they need no JAX (``python -m pytest --noconftest -m
cuda tests/test_torch_bf16_kernels.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.interop import state_from_numpy
from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh
from clima_oceananigans_jl_torch.ops import fused_step as tfs
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection import fluxes as jfl
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JB
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from clima_oceananigans_jl_tpu.models.free_surface import (
        ExplicitFreeSurface as JExplicit)
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel as JN
    from clima_oceananigans_jl_tpu.models.shallow_water import (
        ShallowWaterModel as JSW, _core_tendencies as j_sw_core)
    from clima_oceananigans_jl_tpu.ops.fused_hydrostatic import (
        hydrostatic_advective_core as j_hydro_core)
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
OPTIONS = {"smoothness": dict(bf16_smoothness=True), "fast": dict(fast_bf16=True)}
#: (option, dtype) of the CPU cases (fp64 under fast_bf16 runs on the card)
CASES = [("smoothness", "f32"), ("fast", "f32")]
DTYPES = {"f32": (torch.float32, "float32"), "f64": (torch.float64, "float64")}
#: the largest |JAX − port| of each case's tendencies, as a share of each
#: field's max|ref| (the largest over its fields), read on these inputs with
#: torch 2.13 and jax on the CPU; a zero advection reads 1
MEASURED = {
    ("K2 regular", "smoothness"): 3.34e-4, ("K2 regular", "fast"): 3.61e-2,
    ("K2 stretched", "smoothness"): 6.97e-5, ("K2 stretched", "fast"): 1.91e-2,
    ("K1 general", "smoothness"): 3.36e-4, ("K1 general", "fast"): 1.14e-2,
    ("K3a", "smoothness"): 1.70e-4, ("K3a", "fast"): 1.74e-1,
    ("K4b WENO5", "smoothness"): 8.66e-7, ("K4b WENO5", "fast"): 1.83e-4,
    ("K4b BoundsPreservingWENO5", "smoothness"): 8.66e-7,
    ("K4b BoundsPreservingWENO5", "fast"): 1.36e-4,
}
MARGIN = 1.5
SMOOTH_RATIO = 1.5
AGREE_ULPS = 8
AGREE_SHARE = 0.05
AGREE_RATIO = 3.0
#: after one step, the gate of tests/test_bf16_smoothness.py
STEP_GATE = 5e-3
#: each step moves every advected field by more than this many gates
MOVED = 2


def schemes(pkg, option, names=("WENO5", "PositiveWENO5")):
    """The schemes ``names`` of package ``pkg`` ("jax", "torch") under
    ``option``; the port's without it under ``option`` None."""
    mod = J if pkg == "jax" else T
    return tuple(getattr(mod, n)(**OPTIONS.get(option, {})) for n in names)


def gaps(ref, got):
    """Per field that is not zero: (max |ref − got|, mean |ref − got|, the share of points
    within ``AGREE_ULPS`` fp32 units), each relative to max|ref|."""
    out = {}
    for k, r in ref.items():
        r = np.asarray(r, dtype=np.float64)
        d = np.abs(r - np.asarray(got[k], dtype=np.float64))
        scale = np.abs(r).max()
        if scale == 0:  # a field nothing moves (w from rest): exactly 0 in both
            assert d.max() == 0, k
            continue
        out[k] = (d.max() / scale, d.mean() / scale,
                  np.mean(d <= AGREE_ULPS * 2.0 ** -23 * scale))
    return out


def assert_bf16_answer(case, option, ref, got, fp32):
    """Hold the port's answer ``got`` under ``option`` against JAX's
    ``ref`` as the module docstring says, ``fp32`` the port's answer
    without the option; dicts of interior numpy arrays by field."""
    g, f = gaps(ref, got), gaps(ref, fp32)
    worst = max(v[0] for v in g.values())
    assert worst <= MARGIN * MEASURED[case, option], (case, option, g)
    if option == "smoothness":
        mean, mean32 = sum(v[1] for v in g.values()), sum(v[1] for v in f.values())
        assert mean * SMOOTH_RATIO <= mean32, (case, option, mean, mean32)
    else:
        share = np.mean([v[2] for v in g.values()])
        share32 = np.mean([v[2] for v in f.values()])
        assert share >= AGREE_SHARE and share >= AGREE_RATIO * share32, (
            case, option, share, share32)


def assert_step_close(ref, got, before, what):
    """Every field within ``STEP_GATE`` of its scale of the JAX state after
    the step, and each of ``before``'s fields moved by more than ``MOVED``
    gates by it."""
    for k, r in ref.items():
        r = np.asarray(r, dtype=np.float64)
        g = np.asarray(got[k], dtype=np.float64)
        assert np.all(np.isfinite(g)), (what, k)
        scale = np.abs(r).max() + 1e-12
        assert np.abs(g - r).max() < STEP_GATE * scale, (what, k)
    for k, b in before.items():
        r = np.asarray(ref[k], dtype=np.float64)
        moved = np.abs(r - np.asarray(b, dtype=np.float64)).max()
        assert moved > MOVED * STEP_GATE * np.abs(r).max(), (what, k, moved)


def smooth_fields(shape, names, seed, positive=()):
    """Smooth fields with a little noise, numpy-seeded: velocities ~0.1,
    ``positive`` tracers about 1 (PositiveWENO5's limiter then leaves the
    reconstruction as it is)."""
    rng = np.random.default_rng(seed)
    idx = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    out = {}
    for k, n in enumerate(names):
        phase = sum((0.3 + 0.1 * a + 0.05 * k) * x for a, x in enumerate(idx))
        f = np.sin(phase) + 0.01 * rng.standard_normal(shape)
        out[n] = 1.0 + 0.2 * f if n in positive else 0.1 * f
    return out


def interiors(grid, fields):
    return {k: np.asarray(grid.interior(v)) for k, v in fields.items()}


# -- K2 ----------------------------------------------------------------------

def k2_grids(z, dtype):
    size = (12, 10, 14)
    zf = (np.cumsum(np.r_[-0.5, np.linspace(0.02, 0.05, size[2])]) if z == "stretched"
          else (-0.5, 0.0))
    kw = dict(size=size, x=(0, 1), y=(0, 2), z=zf, topology=("periodic", "periodic", "bounded"))
    return (J.RectilinearGrid(dtype=getattr(jnp, DTYPES[dtype][1]), **kw),
            T.RectilinearGrid(dtype=DTYPES[dtype][0], device=DEVICE, **kw))


def k2_answers(option, dtype, z):
    """(JAX's, the port's, the port's fp32) interior tendencies of u, v, w
    and c on K2's grid."""
    jg, tg = k2_grids(z, dtype)
    jg, tg = jg.with_halo((3, 3, 3)), tg.with_halo((3, 3, 3))
    f = smooth_fields(tg.total_shape, ("u", "v", "w", "c"), 3, positive=("c",))
    f = {k: v.astype(DTYPES[dtype][1]) for k, v in f.items()}
    jm, jt = schemes("jax", option)
    ja = {k: jnp.asarray(v) for k, v in f.items()}
    ref = dict(u=-jfl.div_vu(jg, jm, ja["u"], ja["v"], ja["w"]),
               v=-jfl.div_vv(jg, jm, ja["u"], ja["v"], ja["w"]),
               w=-jfl.div_vw(jg, jm, ja["u"], ja["v"], ja["w"]),
               c=-jfl.div_Uc(jg, jt, ja["u"], ja["v"], ja["w"], ja["c"]))
    out = [{k: np.asarray(v)[tg.interior_slices] for k, v in ref.items()}]
    for opt in (option, None):
        tm, tt = schemes("torch", opt)
        got = tft.fused_advective_tendencies_reference(
            tg, tm, tt, *(torch.as_tensor(f[k]) for k in "uvw"),
            {"c": torch.as_tensor(f["c"])})
        assert got["u"].dtype == DTYPES[dtype][0]
        out.append({k: v[tg.interior_slices].numpy() for k, v in got.items()})
    return out


@pytest.mark.parametrize("z", ["regular", "stretched"])
@pytest.mark.parametrize("option,dtype", CASES)
def test_k2_plain_version_matches_jax(option, dtype, z):
    assert_bf16_answer(f"K2 {z}", option, *k2_answers(option, dtype, z))


@pytest.mark.parametrize("z", ["regular", "stretched"])
@pytest.mark.parametrize("option,dtype", CASES)
def test_k2_rk3_step_matches_jax(option, dtype, z):
    """One RK3 step at Δt = 0.1 (CFL ~0.3 on the smallest spacing)."""
    jg, tg = k2_grids(z, dtype)
    jm, jt = schemes("jax", option)
    tm, tt = schemes("torch", option)
    jmodel = JN(jg, advection=jm, tracer_advection=jt, tracers=("c",), buoyancy=None,
                timestepper="RungeKutta3", fused_advection=False)
    tmodel = T.NonhydrostaticModel(tg, advection=tm, tracer_advection=tt, tracers=("c",),
                                   timestepper="RungeKutta3")
    vals = smooth_fields(tg.shape, ("u", "v", "w", "c"), 5, positive=("c",))
    js = jmodel.initial_state(**vals)
    ts = tmodel.initial_state(**vals)
    before = interiors(jg, js["solution"])
    js = jmodel.step(js, 0.1)
    ts = tmodel.step(ts, 0.1)
    assert_step_close(interiors(jg, js["solution"]), interiors(tg, ts["solution"]),
                      {k: before[k] for k in ("u", "v", "c")}, f"K2 RK3 {option} {dtype} {z}")


# -- K1 ----------------------------------------------------------------------

@pytest.mark.parametrize("option,dtype", CASES)
def test_k1_general_branch_step_matches_jax(option, dtype):
    """K1's plain version on a stretched z, where the fused AB2 step takes
    its general route (K1's general instantiation, with the z rows and the
    tables), with WENO5 momentum and PositiveWENO5 tracers: its tendencies
    against the JAX model's ``tendencies`` on the same state, held as K2's;
    then one quasi-AB2 step at Δt = 0.05 to the step gate."""
    kw = dict(size=(10, 8, 12), x=(0, 1), y=(0, 1),
              z=np.cumsum(np.r_[-1.0, np.linspace(0.06, 0.1, 12)]),
              topology=("periodic", "periodic", "bounded"))
    jg = J.RectilinearGrid(dtype=getattr(jnp, DTYPES[dtype][1]), **kw)
    tg = T.RectilinearGrid(dtype=DTYPES[dtype][0], device=DEVICE, **kw)
    jm, jt = schemes("jax", option)
    jmodel = JN(jg, advection=jm, tracer_advection=jt, buoyancy=JB(),
                fused_advection=False)
    vals = smooth_fields(jg.shape, ("u", "v", "b"), 7)
    vals["b"] = 1e-2 * vals["b"]
    js = jmodel.initial_state(**vals)
    G = [interiors(jg, jmodel.tendencies(js))]
    models = []
    for opt in (option, None):
        tm, tt = schemes("torch", opt)
        tmodel = T.NonhydrostaticModel(tg, advection=tm, tracer_advection=tt,
                                       buoyancy=T.BuoyancyTracer())
        assert tmodel.fused_step and tfs.general_route(tmodel)
        ts = state_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, js))
        G.append(interiors(tg, tfs.fused_ab2_advance_reference(tmodel, ts, 0.05, True)[1]))
        models.append((tmodel, ts))
    assert_bf16_answer("K1 general", option, *G)
    before = interiors(jg, js["solution"])
    js = jax.jit(jmodel.step)(js, getattr(jnp, DTYPES[dtype][1])(0.05))
    tmodel, ts = models[0]
    ts = tmodel.step(ts, 0.05)
    assert_step_close(interiors(jg, js["solution"]), interiors(tg, ts["solution"]),
                      {k: before[k] for k in ("u", "v", "b")}, f"K1 {option} {dtype}")


# -- K3a ---------------------------------------------------------------------

def sw_grids(dtype):
    kw = dict(size=(32, 24, 1), x=(0, 2 * np.pi), y=(0, 1.5))
    jg = J.RectilinearGrid(topology=(J.PERIODIC, J.BOUNDED, J.FLAT),
                           dtype=getattr(jnp, DTYPES[dtype][1]), **kw)
    tg = T.RectilinearGrid(topology=(T.PERIODIC, T.BOUNDED, T.FLAT),
                           dtype=DTYPES[dtype][0], device=DEVICE, **kw)
    return jg, tg


#: the shallow-water cases' g: gravity waves of ~1 over the ~0.4 flow let a
#: step move the tracer by advection past the gate
SW_G = 1.0


@pytest.mark.parametrize("option,dtype", CASES)
def test_k3a_plain_version_matches_jax(option, dtype):
    """K3a's tendencies (uh and vh carried by their own means, the tracer by
    uh/h; Gh holds no reconstruction), then one step at Δt = 0.025."""
    jg, tg = sw_grids(dtype)
    jm, jt = schemes("jax", option)
    tm, tt = schemes("torch", option)
    jmodel = JSW(jg, gravitational_acceleration=SW_G, advection=jm, tracer_advection=jt,
                 tracers=("c",))
    tmodel = T.ShallowWaterModel(tg, gravitational_acceleration=SW_G, advection=tm,
                                 tracer_advection=tt, tracers=("c",))
    g = tmodel.grid
    f = smooth_fields(g.total_shape, ("uh", "vh", "h", "c"), 11, positive=("h", "c"))
    f["uh"], f["vh"] = 4 * f["uh"], 4 * f["vh"]
    f = {k: v.astype(DTYPES[dtype][1]) for k, v in f.items()}
    names = ("uh", "vh", "h", "c")
    ref = j_sw_core(jmodel.grid, jm, jt, SW_G, *(jnp.asarray(f[k]) for k in names[:3]),
                    [jnp.asarray(f["c"])], None)
    out = [interiors(g, dict(zip(names, ref)))]
    for opt in (option, None):
        m, t = schemes("torch", opt)
        got = tft.fused_shallow_water_tendencies_reference(
            g, m, t, SW_G, *(torch.as_tensor(f[k]) for k in names[:3]),
            [torch.as_tensor(f["c"])], None)
        out.append(interiors(g, dict(zip(names, got))))
    out = [{k: v for k, v in o.items() if k != "h"} for o in out]
    assert_bf16_answer("K3a", option, *out)
    vals = {k: g.interior(torch.as_tensor(f[k])).numpy() for k in names}
    js, ts = jmodel.initial_state(**vals), tmodel.initial_state(**vals)
    before = interiors(jmodel.grid, js["solution"])
    js = jmodel.step(js, 0.025)
    ts = tmodel.step(ts, 0.025)
    assert_step_close(interiors(jmodel.grid, js["solution"]), interiors(g, ts["solution"]),
                      {k: before[k] for k in ("uh", "vh", "c")}, f"K3a {option} {dtype}")


# -- K4b ---------------------------------------------------------------------

def latlon_kw(size):
    k = np.arange(size[2] + 1)
    return dict(size=size, longitude=(0, 360), latitude=(-60, 60),
                z=-1000.0 * (1.0 - k / size[2]) ** 1.5)


def region_kw(size):
    """A 2° regional lat-lon grid 100 m deep (bounded longitude)."""
    k = np.arange(size[2] + 1)
    return dict(size=size, longitude=(0, 2 * size[0]), latitude=(-size[1], size[1]),
                z=-100.0 * (1.0 - k / size[2]) ** 1.5)


#: the hydrostatic step: g of the explicit free surface, velocity scale, Δt
#: (gravity waves of ~3 m/s over a ~1 m/s flow on 2° cells)
HYDRO_STEP = dict(g=0.1, speed=10.0, dt=2e4)


@pytest.mark.parametrize("names", [("WENO5", "WENO5"),
                                   ("BoundsPreservingWENO5", "BoundsPreservingWENO5")],
                         ids=["WENO5", "BP"])
@pytest.mark.parametrize("option,dtype", CASES)
def test_k4b_plain_version_matches_jax(option, dtype, names):
    """K4b's advective core (flux-form momentum and tracers) on a small
    lat-lon grid, then one hydrostatic step (explicit free surface) on a
    regional one."""
    size = (12, 8, 5)
    jt, tt = getattr(jnp, DTYPES[dtype][1]), DTYPES[dtype][0]
    jg = JLL(dtype=jt, **latlon_kw(size)).with_halo((3, 3, 3))
    tg = T.LatitudeLongitudeGrid(dtype=tt, device=DEVICE, **latlon_kw(size)).with_halo((3, 3, 3))
    js_m, js_t = schemes("jax", option, names)
    f = smooth_fields(tg.total_shape, ("u", "v", "w", "c", "b"), 13, positive=("c",))
    f["w"], f["b"] = 1e-2 * f["w"], 1e-2 * f["b"]
    f = {k: v.astype(DTYPES[dtype][1]) for k, v in f.items()}
    ja = {k: jnp.asarray(v) for k, v in f.items()}
    ta = {k: torch.as_tensor(v) for k, v in f.items()}
    tracers = ("c", "b")
    ref = j_hydro_core(jg, js_m, js_t, None, tracers, ja["u"], ja["v"], ja["w"],
                       {n: ja[n] for n in tracers})
    out = [{k: np.asarray(jg.interior(ref[k])) for k in ("u", "v") + tracers}]
    for opt in (option, None):
        ts_m, ts_t = schemes("torch", opt, names)
        got = tfh.hydrostatic_advective_core(tg, ts_m, ts_t, None, tracers, ta["u"], ta["v"],
                                             ta["w"], {n: ta[n] for n in tracers})
        out.append({k: tg.interior(got[k]).numpy() for k in ("u", "v") + tracers})
    assert_bf16_answer(f"K4b {names[0]}", option, *out)
    # one step of the model
    size, c = (10, 8, 5), HYDRO_STEP
    ts_m, ts_t = schemes("torch", option, names)
    grids = (JLL(dtype=jt, **region_kw(size)),
             T.LatitudeLongitudeGrid(dtype=tt, device=DEVICE, **region_kw(size)))
    jmodel = JH(grids[0], momentum_advection=js_m, tracer_advection=js_t, tracers=("c",),
                buoyancy=JB(), coriolis=J.HydrostaticSphericalCoriolis(),
                free_surface=JExplicit(gravitational_acceleration=c["g"]))
    tmodel = T.HydrostaticFreeSurfaceModel(
        grids[1], momentum_advection=ts_m, tracer_advection=ts_t, tracers=("c",),
        buoyancy=T.BuoyancyTracer(), coriolis=T.HydrostaticSphericalCoriolis(),
        free_surface=T.ExplicitFreeSurface(gravitational_acceleration=c["g"]))
    assert tfh.unsupported_reason(tmodel) is None
    vals = smooth_fields(size, ("u", "v", "c", "b"), 19, positive=("c",))
    vals = dict(u=c["speed"] * vals["u"], v=c["speed"] * vals["v"], c=vals["c"],
                b=1e-3 * vals["b"])
    js, ts = jmodel.initial_state(**vals), tmodel.initial_state(**vals)
    before = interiors(jmodel.grid, js["solution"])
    js = jmodel.step(js, c["dt"])
    ts = tmodel.step(ts, c["dt"])
    assert_step_close(interiors(jmodel.grid, js["solution"]),
                      interiors(tmodel.grid, ts["solution"]),
                      {k: before[k] for k in ("u", "v", "c")}, f"K4b {option} {dtype}")


def to_bf16(x):
    """fp32 values rounded to bfloat16, to nearest even, and back (numpy)."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def fast_stream(a, const, eps):
    """WENO5(fast_bf16=True).stream_reconstruct in numpy: every operation
    in fp32 on bf16 values and rounded once, in the plain version's tree;
    ``const`` maps each Python constant to the value an operation uses."""
    r = to_bf16
    c = [r(x) for x in a]
    d1 = [r(c[i + 1] - c[i]) for i in range(4)]
    d2 = [r(d1[i + 1] - d1[i]) for i in range(3)]
    two = const(2.0)
    s = (r(d2[0] + r(two * d1[1])), r(d1[1] + d1[2]), r(d2[2] - r(two * d1[2])))
    b = [r(r(r(const(13.0 / 12.0) * d) * d) + r(const(0.25) * r(q * q)))
         for d, q in zip(d2, s)]
    six = np.float32(6.0)
    p = (r(c[2] + r(r(r(const(5.0) * d1[1]) - r(two * d1[0])) / six)),
         r(c[2] + r(r(r(two * d1[2]) + d1[1]) / six)),
         r(c[2] + r(r(r(const(4.0) * d1[2]) - d1[3]) / six)))
    e = [r(x + eps) for x in b]
    t = [r(x * x) for x in e]
    g = (r(const(0.1) * r(t[1] * t[2])), r(const(0.6) * r(t[0] * t[2])),
         r(const(0.3) * r(t[0] * t[1])))
    num = r(r(r(g[0] * p[0]) + r(g[1] * p[1])) + r(g[2] * p[2]))
    return r(num / r(r(g[0] + g[1]) + g[2]))


def test_fast_bf16_differs_from_jax_only_in_the_constants():
    """Why the two packages' fast_bf16 answers differ: emulated operation
    by operation, JAX's stream reconstruction is the one whose Python
    constants are rounded to bf16 (their weak type), bit for bit, and the
    port's the one that takes them in fp32 (torch's opmath; the CPU's
    torch adds eps as a bf16 value), bit for bit; the two differ."""
    from clima_oceananigans_jl_torch.advection import schemes as tsch
    from clima_oceananigans_jl_tpu.advection import schemes as jsch
    rng = np.random.default_rng(0)
    x = np.linspace(0, 20, 4096)
    c = (1 + 0.2 * np.sin(x) + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)
    c = c[:, None, None]
    ja = jsch.upwind_stream(jnp.asarray(c), jnp.ones(c.shape, bool), 0, True)
    ta = tsch.upwind_stream(torch.as_tensor(c), torch.ones(c.shape, dtype=torch.bool), 0, True)
    a = [t.numpy() for t in ta]
    eps = to_bf16(np.float32(1e-6))
    as_jax = fast_stream(a, lambda k: to_bf16(np.float32(k)), eps)
    as_torch = fast_stream(a, np.float32, eps)
    ref = np.asarray(J.WENO5(fast_bf16=True).stream_reconstruct(ja))
    got = T.WENO5(fast_bf16=True).stream_reconstruct(ta).numpy()
    assert np.array_equal(as_jax, ref)
    assert np.array_equal(as_torch, got)
    assert not np.array_equal(ref, got)


def test_kernel_scheme_carries_the_bf16_option():
    """The kernels' scheme argument: the code plus 16 times the option
    (``fast_bf16`` over ``bf16_smoothness``, as the plain version's
    ``stream_reconstruct`` takes it), in K1/K2's and K3a's arguments alike;
    the other schemes carry none."""
    assert tft.kernel_scheme(T.WENO5()) == (1, 1e-6)
    assert tft.kernel_scheme(T.WENO5(bf16_smoothness=True)) == (1 + 16, 1e-6)
    assert tft.kernel_scheme(T.WENO5(fast_bf16=True, bf16_smoothness=True)) == (1 + 32, 1e-6)
    assert tft.kernel_scheme(T.PositiveWENO5(fast_bf16=True))[0] == 3 + 32
    assert tft.kernel_scheme(T.BoundsPreservingWENO5(bf16_smoothness=True))[0] == 7 + 16
    assert tft.kernel_scheme(T.UpwindBiasedFifthOrder()) == (2, 0.0)
    g = T.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1), device=DEVICE)
    ints, _ = tft.advection_args(g, T.WENO5(fast_bf16=True), T.PositiveWENO5(), 4)
    assert (ints[7], ints[8]) == (33, 3)
    sw = T.RectilinearGrid(size=(8, 8, 1), extent=(1, 1),
                           topology=(T.PERIODIC, T.PERIODIC, T.FLAT), device=DEVICE)
    args = tft.shallow_water_args(sw, T.WENO5(bf16_smoothness=True),
                                  T.BoundsPreservingWENO5(fast_bf16=True), 3, 9.8)
    assert args[5:7] == (17, 39)


# -- the kernels on the card -------------------------------------------------

#: (option, dtype) of the card cases
CARD_CASES = [("smoothness", "f32"), ("fast", "f32"), ("fast", "f64")]


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def poison(shape, dtype, n=8):
    """NaN-filled blocks left in the caching allocator, so that an output
    point a kernel does not write stays NaN."""
    blocks = [torch.full(shape, float("nan"), dtype=dtype, device="cuda") for _ in range(n)]
    del blocks


def card_fields(shape, dtype, names, seed):
    """Random fields on the card; in fp64 every 97th value on the boundary
    where torch's round to bf16 (through fp32: 1.0) and a direct one
    (1.0078125) differ."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {n: torch.randn(shape, generator=gen, dtype=dtype, device="cuda") for n in names}
    if dtype == torch.float64:
        for f in out.values():
            f.view(-1)[::97] = 1 + 2 ** -8 + 2 ** -40
    return out


def equal(got, ref, what):
    assert torch.equal(got, ref), (what, float((got - ref).abs().nan_to_num(1e30).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("names", [("WENO5", "PositiveWENO5"),
                                   ("BoundsPreservingWENO5", "WENO5"),
                                   ("PositiveWENO5", "BoundsPreservingWENO5")],
                         ids=["W-PW", "BP-W", "PW-BP"])
@pytest.mark.parametrize("z", ["regular", "stretched"])
@pytest.mark.parametrize("option,dtype", CARD_CASES)
def test_cuda_k2_bf16_forms_match_plain_version(option, dtype, z, names):
    needs_card()
    dt = DTYPES[dtype][0]
    size = (30, 27, 45)
    zf = (np.cumsum(np.r_[-0.5, np.linspace(0.01, 0.02, size[2])]) if z == "stretched"
          else (-0.5, 0.0))
    g = T.RectilinearGrid(size=size, x=(0, 1), y=(0, 1), z=zf, dtype=dt, device="cuda",
                          topology=("periodic", "periodic", "bounded"))
    m, t = schemes("torch", option, names)
    model = T.NonhydrostaticModel(g, advection=m, tracer_advection=t, tracers=("c",))
    f = card_fields(model.grid.total_shape, dt, ("u", "v", "w", "c"), 3)
    args = (model.grid, m, t, f["u"], f["v"], f["w"], {"c": f["c"]})
    poison(model.grid.total_shape, dt)
    before = tft.fused_advective_tendencies.launches
    got = tft.fused_advective_tendencies(*args)
    assert tft.fused_advective_tendencies.launches == before + 1
    ref = tft.fused_advective_tendencies_reference(*args)
    gi = model.grid.interior
    for k in got:
        equal(gi(got[k]), gi(ref[k]), k)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "general"])
@pytest.mark.parametrize("option,dtype", CARD_CASES)
def test_cuda_k1_bf16_forms_match_plain_version(option, dtype, route):
    needs_card()
    dt = DTYPES[dtype][0]
    z = ((-1.0, 0.0) if route == "fused" else
         np.cumsum(np.r_[-1.0, np.linspace(0.015, 0.03, 45)]))
    g = T.RectilinearGrid(size=(30, 27, 45), x=(0, 1), y=(0, 1), z=z, dtype=dt,
                          topology=("periodic", "periodic", "bounded"), device="cuda")
    m, t = schemes("torch", option)
    model = T.NonhydrostaticModel(g, advection=m, tracer_advection=t,
                                  buoyancy=T.BuoyancyTracer(), tracers=("b", "c"))
    assert model.fused_step and tfs.general_route(model) == (route == "general")
    vals = {k: v.cpu().numpy() for k, v in card_fields(g.shape, dt, ("u", "v", "b", "c"),
                                                        5).items()}
    vals["c"] = 1.0 + 0.1 * vals["c"]
    state = model.initial_state(**vals)
    state = model.step(state, 1e-4)  # G_prev from a first step with K1
    for euler in (True, False):
        poison(model.grid.total_shape, dt)
        before = tfs.fused_ab2_advance.launches
        psi_k, g_k = tfs.fused_ab2_advance(model, state, 1e-4, euler)
        assert tfs.fused_ab2_advance.launches == before + 1
        psi_r, g_r = tfs.fused_ab2_advance_reference(model, state, 1e-4, euler)
        for k in psi_k:
            equal(psi_k[k], psi_r[k], f"psi' {k}")
            equal(g_k[k], g_r[k], f"G {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("option,dtype", CARD_CASES)
def test_cuda_k3a_bf16_forms_match_plain_version(option, dtype):
    needs_card()
    dt = DTYPES[dtype][0]
    g = T.RectilinearGrid(size=(300, 177, 1), x=(0, 1), y=(0, 1), dtype=dt, device="cuda",
                          topology=(T.PERIODIC, T.BOUNDED, T.FLAT), halo=(3, 3, 0))
    m, t = schemes("torch", option)
    f = card_fields(g.total_shape, dt, ("uh", "vh", "h", "c"), 7)
    f["h"] = 1.0 + 0.05 * f["h"]
    args = (g, m, t, 9.5, f["uh"], f["vh"], f["h"], [f["c"]], None)
    poison(g.total_shape, dt)
    got = tft.fused_shallow_water_tendencies(*args)
    ref = tft.fused_shallow_water_tendencies_reference(*args)
    for k, (a, b) in enumerate(zip(got, ref)):
        equal(g.interior(a), g.interior(b), k)


@pytest.mark.cuda
@pytest.mark.parametrize("names", [("WENO5", "WENO5"),
                                   ("BoundsPreservingWENO5", "PositiveWENO5")],
                         ids=["WENO5", "BP-PW"])
@pytest.mark.parametrize("option,dtype", CARD_CASES)
def test_cuda_k4b_bf16_forms_match_plain_version(option, dtype, names):
    needs_card()
    dt = DTYPES[dtype][0]
    size = (37, 21, 13)
    g = T.LatitudeLongitudeGrid(dtype=dt, device="cuda", **latlon_kw(size))
    m, t = schemes("torch", option, names)
    model = T.HydrostaticFreeSurfaceModel(
        g, momentum_advection=m, tracer_advection=t, tracers=("c",),
        buoyancy=T.BuoyancyTracer(), coriolis=T.HydrostaticSphericalCoriolis(),
        free_surface=T.SplitExplicitFreeSurface(substeps=8))
    vals = {k: v.cpu().numpy() for k, v in card_fields(size, dt, ("u", "v", "c", "b"),
                                                        9).items()}
    vals = dict(u=0.1 * vals["u"], v=0.1 * vals["v"], c=1.0 + 0.1 * vals["c"],
                b=1e-3 * vals["b"])
    state = model.initial_state(**vals)
    for _ in range(2):
        state = model.step(state, 60.0)
    for adv in ((60.0, False), None):
        poison(model.grid.total_shape, dt, 12)
        got = tfh.fused_hydrostatic_tendencies(model, state, adv)
        ref = tfh.fused_hydrostatic_tendencies_reference(model, state, adv)
        pairs = [(got, ref)] if adv is None else [(got[0], ref[0]), (got[1], ref[1])]
        for a, b in pairs:
            for k in a:
                equal(model.grid.interior(a[k]), model.grid.interior(b[k]), k)


def wall_mask(grid, name):
    """The interior, and the wall face of velocity ``name`` on its bounded
    axis (with-halo index h + n over the interior of the other axes)."""
    mask = torch.zeros(grid.total_shape, dtype=torch.bool, device=grid.device)
    mask[grid.interior_slices] = True
    axis = {"u": 0, "v": 1, "w": 2}.get(name)
    if axis is not None and grid.topology[axis] is T.BOUNDED:
        sl = list(grid.interior_slices)
        sl[axis] = grid.halo[axis] + grid.shape[axis]
        mask[tuple(sl)] = True
    return mask


def unit_seamount(x, y):
    return -1.0 + 0.6 * torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("names", [("WENO5", "PositiveWENO5"),
                                   ("BoundsPreservingWENO5", "WENO5")], ids=["W-PW", "BP-W"])
@pytest.mark.parametrize("where", ["B,B,B", "immersed"])
@pytest.mark.parametrize("option,dtype", CARD_CASES)
def test_cuda_k2_bf16_forms_on_walls_and_bottom(option, dtype, where, names):
    """K2's bf16 forms with bounded x and y (the near-wall bounds read at
    run time, the velocities' wall faces written) and over an immersed
    bottom (the clear flags), bit for bit on the interior and the wall
    faces, every other halo point exactly 0."""
    needs_card()
    dt = DTYPES[dtype][0]
    topology = (("bounded",) * 3 if where == "B,B,B"
                else ("periodic", "periodic", "bounded"))
    g = T.RectilinearGrid(size=(67, 45, 29), x=(0, 1), y=(0, 1), z=(-1, 0),
                          topology=topology, dtype=dt, device="cuda")
    m, t = schemes("torch", option, names)
    bottom = T.GridFittedBottom(unit_seamount) if where == "immersed" else None
    model = T.NonhydrostaticModel(g, advection=m, tracer_advection=t, tracers=("c",),
                                  immersed_boundary=bottom)
    f = card_fields(model.grid.total_shape, dt, ("u", "v", "w", "c"), 11)
    if bottom is not None:
        f = model.immersed_boundary.mask_state(model, {"solution": f})["solution"]
    args = (model.grid, m, t, f["u"], f["v"], f["w"], {"c": f["c"]})
    poison(model.grid.total_shape, dt)
    before = tft.fused_advective_tendencies.launches
    got = tft.fused_advective_tendencies(*args)
    assert tft.fused_advective_tendencies.launches == before + 1
    ref = tft.fused_advective_tendencies_reference(*args)
    for k in ref:
        mask = wall_mask(model.grid, k)
        equal(got[k][mask], ref[k][mask], k)
        rest = got[k][~mask]
        assert not rest.isnan().any() and not rest.any(), f"{k}: halo"


@pytest.mark.cuda
@pytest.mark.parametrize("option,dtype", CARD_CASES)
def test_cuda_k1_bf16_forms_on_a_flat_x(option, dtype):
    """K1's bf16 forms on (Flat, Periodic, Bounded), one of the topologies
    the fused branch takes beside (P, P, B)."""
    needs_card()
    dt = DTYPES[dtype][0]
    g = T.RectilinearGrid(size=(1, 60, 45), x=(0, 1), y=(0, 1), z=(-1, 0), dtype=dt,
                          topology=("flat", "periodic", "bounded"), device="cuda")
    m, t = schemes("torch", option)
    model = T.NonhydrostaticModel(g, advection=m, tracer_advection=t,
                                  buoyancy=T.BuoyancyTracer(), tracers=("b", "c"))
    assert model.fused_step
    vals = {k: v.cpu().numpy() for k, v in card_fields(g.shape, dt, ("v", "b", "c"),
                                                        13).items()}
    vals["c"] = 1.0 + 0.1 * vals["c"]
    state = model.step(model.initial_state(**vals), 1e-4)
    for euler in (True, False):
        poison(model.grid.total_shape, dt)
        before = tfs.fused_ab2_advance.launches
        psi_k, g_k = tfs.fused_ab2_advance(model, state, 1e-4, euler)
        assert tfs.fused_ab2_advance.launches == before + 1
        psi_r, g_r = tfs.fused_ab2_advance_reference(model, state, 1e-4, euler)
        for k in psi_k:
            equal(psi_k[k], psi_r[k], f"psi' {k}")
            equal(g_k[k], g_r[k], f"G {k}")


@pytest.mark.cuda
def test_cuda_torch_applies_python_constants_in_fp32():
    """The rule the kernels' bf16 forms follow on the card: torch's CUDA
    kernels apply a Python constant to a bf16 tensor as its fp32 value (one
    fp32 operation, one round), not rounded to bf16 first, and cast fp64 to
    bf16 through fp32."""
    needs_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(1 << 16, generator=gen, device="cuda").to(torch.bfloat16)
    y = (x.float() * 1e-5).to(torch.bfloat16)
    for got, t, c, mul in (((13.0 / 12.0) * x, x, 13.0 / 12.0, True), (0.1 * x, x, 0.1, True),
                           (x * 0.6, x, 0.6, True), (y + 1e-6, y, 1e-6, False)):
        c32 = torch.tensor(c, dtype=torch.float32, device="cuda")
        as_fp32 = lambda k: (t.float() * k if mul else t.float() + k).to(torch.bfloat16)
        assert torch.equal(got, as_fp32(c32)), c
        assert not torch.equal(got, as_fp32(c32.to(torch.bfloat16).float())), c
    d = torch.tensor([1 + 2 ** -8 + 2 ** -40], dtype=torch.float64, device="cuda")
    assert d.to(torch.bfloat16).item() == 1.0  # a direct round gives 1.0078125
