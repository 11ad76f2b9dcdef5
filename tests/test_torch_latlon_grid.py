"""Port parity: lat-lon grids, stretched axes and the operators on them.

The same grids are built in ``clima_oceananigans_jl_tpu`` and
``clima_oceananigans_jl_torch`` (f64, and f32 for the metrics), the same
inputs made with numpy from a seed go through both:

- axes and lat-lon metrics: bitwise (both come from the same float64
  numpy arithmetic, then one cast);
- WENO5's stretched-axis tables and the stretched-axis ``transport``
  (a stretched z, x or latitude): ≤ 1e-13 of max|ref| (the same
  expression trees; XLA may fuse them);
- ``div_xy_ccc``, ``zeta3_ffc``, ``HydrostaticSphericalCoriolis`` (both
  schemes), the four vector-invariant schemes in 3D (with the vertical
  term), ``div_Uc`` and pHY′ on lat-lon and stretched-z metrics: ≤ 1e-13
  of max|ref| (the sine of the Coriolis parameter may differ in its last
  bit between numpy-backed XLA and PyTorch).

The grids default to the card: one test pins that without touching one.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
import clima_oceananigans_jl_tpu as J
from clima_oceananigans_jl_torch.advection import fluxes as tfl
from clima_oceananigans_jl_torch.advection import reconstruction_tables as trt
from clima_oceananigans_jl_torch.advection import schemes as tsc
from clima_oceananigans_jl_torch.buoyancy import buoyancy as tbu
from clima_oceananigans_jl_torch.ops import operators as top
from clima_oceananigans_jl_tpu.advection import fluxes as jfl
from clima_oceananigans_jl_tpu.advection import reconstruction_tables as jrt
from clima_oceananigans_jl_tpu.advection import schemes as jsc
from clima_oceananigans_jl_tpu.advection.vector_invariant import (
    VectorInvariant as JVI)
from clima_oceananigans_jl_tpu.buoyancy import buoyancy as jbu
from clima_oceananigans_jl_tpu.coriolis.coriolis import (
    HydrostaticSphericalCoriolis as JSph)
from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
from clima_oceananigans_jl_tpu.ops import operators as jop

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
SIZE = (24, 12, 8)
RTOL = 1e-13
LOCS = {"ccc": J.CENTER, "fcc": J.U_LOC, "cfc": J.V_LOC, "ccf": J.W_LOC,
        "ffc": (J.F, J.F, J.C)}


def zfaces(nz, depth=3000.0, p=1.8):
    k = np.arange(nz + 1)
    return -depth * (1.0 - k / nz) ** p


def latlon(size=SIZE, dtype="f64", z=None, latitude=(-75, 75), longitude=(0, 360)):
    z = zfaces(size[2]) if z is None else z
    jd, td = {"f64": (jnp.float64, torch.float64),
              "f32": (jnp.float32, torch.float32)}[dtype]
    jg = JLL(size=size, longitude=longitude, latitude=latitude, z=z, dtype=jd)
    tg = T.LatitudeLongitudeGrid(size=size, longitude=longitude,
                                 latitude=latitude, z=z, dtype=td, device=DEVICE)
    return jg, tg


def same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def close(ref, got, rtol=RTOL, label=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (label, ref.shape, got.shape)
    scale = np.abs(ref).max()
    err = np.abs(ref - got).max()
    assert err <= rtol * scale, f"{label}: max|diff| {err:.3e} > {rtol:g}·{scale:.3e}"


def fields(shape, n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [scale * rng.standard_normal(shape) for _ in range(n)]


def test_grids_default_to_the_card():
    """Every entry point lands on the card unless the caller asks for the
    CPU: the grids' device defaults to "cuda", and without a card a grid
    built with the default raises rather than landing on the CPU."""
    for cls in (T.RectilinearGrid, T.LatitudeLongitudeGrid):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            T.RectilinearGrid(size=(4, 4, 4), extent=(1, 1, 1))
        with pytest.raises((AssertionError, RuntimeError)):
            T.LatitudeLongitudeGrid(size=(4, 4, 4), longitude=(0, 360),
                                    latitude=(-60, 60), z=(-1, 0))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("zkind", ["stretched", "regular"])
def test_latlon_axes_and_metrics_are_bitwise(dtype, zkind):
    jg, tg = latlon(dtype=dtype, z=None if zkind == "stretched" else (-3000, 0))
    assert tg.shape == jg.shape and tg.total_shape == jg.total_shape
    assert tg.topology == jg.topology and tg.curvilinear and not tg.hregular
    assert tg.regular == tuple(a.regular for a in jg._axes)
    for ja, ta in zip(jg._axes, tg._axes):
        for name in ("cf", "cc", "dc", "df"):
            assert same(getattr(ja, name), getattr(ta, name)), name
        assert ja.extent == ta.extent
    for loc in LOCS.values():
        for m in ("dx", "dy", "dz", "Ax", "Ay", "Az", "V"):
            assert same(getattr(jg, m)(loc), getattr(tg, m)(loc)), (m, loc)
        for jn, tn in zip(jg.nodes(loc, with_halo=True), tg.nodes(loc, with_halo=True)):
            assert same(jn, tn)
    assert jg.min_spacing() == tg.min_spacing()


def test_latlon_with_halo_bounded_longitude_and_stretched_rebuild():
    jg, tg = latlon(size=(10, 8, 6), longitude=(-40, 40), latitude=(10, 60))
    assert tg.topology == (T.BOUNDED, T.BOUNDED, T.BOUNDED)
    jh, th = jg.with_halo((4, 4, 4)), tg.with_halo((4, 4, 4))
    assert th.halo == jh.halo == (4, 4, 4) and th.radius == jh.radius
    for ja, ta in zip(jh._axes, th._axes):
        for name in ("cf", "cc", "dc", "df"):
            assert same(getattr(ja, name), getattr(ta, name)), name
    for loc in LOCS.values():
        for m in ("dx", "dy", "Az", "V"):
            assert same(getattr(jh, m)(loc), getattr(th, m)(loc)), (m, loc)


@pytest.mark.parametrize("spec", ["array", "callable"])
def test_stretched_rectilinear_axes_are_bitwise(spec):
    faces = zfaces(7, depth=1.0, p=1.5)
    z = faces if spec == "array" else (lambda k: faces[k])
    kw = dict(size=(6, 5, 7), x=(0, 2), y=(-1, 1), z=z,
              topology=("periodic", "bounded", "bounded"))
    jg = J.RectilinearGrid(dtype=jnp.float64, **kw)
    tg = T.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw)
    assert not tg.z_regular and tg.hregular and tg.regular == (True, True, False)
    for ja, ta in zip(jg._axes, tg._axes):
        for name in ("cf", "cc", "dc", "df"):
            assert same(getattr(ja, name), getattr(ta, name)), name
    for loc in LOCS.values():
        for m in ("dz", "V", "Az"):
            assert same(getattr(jg, m)(loc), getattr(tg, m)(loc)), (m, loc)
    jh, th = jg.with_halo((3, 3, 4)), tg.with_halo((3, 3, 4))
    for ja, ta in zip(jh._axes, th._axes):
        assert same(ja.cf, ta.cf) and same(ja.dc, ta.dc) and same(ja.df, ta.df)
    assert jg.min_spacing() == tg.min_spacing()


@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
def test_weno5_tables_match(to_f):
    jg, tg = latlon()
    jt, tt = jrt.weno5_tables(jg, 2, to_f), trt.weno5_tables(tg, 2, to_f)
    assert trt.weno5_tables(tg, 2, to_f) is tt, "tables are computed once"
    assert trt.weno5_tables(tg, 0, to_f) is None
    for side in ("left", "right"):
        for (jd, jc, jo, jk), (td, tc, to, tk) in zip(jt[side], tt[side]):
            assert jo == to and jk == tk
            h, n = tg.Hz, tg.Nz
            # entries whose stencil wraps the array ends are never read
            ok = slice(h, h + n + 1)
            close(np.asarray(jd)[ok], td[ok], label=f"{side} d")
            for a, b in zip(jc, tc):
                close(np.asarray(a)[ok], b[ok], label=f"{side} c")


def stretched_latitude(nf=13):
    """Latitude faces from −70° to 70°, finer near the equator."""
    s = np.linspace(-1.0, 1.0, nf)
    return 70.0 * (0.6 * s + 0.4 * s ** 3)


@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
def test_stretched_latitude_axis_and_tables_match(to_f):
    """A lat-lon grid on stretched latitude faces: axes and metrics bitwise,
    the y axis' WENO5 tables (K4b reads them as rows) as the z ones."""
    jg, tg = latlon(size=(12, 12, 6), latitude=stretched_latitude())
    assert not tg.y_regular and not jg._axes[1].regular
    for ja, ta in zip(jg._axes, tg._axes):
        assert same(ja.cf, ta.cf) and same(ja.dc, ta.dc) and same(ja.df, ta.df)
    for loc in LOCS.values():
        assert same(jg.dx(loc), tg.dx(loc)) and same(jg.Az(loc), tg.Az(loc))
    jt, tt = jrt.weno5_tables(jg, 1, to_f), trt.weno5_tables(tg, 1, to_f)
    ok = slice(tg.Hy, tg.Hy + tg.Ny + 1)
    for side in ("left", "right"):
        for (jd, jc, jo, jk), (td, tc, to, tk) in zip(jt[side], tt[side]):
            assert jo == to and jk == tk
            close(np.asarray(jd).reshape(-1)[ok], td.reshape(-1)[ok], label=f"{side} d")
            for a, b in zip(jc, tc):
                close(np.asarray(a).reshape(-1)[ok], b.reshape(-1)[ok], label=f"{side} c")


@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
@pytest.mark.parametrize("axis_kind", ["stretched-bounded-z", "stretched-periodic-x",
                                       "stretched-bounded-latitude"])
def test_stretched_transport_matches(to_f, axis_kind):
    if axis_kind == "stretched-bounded-z":
        jg, tg = latlon(size=(12, 8, 10))
        axis = 2
    elif axis_kind == "stretched-bounded-latitude":
        jg, tg = latlon(size=(10, 12, 6), latitude=stretched_latitude())
        axis = 1
    else:
        xf = np.cumsum(np.r_[0.0, 1.0 + 0.3 * np.sin(np.arange(12))])
        kw = dict(size=(12, 8, 6), x=xf, y=(0, 1), z=(-1, 0),
                  topology=("periodic", "periodic", "bounded"))
        jg = J.RectilinearGrid(dtype=jnp.float64, **kw)
        tg = T.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw)
        axis = 0
    vel, c = fields(tg.total_shape, 2, seed=3)
    ref = jsc.transport(J.WENO5(), jnp.asarray(vel), jnp.asarray(c), axis, to_f, jg)
    got = tsc.transport(T.WENO5(), torch.as_tensor(vel), torch.as_tensor(c), axis,
                        to_f, tg)
    # the flux locations every interior divergence reads
    cut = [slice(h, h + n + 1) for h, n in zip(tg.halo, tg.shape)]
    close(np.asarray(ref)[tuple(cut)], got[tuple(cut)], label="transport")


def test_div_xy_zeta_and_spherical_coriolis_match():
    jg, tg = latlon()
    u, v, w = fields(tg.total_shape, 3, seed=4, scale=0.1)
    ju, jv, jw = (jnp.asarray(a) for a in (u, v, w))
    tu, tv, tw = (torch.as_tensor(a) for a in (u, v, w))
    cut = jg.interior
    close(cut(jop.div_xy_ccc(ju, jv, jg)), tg.interior(top.div_xy_ccc(tu, tv, tg)))
    close(cut(jop.zeta3_ffc(ju, jv, jg)), tg.interior(top.zeta3_ffc(tu, tv, tg)))
    for scheme in ("energy", "enstrophy"):
        jc, tc = JSph(scheme=scheme), T.HydrostaticSphericalCoriolis(scheme=scheme)
        close(jc._f_ff(jg), tc.f_ff(tg), label="f")
        close(cut(jc.x_f_cross_U(jg, ju, jv, jw)),
              tg.interior(tc.x_f_cross_U(tg, tu, tv, tw)), label=scheme + " x")
        close(cut(jc.y_f_cross_U(jg, ju, jv, jw)),
              tg.interior(tc.y_f_cross_U(tg, tu, tv, tw)), label=scheme + " y")
    with pytest.raises(ValueError):
        T.HydrostaticSphericalCoriolis(scheme="momentum")


@pytest.mark.parametrize("scheme", ["enstrophy", "energy", "weno", "weno_velocity"])
def test_vector_invariant_3d_on_latlon_matches(scheme):
    jg, tg = latlon()
    u, v, w = fields(tg.total_shape, 3, seed=5, scale=0.1)
    ja = [jnp.asarray(a) for a in (u, v, w)]
    ta = [torch.as_tensor(a) for a in (u, v, w)]
    jvi, tvi = JVI(scheme=scheme), T.VectorInvariant(scheme=scheme)
    close(jg.interior(jvi.U_dot_grad_u(jg, *ja)),
          tg.interior(tvi.U_dot_grad_u(tg, *ta)), label="u")
    close(jg.interior(jvi.U_dot_grad_v(jg, *ja)),
          tg.interior(tvi.U_dot_grad_v(tg, *ta)), label="v")


@pytest.mark.parametrize("scheme", ["weno5", "centered"])
def test_div_uc_and_phy_on_latlon_stretched_z_match(scheme):
    jg, tg = latlon()
    js, ts = {"weno5": (J.WENO5(), T.WENO5()),
              "centered": (J.CenteredSecondOrder(), T.CenteredSecondOrder())}[scheme]
    u, v, w, c = fields(tg.total_shape, 4, seed=6)
    ref = jfl.div_Uc(jg, js, *(jnp.asarray(a) for a in (u, v, w, c)))
    got = tfl.div_Uc(tg, ts, *(torch.as_tensor(a) for a in (u, v, w, c)))
    close(jg.interior(ref), tg.interior(got), label="div_Uc")
    ph_ref = jbu.hydrostatic_pressure_anomaly(J.BuoyancyTracer(), jg,
                                              {"b": jnp.asarray(c)})
    ph = tbu.hydrostatic_pressure_anomaly(T.BuoyancyTracer(), tg,
                                          {"b": torch.as_tensor(c)})
    close(jg.interior(ph_ref), tg.interior(ph), 1e-12, "pHY")
