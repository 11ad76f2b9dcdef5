"""Port parity: fields, abstract operations, model fields and units.

Every abstract operation (unary, binary and multiary operations with
their interpolation to a common location, derivatives, ``at``, grid
metrics, kernel-function and conditional operations, and expressions of
them) is computed by each package on the same numpy-seeded with-halo
fields of a stretched-z box, a lat-lon grid and an immersed box (f64);
``compute``'s Field, halos filled, must be the JAX one bit for bit.
``Average`` and ``Integral`` must agree within 1e-13 relative (their sums
reassociate), with zero weight in the solid of the immersed grid. Field
arithmetic, ``windowed``, ``interpolate``, ``regrid``, ``FunctionField``,
``set_field`` from other fields and operations, the field constructors
and tuples, ``BuoyancyField`` (a buoyancy tracer and a linear seawater
equation of state) and ``PressureField`` are held to JAX the same way;
``prettytime`` and the unit constants give JAX's strings and numbers.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.utils import units as tunits

try:  # this file needs JAX; the guard keeps collection quiet without it
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.abstract_operations import (
        ConditionalOperation as JConditional, UnaryOperation as JUnary)
    from clima_oceananigans_jl_tpu.utils import units as junits
except ImportError:
    pass

from clima_oceananigans_jl_torch.abstract_operations import (
    ConditionalOperation as TConditional, UnaryOperation as TUnary)

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
SIZE = (8, 6, 5)


def P(side):
    return J if side == "jax" else T


def zfaces(nz):
    k = np.arange(nz + 1)
    return -(1.0 - k / nz) ** 1.5


def make_grid(side, kind):
    """The grid of a case, with halo 3 (an immersed box: a model's grid)."""
    p = P(side)
    kw = dict(dtype=jnp.float64) if side == "jax" else dict(dtype=torch.float64,
                                                            device=DEVICE)
    if kind == "stretched":
        g = p.RectilinearGrid(size=SIZE, x=(0, 1.3), y=(0, 0.7), z=zfaces(SIZE[2]),
                              topology=("periodic", "bounded", "bounded"), halo=(3, 3, 3), **kw)
    elif kind == "latlon":
        g = p.LatitudeLongitudeGrid(size=SIZE, longitude=(0, 360), latitude=(-60, 60),
                                    z=(-1000.0, 0.0), **kw)
    else:
        xp = jnp if side == "jax" else torch
        box = p.RectilinearGrid(size=SIZE, x=(0, 1), y=(0, 1), z=(-1, 0),
                                topology=("periodic", "periodic", "bounded"), **kw)
        bottom = lambda x, y: -0.8 + 0.5 * xp.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.05)
        kwm = dict(advection=p.WENO5(), immersed_boundary=p.GridFittedBottom(bottom))
        if side == "jax":
            kwm["fused_advection"] = False
        g = p.NonhydrostaticModel(box, **kwm).grid
        assert g.immersed is not None
    return g


def fields(side, grid, seed=0):
    """Random with-halo u, v, w, b (the same numbers in both packages)."""
    p = P(side)
    rng = np.random.default_rng(seed)
    out = {}
    for name, loc in (("u", p.U_LOC), ("v", p.V_LOC), ("w", p.W_LOC), ("b", p.CENTER)):
        a = rng.standard_normal(tuple(grid.total_shape))
        data = jnp.asarray(a) if side == "jax" else torch.as_tensor(a)
        out[name] = p.Field(data, loc, p.regularize_bcs(grid, loc, None))
    return out


def numpy_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def expressions(side, f, grid):
    """name -> one operation of each kind over the fields ``f``."""
    p = P(side)
    xp = jnp if side == "jax" else torch
    F, C = p.F, p.C
    Unary = JUnary if side == "jax" else TUnary
    Conditional = JConditional if side == "jax" else TConditional
    u, v, w, b = f["u"], f["v"], f["w"], f["b"]
    positive = b.data > 0
    return {
        "u+v": u + v,
        "2*b-u": 2.0 * b - u,
        "3-b": 3.0 - b,
        "b/u": b / u,
        "-w": -w,
        "u**2": u ** 2,
        "abs(b)": Unary(xp.abs, b),
        "uvw": p.MultiaryOperation(lambda a, c, d: a * c + d, (u, v, w), p.CENTER),
        "dx(u)": p.partial_x(u),
        "dy(v)": p.partial_y(v),
        "dz(w)": p.partial_z(w),
        "dz(b)": p.partial_z(b),
        "vorticity": p.partial_x(v) - p.partial_y(u),
        "divergence": p.partial_x(u) + p.partial_y(v) + p.partial_z(w),
        "at(u)": p.at(p.CENTER, u),
        "at(b)": p.at((F, F, C), b),
        "volume*b": p.GridMetric("volume") * b,
        "Az": p.GridMetric("Az", (F, F, C)),
        "dx metric": p.GridMetric("dx", p.U_LOC) * u,
        "kernel": p.KernelFunctionOperation(lambda g, a: a * g.dz(p.CENTER), p.CENTER,
                                            (b.data,)),
        "where": Conditional(u * v, positive, -1.0),
        "where(fn)": Conditional(b, lambda g: positive),
    }


CASES = ("stretched", "latlon", "immersed")
NAMES = list(expressions("torch", fields("torch", make_grid("torch", "stretched")),
                         make_grid("torch", "stretched")))


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_compute_is_bitwise_jax(kind, name):
    out = {}
    for side in ("jax", "torch"):
        g = make_grid(side, kind)
        op = expressions(side, fields(side, g), g)[name]
        out[side] = (P(side).compute(op, g), op.loc)
    (jf, jloc), (tf, tloc) = out["jax"], out["torch"]
    assert tloc == jloc and tf.loc == jf.loc
    assert tuple(tf.data.shape) == tuple(jf.data.shape)
    np.testing.assert_array_equal(tf.data.numpy(), np.asarray(jf.data))


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("dims", [(0, 1, 2), (0, 1), (2,)], ids=["xyz", "xy", "z"])
def test_average_and_integral_match_jax(kind, dims):
    out = {}
    for side in ("jax", "torch"):
        p = P(side)
        g = make_grid(side, kind)
        f = fields(side, g)
        op = f["b"] * f["u"]
        out[side] = [numpy_of(p.Average(op, dims).compute(g)),
                     numpy_of(p.Integral(op, dims).compute(g)),
                     numpy_of(p.average(f["w"], g, dims)), numpy_of(p.integral(f["w"], g, dims)),
                     numpy_of(p.field_norm(f["v"], g))]
    for ref, got in zip(out["jax"], out["torch"]):
        # a level all solid averages 0/0 in both packages
        assert ref.shape == got.shape and np.array_equal(np.isnan(ref), np.isnan(got))
        np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13 * np.nanmax(np.abs(ref)))


def test_reductions_give_the_solid_zero_weight():
    g = make_grid("torch", "immersed")
    f = fields("torch", g)["b"]
    solid = g.immersed.mask_for(T.CENTER)
    vol = torch.broadcast_to(g.V(T.CENTER), g.total_shape)
    fluid = g.interior(~solid)
    assert fluid.any() and not fluid.all()
    num = g.interior(f.data * vol)[fluid].sum()
    ref = num / g.interior(vol)[fluid].sum()
    assert float(T.average(f, g)) == pytest.approx(float(ref), rel=1e-13)
    assert float(T.integral(f, g)) == pytest.approx(float(num), rel=1e-13)


def grids_pair(kind="stretched"):
    return make_grid("jax", kind), make_grid("torch", kind)


def test_field_arithmetic_and_windowed_match_jax():
    jg, tg = grids_pair()
    jf, tf = fields("jax", jg), fields("torch", tg)
    for expr in (lambda f: (f["u"] + f["b"]) * 2.0 - 1.0 / f["v"],
                 lambda f: -(f["b"] ** 3) + f["w"] * f["u"]):
        np.testing.assert_array_equal(T.compute(expr(tf), tg).data.numpy(),
                                      np.asarray(J.compute(expr(jf), jg).data))
    for indices in [None, (2, None, (1, 4)), (slice(1, 5), -1, slice(None)), ((0, 3), (2, 6), 4)]:
        jw, tw = J.windowed(jf["w"], jg, indices), T.windowed(tf["w"], tg, indices)
        assert tw.indices == jw.indices and tw.loc == jw.loc and tw.bcs is None
        np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))


def test_interpolate_and_regrid_match_jax():
    jg, tg = grids_pair()
    jf, tf = fields("jax", jg), fields("torch", tg)
    rng = np.random.default_rng(5)
    x, y, z = (rng.uniform(lo, hi, 50) for lo, hi in ((-0.1, 1.4), (0.0, 0.7), (-1.0, 0.0)))
    for name in ("u", "v", "w", "b"):
        ref = np.asarray(J.interpolate(jf[name], jg, x, y, z))
        got = T.interpolate(tf[name], tg, x, y, z).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-15, atol=1e-15)
        one = T.interpolate(tf[name], tg, 0.3, 0.2, -0.4)
        assert one.ndim == 0
        assert float(one) == pytest.approx(float(J.interpolate(jf[name], jg, 0.3, 0.2, -0.4)),
                                           rel=1e-15, abs=1e-15)
    kw = dict(size=(12, 10, 6), x=(0, 1.3), y=(0, 0.7), z=(-1, 0),
              topology=("periodic", "bounded", "bounded"))
    jdst = J.RectilinearGrid(dtype=jnp.float64, **kw)
    tdst = T.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw)
    for name in ("u", "b"):
        ref = np.asarray(J.regrid(jf[name], jg, jdst).data)
        got = T.regrid(tf[name], tg, tdst).data.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14)


def test_function_field_and_set_field_match_jax():
    jg, tg = grids_pair()
    jfn = J.FunctionField(lambda x, y, z, t: jnp.sin(3 * x) * y + z * t, J.U_LOC, True)
    tfn = T.FunctionField(lambda x, y, z, t: torch.sin(3 * x) * y + z * t, T.U_LOC, True)
    np.testing.assert_array_equal(tfn.at_time(tg, 0.25).data.numpy(),
                                  np.asarray(jfn.at_time(jg, 0.25).data))
    jf, tf = fields("jax", jg), fields("torch", tg)
    sources = {"function field": (jfn, tfn), "field at another location": (jf["u"], tf["u"]),
               "operation": (J.partial_x(jf["u"]) * 2.0, T.partial_x(tf["u"]) * 2.0)}
    for name, (js, ts) in sources.items():
        ref = J.set_field(J.CenterField(jg), jg, js, t=0.25)
        got = T.set_field(T.CenterField(tg), tg, ts, t=0.25)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data), err_msg=name)


def test_field_constructors_and_tuples_match_jax():
    jg, tg = grids_pair()
    for name in ("CenterField", "XFaceField", "YFaceField", "ZFaceField"):
        jf, tf = getattr(J, name)(jg), getattr(T, name)(tg)
        assert tf.loc == jf.loc and tuple(tf.data.shape) == tuple(jf.data.shape)
        sides = ("west", "east", "south", "north", "bottom", "top")
        kinds = lambda bcs: [getattr(getattr(bcs, s), "kind", None) for s in sides]
        assert kinds(tf.bcs) == kinds(jf.bcs)
    assert list(T.VelocityFields(tg)) == list(J.VelocityFields(jg)) == ["u", "v", "w"]
    tr = T.TracerFields(tg, ("T", "S"))
    assert list(tr) == ["T", "S"] and all(f.loc == T.CENTER for f in tr.values())


@pytest.mark.parametrize("buoyancy", ["tracer", "seawater"])
def test_buoyancy_and_pressure_fields_match_jax(buoyancy):
    out = {}
    for side in ("jax", "torch"):
        p = P(side)
        kw = dict(size=(8, 8, 8), x=(0, 1), y=(0, 1), z=(-1, 0),
                  topology=("periodic", "periodic", "bounded"))
        g = (J.RectilinearGrid(dtype=jnp.float64, **kw) if side == "jax" else
             T.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw))
        b = (p.BuoyancyTracer() if buoyancy == "tracer" else
             p.SeawaterBuoyancy(equation_of_state=p.LinearEquationOfState(
                 thermal_expansion=2e-4, haline_contraction=8e-4)))
        m = p.NonhydrostaticModel(g, advection=p.WENO5(), buoyancy=b,
                                  **({"fused_advection": False} if side == "jax" else {}))
        rng = np.random.default_rng(7)
        s = m.initial_state(**{n: rng.standard_normal((8, 8, 8)) for n in m.tracer_names})
        s = m.step(s, 1e-3)
        out[side] = (m, p.BuoyancyField(m, s), p.PressureField(m, s))
    (jm, jb, jp), (tm, tb, tp) = out["jax"], out["torch"]
    assert tb.loc == jb.loc and tp.loc == jp.loc
    np.testing.assert_array_equal(tm.grid.interior(tb.data).numpy(),
                                  np.asarray(jm.grid.interior(jb.data)))
    ref = np.asarray(jm.grid.interior(jp.data))
    got = tm.grid.interior(tp.data).numpy()
    assert np.abs(ref - got).max() <= 1e-9 * np.abs(ref).max()


@pytest.mark.parametrize("t", [3e-10, 4.5e-7, 2e-4, 0.5, 42.0, 1234.5, 7.2e4, 3e6, 5e8])
def test_prettytime_is_jax(t):
    assert tunits.prettytime(t) == junits.prettytime(t)


def test_unit_constants_are_jax():
    for name in ("second", "minute", "hour", "day", "year", "meter", "kilometer",
                 "KiB", "MiB", "GiB", "TiB"):
        assert getattr(tunits, name) == getattr(junits, name)
