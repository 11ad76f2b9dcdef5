"""Port parity: forcing and the related tendency terms, term by term.

Each term the surface-forced configurations add to the nonhydrostatic
tendencies, in f64 on the CPU, through the JAX package's function and the
port's on the same numpy-seeded fields of a (Periodic, Periodic, Bounded)
8×6×5 grid with halo 3:

- ``SeawaterBuoyancy`` with a ``LinearEquationOfState`` (and with a
  constant salinity), its required tracers and its pHY′;
- the tilted-gravity terms ``buoyancy_x_term`` / ``buoyancy_y_term``
  and pHY′ under a tilted ĝ;
- the six ``UniformStokesDrift`` terms;
- ``Forcing`` in its continuous form (field dependencies, parameters)
  and its discrete form, ``Relaxation`` with ``GaussianMask`` and
  ``LinearTarget``, ``AdvectiveForcing``, ``MultipleForcings`` and
  ``regularize_forcing``;
- ``materialize_background`` and the advection cross terms ``div_vu``,
  ``div_vv``, ``div_vw`` with ``U=``.

Bitwise where the arithmetic is elementwise. The exceptions, each with
its tolerance: pHY′ (cumulative sums in different orders, 1e-13 of
max|ref|), and anything through ``exp`` (``GaussianMask``; numpy, JAX and
torch each round exp within an ulp or two, so 1e-15 relative). User
callables are written twice, with ``jnp`` and with ``torch``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
import clima_oceananigans_jl_tpu as J
from clima_oceananigans_jl_torch.advection import fluxes as tfl
from clima_oceananigans_jl_torch.buoyancy import buoyancy as tb
from clima_oceananigans_jl_torch.fields.background import (
    materialize_background as t_materialize)
from clima_oceananigans_jl_torch.forcings import forcing as tf
from clima_oceananigans_jl_torch.timesteppers.steppers import Clock as TClock
from clima_oceananigans_jl_tpu.advection import fluxes as jfl
from clima_oceananigans_jl_tpu.buoyancy import buoyancy as jb
from clima_oceananigans_jl_tpu.fields import background as jbg
from clima_oceananigans_jl_tpu.forcings import forcing as jf
from clima_oceananigans_jl_tpu.stokes_drift import UniformStokesDrift as JStokes
from clima_oceananigans_jl_tpu.timesteppers.steppers import Clock as JClock

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
SIZE = (8, 6, 5)
TIME = 37.5


def grids():
    kw = dict(size=SIZE, x=(0.0, 64.0), y=(0.0, 48.0), z=(-32.0, 0.0))
    return (J.RectilinearGrid(topology=("periodic", "periodic", "bounded"),
                              dtype=jnp.float64, **kw),
            T.RectilinearGrid(topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                              dtype=torch.float64, device=DEVICE, **kw))


def fields(grid, names=("u", "v", "w", "T", "S", "b", "c"), seed=0):
    """Random with-halo numpy fields."""
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(grid.total_shape) for n in names}


def both(f):
    return ({n: jnp.asarray(a) for n, a in f.items()},
            {n: torch.as_tensor(a) for n, a in f.items()})


def same(ref, got):
    ref = np.broadcast_to(np.asarray(ref), np.shape(got))
    assert np.array_equal(ref, np.asarray(got)), np.abs(ref - np.asarray(got)).max()


def close(ref, got, rtol):
    ref, got = np.asarray(ref), np.asarray(got)
    err, scale = np.abs(ref - got).max(), np.abs(ref).max()
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("constant_salinity", [None, 35.0])
def test_seawater_buoyancy_matches_jax(constant_salinity):
    jg, tg = grids()
    jeos = jb.LinearEquationOfState(thermal_expansion=2e-4, haline_contraction=8e-4)
    teos = T.LinearEquationOfState(thermal_expansion=2e-4, haline_contraction=8e-4)
    jbuoy = jb.SeawaterBuoyancy(equation_of_state=jeos,
                                constant_salinity=constant_salinity)
    tbuoy = T.SeawaterBuoyancy(equation_of_state=teos,
                               constant_salinity=constant_salinity)
    assert tbuoy.required_tracers == jbuoy.required_tracers
    jt, tt = both(fields(tg, ("T", "S")))
    same(jbuoy.buoyancy_perturbation(jg, jt), tbuoy.buoyancy_perturbation(tg, tt))
    close(jb.hydrostatic_pressure_anomaly(jbuoy, jg, jt),
          tb.hydrostatic_pressure_anomaly(tbuoy, tg, tt), 1e-13)


def test_seawater_buoyancy_defaults_match_jax():
    assert T.SeawaterBuoyancy().required_tracers == ("T", "S")
    assert (T.SeawaterBuoyancy().gravitational_acceleration
            == jb.SeawaterBuoyancy().gravitational_acceleration)
    assert T.LinearEquationOfState() == T.LinearEquationOfState(1.67e-4, 7.80e-4)
    # any equation of state with density_anomaly: TEOS-10 as the JAX one;
    # an object without it is refused, naming what is missing
    from clima_oceananigans_jl_tpu.buoyancy.nonlinear_eos import TEOS10EquationOfState
    jg, tg = grids()
    f = fields(tg, ("T", "S"), seed=3)
    jt, tt = both({"T": 10.0 + f["T"], "S": 35.0 + f["S"]})
    ref = jb.SeawaterBuoyancy(equation_of_state=TEOS10EquationOfState()
                              ).buoyancy_perturbation(jg, jt)
    got = T.SeawaterBuoyancy(equation_of_state=T.TEOS10EquationOfState()
                             ).buoyancy_perturbation(tg, tt)
    # torch's CPU sqrt is 1 ulp off on some inputs (tests/test_torch_nonlinear_eos.py)
    assert np.abs(np.asarray(ref) - got.numpy()).max() <= 1e-14 * 9.80665
    with pytest.raises(TypeError, match="density_anomaly"):
        T.SeawaterBuoyancy(equation_of_state=object())


@pytest.mark.parametrize("angle", [0.0, 0.3, -0.1])
def test_tilted_gravity_terms_match_jax(angle):
    """ĝ = (sin θ, 0, −cos θ) as in examples/tilted_bottom_boundary_layer.py,
    and one tilted in y."""
    jg, tg = grids()
    for gvec in ((np.sin(angle), 0.0, -np.cos(angle)),
                 (0.0, np.sin(angle), -np.cos(angle))):
        jbuoy = jb.BuoyancyTracer(gravity_unit_vector=gvec)
        tbuoy = T.BuoyancyTracer(gravity_unit_vector=gvec)
        jt, tt = both(fields(tg, ("b",)))
        for jfn, tfn in ((jb.buoyancy_x_term, tb.buoyancy_x_term),
                         (jb.buoyancy_y_term, tb.buoyancy_y_term)):
            r, g = jfn(jbuoy, jg, jt), tfn(tbuoy, tg, tt)
            assert (r is None) == (g is None)
            if r is not None:
                same(r, g)
        close(jb.hydrostatic_pressure_anomaly(jbuoy, jg, jt),
              tb.hydrostatic_pressure_anomaly(tbuoy, tg, tt), 1e-13)


def test_uniform_stokes_drift_terms_match_jax():
    """All six terms, with polynomial profiles (written with jnp and with
    torch)."""
    jg, tg = grids()
    prof = lambda z, t: 1e-3 + 2e-4 * z + 1e-5 * t + 3e-6 * z * z
    jsd = JStokes(dz_us=prof, dz_vs=lambda z, t: -0.5 * prof(z, t),
                  dt_us_fn=lambda z, t: 1e-6 * z + jnp.zeros_like(z),
                  dt_vs_fn=lambda z, t: 2e-6 * t + jnp.zeros_like(z))
    tsd = T.UniformStokesDrift(dz_us=prof, dz_vs=lambda z, t: -0.5 * prof(z, t),
                               dt_us_fn=lambda z, t: 1e-6 * z + torch.zeros_like(z),
                               dt_vs_fn=lambda z, t: 2e-6 * t + torch.zeros_like(z))
    (ju, jv, jw), (tu, tv, tw) = [tuple(d[n] for n in "uvw")
                                  for d in both(fields(tg, ("u", "v", "w")))]
    for name in ("x_curl_Us_cross_U", "y_curl_Us_cross_U", "z_curl_Us_cross_U"):
        same(getattr(jsd, name)(jg, ju, jv, jw, TIME),
             getattr(tsd, name)(tg, tu, tv, tw, TIME))
    for name in ("dt_us", "dt_vs", "dt_ws"):
        same(getattr(jsd, name)(jg, TIME), getattr(tsd, name)(tg, TIME))


def test_stokes_drift_defaults_are_zero():
    _, tg = grids()
    sd = T.UniformStokesDrift()
    assert not sd.dt_us(tg, 0.0).any() and sd.dt_ws(tg, 0.0).shape == (1, 1, 1)


def test_continuous_and_discrete_forcing_match_jax():
    jg, tg = grids()
    jfl_, tfl_ = both(fields(tg))
    params = dict(a=-1e-3, b=2e-5)
    jforce = jf.Forcing(lambda x, y, z, t, u, c, p: p["a"] * u + p["b"] * z * c + t * x,
                        parameters=params, field_dependencies=("u", "c"))
    tforce = tf.Forcing(lambda x, y, z, t, u, c, p: p["a"] * u + p["b"] * z * c + t * x,
                        parameters=params, field_dependencies=("u", "c"))
    same(jforce(jg, JClock(TIME, 3), jfl_), tforce(tg, TClock(TIME, 3), tfl_))
    one = tf.Forcing(lambda x, y, z, t, u: -2.0 * u, field_dependencies="u",
                     loc=T.U_LOC)
    assert one.field_dependencies == ("u",)
    same(jf.Forcing(lambda x, y, z, t, u: -2.0 * u, field_dependencies="u",
                    loc=J.U_LOC)(jg, JClock(TIME, 0), jfl_),
         one(tg, TClock(TIME, 0), tfl_))
    for p in (None, 0.25):
        if p is None:
            jd = jf.Forcing(lambda g, clk, f: -1e-2 * f["T"] * clk.time,
                            discrete_form=True)
            td = tf.Forcing(lambda g, clk, f: -1e-2 * f["T"] * clk.time,
                            discrete_form=True)
        else:
            jd = jf.Forcing(lambda g, clk, f, q: q * f["S"], parameters=p,
                            discrete_form=True)
            td = tf.Forcing(lambda g, clk, f, q: q * f["S"], parameters=p,
                            discrete_form=True)
        same(jd(jg, JClock(TIME, 0), jfl_), td(tg, TClock(TIME, 0), tfl_))


def test_relaxation_with_mask_and_target_matches_jax():
    """A sponge: ``Relaxation(rate, GaussianMask(z), LinearTarget(N²z))``,
    bound to its field by ``regularize_forcing``; the mask goes through
    exp. Without a mask and with a constant target it is bitwise."""
    jg, tg = grids()
    jfl_, tfl_ = both(fields(tg))
    jr = jf.regularize_forcing("b", jf.Relaxation(
        rate=1 / 60, mask=jf.GaussianMask(center=-28.0, width=3.0),
        target=jf.LinearTarget(gradient=1e-5)))
    tr = tf.regularize_forcing("b", tf.Relaxation(
        rate=1 / 60, mask=tf.GaussianMask(center=-28.0, width=3.0),
        target=tf.LinearTarget(gradient=1e-5)))
    assert tr.field_name == "b"
    close(jr(jg, JClock(TIME, 0), jfl_), tr(tg, TClock(TIME, 0), tfl_), 1e-15)
    mask_t = tf.GaussianMask(center=10.0, width=5.0, axis=0)
    x = tg.nodes(T.CENTER, with_halo=True)[0]
    close(np.exp(-((x.numpy() - 10.0) ** 2) / 50.0), mask_t(*tg.nodes(T.CENTER, True)), 1e-15)
    same(jf.LinearTarget(1.0, 2e-3, axis=1)(*jg.nodes(J.CENTER, True), 0.0),
         tf.LinearTarget(1.0, 2e-3, axis=1)(*tg.nodes(T.CENTER, True), 0.0))
    plain_j = jf.Relaxation(rate=0.5, target=2.0, field_name="T")
    plain_t = tf.Relaxation(rate=0.5, target=2.0, field_name="T")
    same(plain_j(jg, JClock(TIME, 0), jfl_), plain_t(tg, TClock(TIME, 0), tfl_))


@pytest.mark.parametrize("scheme", ["centered", "weno5"])
def test_advective_and_multiple_forcings_match_jax(scheme):
    jg, tg = grids()
    jfl_, tfl_ = both(fields(tg))
    js = J.CenteredSecondOrder() if scheme == "centered" else J.WENO5()
    ts = T.CenteredSecondOrder() if scheme == "centered" else T.WENO5()
    jadv = jf.regularize_forcing("c", jf.AdvectiveForcing(js, w=-1e-3))
    tadv = tf.regularize_forcing("c", tf.AdvectiveForcing(ts, w=-1e-3))
    assert tadv.field_name == "c" and tadv.scheme is ts
    same(jadv(jg, JClock(TIME, 0), jfl_), tadv(tg, TClock(TIME, 0), tfl_))
    decay = lambda g, clk, f: -1e-4 * f["c"]
    jm = jf.regularize_forcing("c", (jf.AdvectiveForcing(js, u=0.1), decay))
    tm = tf.regularize_forcing("c", [tf.AdvectiveForcing(ts, u=0.1), decay])
    assert isinstance(tm, tf.MultipleForcings) and tm.parts[0].field_name == "c"
    same(jm(jg, JClock(TIME, 0), jfl_), tm(tg, TClock(TIME, 0), tfl_))
    # an explicit field name is kept
    assert tf.regularize_forcing("c", tf.Relaxation(1.0, field_name="T")).field_name == "T"


@pytest.mark.parametrize("scheme", ["centered", "weno5"])
def test_background_fields_and_cross_terms_match_jax(scheme):
    jg, tg = grids()
    js = J.CenteredSecondOrder() if scheme == "centered" else J.WENO5()
    ts = T.CenteredSecondOrder() if scheme == "centered" else T.WENO5()
    shear = lambda x, y, z, t, s: s * z + 0.01 * t
    jbf = {"u": jbg.BackgroundField(shear, parameters=1e-3),
           "b": lambda x, y, z, t: 1e-5 * z + 0.0 * x * y,
           "v": np.full(tg.total_shape, 0.02)}
    tbf = {"u": T.BackgroundField(shear, parameters=1e-3),
           "b": lambda x, y, z, t: 1e-5 * z + 0.0 * x * y,
           "v": torch.full(tg.total_shape, 0.02, dtype=torch.float64)}
    jlocs = dict(u=J.U_LOC, v=J.V_LOC, w=J.W_LOC, b=J.CENTER)
    tlocs = dict(u=T.U_LOC, v=T.V_LOC, w=T.W_LOC, b=T.CENTER)
    jbgs = jbg.materialize_background(jbf, jg, jlocs, TIME)
    tbgs = t_materialize(tbf, tg, tlocs, TIME)
    assert set(tbgs) == {"u", "b", "v"}
    for n in tbgs:
        assert tuple(tbgs[n].shape) == tg.total_shape
        same(jbgs[n], tbgs[n])
    assert "BackgroundField(" in repr(tbf["u"])
    (ju, jv, jw), (tu, tv, tw) = [tuple(d[n] for n in "uvw")
                                  for d in both(fields(tg, ("u", "v", "w")))]
    jU = (jbgs["u"], jbgs["v"], jnp.zeros_like(jw))
    tU = (tbgs["u"], tbgs["v"], torch.zeros_like(tw))
    for jfn, tfn in ((jfl.div_vu, tfl.div_vu), (jfl.div_vv, tfl.div_vv),
                     (jfl.div_vw, tfl.div_vw)):
        same(jfn(jg, js, ju, jv, jw, U=jU), tfn(tg, ts, tu, tv, tw, U=tU))
        same(jfn(jg, js, *jU, U=(ju, jv, jw)), tfn(tg, ts, *tU, U=(tu, tv, tw)))
        # U=None is the field's own velocity
        same(jfn(jg, js, ju, jv, jw), tfn(tg, ts, tu, tv, tw, U=None))
