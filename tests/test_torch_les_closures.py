"""Port parity: the LES closures, the biharmonic diffusivity, array- and
callable-valued diffusivities, closure tuples and the diffusion timescale.

Every case builds the same numpy-seeded with-halo fields in both packages
on a (Periodic, Periodic, Bounded) grid stretched in z, f64:

- the diffusivities of ``SmagorinskyLilly`` (with and without buoyancy),
  ``AnisotropicMinimumDissipation`` (Cb = 0 and Cb ≠ 0, two tracers) and
  ``TwoDimensionalLeith`` (C_div = 0 and ≠ 0) against JAX within
  ``1e-12`` of max|ν| (the same trees and orders of summation; the
  Smagorinsky filter width takes a cube root, ``jnp.cbrt`` against
  ``torch.pow(·, 1/3)``);
- the explicit diffusion (``momentum_diffusion`` of u, v, w and
  ``tracer_diffusion``) of ``ScalarBiharmonicDiffusivity`` in both
  formulations, of 3D ν/κ arrays (centred, interpolated onto the faces),
  and of closure tuples, within ``1e-12`` of max|term|;
- ``cell_diffusion_timescale`` of each closure, its tuples and its LES
  fields, within 1e-12;
- five AB2 (or RK3) steps of centred-advection models with each closure
  (the LES closures, the biharmonic one, a tuple, array-valued ν and κ, a
  callable vertical κ under vertically implicit diffusion) against JAX
  within ``1e-9`` of max|field|, as ``test_torch_rk3.py`` holds whole
  steps (WENO5 models are held in ``test_torch_stretched_nonhydrostatic.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.closures import scalar_diffusivity as tsd

try:
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.buoyancy import buoyancy as jbuoy
    from clima_oceananigans_jl_tpu.closures import eddy_viscosity as jev
    from clima_oceananigans_jl_tpu.closures import scalar_diffusivity as jsd
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel as JN
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-12
SIZE = (10, 8, 9)


def zfaces(nz):
    rng = np.random.default_rng(11)
    return np.concatenate([[-20.0], -20.0 + np.cumsum(rng.uniform(1.0, 3.0, nz))])


def grids(size=SIZE):
    kw = dict(size=size, x=(0, 40), y=(0, 30), z=zfaces(size[2]))
    return (J.RectilinearGrid(topology=("periodic", "periodic", "bounded"),
                              dtype=jnp.float64, **kw),
            T.RectilinearGrid(topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                              dtype=torch.float64, device=DEVICE, **kw))


def fields(tg, names=("u", "v", "w", "b", "c"), seed=0):
    rng = np.random.default_rng(seed)
    shape = tg.total_shape
    z = tg.coord(2, T.C, with_halo=True).numpy().reshape(1, 1, -1)
    out = {n: 1e-2 * rng.standard_normal(shape) for n in names}
    out["b"] = 1e-4 * z + 1e-5 * rng.standard_normal(shape)
    return out


def both(arrays):
    return ({n: jnp.asarray(x) for n, x in arrays.items()},
            {n: torch.as_tensor(x) for n, x in arrays.items()})


def close(ref, got, rtol=RTOL, interior=None):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if interior is not None:
        ref, got = interior(ref), interior(got)
    assert np.abs(ref - got).max() <= rtol * np.abs(ref).max()


def interior_of(tg):
    return lambda a: a[tg.interior_slices] if np.ndim(a) == 3 else a


LES = {
    "smagorinsky": (lambda m: m.SmagorinskyLilly(), True),
    "smagorinsky, no buoyancy": (lambda m: m.SmagorinskyLilly(C=0.2, Cb=0.5), False),
    "amd": (lambda m: m.AnisotropicMinimumDissipation(), True),
    "amd, Cb": (lambda m: m.AnisotropicMinimumDissipation(C=0.3, Cb=1.0,
                                                          nu_background=1e-6,
                                                          kappa_background=2e-6), True),
    "leith": (lambda m: m.TwoDimensionalLeith(), True),
    "leith, C_div": (lambda m: m.TwoDimensionalLeith(C_div=0.5, nu_background=1e-6), True),
}


def flatten(d, prefix=""):
    if isinstance(d, dict):
        out = {}
        for k, v in d.items():
            out.update(flatten(v, f"{prefix}{k}."))
        return out
    return {prefix: d}


@pytest.mark.parametrize("name", list(LES))
def test_les_diffusivities_match_jax(name):
    jg, tg = grids()
    make, with_b = LES[name]
    jf, tf = both(fields(tg))
    jb = jbuoy.BuoyancyTracer() if with_b else None
    tb = T.BuoyancyTracer() if with_b else None
    tr = ("b", "c")
    ref = make(jev).compute_diffusivities(jg, jf, jb, {n: jf[n] for n in tr})
    got = make(T).compute_diffusivities(tg, tf, tb, {n: tf[n] for n in tr})
    ref, got = flatten(ref), flatten(got)
    assert set(ref) == set(got)
    for k in ref:
        close(ref[k], got[k], interior=interior_of(tg))


def diffusion_terms(sd, grid, closure, diffs, f, loc):
    """The explicit diffusion terms of every field under ``closure``."""
    locs = dict(u=loc.U_LOC, v=loc.V_LOC, w=loc.W_LOC)
    out = {n: sd.momentum_diffusion(f[n], grid, locs[n], closure, diffs)
           for n in locs}
    for n in ("b", "c"):
        out[n] = sd.tracer_diffusion(f[n], grid, n, closure, diffs)
    return out


def closures(m, sd, tg, kind, arrays):
    """(closure, needs diffusivities) of ``kind`` in package ``m``."""
    if kind.startswith("biharmonic"):
        form = "horizontal" if kind.endswith("horizontal") else "three_dimensional"
        return sd.ScalarBiharmonicDiffusivity(nu=0.3, kappa={"b": 0.2, "c": 0.1},
                                              formulation=form)
    if kind == "arrays":
        return sd.ScalarDiffusivity(nu=arrays["nu"], kappa=arrays["kappa"],
                                    nu_z=arrays["nu_z"], kappa_z={"b": 1e-3, "c": arrays["kappa"]})
    if kind == "tuple":
        ev = jev if m is J else T
        return (ev.AnisotropicMinimumDissipation(C=0.2),
                sd.ScalarDiffusivity(nu=1e-3, kappa=2e-3),
                sd.ScalarBiharmonicDiffusivity(nu=0.1, kappa=0.1, formulation="horizontal"))
    if kind == "implicit":
        return sd.ScalarDiffusivity(nu=1e-3, kappa=1e-3, nu_z=arrays["nu_z"],
                                    time_discretization="vertically_implicit")
    raise ValueError(kind)


KINDS = ("biharmonic", "biharmonic horizontal", "arrays", "tuple", "implicit")


@pytest.mark.parametrize("kind", KINDS)
def test_explicit_diffusion_matches_jax(kind):
    jg, tg = grids()
    rng = np.random.default_rng(5)
    arrays = {n: 1e-3 * (1.0 + rng.uniform(0, 1, tg.total_shape))
              for n in ("nu", "kappa", "nu_z")}
    jarr, tarr = both(arrays)
    jcl = closures(J, jsd, tg, kind, jarr)
    tcl = closures(T, tsd, tg, kind, tarr)
    jf, tf = both(fields(tg, seed=2))
    tr = ("b", "c")
    jd = jsd.compute_closure_diffusivities(jcl, jg, jf, jbuoy.BuoyancyTracer(),
                                           {n: jf[n] for n in tr})
    td = tsd.compute_closure_diffusivities(tcl, tg, tf, T.BuoyancyTracer(),
                                           {n: tf[n] for n in tr})
    ref = diffusion_terms(jsd, jg, jcl, jd, jf, J)
    got = diffusion_terms(tsd, tg, tcl, td, tf, T)
    # biharmonic terms consume two halo cells; compare the interior
    for n in ref:
        close(ref[n], got[n], interior=interior_of(tg))
    if kind != "tuple":
        assert tsd.compute_closure_diffusivities(tcl, tg, tf, None, {}) is None
    else:
        assert len(td) == 3 and td[1] is None and td[2] is None


@pytest.mark.parametrize("kind", KINDS + tuple(LES))
def test_cell_diffusion_timescale_matches_jax(kind):
    jg, tg = grids()
    rng = np.random.default_rng(6)
    arrays = {n: 1e-3 * (1.0 + rng.uniform(0, 1, tg.total_shape))
              for n in ("nu", "kappa", "nu_z")}
    jarr, tarr = both(arrays)
    if kind in LES:
        make = LES[kind][0]
        jcl, tcl = make(jev), make(T)
    else:
        jcl = closures(J, jsd, tg, kind, jarr)
        tcl = closures(T, tsd, tg, kind, tarr)
    jf, tf = both(fields(tg, seed=3))
    tr = ("b", "c")
    jd = jsd.compute_closure_diffusivities(jcl, jg, jf, jbuoy.BuoyancyTracer(),
                                           {n: jf[n] for n in tr})
    td = tsd.compute_closure_diffusivities(tcl, tg, tf, T.BuoyancyTracer(),
                                           {n: tf[n] for n in tr})
    ref = jsd.cell_diffusion_timescale(jcl, jg, jd, tr)
    got = tsd.cell_diffusion_timescale(tcl, tg, td, tr)
    assert np.isfinite(got) and abs(got - ref) <= RTOL * abs(ref)


def test_cell_diffusion_timescale_without_limits():
    _, tg = grids()
    assert tsd.cell_diffusion_timescale(None, tg) == np.inf
    implicit = T.ScalarDiffusivity(nu=0.0, kappa=0.0, nu_z=1.0, kappa_z=1.0,
                                   time_discretization="vertically_implicit")
    assert tsd.cell_diffusion_timescale(implicit, tg) == np.inf
    assert tsd.cell_diffusion_timescale(T.AnisotropicMinimumDissipation(), tg) == np.inf


MODELS = {
    "smagorinsky": lambda m: m.SmagorinskyLilly(),
    "leith": lambda m: m.TwoDimensionalLeith(C_div=0.3),
    "amd, Cb": lambda m: m.AnisotropicMinimumDissipation(Cb=1.0),
}


def model_pair(kind, timestepper, size=(8, 8, 8)):
    jg, tg = grids(size)
    rng = np.random.default_rng(8)
    # at the models' halo of 1 (centred advection)
    nu = 1e-2 * (1.0 + rng.uniform(0, 1, tuple(n + 2 for n in size)))
    pick = {
        "biharmonic": lambda m, sd, arr: sd.ScalarBiharmonicDiffusivity(
            nu=1.0, kappa=1.0, formulation="horizontal"),
        "tuple": lambda m, sd, arr: (
            (jev if m is J else T).AnisotropicMinimumDissipation(),
            sd.ScalarDiffusivity(nu=1e-4, kappa=1e-4)),
        "arrays": lambda m, sd, arr: sd.ScalarDiffusivity(nu=arr, kappa=arr),
        "implicit callable": lambda m, sd, arr: sd.ScalarDiffusivity(
            nu=1e-4, kappa=1e-4, nu_z=1e-2,
            kappa_z=lambda z: 1e-2 * (1.5 + (jnp if m is J else torch).tanh(z / 5.0)),
            time_discretization="vertically_implicit"),
    }
    models = []
    for m, sd, arr, g in ((J, jsd, jnp.asarray(nu), jg),
                          (T, tsd, torch.as_tensor(nu), tg)):
        ev = jev if m is J else T
        closure = (MODELS[kind](ev) if kind in MODELS else pick[kind](m, sd, arr))
        kw = dict(fused_advection=False) if m is J else {}
        Model = JN if m is J else T.NonhydrostaticModel
        buoy = jbuoy.BuoyancyTracer() if m is J else T.BuoyancyTracer()
        models.append(Model(g, advection=m.CenteredSecondOrder(), buoyancy=buoy,
                            timestepper=timestepper, closure=closure, **kw))
    return models


@pytest.mark.parametrize("kind,timestepper", [
    ("smagorinsky", "QuasiAdamsBashforth2"), ("leith", "QuasiAdamsBashforth2"),
    ("amd, Cb", "QuasiAdamsBashforth2"), ("biharmonic", "QuasiAdamsBashforth2"),
    ("tuple", "QuasiAdamsBashforth2"), ("arrays", "QuasiAdamsBashforth2"),
    ("implicit callable", "RungeKutta3")])
def test_closure_models_five_steps_match_jax(kind, timestepper):
    jm, tm = model_pair(kind, timestepper)
    shape = tm.grid.shape
    rng = np.random.default_rng(9)
    z = tm.grid.coord(2, T.C).numpy().reshape(1, 1, -1)
    vals = dict(u=1e-2 * rng.standard_normal(shape), v=1e-2 * rng.standard_normal(shape),
                w=1e-3 * rng.standard_normal(shape),
                b=1e-4 * z + 1e-6 * rng.standard_normal(shape))
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(5):
        js = step(js, 2.0)
        ts = tm.step(ts, 2.0)
    for n in tm.prognostic_names():
        close(jm.grid.interior(js["solution"][n]), tm.grid.interior(ts["solution"][n]),
              rtol=1e-9)
    assert tm.cell_diffusion_timescale(ts) > 0
