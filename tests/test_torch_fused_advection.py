"""Port parity: the JAX constructor keyword ``fused_advection``.

One dict of keywords, ``fused_advection=False`` among them, builds the
nonhydrostatic model (WENO5, BuoyancyTracer, FPlane, ScalarDiffusivity on
(Periodic, Periodic, Bounded), quasi-AB2 and RK3) and the hydrostatic
model (the ¼° flagship's forms at 16×8×6) in both packages; each entry
names a class that both packages export, with its arguments. Both take
the same branch (the nonhydrostatic general AB2 branch, G_prev with
halos) and agree after 10 steps to ≤ 1e-9 of max|field|, the tolerance
of the other end-to-end files (reassociated cumulative sums and FFTs
carried through 10 steps).

``False`` makes a model's step take the ``PLAIN`` mapping of the kernels'
wrappers, on the card as on the CPU; ``"auto"`` and ``True`` keep
``KERNELS``. The spies below stand in one entry of each mapping.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.models import hydrostatic as thm
from clima_oceananigans_jl_torch.models import nonhydrostatic as tnm

try:  # this file needs JAX; the guard keeps collection quiet without it
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
SIZE = {"nonhydrostatic": (12, 10, 8), "hydrostatic": (16, 8, 6)}
DT = {"nonhydrostatic": 1e-3, "hydrostatic": 600.0}


def zfaces(nz):
    k = np.arange(nz + 1)
    return -3000.0 * (1.0 - k / nz) ** 1.8


#: the models' keywords: (class name, arguments) is built in each package
KEYWORDS = {
    "nonhydrostatic": dict(
        advection=("WENO5", {}), buoyancy=("BuoyancyTracer", {}),
        coriolis=("FPlane", {"f": 1e-4}),
        closure=("ScalarDiffusivity", {"nu": 1e-5, "kappa": 1e-5}),
        fused_advection=False),
    "hydrostatic": dict(
        momentum_advection=("VectorInvariant", {"scheme": "weno_velocity"}),
        tracer_advection=("WENO5", {}), tracers=("T", "S"),
        free_surface=("SplitExplicitFreeSurface", {"substeps": 8}),
        coriolis=("HydrostaticSphericalCoriolis", {}),
        buoyancy=("BuoyancyTracer", {}), fused_advection=False),
}


def resolve(P, keywords):
    """``keywords`` with each (class name, arguments) built in package P."""
    return {k: getattr(P, v[0])(**v[1])
            if isinstance(v, tuple) and len(v) == 2 and isinstance(v[1], dict)
            else v for k, v in keywords.items()}


def build(P, kind, **extra):
    """The model of ``kind`` in package P (J or T) from ``KEYWORDS``."""
    size = SIZE[kind]
    dtype = dict(dtype=jnp.float64) if P is not T else dict(dtype=torch.float64,
                                                             device=DEVICE)
    kw = dict(resolve(P, KEYWORDS[kind]), **extra)
    if kind == "nonhydrostatic":
        grid = P.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                                 topology=("periodic", "periodic", "bounded"),
                                 **dtype)
        return P.NonhydrostaticModel(grid, **kw)
    grid = P.LatitudeLongitudeGrid(size=size, longitude=(0, 360),
                                   latitude=(-75, 75), z=zfaces(size[2]),
                                   **dtype)
    return P.HydrostaticFreeSurfaceModel(grid, **kw)


def initial_values(kind, seed=0):
    rng = np.random.default_rng(seed)
    shape = SIZE[kind]
    if kind == "nonhydrostatic":
        return dict(u=1e-2 * rng.standard_normal(shape),
                    v=1e-2 * rng.standard_normal(shape),
                    b=1e-4 * rng.standard_normal(shape))
    return dict(u=0.1 * rng.standard_normal(shape),
                T=rng.standard_normal(shape), S=0.5 * rng.standard_normal(shape),
                b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)


def close(ref, got, what):
    ref, got = np.asarray(ref), got.numpy()
    err, scale = np.abs(ref - got).max(), np.abs(ref).max()
    assert err <= RTOL * scale, (what, err, scale)


@pytest.mark.parametrize("kind,timestepper", [
    ("nonhydrostatic", "QuasiAdamsBashforth2"), ("nonhydrostatic", "RungeKutta3"),
    ("hydrostatic", None)], ids=["nonhydrostatic-ab2", "nonhydrostatic-rk3",
                                 "hydrostatic"])
def test_one_dict_of_keywords_builds_both_packages_models(kind, timestepper):
    extra = {} if timestepper is None else dict(timestepper=timestepper)
    jm, tm = build(J, kind, **extra), build(T, kind, **extra)
    assert tm.grid.halo == jm.grid.halo == (3, 3, 3)
    assert not jm.fused_advection and not tm.fused_advection
    assert tm.kernels is (tnm.PLAIN if kind == "nonhydrostatic" else thm.PLAIN)
    if kind == "nonhydrostatic":
        assert not jm.fused_step and not tm.fused_step
        assert not jm.g_interior and not tm.g_interior
    vals = initial_values(kind)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    for _ in range(10):
        js = jm.step(js, DT[kind])
        ts = tm.step(ts, DT[kind])
    for name, a in ts["solution"].items():
        close(jm.grid.interior(js["solution"][name]), tm.grid.interior(a), name)
    for name, g in ts["G_prev"].items():
        assert tuple(g.shape) == tuple(js["G_prev"][name].shape), name
    if kind == "hydrostatic":
        close(js["eta"], ts["eta"], "eta")
    else:
        close(jm.grid.interior(js["pNHS"]), tm.grid.interior(ts["pNHS"]), "pNHS")


def spy(calls, name, fn):
    def run(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    return run


@pytest.mark.parametrize("fused", ["auto", True, False])
@pytest.mark.parametrize("kind", ["nonhydrostatic", "hydrostatic"])
def test_fused_advection_false_steps_through_the_plain_versions(
        kind, fused, monkeypatch):
    module, entry = ((tnm, "advect") if kind == "nonhydrostatic"
                     else (thm, "tendencies"))
    calls = []
    for mapping, label in ((module.KERNELS, "kernels"), (module.PLAIN, "plain")):
        monkeypatch.setitem(mapping, entry, spy(calls, label, mapping[entry]))
    extra = dict(fused_advection=fused)
    if kind == "nonhydrostatic":  # every step calls "advect"
        extra["timestepper"] = "RungeKutta3"
    model = build(T, kind, **extra)
    assert model.fused_advection is (fused is not False)
    assert model.kernels is (module.KERNELS if fused is not False else module.PLAIN)
    state = model.initial_state(**initial_values(kind))
    calls.clear()
    model.step(state, DT[kind])
    assert calls and set(calls) == {"plain" if fused is False else "kernels"}
    # a mapping passed to step still replaces the model's own
    calls.clear()
    model.step(state, DT[kind], kernels=module.PLAIN)
    assert set(calls) == {"plain"}


def test_fused_advection_false_takes_the_general_ab2_branch():
    """As JAX's fused_step_ok, the port's fused AB2 branch needs the
    keyword: the bench configuration takes it under "auto" and True, and
    the general branch (G_prev with halos) under False."""
    for fused in ("auto", True, False):
        grid = T.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1),
                                 topology=("periodic", "periodic", "bounded"),
                                 dtype=torch.float64, device=DEVICE)
        model = T.NonhydrostaticModel(grid, advection=T.WENO5(),
                                      buoyancy=T.BuoyancyTracer(),
                                      fused_advection=fused)
        assert model.fused_step is (fused is not False)
        assert model.g_interior is (fused is not False)
