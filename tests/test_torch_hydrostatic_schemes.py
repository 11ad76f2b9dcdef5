"""Port parity: every advection scheme in the hydrostatic model and K4b.

JAX's K4 gate takes any ``AdvectionScheme`` for flux-form momentum and for
the tracers, and its model runs ``hydrostatic_advective_core`` with them.
The port's K4b takes the eight scheme codes of ``KERNEL_SCHEMES`` (its
``ANY`` instantiation for all but WENO5 and the centred scheme). Held
against the JAX package in float64, the same numpy-seeded inputs through
both:

- K4b's plain version (``hydrostatic_advective_core``) against the JAX
  core with each of UB5, ``PositiveWENO5``, C4, UB1, UB3 and
  ``BoundsPreservingWENO5`` as flux-form momentum and as the tracer scheme,
  on a (Periodic, Bounded, Bounded) rectilinear grid and a lat-lon grid
  with a stretched z, flat and over a ``GridFittedBottom``: bit for bit on
  the interior;
- 5 split-explicit steps of the lat-lon model with each scheme against the
  JAX model (its plain path) within ``RTOL``;
- K4's gate takes each scheme and still refuses a Flat y, a stretched x
  and the Cartesian Coriolis forms, by name.

The ``cuda`` cases hold K4b against its plain version on the card bit for
bit over NaN-filled outputs: each scheme as flux-form momentum and
tracers, with vector-invariant momentum and each tracer scheme, fp32 and
fp64, sizes off K4b's 16×8 tiles, in the fused advance and the tendency
form, over a flat bottom and an immersed one, and on a stretched latitude
(``python -m pytest --noconftest -m cuda
tests/test_torch_hydrostatic_schemes.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.immersed.immersed import ImmersedGrid
from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection import schemes as jsch
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JB
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from clima_oceananigans_jl_tpu.immersed.immersed import GridFittedBottom as JGFB
    from clima_oceananigans_jl_tpu.immersed.immersed import ImmersedGrid as JIG
    from clima_oceananigans_jl_tpu.models.free_surface import (
        SplitExplicitFreeSurface as JSplit)
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    from clima_oceananigans_jl_tpu.ops.fused_hydrostatic import (
        hydrostatic_advective_core as j_core)
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
#: the schemes K4b takes beyond WENO5 and the centred one
SCHEMES = ("UpwindBiasedFifthOrder", "PositiveWENO5", "CenteredFourthOrder",
           "UpwindBiasedFirstOrder", "UpwindBiasedThirdOrder", "BoundsPreservingWENO5")


def zfaces(nz, depth=3000.0, p=1.8):
    k = np.arange(nz + 1)
    return -depth * (1.0 - k / nz) ** p


def stretched_latitude(nf):
    s = np.linspace(-1.0, 1.0, nf)
    return 70.0 * (0.6 * s + 0.4 * s ** 3)


def grid_kw(kind, size):
    if kind.startswith("latlon"):
        lat = stretched_latitude(size[1] + 1) if kind == "latlon-sy" else (-75, 75)
        return dict(size=size, longitude=(0, 360), latitude=lat, z=zfaces(size[2]))
    return dict(size=size, x=(0, 1e5), y=(0, 8e4), z=zfaces(size[2], 1e3, 1.5),
                topology=("periodic", "bounded", "bounded"))


def torch_grid(kind, size, dtype=torch.float64, device=DEVICE):
    cls = T.LatitudeLongitudeGrid if kind.startswith("latlon") else T.RectilinearGrid
    return cls(dtype=dtype, device=device, **grid_kw(kind, size))


def ridge(kind, xp):
    """A bottom that leaves some columns solid and some shallow."""
    if kind.startswith("latlon"):
        return lambda lam, phi: -3000.0 + 2600.0 * xp.exp(-((lam - 180.0) / 40.0) ** 2)
    return lambda x, y: -1000.0 + 800.0 * xp.exp(-((x - 5e4) / 2e4) ** 2)


def scheme(name, pkg):
    return getattr(jsch if pkg == "jax" else T, name)()


@pytest.mark.parametrize("bottom", [False, True], ids=["flat", "immersed"])
@pytest.mark.parametrize("kind", ["rect", "latlon"])
@pytest.mark.parametrize("name", SCHEMES)
def test_core_plain_version_matches_jax_bitwise(name, kind, bottom):
    """K4b's plain version with the scheme as flux-form momentum and as
    the tracer scheme, over Coriolis and −∂pHY′, bit for bit."""
    size = (14, 10, 6)
    kw = grid_kw(kind, size)
    jg = (JLL if kind == "latlon" else J.RectilinearGrid)(dtype=jnp.float64, **kw)
    tg = torch_grid(kind, size)
    jg, tg = jg.with_halo((3, 3, 3)), tg.with_halo((3, 3, 3))
    if bottom:
        jg = JIG.wrap(jg, JGFB(ridge(kind, jnp)).build(jg))
        tg = ImmersedGrid(tg, T.GridFittedBottom(ridge(kind, torch)).build(tg))
    jcor = J.FPlane(f=1e-4) if kind == "rect" else J.HydrostaticSphericalCoriolis()
    tcor = T.FPlane(f=1e-4) if kind == "rect" else T.HydrostaticSphericalCoriolis()
    rng = np.random.default_rng(41)
    names = ("c", "b")
    shape = tg.total_shape
    f = dict(u=0.1 * rng.standard_normal(shape), v=0.1 * rng.standard_normal(shape),
             w=1e-3 * rng.standard_normal(shape), pHY=rng.standard_normal(shape),
             c=rng.uniform(-0.1, 1.1, shape), b=1e-3 * rng.standard_normal(shape))
    ja = {k: jnp.asarray(v) for k, v in f.items()}
    ta = {k: torch.as_tensor(v) for k, v in f.items()}
    js, ts = scheme(name, "jax"), scheme(name, "torch")
    ref = j_core(jg, js, js, jcor, names, ja["u"], ja["v"], ja["w"],
                 {n: ja[n] for n in names}, pHY=ja["pHY"])
    got = tfh.hydrostatic_advective_core(tg, ts, ts, tcor, names, ta["u"], ta["v"],
                                         ta["w"], {n: ta[n] for n in names}, pHY=ta["pHY"])
    for n in ("u", "v") + names:
        r, g = np.asarray(jg.interior(ref[n])), tg.interior(got[n]).numpy()
        assert np.array_equal(r, g), (n, np.abs(r - g).max())


@pytest.mark.parametrize("name", SCHEMES)
def test_model_five_steps_match_jax(name):
    """The lat-lon model (split-explicit free surface, spherical Coriolis,
    buoyancy) with the scheme as momentum and tracers, 5 steps, within
    RTOL of the JAX model's plain path."""
    size = (12, 8, 5)
    kw = grid_kw("latlon", size)
    jm = JH(JLL(dtype=jnp.float64, **kw), momentum_advection=scheme(name, "jax"),
            tracer_advection=scheme(name, "jax"), buoyancy=JB(), tracers=("c",),
            coriolis=J.HydrostaticSphericalCoriolis(), free_surface=JSplit(substeps=8),
            fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(
        torch_grid("latlon", size), momentum_advection=scheme(name, "torch"),
        tracer_advection=scheme(name, "torch"), buoyancy=T.BuoyancyTracer(),
        tracers=("c",), coriolis=T.HydrostaticSphericalCoriolis(),
        free_surface=T.SplitExplicitFreeSurface(substeps=8))
    assert tm.grid.halo == jm.grid.halo
    rng = np.random.default_rng(43)
    vals = dict(u=0.05 * rng.standard_normal(size), v=0.05 * rng.standard_normal(size),
                b=1e-4 * rng.standard_normal(size), c=rng.uniform(0.0, 1.0, size))
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(5):
        js, ts = step(js, 300.0), tm.step(ts, 300.0)
    for k in ("u", "v", "b", "c"):
        ref = np.asarray(jm.grid.interior(js["solution"][k]))
        got = tm.grid.interior(ts["solution"][k]).numpy()
        assert np.isfinite(got).all()
        assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max(), k
    ref, got = np.asarray(js["eta"]), ts["eta"].numpy()
    assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max()


def test_k4_gate_takes_each_scheme_and_refuses_the_rest_by_name():
    g = torch_grid("latlon", (12, 8, 4))
    for name in SCHEMES + ("WENO5", "CenteredSecondOrder"):
        m = T.HydrostaticFreeSurfaceModel(g, momentum_advection=scheme(name, "torch"),
                                          tracer_advection=scheme(name, "torch"),
                                          tracers=("c",))
        assert tfh.unsupported_reason(m) is None, name
        m = T.HydrostaticFreeSurfaceModel(g, tracer_advection=scheme(name, "torch"),
                                          tracers=("c",))
        assert tfh.unsupported_reason(m) is None, name
    flat_y = T.RectilinearGrid(size=(8, 1, 4), extent=(1, 1, 1), device=DEVICE,
                               topology=(T.PERIODIC, T.FLAT, T.BOUNDED))
    m = T.HydrostaticFreeSurfaceModel(flat_y, tracer_advection=T.PositiveWENO5(),
                                      tracers=("c",), free_surface=T.ExplicitFreeSurface())
    assert tfh.unsupported_reason(m) is None  # K4's Flat-y layout
    stretched_x = T.RectilinearGrid(size=(8, 8, 4), x=np.cumsum(np.r_[0, np.arange(1, 9)]),
                                    y=(0, 1), z=(-1, 0), device=DEVICE)
    m = T.HydrostaticFreeSurfaceModel(stretched_x, tracer_advection=T.UpwindBiasedThirdOrder(),
                                      tracers=("c",), free_surface=T.ExplicitFreeSurface())
    assert "regular x" in tfh.unsupported_reason(m)
    m = T.HydrostaticFreeSurfaceModel(g, momentum_advection=T.CenteredFourthOrder(),
                                      tracers=("c",))
    for cor in (T.ConstantCartesianCoriolis(fz=1e-4), T.NonTraditionalBetaPlane()):
        m = T.HydrostaticFreeSurfaceModel(g, momentum_advection=T.CenteredFourthOrder(),
                                          tracers=("c",), coriolis=cor)
        assert tfh.unsupported_reason(m) is None  # K4b's Cartesian forms
    m.coriolis = object()
    assert "K4 has no object Coriolis" in tfh.unsupported_reason(m)
    # the conditional fluxes read buffer + 1 halo cells: C4's 2, UB5's 3
    ig = torch_grid("rect", (12, 8, 4))
    m = T.HydrostaticFreeSurfaceModel(ig, momentum_advection=T.CenteredFourthOrder(),
                                      tracer_advection=T.CenteredFourthOrder(),
                                      tracers=("c",),
                                      immersed_boundary=T.GridFittedBottom(ridge("rect", torch)))
    assert m.grid.halo[:2] == (2, 2) and tfh.unsupported_reason(m) is None


# -- on the card ---------------------------------------------------------------------

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def poison(grid, n):
    blocks = [torch.full(grid.total_shape, float("nan"), dtype=grid.dtype, device="cuda")
              for _ in range(n)]
    del blocks


def hold_k4b(model, advance):
    """K4b against its plain version on the interior, bit for bit, its
    halos exactly zero, over NaN-filled memory; one launch."""
    g = model.grid
    gen = torch.Generator(device="cuda").manual_seed(47)
    size = g.shape
    rand = lambda s: s * torch.randn(size, generator=gen, dtype=g.dtype, device="cuda")
    state = model.initial_state(u=rand(0.1), v=rand(0.1), b=rand(1e-3),
                                c=torch.rand(size, generator=gen, dtype=g.dtype,
                                             device="cuda") * 1.2 - 0.1)
    state = model.update_state(state)
    state["G_prev"] = {k: torch.zeros_like(v) + 1e-6 for k, v in state["solution"].items()}
    adv = (60.0, False) if advance else None
    poison(g, 12)
    before = tfh.fused_hydrostatic_tendencies.launches
    got = tfh.fused_hydrostatic_tendencies(model, state, adv)
    torch.cuda.synchronize()
    assert tfh.fused_hydrostatic_tendencies.launches == before + 1
    ref = tfh.fused_hydrostatic_tendencies_reference(model, state, adv)
    got, ref = (got, ref) if advance else ((got,), (ref,))
    for a, b in zip(got, ref):
        for n in b:
            assert torch.equal(g.interior(a[n]).nan_to_num(7.0),
                               g.interior(b[n]).nan_to_num(7.0)), n
            halo = a[n].clone()
            halo[g.interior_slices] = 0
            assert not halo.isnan().any() and not halo.any(), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", ["advance", "tendencies", "immersed", "vi", "latlon-sy"])
@pytest.mark.parametrize("name", SCHEMES)
def test_cuda_k4b_matches_plain_version(name, form, dtype):
    needs_card()
    kind = "latlon-sy" if form == "latlon-sy" else "latlon"
    kw = {}
    if form == "immersed":
        kw["immersed_boundary"] = T.GridFittedBottom(ridge(kind, torch))
    mom = T.VectorInvariant(scheme="weno_velocity") if form == "vi" else scheme(name, "torch")
    m = T.HydrostaticFreeSurfaceModel(
        torch_grid(kind, (45, 21, 7), DTYPES[dtype], "cuda"), momentum_advection=mom,
        tracer_advection=scheme(name, "torch"), buoyancy=T.BuoyancyTracer(),
        tracers=("c",), coriolis=T.HydrostaticSphericalCoriolis(),
        free_surface=T.ExplicitFreeSurface(), **kw)
    hold_k4b(m, form in ("advance", "latlon-sy"))
