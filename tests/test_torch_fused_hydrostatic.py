"""Port parity: the hydrostatic kernels' plain versions (K4a, K4b, K5).

The JAX side is its plain path (``fused_advection=False``); the JAX suite
pins its Pallas K4 and K5 to that path (``tests/test_fused_hydrostatic.py``,
``tests/test_fused_barotropic.py``). Here, in f64 on lat-lon grids of at
most 32×16×8 and on a (Bounded, Bounded, Bounded) rectilinear grid:

- K4b's plain version, ``hydrostatic_advective_core``, against the JAX
  ``hydrostatic_advective_core`` over the four vector-invariant schemes,
  both spherical Coriolis schemes, f- and β-planes, flux-form momentum,
  stretched z and bounded-y order reduction: ≤ 1e-12 of max|ref| (the
  same expression trees; the sine of f may differ in its last bit);
- K4a's plain version (w and pHY′ summed level by level) against the JAX
  ``compute_w`` and pHY′ (cumulative sums): ≤ 1e-12 of max|ref|, the
  difference being the cumsum's association;
- K4b's advance form against tendencies then ``ab2_substep``: bitwise;
- K5's plain version against the JAX ``substep_eta`` (its XLA loop):
  ≤ 1e-14 of max|ref|, the column depths (a sum over z) being the only
  reassociated input; over an immersed bottom too, where the depths vary
  in x and y and K5 takes them as (X, Y) planes (a numpy check that the
  wrapper hands the kernel the planes, not rows);
- K4b's plain version with its three newer parts against the JAX core:
  the in-kernel closure (``kernel_closure``: explicit, vertically
  implicit, per-tracer κ), the solid masks (the JAX kernel's
  ``_DuckImmersed`` 0/1 masks against the port's boolean ones, WENO5
  tracers and flux-form WENO5 momentum) and a stretched latitude (WENO5
  tracers and flux-form WENO5 momentum with y tables), bit for bit; a numpy
  mirror of the y table rows K4b reads; the clear flags against
  ``_immersed_clear``.

The ``cuda`` cases hold each kernel against its plain version on the card
(``python -m pytest --noconftest -m cuda
tests/test_torch_fused_hydrostatic.py``): K4a, K4b and K5 bit for bit,
K4a and K5 on every with-halo point after the allocator's cache is filled
with NaNs (so a point the kernel leaves unwritten shows); K4b with the
closure, the masks and a stretched latitude, K5 on depth planes.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.models.free_surface import (ETA_LOC,
                                                             column_depths,
                                                             fill2d)
from clima_oceananigans_jl_torch.ops import fused_barotropic as tfb
from clima_oceananigans_jl_torch.immersed import immersed as T_immersed
from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh
from clima_oceananigans_jl_torch.ops import metric_rows as tmr

try:  # the cuda cases also run on a machine without JAX
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection.vector_invariant import (
        VectorInvariant as JVI)
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JB
    from clima_oceananigans_jl_tpu.coriolis import coriolis as jcor
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from clima_oceananigans_jl_tpu.models.free_surface import (
        SplitExplicitFreeSurface as JSplit)
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    from clima_oceananigans_jl_tpu.immersed import immersed as J_immersed
    from clima_oceananigans_jl_tpu.ops.fused_hydrostatic import (
        _DuckImmersed as j_duck, hydrostatic_advective_core as j_core)
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-12


def zfaces(nz, depth=3000.0, p=1.8):
    k = np.arange(nz + 1)
    return -depth * (1.0 - k / nz) ** p


def torch_grid(kind, size, dtype=torch.float64, device=DEVICE):
    if kind == "latlon":
        return T.LatitudeLongitudeGrid(size=size, longitude=(0, 360),
                                       latitude=(-75, 75), z=zfaces(size[2]),
                                       dtype=dtype, device=device)
    return T.RectilinearGrid(size=size, x=(0, 1e5), y=(0, 8e4),
                             z=zfaces(size[2], 1e3, 1.5),
                             topology=("bounded", "bounded", "bounded"),
                             dtype=dtype, device=device)


def jax_grid(kind, size):
    if kind == "latlon":
        return JLL(size=size, longitude=(0, 360), latitude=(-75, 75),
                   z=zfaces(size[2]), dtype=jnp.float64)
    return J.RectilinearGrid(size=size, x=(0, 1e5), y=(0, 8e4),
                             z=zfaces(size[2], 1e3, 1.5),
                             topology=("bounded", "bounded", "bounded"),
                             dtype=jnp.float64)


MOMENTUM = {"vi-enstrophy": "enstrophy", "vi-energy": "energy",
            "vi-weno": "weno", "vi-weno-velocity": "weno_velocity",
            "flux-weno5": "weno5", "flux-centered": "centered"}


def momentum(name, pkg):
    m = MOMENTUM[name]
    if m == "weno5":
        return pkg.WENO5()
    if m == "centered":
        return pkg.CenteredSecondOrder()
    return (JVI if pkg is J else T.VectorInvariant)(scheme=m)


def coriolis(name, pkg):
    if name is None:
        return None
    if name.startswith("spherical"):
        cls = jcor.HydrostaticSphericalCoriolis if pkg is J else T.HydrostaticSphericalCoriolis
        return cls(scheme=name.split("-")[1])
    if name == "fplane":
        return (jcor.FPlane if pkg is J else T.FPlane)(f=1e-4)
    return (jcor.BetaPlane if pkg is J else T.BetaPlane)(f0=1e-4, beta=1e-11)


def fields(shape, names, seed):
    rng = np.random.default_rng(seed)
    scale = dict(u=0.1, v=0.1, w=1e-3, pHY=1.0)
    return {n: scale.get(n, 1e-3) * rng.standard_normal(shape) for n in names}


CASES = [  # (grid, momentum, coriolis, tracer scheme)
    ("latlon", "vi-weno-velocity", "spherical-energy", "weno5"),
    ("latlon", "vi-weno", "spherical-enstrophy", "weno5"),
    ("latlon", "vi-energy", "spherical-energy", "centered"),
    ("latlon", "vi-enstrophy", "spherical-enstrophy", "weno5"),
    ("latlon", "flux-weno5", "spherical-energy", "weno5"),
    ("rect-bbb", "flux-weno5", "betaplane", "weno5"),
    ("rect-bbb", "flux-centered", "fplane", "centered"),
    ("rect-bbb", "vi-weno-velocity", None, "weno5"),
]


@pytest.mark.parametrize("kind,mom,cor,ts", CASES,
                         ids=["-".join(str(x) for x in c) for c in CASES])
def test_core_plain_version_matches_jax(kind, mom, cor, ts):
    size = (32, 16, 8) if kind == "latlon" else (16, 12, 8)
    jg, tg = jax_grid(kind, size), torch_grid(kind, size)
    names = ("T", "b")
    f = fields(tg.total_shape, ("u", "v", "w", "pHY") + names, seed=1)
    jt = {"weno5": J.WENO5(), "centered": J.CenteredSecondOrder()}[ts]
    tt = {"weno5": T.WENO5(), "centered": T.CenteredSecondOrder()}[ts]
    ja = {k: jnp.asarray(v) for k, v in f.items()}
    ta = {k: torch.as_tensor(v) for k, v in f.items()}
    ref = j_core(jg, momentum(mom, J), jt, coriolis(cor, J), names, ja["u"],
                 ja["v"], ja["w"], {n: ja[n] for n in names}, pHY=ja["pHY"])
    got = tfh.hydrostatic_advective_core(
        tg, momentum(mom, T), tt, coriolis(cor, T), names, ta["u"], ta["v"],
        ta["w"], {n: ta[n] for n in names}, pHY=ta["pHY"])
    for n in ("u", "v") + names:
        r, g = np.asarray(jg.interior(ref[n])), tg.interior(got[n]).numpy()
        assert np.abs(r - g).max() <= RTOL * np.abs(r).max(), n


def flagship_models(size=(16, 8, 6), substeps=8, jax_model=True, device=DEVICE,
                    dtype=torch.float64, mom="vi-weno-velocity", kind="latlon",
                    cor="spherical-energy"):
    tm = T.HydrostaticFreeSurfaceModel(
        torch_grid(kind, size, dtype, device), momentum_advection=momentum(mom, T),
        tracer_advection=T.WENO5(), tracers=("T", "S"),
        free_surface=T.SplitExplicitFreeSurface(substeps=substeps),
        coriolis=coriolis(cor, T), buoyancy=T.BuoyancyTracer())
    if not jax_model:
        return None, tm
    jm = JH(jax_grid(kind, size), momentum_advection=momentum(mom, J),
            tracer_advection=J.WENO5(), tracers=("T", "S"),
            free_surface=JSplit(substeps=substeps), coriolis=coriolis(cor, J),
            buoyancy=JB(), fused_advection=False)
    return jm, tm


def initial_values(shape, seed=0):
    rng = np.random.default_rng(seed)
    return dict(u=0.1 * rng.standard_normal(shape),
                v=0.05 * rng.standard_normal(shape),
                T=rng.standard_normal(shape),
                b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)


@pytest.mark.parametrize("kind", ["latlon", "rect-bbb"])
def test_columns_plain_version_matches_jax_compute_w_and_phy(kind):
    size = (32, 16, 8) if kind == "latlon" else (16, 12, 8)
    jm, tm = flagship_models(size=size, kind=kind,
                             mom="vi-weno-velocity" if kind == "latlon" else "flux-weno5",
                             cor="spherical-energy" if kind == "latlon" else "betaplane")
    vals = initial_values(tm.grid.shape, seed=2)
    vals["b"] = np.random.default_rng(3).standard_normal(tm.grid.shape)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    for key in ("w", "pHY"):
        r, g = np.asarray(js[key]), ts[key].numpy()
        assert r.shape == g.shape
        assert np.abs(r - g).max() <= RTOL * np.abs(r).max(), key
    w, ph = tfh.hydrostatic_columns_reference(
        tm.grid, ts["solution"]["u"], ts["solution"]["v"], ts["solution"]["b"])
    assert torch.equal(tm.compute_w(ts["solution"]), ts["w"])
    assert torch.equal(tm.grid.interior(ph), tm.grid.interior(ts["pHY"]))


def test_advance_form_matches_the_two_stage_step_bitwise():
    _, tm = flagship_models(jax_model=False)
    state = tm.initial_state(**initial_values(tm.grid.shape, seed=4))
    rng = np.random.default_rng(5)
    state["G_prev"] = {n: torch.as_tensor(1e-6 * rng.standard_normal(tm.grid.total_shape))
                       for n in tm.prognostic_names()}
    for euler in (True, False):
        psi, G = tfh.fused_hydrostatic_tendencies(tm, state, advance=(600.0, euler))
        G2 = tfh.fused_hydrostatic_tendencies(tm, state)
        psi2 = T.timesteppers.steppers.ab2_substep(
            state["solution"], G2, state["G_prev"], 600.0, tm.ab2_chi, euler)
        for n in tm.prognostic_names():
            assert torch.equal(G[n], G2[n]) and torch.equal(psi[n], psi2[n]), n


@pytest.mark.parametrize("weights", ["uniform", "hann"])
def test_barotropic_plain_version_matches_jax_substep_eta(weights):
    jm, tm = flagship_models(size=(24, 12, 6), substeps=10)
    if weights == "hann":
        tm.free_surface = T.SplitExplicitFreeSurface.with_hann_filter(substeps=10)
        jm = JH(jm.grid, momentum_advection=jm.momentum_advection,
                tracer_advection=jm.tracer_advection, tracers=("T", "S"),
                free_surface=JSplit.with_hann_filter(substeps=10),
                coriolis=jm.coriolis, buoyancy=JB(), fused_advection=False)
    g = tm.grid
    rng = np.random.default_rng(6)
    shape = g.total_shape[:2] + (1,)
    eta, U0, V0, GU, GV = (s * rng.standard_normal(shape)
                           for s in (0.1, 10.0, 10.0, 1e-3, 1e-3))
    from clima_oceananigans_jl_tpu.models.free_surface import fill2d as jfill2d
    jeta = jfill2d(jnp.asarray(eta), jm.grid, J.W_LOC[:2] + (J.F,), jm.eta_bcs)
    teta = fill2d(torch.as_tensor(eta), g, ETA_LOC, tm.eta_bcs)
    ref = jm.free_surface.substep_eta(jm.grid, jm.eta_bcs, jeta, *(
        jnp.asarray(a) for a in (GU, GV, U0, V0)), 600.0)
    got = tm.free_surface.substep_eta(g, tm.eta_bcs, teta, *(
        torch.as_tensor(a) for a in (GU, GV, U0, V0)), 600.0)
    for name, r, x in zip(("eta", "U", "V"), ref, got):
        r, x = np.asarray(r), x.numpy()
        assert r.shape == x.shape
        assert np.abs(r - x).max() <= 1e-14 * np.abs(r).max(), name


def test_metric_rows_are_slices_of_the_plain_versions_metrics():
    g = torch_grid("latlon", (16, 8, 6))
    cor = T.HydrostaticSphericalCoriolis()
    ys, zs = tmr.y_rows(g, cor), tmr.z_rows(g, tables=True)
    assert ys.shape == (len(tmr.Y_ROWS), g.total_shape[1])
    assert zs.shape == (2 + 24, g.total_shape[2])
    full = lambda m: torch.broadcast_to(m, g.total_shape[:2] + (1,))
    assert torch.equal(full(g.dx((T.F, T.C, T.C)))[:, :, 0],
                       ys[tmr.Y_ROWS.index("dx_fc")].expand(g.total_shape[0], -1))
    assert torch.equal(full(g.Az((T.C, T.F, T.C)))[:, :, 0],
                       ys[tmr.Y_ROWS.index("az_cf")].expand(g.total_shape[0], -1))
    assert torch.equal(cor.f_ff(g).reshape(-1), ys[tmr.Y_ROWS.index("f_u")])
    assert torch.equal(g.dz(T.W_LOC).reshape(-1), zs[1])
    with pytest.raises(ValueError):
        tmr.coriolis_rows(g, object())
    # built once per grid and options, as the column depths are
    assert tmr.y_rows(g, T.HydrostaticSphericalCoriolis()) is ys
    assert tmr.z_rows(g, tables=True) is zs
    assert tmr.y_rows(g) is not ys and tmr.z_rows(g) is not zs
    assert all(a is b for a, b in zip(column_depths(g), column_depths(g)))


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch():
    _, tm = flagship_models(jax_model=False)
    state = tm.initial_state(**initial_values(tm.grid.shape))
    before = (tfh.hydrostatic_columns.launches,
              tfh.fused_hydrostatic_tendencies.launches,
              tfb.fused_substep_eta.launches)
    state = tm.step(state, 600.0)
    assert (tfh.hydrostatic_columns.launches,
            tfh.fused_hydrostatic_tendencies.launches,
            tfb.fused_substep_eta.launches) == before
    assert tfh.unsupported_reason(tm) is None
    assert tfb.unsupported_reason(tm.grid, tm.eta_bcs) is None


def test_kernel_gates_refuse_what_the_kernels_lack():
    stretched_x = T.RectilinearGrid(size=(8, 8, 6), x=np.cumsum(np.r_[0, np.arange(1, 9)]),
                                    y=(0, 1), z=(-1, 0), dtype=torch.float64,
                                    device=DEVICE)
    m = T.HydrostaticFreeSurfaceModel(stretched_x, tracer_advection=T.WENO5(),
                                      free_surface=T.ExplicitFreeSurface(),
                                      tracers=("c",))
    assert "regular x" in tfh.unsupported_reason(m)
    assert "regular x" in tfb.unsupported_reason(m.grid, m.eta_bcs)
    stretched_y = T.RectilinearGrid(size=(8, 8, 6), x=(0, 1),
                                    y=np.cumsum(np.r_[0, np.arange(1, 9)]),
                                    z=(-1, 0), dtype=torch.float64, device=DEVICE)
    m = T.HydrostaticFreeSurfaceModel(stretched_y, tracer_advection=T.WENO5(),
                                      free_surface=T.ExplicitFreeSurface(),
                                      tracers=("c",))
    assert tfh.unsupported_reason(m) is None  # K4b reads a stretched y's tables
    walls = {"eta": T.FieldBCs(south=T.ValueBC(0.1))}
    m = T.HydrostaticFreeSurfaceModel(
        torch_grid("rect-bbb", (8, 8, 6)), boundary_conditions=walls,
        free_surface=T.SplitExplicitFreeSurface(substeps=4))
    assert "zero-gradient" in tfb.unsupported_reason(m.grid, m.eta_bcs)


# -- K4b's closure, solid masks and stretched-y tables; K5 on depth planes ------------

def stretched_latitude(nf=13):
    """Latitude faces from −70° to 70°, finer near the equator."""
    s = np.linspace(-1.0, 1.0, nf)
    return 70.0 * (0.6 * s + 0.4 * s ** 3)


def pair(kind, size, latitude=None):
    """(JAX grid, port grid) with the models' halos (3 each)."""
    if kind == "latlon":
        lat = latitude if latitude is not None else (-75, 75)
        jg = JLL(size=size, longitude=(0, 360), latitude=lat, z=zfaces(size[2]),
                 dtype=jnp.float64)
        tg = T.LatitudeLongitudeGrid(size=size, longitude=(0, 360), latitude=lat,
                                     z=zfaces(size[2]), dtype=torch.float64,
                                     device=DEVICE)
    else:
        jg, tg = jax_grid(kind, size), torch_grid(kind, size)
    return jg.with_halo((3, 3, 3)), tg.with_halo((3, 3, 3))


def jloc(loc):
    return tuple(J.C if l == T.C else J.F for l in loc)


class _JKernelGrid:
    """A JAX grid carrying the JAX kernel's ``_DuckImmersed`` 0/1 masks,
    as its Pallas kernel hands them to ``hydrostatic_advective_core``."""

    def __init__(self, grid, masks):
        self._grid = grid
        self.immersed = j_duck(masks)

    def __getattr__(self, name):
        return getattr(self._grid, name)


def _core_pair(jg, tg, mom, cor, ts, names, seed, jcl=None, tcl=None):
    f = fields(tg.total_shape, ("u", "v", "w", "pHY") + names, seed=seed)
    jt = {"weno5": J.WENO5(), "centered": J.CenteredSecondOrder()}[ts]
    tt = {"weno5": T.WENO5(), "centered": T.CenteredSecondOrder()}[ts]
    ja = {k: jnp.asarray(v) for k, v in f.items()}
    ta = {k: torch.as_tensor(v) for k, v in f.items()}
    ref = j_core(jg, momentum(mom, J), jt, coriolis(cor, J), names, ja["u"], ja["v"],
                 ja["w"], {n: ja[n] for n in names}, pHY=ja["pHY"], closure=jcl)
    got = tfh.hydrostatic_advective_core(
        tg, momentum(mom, T), tt, coriolis(cor, T), names, ta["u"], ta["v"], ta["w"],
        {n: ta[n] for n in names}, pHY=ta["pHY"], closure=tcl)
    return ref, got


def _held(jg, tg, ref, got, names):
    """Bit for bit: the same expression trees on the same metrics."""
    for n in ("u", "v") + names:
        r, g = np.asarray(jg.interior(ref[n])), tg.interior(got[n]).numpy()
        assert np.array_equal(r, g), (n, np.abs(r - g).max())


CLOSURE_KW = {
    "explicit": dict(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4),
    "vertically-implicit": dict(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
                                time_discretization="vertically_implicit"),
    "per-tracer": dict(nu=2e3, kappa={"T": 1e3, "b": 5e2}, kappa_z={"T": 1e-3}),
}


@pytest.mark.parametrize("closure", sorted(CLOSURE_KW))
@pytest.mark.parametrize("kind,mom,cor,ts", [
    ("latlon", "vi-weno-velocity", "spherical-energy", "weno5"),
    ("rect-bbb", "flux-weno5", "betaplane", "centered")], ids=["latlon", "rect-bbb"])
def test_core_with_the_kernel_closure_matches_jax(closure, kind, mom, cor, ts):
    size = (24, 12, 8) if kind == "latlon" else (16, 12, 8)
    jg, tg = pair(kind, size)
    jcl, tcl = J.ScalarDiffusivity(**CLOSURE_KW[closure]), T.ScalarDiffusivity(**CLOSURE_KW[closure])
    names = ("T", "b")
    ref, got = _core_pair(jg, tg, mom, cor, ts, names, 31, jcl, tcl)
    _held(jg, tg, ref, got, names)
    # and the closure changed every field
    _, bare = _core_pair(jg, tg, mom, cor, ts, names, 31)
    assert all(not torch.equal(got[n], bare[n]) for n in ("u", "v") + names)


@pytest.mark.parametrize("mom,ts", [("vi-weno-velocity", "weno5"), ("flux-weno5", "weno5"),
                                    ("flux-weno5", "centered")])
def test_core_with_solid_masks_matches_jax(mom, ts):
    """The JAX kernel's 0/1 masks (``_DuckImmersed``) against the port's
    boolean ones on an immersed lat-lon grid with the validation's ridge."""
    jg, tg = pair("latlon", (24, 12, 8))
    ridge_j = lambda lam, phi: -3000.0 + 2600.0 * jnp.exp(-((lam - 180.0) / 30.0) ** 2)
    ridge_t = lambda lam, phi: -3000.0 + 2600.0 * torch.exp(-((lam - 180.0) / 30.0) ** 2)
    jb = J_immersed.GridFittedBottom(ridge_j).build(jg)
    tb = T.GridFittedBottom(ridge_t).build(tg)
    masks = {jloc(l): jb.mask_for(jloc(l)).astype(jnp.float64)
             for l in (T.CENTER, T.U_LOC, T.V_LOC)}
    tig = T_immersed.ImmersedGrid(tg, tb)
    names = ("T", "b")
    ref, got = _core_pair(_JKernelGrid(jg, masks), tig, mom, "spherical-energy", ts,
                          names, 32)
    _held(jg, tg, ref, got, names)
    _, bare = _core_pair(jg, tg, mom, "spherical-energy", ts, names, 32)
    assert any(not torch.equal(got[n], bare[n]) for n in ("u", "v") + names)


@pytest.mark.parametrize("mom,ts,bottom", [("flux-weno5", "weno5", False),
                                           ("vi-weno-velocity", "weno5", False),
                                           ("flux-centered", "centered", False),
                                           ("flux-weno5", "weno5", True)],
                         ids=["flux-weno5", "vi-weno-velocity", "flux-centered",
                              "flux-weno5-immersed"])
def test_core_on_a_stretched_latitude_matches_jax(mom, ts, bottom):
    """K4b's plain version on stretched latitudes (the y tables), also with
    the solid masks: there the two-sided table form falls back to the
    cells below and above the face."""
    jg, tg = pair("latlon", (16, 12, 6), latitude=stretched_latitude())
    assert not tg.y_regular
    if bottom:
        ridge_j = lambda lam, phi: -3000.0 + 2600.0 * jnp.exp(-((phi - 10.0) / 20.0) ** 2)
        ridge_t = lambda lam, phi: -3000.0 + 2600.0 * torch.exp(-((phi - 10.0) / 20.0) ** 2)
        jb = J_immersed.GridFittedBottom(ridge_j).build(jg)
        tb = T.GridFittedBottom(ridge_t).build(tg)
        masks = {jloc(l): jb.mask_for(jloc(l)).astype(jnp.float64)
                 for l in (T.CENTER, T.U_LOC, T.V_LOC)}
        jg, tg = _JKernelGrid(jg, masks), T_immersed.ImmersedGrid(tg, tb)
    names = ("T", "b")
    ref, got = _core_pair(jg, tg, mom, "spherical-enstrophy", ts, names, 33)
    _held(jg, tg, ref, got, names)


def mirror_reconstruct(rows, c, side, to_f, n, h):
    """numpy mirror of ``table_side`` (csrc/weno5_advection.cuh) along y:
    at each interior face (to faces) or centre (to centres) J, o the offset
    of the cell or face above, the rows' weights and coefficients with
    offsets r − 3 (left) or −r (right) from o, the Jiang-Shu indicators and
    the single-division combination."""
    out = {}
    eps = 1e-6
    for J_ in range(h + 1, h + n):
        o = J_ if to_f else J_ + 1
        p, b, d = [], [], []
        for r in range(3):
            base = side * 12 + r * 4
            d.append(rows[base, J_])
            cj = rows[base + 1: base + 4, J_]
            off = r - 3 if side == 0 else -r
            w0, w1, w2 = c[o + off], c[o + off + 1], c[o + off + 2]
            p.append(cj[0] * w0 + cj[1] * w1 + cj[2] * w2)
            kind = r if side == 0 else 2 - r
            t2 = (w0 - 4.0 * w1 + 3.0 * w2 if kind == 0 else
                  (w0 - w2 if kind == 1 else 3.0 * w0 - 4.0 * w1 + w2))
            q = w0 - 2.0 * w1 + w2
            b.append(13.0 / 12.0 * (q * q) + 0.25 * t2 * t2)
        t = [(x + eps) * (x + eps) for x in b]
        g = (d[0] * (t[1] * t[2]), d[1] * (t[0] * t[2]), d[2] * (t[0] * t[1]))
        out[J_] = (g[0] * p[0] + g[1] * p[1] + g[2] * p[2]) / (g[0] + g[1] + g[2])
    return out


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
def test_y_tables_mirror_weno5_tables(to_f, side):
    """``y_tables`` holds weno5_tables(grid, 1, to_f) (port and JAX) row by
    row in the layout K4b reads (to faces, then to centres 24 rows on), and
    K4b's offsets reconstruct as ``WENO5.table_reconstruct`` along y."""
    from clima_oceananigans_jl_torch.advection.reconstruction_tables import weno5_tables
    from clima_oceananigans_jl_tpu.advection.reconstruction_tables import (
        weno5_tables as jweno5_tables)
    jg, tg = pair("latlon", (7, 12, 5), latitude=stretched_latitude())
    rows = tmr.y_tables(tg).numpy()
    assert rows.shape == (2 * tmr.TABLE_ROWS, tg.total_shape[1])
    assert tmr.y_tables(tg) is tmr.y_tables(tg)
    block = rows[(0 if to_f else tmr.TABLE_ROWS):][:tmr.TABLE_ROWS]
    s = 0 if side == "left" else 1
    for tables in (weno5_tables(tg, 1, to_f), jweno5_tables(jg, 1, to_f)):
        for r, (d, cj, _voff, _kind) in enumerate(tables[side]):
            b0 = s * 12 + r * 4
            np.testing.assert_allclose(block[b0], np.asarray(d).reshape(-1),
                                       rtol=1e-14, atol=0)
            for j in range(3):
                np.testing.assert_allclose(block[b0 + 1 + j], np.asarray(cj[j]).reshape(-1),
                                           rtol=1e-14, atol=1e-15)
    c = np.random.default_rng(12).standard_normal(tg.total_shape[1])
    ref = T.WENO5().table_reconstruct(
        torch.as_tensor(c).reshape(1, -1, 1).expand(tg.total_shape).contiguous(),
        1, weno5_tables(tg, 1, to_f), side)[0, :, 0].numpy()
    got = mirror_reconstruct(block, c, s, to_f, tg.Ny, tg.Hy)
    for J_, v in got.items():
        assert abs(v - ref[J_]) <= 1e-14 * max(1.0, abs(ref[J_])), J_


def test_clear_flags_are_the_plain_versions_conditional_fluxes():
    """Bit a of K4b's clear flags at a location is ``_immersed_clear`` of
    the transport along axis a there (to faces or to centres as
    ``advection/fluxes.py`` has it), on every with-halo point."""
    from clima_oceananigans_jl_torch.advection.schemes import _immersed_clear
    _, tg = pair("latlon", (24, 12, 8))
    tb = T.GridFittedBottom(lambda lam, phi: -3000.0 + 2600.0 * torch.exp(
        -((lam - 180.0) / 30.0) ** 2)).build(tg)
    ig = T_immersed.ImmersedGrid(tg, tb)
    for loc, to_fs in ((T.CENTER, (True, True, True)), (T.U_LOC, (False, True, True)),
                       (T.V_LOC, (True, False, True))):
        flags = tfh.clear_flags(ig, loc, 2)
        assert flags.dtype == torch.uint8 and tfh.clear_flags(ig, loc, 2) is flags
        for axis, to_f in enumerate(to_fs):
            bit = ((flags >> axis) & 1).bool()
            assert torch.equal(bit, _immersed_clear(tb, loc, axis, to_f, 2)), (loc, axis)


def test_barotropic_plain_version_on_depth_planes_matches_jax():
    """K5's plain version with the column depths of an immersed bottom
    (x- and y-varying) against the JAX ``substep_eta``; the kernel's depth
    input is the (X, Y) plane of those depths, not a row of them."""
    size = (24, 12, 6)
    bottom_j = lambda lam, phi: -3000.0 + 2600.0 * jnp.exp(-((lam - 180.0) / 30.0) ** 2)
    bottom_t = lambda lam, phi: -3000.0 + 2600.0 * torch.exp(-((lam - 180.0) / 30.0) ** 2)
    jm = JH(jax_grid("latlon", size), tracers=("T",), free_surface=JSplit(substeps=10),
            coriolis=coriolis("spherical-energy", J), buoyancy=JB(),
            immersed_boundary=J_immersed.GridFittedBottom(bottom_j), fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(
        torch_grid("latlon", size), tracers=("T",),
        free_surface=T.SplitExplicitFreeSurface(substeps=10),
        coriolis=coriolis("spherical-energy", T), buoyancy=T.BuoyancyTracer(),
        immersed_boundary=T.GridFittedBottom(bottom_t))
    g = tm.grid
    Hfc, Hcf = column_depths(g)
    assert not torch.equal(Hfc, Hfc[g.Hx:g.Hx + 1].expand_as(Hfc)), "x-constant depths"
    rows, planes = tfb.depth_inputs(g, Hfc, Hcf)
    for plane, H in zip(planes, (Hfc, Hcf)):
        assert plane.shape == g.total_shape[:2] and plane.is_contiguous()
        np.testing.assert_array_equal(plane.numpy(), H.numpy()[:, :, 0])
    # the x-constant rows hold the five metrics only, no depth
    assert tuple(rows.shape) == (5, g.total_shape[1])
    rng = np.random.default_rng(34)
    shape = g.total_shape[:2] + (1,)
    eta, U0, V0, GU, GV = (s * rng.standard_normal(shape)
                           for s in (0.1, 10.0, 10.0, 1e-3, 1e-3))
    from clima_oceananigans_jl_tpu.models.free_surface import fill2d as jfill2d
    jeta = jfill2d(jnp.asarray(eta), jm.grid, J.W_LOC[:2] + (J.F,), jm.eta_bcs)
    teta = fill2d(torch.as_tensor(eta), g, ETA_LOC, tm.eta_bcs)
    ref = jm.free_surface.substep_eta(jm.grid, jm.eta_bcs, jeta, *(
        jnp.asarray(a) for a in (GU, GV, U0, V0)), 600.0)
    got = tm.free_surface.substep_eta(g, tm.eta_bcs, teta, *(
        torch.as_tensor(a) for a in (GU, GV, U0, V0)), 600.0)
    for name, r, x in zip(("eta", "U", "V"), ref, got):
        r, x = np.asarray(r), x.numpy()
        assert np.abs(r - x).max() <= 1e-14 * np.abs(r).max(), name


# -- on the card --------------------------------------------------------------------

def _random_state(model, seed):
    rng = np.random.default_rng(seed)
    g = model.grid
    state = model.initial_state(**{n: s * rng.standard_normal(g.shape) for n, s in
                                   (("u", 0.1), ("v", 0.1), ("T", 1.0), ("S", 1.0),
                                    ("b", 1e-3))})
    state["G_prev"] = {n: torch.as_tensor(1e-6 * rng.standard_normal(g.total_shape),
                                          dtype=g.dtype, device=g.device)
                       for n in model.prognostic_names()}
    return state


def _close(got, ref, rtol, cut=lambda a: a):
    got, ref = cut(got), cut(ref)
    assert float((got - ref).abs().max()) <= rtol * float(ref.abs().max())


def _poison_cache(shape, dtype, n=8):
    """Leave n NaN-filled blocks of ``shape`` in the caching allocator, so
    that an output point a kernel does not write stays NaN."""
    blocks = [torch.full(shape, float("nan"), dtype=dtype, device="cuda")
              for _ in range(n)]
    del blocks


def _bitwise(got, ref):
    """Every with-halo point equal (and none NaN, which would be unwritten)."""
    for a, r in zip(got, ref):
        if r is None:
            assert a is None
            continue
        assert not torch.isnan(a).any(), "a point was left unwritten"
        assert torch.equal(a, r), float((a - r).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["latlon-vi-weno-velocity", "latlon-vi-energy",
                                  "rect-bbb-flux-weno5"])
def test_cuda_k4_matches_plain_versions(case):
    """K4a and K4b (both forms) against their plain versions in f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kind = "latlon" if case.startswith("latlon") else "rect-bbb"
    mom = case[len(kind) + 1:]
    _, tm = flagship_models(size=(32, 16, 8), jax_model=False, device="cuda",
                            kind=kind, mom=mom,
                            cor="betaplane" if kind == "rect-bbb" else "spherical-energy")
    state = _random_state(tm, 7)
    g = tm.grid
    sol = state["solution"]
    _poison_cache(g.total_shape, g.dtype)
    n0 = tfh.hydrostatic_columns.launches
    got = tfh.hydrostatic_columns(g, sol["u"], sol["v"], sol["b"])
    ref = tfh.hydrostatic_columns_reference(g, sol["u"], sol["v"], sol["b"])
    assert tfh.hydrostatic_columns.launches == n0 + 1
    _bitwise(got, ref)
    for adv in (None, (600.0, False)):
        got = tfh.fused_hydrostatic_tendencies(tm, state, adv)
        ref = tfh.fused_hydrostatic_tendencies_reference(tm, state, adv)
        got, ref = ((got,), (ref,)) if adv is None else (got, ref)
        for gd, rd in zip(got, ref):
            for n in rd:
                _close(gd[n], rd[n], 1e-13, g.interior)
                halo = gd[n].clone()
                halo[g.interior_slices] = 0
                assert not halo.any(), "K4b wrote outside the interior"


@pytest.mark.cuda
def test_cuda_k5_and_steps_match_plain_versions():
    """K5 against its plain version on every with-halo point, then three
    split-explicit steps through K4a, K4b and K5 against the plain run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clima_oceananigans_jl_torch.models import hydrostatic as th
    _, tm = flagship_models(size=(32, 16, 8), jax_model=False, device="cuda")
    g = tm.grid
    gen = torch.Generator(device="cuda").manual_seed(8)
    shape = g.total_shape[:2] + (1,)
    rand = lambda s: s * torch.randn(shape, generator=gen, dtype=g.dtype, device="cuda")
    eta = fill2d(rand(0.1), g, ETA_LOC, tm.eta_bcs)
    args = (g, tm.eta_bcs, eta, rand(10.0), rand(10.0), rand(1e-3), rand(1e-3),
            *column_depths(g), 9.80665, 40.0)
    wv = tm.free_surface._weight_vec(None, eta)
    _poison_cache(shape, g.dtype, 20)
    n0 = tfb.fused_substep_eta.launches
    got = tfb.fused_substep_eta(*args, wv, wv, 8)
    assert tfb.fused_substep_eta.launches == n0 + 1
    _bitwise(got, tfb.fused_substep_eta_reference(*args, wv, wv, 8))

    def run(kernels):
        state = tm.initial_state(**initial_values(g.shape, seed=9))
        for _ in range(3):
            state = tm.step(state, 600.0, kernels)
        return state

    got, ref = run(None), run(th.PLAIN)
    for n in tm.prognostic_names():
        _close(got["solution"][n], ref["solution"][n], 1e-12)
    _close(got["eta"], ref["eta"], 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("free_surface", ["explicit", "implicit-pcg"])
def test_cuda_other_free_surfaces_step_as_the_plain_run(free_surface):
    """Three steps with an explicit or an implicit (CG) free surface: K4a
    and K4b (tendency form, or advance form before the solve) against the
    plain versions, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clima_oceananigans_jl_torch.models import hydrostatic as th
    fs = (T.ExplicitFreeSurface() if free_surface == "explicit"
          else T.ImplicitFreeSurface(solver_method="pcg", tolerance=1e-13))
    tm = T.HydrostaticFreeSurfaceModel(
        torch_grid("latlon", (32, 16, 8), device="cuda"),
        momentum_advection=T.VectorInvariant(scheme="weno_velocity"),
        tracer_advection=T.WENO5(), tracers=("T",), free_surface=fs,
        coriolis=T.HydrostaticSphericalCoriolis(), buoyancy=T.BuoyancyTracer())

    def run(kernels):
        vals = initial_values(tm.grid.shape, seed=10)
        state = tm.initial_state(u=vals["u"], v=vals["v"], T=vals["T"], b=vals["b"])
        for _ in range(3):
            state = tm.step(state, 60.0, kernels)
        return state

    n0 = tfh.fused_hydrostatic_tendencies.launches
    got = run(None)
    assert tfh.fused_hydrostatic_tendencies.launches == n0 + 3
    ref = run(th.PLAIN)
    for n in tm.prognostic_names():
        _close(got["solution"][n], ref["solution"][n], 1e-12)
    _close(got["eta"], ref["eta"], 1e-12)


def _smooth_or_zero_state(model, kind):
    """The path's kind of fields: smooth u and v, T = S = 0 and b linear in
    z (smooth), or every field zero; G⁻ = 0."""
    g = model.grid
    nx, ny, nz = g.shape
    i = np.arange(nx)[:, None, None] * (2 * np.pi / nx)
    j = np.arange(ny)[None, :, None] * (np.pi / ny)
    k = np.arange(nz)[None, None, :] / nz
    ones = np.ones(g.shape)
    if kind == "zero":
        state = model.initial_state()
    else:
        state = model.initial_state(
            u=0.1 * np.sin(i) * np.cos(j) * (1 + 0.1 * k) * ones,
            v=0.05 * np.cos(i) * np.sin(j) * ones,
            b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    state["G_prev"] = {n: torch.zeros(g.total_shape, dtype=g.dtype, device=g.device)
                       for n in model.prognostic_names()}
    return state


@pytest.mark.cuda
@pytest.mark.parametrize("fields", ["smooth", "zero"])
@pytest.mark.parametrize("kind,size,mom,cor,dtype", [
    ("latlon", (37, 19, 8), "vi-weno-velocity", "spherical-energy", torch.float32),
    ("latlon", (35, 21, 9), "vi-energy", "spherical-enstrophy", torch.float64),
    ("rect-bbb", (35, 21, 7), "flux-weno5", "betaplane", torch.float64)],
    ids=["latlon-flagship-f32", "latlon-vi-energy-f64", "bbb-flux-weno5-f64"])
def test_cuda_k4b_is_bitwise_its_plain_version(fields, kind, size, mom, cor, dtype):
    """K4b, both forms, bit for bit against its plain version on the card,
    on smooth and all-zero fields (where IEEE division would take its slow
    path), on sizes that are not multiples of its 16×8 tile, with bounded
    y (lat-lon) or bounded x, y and z walls; the halos are zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tm = flagship_models(size=size, jax_model=False, device="cuda", dtype=dtype,
                            kind=kind, mom=mom, cor=cor)
    state = _smooth_or_zero_state(tm, fields)
    g = tm.grid
    for adv in (None, (600.0, False)):
        got = tfh.fused_hydrostatic_tendencies(tm, state, adv)
        ref = tfh.fused_hydrostatic_tendencies_reference(tm, state, adv)
        got, ref = ((got,), (ref,)) if adv is None else (got, ref)
        for gd, rd in zip(got, ref):
            for n in rd:
                assert torch.equal(g.interior(gd[n]), g.interior(rd[n])), n
                halo = gd[n].clone()
                halo[g.interior_slices] = 0
                assert not halo.any(), "K4b wrote a nonzero halo"


@pytest.mark.cuda
@pytest.mark.parametrize("kind,size,dtype,with_b", [
    ("latlon", (37, 70, 8), torch.float64, True),
    ("latlon", (37, 70, 8), torch.float64, False),
    ("rect-bbb", (35, 41, 8), torch.float64, True),
    ("rect-bbb", (35, 41, 8), torch.float64, False),
    ("latlon", (20, 30, 50), torch.float64, True),
    ("rect-bbb", (13, 45, 50), torch.float64, False),
    ("latlon", (37, 70, 8), torch.float32, True)],
    ids=["latlon-f64", "latlon-f64-w-only", "bbb-f64", "bbb-f64-w-only",
         "latlon-nz50-f64", "bbb-nz50-f64-w-only", "latlon-f32"])
def test_cuda_k4a_is_bitwise_its_plain_version(kind, size, dtype, with_b):
    """K4a bit for bit against its plain version on every with-halo point,
    with b (w and pHY′) and without (w only, as ``compute_w`` calls it), on
    lat-lon and (Bounded, Bounded, Bounded) grids; 76 and 51 with-halo y
    columns are not multiples of its 32-column run, and 50 levels in fp64
    cut the run to fit shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tm = flagship_models(size=size, jax_model=False, device="cuda", dtype=dtype,
                            kind=kind, mom="vi-weno-velocity" if kind == "latlon"
                            else "flux-weno5",
                            cor="spherical-energy" if kind == "latlon" else "betaplane")
    g = tm.grid
    sol = _random_state(tm, 21)["solution"]
    b = sol["b"] if with_b else None
    _poison_cache(g.total_shape, dtype)
    n0 = tfh.hydrostatic_columns.launches
    got = tfh.hydrostatic_columns(g, sol["u"], sol["v"], b)
    assert tfh.hydrostatic_columns.launches == n0 + 1
    assert (got[1] is None) == (b is None)
    _bitwise(got, tfh.hydrostatic_columns_reference(g, sol["u"], sol["v"], b))


@pytest.mark.cuda
@pytest.mark.parametrize("n,kind,weights,size,dtype", [
    (1, "latlon", "uniform", (32, 16, 4), torch.float64),
    (8, "rect-bbb", "hann", (35, 21, 4), torch.float64),
    (200, "latlon", "hann", (24, 12, 4), torch.float64),
    (200, "rect-bbb", "uniform", (24, 12, 4), torch.float64),
    (8, "latlon", "uniform", (1440, 600, 4), torch.float32),
    (8, "rect-bbb", "hann", (3000, 2000, 4), torch.float64)],
    ids=["n1-periodic-x", "n8-bounded-hann", "n200-periodic-x-hann",
         "n200-bounded", "n8-flagship-width-f32", "n8-bounded-hann-6M-points-f64"])
def test_cuda_k5_is_bitwise_its_plain_version(n, kind, weights, size, dtype):
    """K5, one cooperative launch for all n substeps, bit for bit against
    its plain version on every with-halo point: periodic x and bounded y
    (lat-lon) or bounded x and y, uniform or Hann weights. At the
    flagship's width each thread of the cooperative grid takes several
    points; at 6 M points in fp64 more than its shared memory keeps, so
    the rest keep their averages in the outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tm = flagship_models(size=size, substeps=n, jax_model=False, device="cuda",
                            dtype=dtype, kind=kind,
                            mom="vi-weno-velocity" if kind == "latlon" else "flux-weno5",
                            cor="spherical-energy" if kind == "latlon" else "betaplane")
    fs = (tm.free_surface if weights == "uniform"
          else T.SplitExplicitFreeSurface.with_hann_filter(substeps=n))
    g = tm.grid
    gen = torch.Generator(device="cuda").manual_seed(22)
    shape = g.total_shape[:2] + (1,)
    rand = lambda s: s * torch.randn(shape, generator=gen, dtype=dtype, device="cuda")
    eta = rand(0.1)  # halos unfilled: the kernel fills η from its interior
    wv = fs._weight_vec(fs.velocity_weights, eta)
    wf = fs._weight_vec(fs.free_surface_weights, eta)
    args = (g, tm.eta_bcs, eta, rand(10.0), rand(10.0), rand(1e-3), rand(1e-3),
            *column_depths(g), 9.80665, 40.0, wv, wf, n)
    _poison_cache(shape, dtype, 20)
    n0 = tfb.fused_substep_eta.launches
    got = tfb.fused_substep_eta(*args)
    assert tfb.fused_substep_eta.launches == n0 + 1
    _bitwise(got, tfb.fused_substep_eta_reference(*args))
    cfg = tfb.cooperative_grid(g)
    if size[0] >= 1440:
        assert cfg["blocks"] * cfg["threads"] < shape[0] * shape[1]
    if size[0] >= 3000:
        assert cfg["points_kept"] * cfg["thread_rows"] < shape[0]


def _k4b_model(case, size, dtype, device="cuda"):
    """A model on the card that reaches one of K4b's newer parts: the
    in-kernel closure (``closure-*``), the solid masks (``masks-*``) or a
    stretched latitude's y tables (``stretched-y-*``)."""
    if "stretched-y" in case:
        grid = T.LatitudeLongitudeGrid(size=size, longitude=(0, 360),
                                       latitude=stretched_latitude(size[1] + 1),
                                       z=zfaces(size[2]), dtype=dtype, device=device)
    else:
        grid = torch_grid("rect-bbb" if case.endswith("bbb") else "latlon", size, dtype,
                          device)
    latlon_grid = isinstance(grid, T.LatitudeLongitudeGrid)
    kw = dict(tracer_advection=T.WENO5(), tracers=("T", "S"), buoyancy=T.BuoyancyTracer(),
              free_surface=T.SplitExplicitFreeSurface(substeps=4),
              coriolis=(T.HydrostaticSphericalCoriolis() if latlon_grid
                        else T.BetaPlane(f0=1e-4, beta=1e-11)),
              momentum_advection=(T.WENO5() if "flux" in case or not latlon_grid
                                  else T.VectorInvariant(scheme="weno_velocity")))
    if case.startswith("closure"):
        kw["closure"] = T.ScalarDiffusivity(**(
            CLOSURE_KW["vertically-implicit"] if latlon_grid else CLOSURE_KW["per-tracer"]))
    if case.startswith("masks"):
        if latlon_grid:
            kw["immersed_boundary"] = T.GridFittedBottom(
                lambda lam, phi: -3000.0 + 2600.0 * torch.exp(-((lam - 180.0) / 30.0) ** 2))
        else:
            kw["immersed_boundary"] = T.GridFittedBottom(
                lambda x, y: -1000.0 + 700.0 * torch.exp(-((x - 1.7e5) / 5e4) ** 2))
    return T.HydrostaticFreeSurfaceModel(grid, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("fields", ["random", "smooth"])
@pytest.mark.parametrize("case,size,dtype", [
    ("closure-latlon", (37, 19, 8), torch.float32),
    ("closure-bbb", (35, 21, 7), torch.float64),
    ("masks-latlon", (37, 19, 8), torch.float32),
    ("masks-flux-bbb", (35, 21, 7), torch.float64),
    ("stretched-y-flux", (35, 21, 9), torch.float64),
    ("stretched-y-latlon", (37, 19, 8), torch.float32),
    ("masks-stretched-y-flux", (35, 21, 9), torch.float64)],
    ids=["closure-latlon-f32", "closure-bbb-f64", "masks-latlon-f32",
         "masks-flux-bbb-f64", "stretched-y-flux-f64", "stretched-y-vi-f32",
         "masks-stretched-y-flux-f64"])
def test_cuda_k4b_newer_parts_are_bitwise_their_plain_version(fields, case, size, dtype):
    """K4b with the in-kernel closure (vertically implicit on lat-lon; an
    explicit νz and a per-tracer κ on the bounded β-plane), the CENTER and
    U/V masks, and a stretched latitude, both forms, bit for bit against
    its plain version on the interior, its halos zero, on sizes off its
    16×8 tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tm = _k4b_model(case, size, dtype)
    state = (_random_state(tm, 35) if fields == "random"
             else _smooth_or_zero_state(tm, "smooth"))
    g = tm.grid
    for adv in (None, (600.0, False)):
        n0 = tfh.fused_hydrostatic_tendencies.launches
        got = tfh.fused_hydrostatic_tendencies(tm, state, adv)
        assert tfh.fused_hydrostatic_tendencies.launches == n0 + 1
        ref = tfh.fused_hydrostatic_tendencies_reference(tm, state, adv)
        got, ref = ((got,), (ref,)) if adv is None else (got, ref)
        for gd, rd in zip(got, ref):
            for n in rd:
                assert torch.equal(g.interior(gd[n]), g.interior(rd[n])), (n, float(
                    (g.interior(gd[n]) - g.interior(rd[n])).abs().max()))
                halo = gd[n].clone()
                halo[g.interior_slices] = 0
                assert not halo.any(), "K4b wrote a nonzero halo"


@pytest.mark.cuda
@pytest.mark.parametrize("size,dtype", [((37, 19, 8), torch.float64),
                                        ((1440, 600, 4), torch.float32)],
                         ids=["f64", "flagship-width-f32"])
def test_cuda_k5_on_depth_planes_is_bitwise_its_plain_version(size, dtype):
    """K5 over an immersed bottom (the depths as (X, Y) planes) bit for bit
    against its plain version on every with-halo point."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tm = _k4b_model("masks-latlon", size, dtype)
    g = tm.grid
    assert tfb.cooperative_grid(g)["blocks"] > 0
    gen = torch.Generator(device="cuda").manual_seed(36)
    shape = g.total_shape[:2] + (1,)
    rand = lambda s: s * torch.randn(shape, generator=gen, dtype=dtype, device="cuda")
    eta = rand(0.1)
    wv = tm.free_surface._weight_vec(None, eta)
    args = (g, tm.eta_bcs, eta, rand(10.0), rand(10.0), rand(1e-3), rand(1e-3),
            *column_depths(g), 9.80665, 40.0, wv, wv, tm.free_surface.substeps)
    _poison_cache(shape, dtype, 20)
    n0 = tfb.fused_substep_eta.launches
    got = tfb.fused_substep_eta(*args)
    assert tfb.fused_substep_eta.launches == n0 + 1
    _bitwise(got, tfb.fused_substep_eta_reference(*args))
