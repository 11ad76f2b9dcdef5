"""Port parity: immersed boundaries (``clima_oceananigans_jl_torch/immersed``).

The same grids and boundaries are built in ``clima_oceananigans_jl_tpu``
and the port (f64, CPU), the same inputs made with numpy from a seed go
through both:

- the solid masks at every location triple, corners included, for
  ``GridFittedBottom`` of a callable, a constant and an array and for
  ``GridFittedBoundary``: bitwise (boolean logic);
- the conditional fluxes (``_immersed_clear`` bitwise; ``transport`` with
  the field's location, WENO5 and centred, to faces and to centres, on
  every axis), ``div_Uc``, ``div_vu`` and ``div_vv`` on an immersed
  lat-lon grid, the diffusion with its fluxes zeroed at solid faces,
  ``apply_immersed_flux_bcs`` with constant, callable and discrete values
  (the validation's quadratic bottom drag), ``mask_state`` and
  ``mask_tendency``: bitwise (the same elementwise trees);
- the column depths over the bottom (≤ 1e-14: a sum over z), the
  implicit free surface's "auto" solve, and the immersed grid's own
  cache: a flat-bottom model built first from the same parent grid must
  not hand its depths to the immersed model;
- the cases of ``tests/test_immersed.py`` that the port runs, in the
  hydrostatic model: the grid wrapper, the tracer budget under
  conditional advection, a uniform tracer under pure diffusion, the
  immersed flux budget and the discrete bottom drag.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.advection import fluxes as tfl
from clima_oceananigans_jl_torch.advection import schemes as tsc
from clima_oceananigans_jl_torch.boundary_conditions import bcs as tbcs
from clima_oceananigans_jl_torch.closures import scalar_diffusivity as tsd
from clima_oceananigans_jl_torch.immersed.immersed import ImmersedGrid
from clima_oceananigans_jl_torch.models.free_surface import column_depths

try:  # this file needs JAX; the guard keeps collection quiet without it
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection import fluxes as jfl
    from clima_oceananigans_jl_tpu.advection import schemes as jsc
    from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs
    from clima_oceananigans_jl_tpu.closures import scalar_diffusivity as jsd
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from clima_oceananigans_jl_tpu.immersed import immersed as jim
    from clima_oceananigans_jl_tpu.models import free_surface as jfs
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-13
C, F = T.C, T.F
ALL_LOCS = [(a, b, c) for a in (C, F) for b in (C, F) for c in (C, F)]


def zfaces(nz, depth=3000.0, p=1.8):
    k = np.arange(nz + 1)
    return -depth * (1.0 - k / nz) ** p


def latlon(size=(24, 12, 8)):
    jg = JLL(size=size, longitude=(0, 360), latitude=(-75, 75),
             z=zfaces(size[2]), dtype=jnp.float64)
    tg = T.LatitudeLongitudeGrid(size=size, longitude=(0, 360), latitude=(-75, 75),
                                 z=zfaces(size[2]), dtype=torch.float64, device=DEVICE)
    return jg.with_halo((3, 3, 3)), tg.with_halo((3, 3, 3))


def rect(size=(16, 12, 8)):
    kw = dict(size=size, x=(0, 1e5), y=(0, 8e4), z=(-1e3, 0),
              topology=("periodic", "bounded", "bounded"))
    return (J.RectilinearGrid(dtype=jnp.float64, **kw).with_halo((3, 3, 3)),
            T.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw).with_halo((3, 3, 3)))


def j_continents(lam, phi):
    """An idealised continent and a ridge (validation/near_global_lat_lon.py)."""
    s = jax.nn.sigmoid
    land = s((lam - 255.0) / 8.0) * s((300.0 - lam) / 8.0) * s((phi + 55.0) / 6.0) \
        * s((70.0 - phi) / 6.0)
    ridge = 1200.0 * jnp.exp(-((lam - 330.0) / 12.0) ** 2)
    return jnp.where(land > 0.5, 100.0, -3000.0 + ridge)


def t_continents(lam, phi):
    s = torch.sigmoid
    land = s((lam - 255.0) / 8.0) * s((300.0 - lam) / 8.0) * s((phi + 55.0) / 6.0) \
        * s((70.0 - phi) / 6.0)
    ridge = 1200.0 * torch.exp(-((lam - 330.0) / 12.0) ** 2)
    return torch.where(land > 0.5, torch.full((), 100.0, dtype=lam.dtype),
                       -3000.0 + ridge)


def boundaries(kind, jg, tg):
    """(JAX boundary, port boundary) built on the grids."""
    if kind == "bottom-callable":
        return (jim.GridFittedBottom(j_continents).build(jg),
                T.GridFittedBottom(t_continents).build(tg))
    if kind == "bottom-constant":
        return (jim.GridFittedBottom(-1400.0).build(jg),
                T.GridFittedBottom(-1400.0).build(tg))
    if kind == "bottom-array":
        h = -3000.0 + 2500.0 * np.random.default_rng(1).random(tg.total_shape[:2] + (1,))
        return (jim.GridFittedBottom(h).build(jg), T.GridFittedBottom(h).build(tg))
    jmask = lambda x, y, z: (jnp.abs(y) < 20.0) & (z < -800.0) & (x > 90.0)
    tmask = lambda x, y, z: (y.abs() < 20.0) & (z < -800.0) & (x > 90.0)
    return (jim.GridFittedBoundary(jmask).build(jg),
            T.GridFittedBoundary(tmask).build(tg))


def grids(kind="bottom-callable", size=(24, 12, 8)):
    jg, tg = latlon(size)
    jb, tb = boundaries(kind, jg, tg)
    return jim.ImmersedGrid.wrap(jg, jb), ImmersedGrid(tg, tb)


def jloc(loc):
    """The JAX package's location triple (its members are other objects
    than the port's, and it compares them with ``is``)."""
    return tuple(J.C if l == C else J.F for l in loc)


def same(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return ref.shape == got.shape and np.array_equal(ref, got)


def close(ref, got, rtol=RTOL, label=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (label, ref.shape, got.shape)
    err, scale = np.abs(ref - got).max(), np.abs(ref).max()
    assert err <= rtol * scale, f"{label}: max|diff| {err:.3e} > {rtol:g}·{scale:.3e}"


def fields(shape, n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [scale * rng.standard_normal(shape) for _ in range(n)]


@pytest.mark.parametrize("kind", ["bottom-callable", "bottom-constant",
                                  "bottom-array", "boundary"])
def test_masks_match_at_every_location(kind):
    jg, tg = grids(kind)
    jb, tb = jg.immersed, tg.immersed
    assert tb.solid_ccc.dtype == torch.bool and tb.solid_ccc.device.type == DEVICE
    assert tb.solid_ccc.any() and not tb.solid_ccc.all()
    for loc in ALL_LOCS:
        assert same(jb.mask_for(jloc(loc)), tb.mask_for(loc)), loc
    # the corner rule: (F, F, C) is solid where any of its four centres is
    s = tb.solid_ccc
    expect = s | s.roll(1, 0) | s.roll(1, 1) | s.roll(1, 0).roll(1, 1)
    assert torch.equal(tb.mask_for((F, F, C)), expect)


def test_rectilinear_bottom_masks_match():
    jg, tg = rect()
    h = lambda x, y: -1e3 + 400.0 * np.exp(-((np.asarray(x) - 5e4) / 1e4) ** 2)
    jb = jim.GridFittedBottom(lambda x, y: jnp.asarray(h(x, y))).build(jg)
    tb = T.GridFittedBottom(lambda x, y: torch.as_tensor(h(x, y))).build(tg)
    for loc in ALL_LOCS:
        assert same(jb.mask_for(jloc(loc)), tb.mask_for(loc)), loc


@pytest.mark.parametrize("loc", [T.CENTER, T.U_LOC, T.V_LOC, T.W_LOC, (F, F, C)],
                         ids=["ccc", "fcc", "cfc", "ccf", "ffc"])
@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
def test_immersed_clear_matches(loc, to_f):
    jg, tg = grids()
    for axis in range(3):
        for buffer in (1, 2):
            ref = jsc._immersed_clear(jg.immersed, jloc(loc), axis, to_f, buffer)
            got = tsc._immersed_clear(tg.immersed, loc, axis, to_f, buffer)
            assert same(ref, got), (axis, buffer)


@pytest.mark.parametrize("scheme", ["weno5", "centered"])
@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_conditional_transport_matches(scheme, to_f, axis):
    """``transport`` with the field's location on an immersed stretched-z
    lat-lon grid: the stencils that reach the solid drop to first-order
    upwind (WENO5); the centred scheme is unchanged."""
    jg, tg = grids()
    js, ts = {"weno5": (J.WENO5(), T.WENO5()),
              "centered": (J.CenteredSecondOrder(), T.CenteredSecondOrder())}[scheme]
    vel, c = fields(tg.total_shape, 2, seed=axis + 3)
    for loc in (T.CENTER, T.U_LOC):
        ref = jsc.transport(js, jnp.asarray(vel), jnp.asarray(c), axis, to_f, jg,
                            jloc(loc))
        got = tsc.transport(ts, torch.as_tensor(vel), torch.as_tensor(c), axis,
                            to_f, tg, loc)
        cut = tuple(slice(h, h + n + 1) for h, n in zip(tg.halo, tg.shape))
        assert same(np.asarray(ref)[cut], got[cut]), f"transport {loc}"
    # without the location, or on the parent grid, nothing is conditional
    plain = tsc.transport(ts, torch.as_tensor(vel), torch.as_tensor(c), axis, to_f,
                          tg.parent)
    assert torch.equal(plain, tsc.transport(ts, torch.as_tensor(vel),
                                            torch.as_tensor(c), axis, to_f, tg))
    if scheme == "weno5":
        cond = tsc.transport(ts, torch.as_tensor(vel), torch.as_tensor(c), axis,
                             to_f, tg, T.CENTER)
        assert not torch.equal(cond, plain), "no flux reached the solid"


def test_flux_divergences_on_an_immersed_latlon_grid_match():
    jg, tg = grids()
    u, v, w, c = fields(tg.total_shape, 4, seed=7)
    ja = [jnp.asarray(a) for a in (u, v, w)]
    ta = [torch.as_tensor(a) for a in (u, v, w)]
    for js, ts in ((J.WENO5(), T.WENO5()),
                   (J.CenteredSecondOrder(), T.CenteredSecondOrder())):
        assert same(jg.interior(jfl.div_Uc(jg, js, *ja, jnp.asarray(c))),
                    tg.interior(tfl.div_Uc(tg, ts, *ta, torch.as_tensor(c)))), "div_Uc"
        assert same(jg.interior(jfl.div_vu(jg, js, *ja)),
                    tg.interior(tfl.div_vu(tg, ts, *ta))), "div_vu"
        assert same(jg.interior(jfl.div_vv(jg, js, *ja)),
                    tg.interior(tfl.div_vv(tg, ts, *ta))), "div_vv"


@pytest.mark.parametrize("loc", [T.CENTER, T.U_LOC, T.V_LOC],
                         ids=["ccc", "fcc", "cfc"])
@pytest.mark.parametrize("vertical", [True, False], ids=["3d", "horizontal"])
def test_diffusion_is_zero_through_solid_faces_and_matches(loc, vertical):
    jg, tg = grids()
    (c,) = fields(tg.total_shape, 1, seed=8)
    ref = jsd.div_kappa_grad(jnp.asarray(c), jg, jloc(loc), 1e3, 1e-4,
                             vertical=vertical)
    got = tsd.div_kappa_grad(torch.as_tensor(c), tg, loc, 1e3, 1e-4, vertical=vertical)
    assert same(jg.interior(ref), tg.interior(got))
    if loc != T.CENTER:  # a velocity's solid faces are no-slip walls
        return
    # a tracer uniform in the fluid diffuses nowhere, whatever the solid holds
    uniform = torch.where(tg.immersed.mask_for(loc), torch.tensor(-5.0),
                          torch.tensor(2.0, dtype=torch.float64))
    d = tsd.div_kappa_grad(uniform, tg, loc, 1e3, 1e-4, vertical=vertical)
    fluid = ~tg.immersed.mask_for(loc)
    assert float(tg.interior(d.abs() * fluid).max()) == 0.0


def _drag(lib):
    def drag(grid, t, fields):
        sp = lib.sqrt(fields["u"] ** 2 + fields["v"] ** 2)
        return -2.5e-3 * sp * fields["u"]
    return drag


@pytest.mark.parametrize("value", ["constant", "callable", "discrete"])
@pytest.mark.parametrize("loc", [T.CENTER, T.U_LOC], ids=["ccc", "fcc"])
def test_immersed_flux_bcs_match(value, loc):
    jg, tg = grids()
    G, u, v = fields(tg.total_shape, 3, seed=9)
    if value == "constant":
        jq, tq = 0.7, 0.7
    elif value == "callable":
        jq = lambda x, y, z, t: 1e-3 * jnp.cos(jnp.deg2rad(y)) + 1e-6 * z + t
        tq = lambda x, y, z, t: 1e-3 * torch.cos(torch.deg2rad(y)) + 1e-6 * z + t
    else:
        jq, tq = _drag(jnp), _drag(torch)
    discrete = value == "discrete"
    jb = jbcs.FieldBCs(immersed=jbcs.FluxBC(jq, discrete=discrete))
    tb = T.FieldBCs(immersed=T.FluxBC(tq, discrete=discrete))
    assert tbcs.regularize_bcs(tg, loc, tb).immersed is tb.immersed
    jf = {"u": jnp.asarray(u), "v": jnp.asarray(v)}
    tf = {"u": torch.as_tensor(u), "v": torch.as_tensor(v)}
    ref = jbcs.apply_immersed_flux_bcs(jnp.asarray(G), jg, jloc(loc), jb, 5.0, jf)
    got = tbcs.apply_immersed_flux_bcs(torch.as_tensor(G), tg, loc, tb, 5.0, tf)
    assert same(ref, got)
    assert not np.array_equal(np.asarray(ref), G), "no cell sits on the bottom"
    # no immersed BC, or no immersed boundary: G itself
    Gt = torch.as_tensor(G)
    assert tbcs.apply_immersed_flux_bcs(Gt, tg, loc, T.FieldBCs()) is Gt
    assert tbcs.apply_immersed_flux_bcs(Gt, tg.parent, loc, tb) is Gt
    with pytest.raises(ValueError):
        tbcs.apply_immersed_flux_bcs(Gt, tg, loc, T.FieldBCs(immersed=T.ValueBC(1.0)))


class _Model:
    """The two methods the masking hooks read of a model."""

    def __init__(self, names):
        self.names = names

    def _locs(self):
        locs = dict(u=T.U_LOC, v=T.V_LOC)
        locs.update({n: T.CENTER for n in self.names})
        return locs


def test_mask_state_and_tendency_match():
    jg, tg = grids()
    u, v, b, G = fields(tg.total_shape, 4, seed=10)
    sol = dict(u=u, v=v, b=b)
    js = jg.immersed.mask_state(_Model(("b",)), {"solution": {k: jnp.asarray(a) for k, a in sol.items()}})
    ts = tg.immersed.mask_state(_Model(("b",)), {"solution": {k: torch.as_tensor(a) for k, a in sol.items()}})
    for k in sol:
        assert same(js["solution"][k], ts["solution"][k]), k
    for name in ("u", "v", "b", "other"):
        assert same(jg.immersed.mask_tendency(_Model(("b",)), name, jnp.asarray(G)),
                    tg.immersed.mask_tendency(_Model(("b",)), name, torch.as_tensor(G)))


def test_column_depths_count_fluid_cells_and_match():
    jg, tg = grids()
    for r, g in zip(jfs.column_depths(jg), column_depths(tg)):
        close(r, g, 1e-14, "depth")
    # solid columns keep 10^-3 of the z extent
    assert float(column_depths(tg)[0].min()) == pytest.approx(3.0)
    fs = T.ImplicitFreeSurface()
    assert fs.resolve_method(tg) == "pcg"
    _, rg = rect()
    assert fs.resolve_method(rg) == "fft"
    assert fs.resolve_method(ImmersedGrid(rg, T.GridFittedBottom(-500.0).build(rg))) == "pcg"


def test_the_immersed_model_has_its_own_cache():
    """A flat-bottom model built first from the same parent grid fills the
    parent's cache with flat depths; the immersed model must not read
    them (its grid forwards every other attribute to the parent)."""
    parent = T.LatitudeLongitudeGrid(size=(24, 12, 6), longitude=(0, 360),
                                     latitude=(-75, 75), z=zfaces(6),
                                     dtype=torch.float64, device=DEVICE)
    split = T.SplitExplicitFreeSurface(substeps=4)
    flat = T.HydrostaticFreeSurfaceModel(parent, free_surface=split)
    flat.initial_state()
    deep = column_depths(flat.grid)
    # the flat model's grid has the halos the immersed model needs, so it
    # is the very parent the immersed grid wraps
    imm = T.HydrostaticFreeSurfaceModel(flat.grid, free_surface=split,
                                        immersed_boundary=T.GridFittedBottom(t_continents))
    assert isinstance(imm.grid, ImmersedGrid) and imm.grid.parent is flat.grid
    imm.initial_state()
    shallow = column_depths(imm.grid)
    assert column_depths(flat.grid) is deep
    rises = imm.grid.immersed.solid_fcc[:, :, imm.grid.Hz]  # the bottom level is solid
    assert bool(rises.any())
    assert bool((shallow[0][:, :, 0][rises] < deep[0][:, :, 0][rises]).all())
    assert torch.equal(shallow[0][:, :, 0][~rises], deep[0][:, :, 0][~rises])
    from clima_oceananigans_jl_torch.ops.fused_barotropic import depth_inputs
    flat_planes = depth_inputs(flat.grid, *deep)[1]
    planes = depth_inputs(imm.grid, *shallow)[1]
    assert torch.equal(flat_planes[0], deep[0][:, :, 0])
    assert torch.equal(planes[0], shallow[0][:, :, 0])
    assert bool((planes[0][rises] < flat_planes[0][rises]).all())


# -- tests/test_immersed.py's cases, in the hydrostatic model -------------------------

def _box(size=(16, 16, 8), **kw):
    return T.RectilinearGrid(size=size, x=(0, 1e5), y=(0, 1e5), z=(-1e3, 0),
                             topology=("periodic", "periodic", "bounded"),
                             dtype=torch.float64, device=DEVICE, **kw)


def _jbox(size=(16, 16, 8)):
    return J.RectilinearGrid(size=size, x=(0, 1e5), y=(0, 1e5), z=(-1e3, 0),
                             topology=("periodic", "periodic", "bounded"),
                             dtype=jnp.float64)


def test_immersed_grid_forwards_and_masks():
    ridge = lambda x, y: -1e3 + 400.0 * torch.exp(-((x - 5e4) / 1e4) ** 2) + 0 * y
    m = T.HydrostaticFreeSurfaceModel(_box(), tracers=("c",),
                                      free_surface=T.ExplicitFreeSurface(),
                                      immersed_boundary=T.GridFittedBottom(ridge))
    g = m.grid
    assert isinstance(g, ImmersedGrid) and g.shape == (16, 16, 8)
    assert g.topology[2] is T.BOUNDED and not g.curvilinear
    assert g.immersed is m.immersed_boundary and not m.fused_advance
    assert repr(g).startswith("ImmersedGrid(")


def test_hydrostatic_immersed_runs_and_conserves():
    """tests/test_immersed.py's ridge: WENO5 tracer under conditional
    fluxes, 5 steps against JAX and its own budget."""
    ridge_j = lambda x, y: -1e3 + 400.0 * jnp.exp(-((x - 5e4) ** 2) / (1e4) ** 2)
    ridge_t = lambda x, y: -1e3 + 400.0 * torch.exp(-((x - 5e4) ** 2) / (1e4) ** 2)
    jm = JH(_jbox(), immersed_boundary=jim.GridFittedBottom(ridge_j), tracers=("c",),
            tracer_advection=J.WENO5(), fused_advection=False)
    tm = T.HydrostaticFreeSurfaceModel(_box(), immersed_boundary=T.GridFittedBottom(ridge_t),
                                       tracers=("c",), tracer_advection=T.WENO5())
    c0 = lambda x, y, z: np.exp(-((np.asarray(x) - 3e4) ** 2) / (1e4) ** 2) + 0 * np.asarray(y + z)
    js = jm.initial_state(u=0.1, c=lambda x, y, z: jnp.asarray(c0(x, y, z)))
    ts = tm.initial_state(u=0.1, c=lambda x, y, z: torch.as_tensor(c0(x, y, z)))
    ig = tm.grid
    fluid_w = torch.where(ig.immersed.solid_ccc, 0.0, 1.0) * ig.V(T.CENTER)
    total = lambda s: float(ig.interior(s["solution"]["c"] * fluid_w).sum())
    t0 = total(ts)
    for _ in range(5):
        js, ts = jm.step(js, 50.0), tm.step(ts, 50.0)
    for n in ("u", "v", "c"):
        close(jm.grid.interior(js["solution"][n]), ig.interior(ts["solution"][n]),
              1e-9, n)
    assert abs(total(ts) - t0) < 1e-3 * abs(t0)


def test_uniform_tracer_stays_uniform_under_diffusion():
    """Solid cells (masked to 0) must not act as a value wall."""
    m = T.HydrostaticFreeSurfaceModel(
        _box(), tracers=("c",), momentum_advection=None,
        closure=T.ScalarDiffusivity(nu=1e2, kappa=1e2),
        free_surface=T.ExplicitFreeSurface(),
        immersed_boundary=T.GridFittedBottom(
            lambda x, y: -1e3 + 600.0 * torch.exp(-((x - 5e4) ** 2 + (y - 5e4) ** 2) / 4e8)))
    state = m.initial_state(c=1.0)
    for _ in range(5):
        state = m.step(state, 10.0)
    g = m.grid
    c = g.interior(state["solution"]["c"])
    fluid = ~g.interior(g.immersed.solid_ccc)
    assert float((c[fluid] - 1.0).abs().max()) <= 1e-12


def test_immersed_boundary_condition_flux_budget():
    """FieldBCs(immersed=FluxBC(q)) adds exactly q·A_bottom·t to the budget."""
    Lx, Ly, H, q = 2.0, 3.0, 1.0, 0.7
    g = T.RectilinearGrid(size=(8, 8, 16), x=(0, Lx), y=(0, Ly), z=(-H, 0),
                          topology=("periodic", "periodic", "bounded"),
                          dtype=torch.float64, device=DEVICE)
    m = T.HydrostaticFreeSurfaceModel(
        g, tracers=("c",), momentum_advection=None, tracer_advection=None,
        free_surface=T.ExplicitFreeSurface(),
        immersed_boundary=T.GridFittedBottom(-0.5),
        boundary_conditions={"c": T.FieldBCs(immersed=T.FluxBC(q))})
    gi = m.grid
    state = m.initial_state(c=1.0)
    dt, n = 1e-2, 40
    for _ in range(n):
        state = m.step(state, dt)
    vol = torch.broadcast_to(gi.V(T.CENTER), gi.total_shape)
    fluid = ~gi.immersed.solid_ccc
    total = float(gi.interior(state["solution"]["c"] * vol * fluid).sum())
    expected = 1.0 * Lx * Ly * 0.5 + q * Lx * Ly * n * dt
    assert total == pytest.approx(expected, rel=1e-12)


def test_discrete_form_immersed_bottom_drag():
    """A linear drag −r u through the immersed bottom decays the bottom
    fluid cell at r/Δz; the cells above keep their velocity, the solid
    stays zero."""
    H, r = 1.0, 0.05
    g = T.RectilinearGrid(size=(4, 4, 16), x=(0, 1), y=(0, 1), z=(-H, 0),
                          topology=("periodic", "periodic", "bounded"),
                          dtype=torch.float64, device=DEVICE)
    m = T.HydrostaticFreeSurfaceModel(
        g, momentum_advection=None, free_surface=T.ExplicitFreeSurface(),
        immersed_boundary=T.GridFittedBottom(-0.5),
        boundary_conditions={"u": T.FieldBCs(immersed=T.FluxBC(
            lambda grid, t, fields: -r * fields["u"], discrete=True))})
    state = m.initial_state(u=0.3)
    dt, n = 1e-2, 100
    for _ in range(n):
        state = m.step(state, dt)
    u = m.grid.interior(state["solution"]["u"]).mean((0, 1)).numpy()
    t = n * dt
    assert abs(u[8] - 0.3 * np.exp(-r * t / (H / 16))) < 0.01, u[8]
    assert np.allclose(u[9:], 0.3, atol=1e-12)
    assert np.all(u[:8] == 0.0)


def test_implicit_free_surface_sees_immersed_depth():
    """tests/test_immersed.py's gravity wave over a ridge: the implicit
    free surface (its "auto" solve, CG over the bottom) carries the fluid
    column depth, so it tracks the explicit one stepped at the same Δt."""
    L, H = 1e5, 100.0
    ridge = lambda x, y: -H + 60.0 * torch.exp(-((x - L / 2) / 8e3) ** 2)
    g = T.RectilinearGrid(size=(64, 1, 8), x=(0, L), y=(0, 1), z=(-H, 0),
                          topology=("periodic", "flat", "bounded"),
                          dtype=torch.float64, device=DEVICE)

    def run(fs):
        m = T.HydrostaticFreeSurfaceModel(g, free_surface=fs, momentum_advection=None,
                                          immersed_boundary=T.GridFittedBottom(ridge))
        s = m.initial_state(eta=lambda x, y: 0.01 * torch.exp(-((x - L / 4) / 6e3) ** 2))
        for _ in range(60):
            s = m.step(s, 10.0)
        gi = m.grid
        return s["eta"][gi.Hx:gi.Hx + gi.Nx, gi.Hy, 0].numpy()

    eta_exp = run(T.ExplicitFreeSurface())
    eta_imp = run(T.ImplicitFreeSurface(solver_method="auto", tolerance=1e-12, maxiter=600))
    assert np.isfinite(eta_imp).all() and np.isfinite(eta_exp).all()
    assert np.corrcoef(eta_imp, eta_exp)[0, 1] > 0.99
    assert np.argmax(np.abs(eta_imp)) == np.argmax(np.abs(eta_exp))
    assert 0.85 < np.abs(eta_imp).max() / np.abs(eta_exp).max() < 1.05
