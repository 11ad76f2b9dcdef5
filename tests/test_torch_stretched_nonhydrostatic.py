"""Port parity: the nonhydrostatic model on a z stretched as the upper-ocean
LES examples stretch it, with the LES closure and vertically implicit
diffusion.

Built in both packages from the same numpy-seeded state, f64, stepped on
the JAX plain path (``fused_advection=False``) and on the port's CPU path
(the kernels' plain versions):

- 10 RK3 steps of ``examples/ocean_wind_mixing_and_convection.py`` uncut
  (``UpwindBiasedFifthOrder``; its own stretched z faces, refinement 1.2
  and stretching 12, at 16³; AMD; seawater buoyancy; its flux and
  gradient BCs) and of
  ``examples/langmuir_turbulence.py`` with its own AMD closure, within
  ``1e-9`` of max|field| (the Fourier-tridiagonal solve's transforms
  differ in rounding, see ``test_torch_tridiagonal.py``);
- 10 quasi-AB2 steps of the bench configuration (WENO5,
  ``BuoyancyTracer``) on that stretched z with a vertically implicit
  ``ScalarDiffusivity``, through the fused branch (K1's plain version,
  then the implicit step and the general projection) and the general
  branch, and AB2 with ``FluxBC`` w walls on a regular grid (the same
  route after the fused advance), within ``1e-9``;
- a JAX AMD state stepping in the port (``interop``), and back;
- K2's and K1's plain versions against the JAX plain path's advection and
  tendencies on a stretched z, WENO5 and centred tracers, within 1e-13
  of max|G|;
- a numpy mirror of the z rows K1 and K2 read on a stretched z (to-faces
  and to-centres tables; ``csrc/weno5_advection.cuh::table_side``'s
  offsets) against ``weno5_tables`` and ``WENO5.table_reconstruct``.

The ``cuda`` cases hold K1 and K2 on a stretched z, and the three new
paths' steps, against their plain versions on the card, bit for bit.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.advection.reconstruction_tables import weno5_tables
from clima_oceananigans_jl_torch.interop import state_from_numpy, state_to_numpy
from clima_oceananigans_jl_torch.models import nonhydrostatic as tnm
from clima_oceananigans_jl_torch.ops import fused_step as tfs
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft
from clima_oceananigans_jl_torch.ops.metric_rows import TABLE_ROWS, z_rows
from clima_oceananigans_jl_torch.solvers import tridiagonal as ttri
from clima_oceananigans_jl_torch.solvers.fourier_tridiagonal import (
    FourierTridiagonalSolver)

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection import fluxes as jfl
    from clima_oceananigans_jl_tpu.advection.reconstruction_tables import (
        weno5_tables as jweno5_tables)
    from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs
    from clima_oceananigans_jl_tpu.buoyancy import buoyancy as jbuoy
    from clima_oceananigans_jl_tpu.closures.eddy_viscosity import (
        AnisotropicMinimumDissipation as JAMD)
    from clima_oceananigans_jl_tpu.closures.scalar_diffusivity import (
        ScalarDiffusivity as JSD)
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel as JN
    from clima_oceananigans_jl_tpu.timesteppers.steppers import Clock as JClock
    from clima_oceananigans_jl_tpu.timesteppers.steppers import ab2_substep as jab2
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9

# examples/ocean_wind_mixing_and_convection.py
QT = 200.0 / (1026.0 * 3991.0)
DTDZ = 0.01
QU_WIND = -1.225 / 1026.0 * 2.5e-3 * 10.0 * abs(10.0)
EVAPORATION = 1e-3 / 3600.0
# examples/langmuir_turbulence.py
QU_LANGMUIR, QB, N2 = -3.72e-5, 2.307e-8, 1.936e-5
DT = {"wind mixing": 0.5, "langmuir": 1.0}


def wind_mixing_faces(nz, Lz=32.0, refinement=1.2, stretching=12.0):
    """examples/ocean_wind_mixing_and_convection.py:31-38."""
    h = np.arange(nz + 1) / nz
    zeta = 1 + (h - 1) / refinement
    sigma = (1 - np.exp(-stretching * h)) / (1 - np.exp(-stretching))
    return Lz * (zeta * sigma - 1)


def grid_pair(size, stretched=True, device=DEVICE):
    kw = dict(size=size, x=(0, 64), y=(0, 64),
              z=wind_mixing_faces(size[2]) if stretched else (-32, 0))
    jg = (J.RectilinearGrid(topology=("periodic", "periodic", "bounded"),
                            dtype=jnp.float64, **kw) if device == DEVICE else None)
    tg = T.RectilinearGrid(topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                           dtype=torch.float64, device=device, **kw)
    return jg, tg


def wind_mixing(jax_side, size, device=DEVICE):
    jg, tg = grid_pair(size, device=device)

    def QS(grid, t, fields):
        return -EVAPORATION * fields["S"]
    if jax_side:
        return JN(jg, advection=J.UpwindBiasedFifthOrder(), timestepper="RungeKutta3",
                  tracers=("T", "S"), coriolis=J.FPlane(f=1e-4),
                  buoyancy=jbuoy.SeawaterBuoyancy(equation_of_state=jbuoy.LinearEquationOfState(
                      thermal_expansion=2e-4, haline_contraction=8e-4)),
                  closure=JAMD(),
                  boundary_conditions={
                      "u": jbcs.FieldBCs(top=jbcs.FluxBC(QU_WIND)),
                      "T": jbcs.FieldBCs(top=jbcs.FluxBC(QT), bottom=jbcs.GradientBC(DTDZ)),
                      "S": jbcs.FieldBCs(top=jbcs.FluxBC(QS, discrete=True))},
                  fused_advection=False)
    return T.NonhydrostaticModel(
        tg, advection=T.UpwindBiasedFifthOrder(), timestepper="RungeKutta3",
        tracers=("T", "S"),
        coriolis=T.FPlane(f=1e-4),
        buoyancy=T.SeawaterBuoyancy(equation_of_state=T.LinearEquationOfState(
            thermal_expansion=2e-4, haline_contraction=8e-4)),
        closure=T.AnisotropicMinimumDissipation(),
        boundary_conditions={
            "u": T.FieldBCs(top=T.FluxBC(QU_WIND)),
            "T": T.FieldBCs(top=T.FluxBC(QT), bottom=T.GradientBC(DTDZ)),
            "S": T.FieldBCs(top=T.FluxBC(QS, discrete=True))})


def langmuir(jax_side, size, device=DEVICE):
    """examples/langmuir_turbulence.py with its own AMD closure (the
    Stokes drift is held in test_torch_surface_forced.py)."""
    jg, tg = grid_pair(size, stretched=False, device=device)
    m, g, bcs, closure = ((J, jg, jbcs, JAMD()) if jax_side else
                          (T, tg, T, T.AnisotropicMinimumDissipation()))
    kw = dict(fused_advection=False) if jax_side else {}
    Model = JN if jax_side else T.NonhydrostaticModel
    buoy = jbuoy.BuoyancyTracer() if jax_side else T.BuoyancyTracer()
    return Model(g, advection=m.WENO5(), timestepper="RungeKutta3", tracers=("b",),
                 buoyancy=buoy, coriolis=m.FPlane(f=1e-4), closure=closure,
                 boundary_conditions={
                     "u": bcs.FieldBCs(top=bcs.FluxBC(QU_LANGMUIR)),
                     "b": bcs.FieldBCs(top=bcs.FluxBC(QB), bottom=bcs.GradientBC(N2))},
                 **kw)


BUILD = {"wind mixing": wind_mixing, "langmuir": langmuir}


def initial_values(config, grid, seed=0):
    """The examples' initial states (numpy), their noise from a seeded
    generator."""
    rng = np.random.default_rng(seed)
    zc = grid.nodes(T.CENTER, with_halo=False)[2].cpu().numpy().reshape(1, 1, -1)
    shape = grid.shape
    if config == "langmuir":
        decay = np.exp(zc / 4.0)
        ustar = np.sqrt(abs(QU_LANGMUIR))
        strat = np.where(zc < -8.0, N2 * zc, -N2 * 8.0)
        return dict(b=strat + 1e-1 * N2 * 32 * decay * rng.standard_normal(shape),
                    u=ustar * 1e-1 * decay * rng.standard_normal(shape),
                    w=ustar * 1e-1 * decay * rng.standard_normal(shape))
    noise = zc / 32.0 * (1 + zc / 32.0)
    ustar = np.sqrt(abs(QU_WIND))
    return dict(T=20.0 + DTDZ * zc + DTDZ * 32.0 * 1e-6 * noise * rng.standard_normal(shape),
                u=ustar * 1e-3 * noise * rng.standard_normal(shape),
                w=ustar * 1e-3 * noise * rng.standard_normal(shape), S=35.0)


def compare(jm, js, tm, ts, rtol=RTOL, keys=()):
    for name in tm.prognostic_names():
        ref = np.asarray(jm.grid.interior(js["solution"][name]))
        got = tm.grid.interior(ts["solution"][name]).numpy()
        assert np.abs(ref - got).max() <= rtol * np.abs(ref).max(), name
    for key in keys:
        ref = np.asarray(jm.grid.interior(js[key]))
        got = tm.grid.interior(ts[key]).numpy()
        assert np.abs(ref - got).max() <= rtol * np.abs(ref).max(), key


@pytest.mark.parametrize("config", ["wind mixing", "langmuir"])
def test_les_examples_ten_rk3_steps_match_jax(config):
    jm, tm = BUILD[config](True, (16, 16, 16)), BUILD[config](False, (16, 16, 16))
    expected = FourierTridiagonalSolver if config == "wind mixing" else T.NonhydrostaticModel
    if config == "wind mixing":
        assert isinstance(tm.pressure_solver, expected) and not tm.projection_kernels
    vals = initial_values(config, tm.grid)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(10):
        js = step(js, DT[config])
        ts = tm.step(ts, DT[config])
    compare(jm, js, tm, ts)
    ref = np.asarray(jm.grid.interior(js["diffusivities"]["nu_e"]))
    got = tm.grid.interior(ts["diffusivities"]["nu_e"]).numpy()
    assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max()
    assert set(ts["diffusivities"]["kappa_e"]) == set(tm.tracer_names)
    # the wind drove the top layer
    assert float(tm.grid.interior(ts["solution"]["u"])[:, :, -1].mean()) > 0


IMPLICIT = dict(nu=1e-5, kappa=1e-5, time_discretization="vertically_implicit")


def ab2_pair(stretched, closure, flux_walls, fused, size=(16, 12, 10)):
    jg, tg = grid_pair(size, stretched)
    jb = {"w": jbcs.FieldBCs(bottom=jbcs.FluxBC(), top=jbcs.FluxBC())} if flux_walls else None
    tb = {"w": T.FieldBCs(bottom=T.FluxBC(), top=T.FluxBC())} if flux_walls else None
    jm = JN(jg, advection=J.WENO5(), buoyancy=jbuoy.BuoyancyTracer(),
            closure=JSD(**closure) if closure else None, boundary_conditions=jb,
            fused_advection=False)
    tm = T.NonhydrostaticModel(tg, advection=T.WENO5(), buoyancy=T.BuoyancyTracer(),
                               closure=T.ScalarDiffusivity(**closure) if closure else None,
                               boundary_conditions=tb, fused_advection=fused)
    return jm, tm


def bench_values(shape, seed=0):
    """bench.py's initial fields (random u, v, b)."""
    rng = np.random.default_rng(seed)
    return dict(u=1e-2 * rng.standard_normal(shape), v=1e-2 * rng.standard_normal(shape),
                b=1e-4 * rng.standard_normal(shape), w=1e-3 * rng.standard_normal(shape))


@pytest.mark.parametrize("stretched,closure,flux_walls", [
    (True, IMPLICIT, False), (False, IMPLICIT, False),
    (False, dict(nu=1e-5, kappa=1e-5), True), (True, None, True)],
    ids=["stretched implicit", "regular implicit", "regular flux walls",
         "stretched flux walls"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused branch", "general branch"])
def test_ab2_ten_steps_match_jax(stretched, closure, flux_walls, fused):
    jm, tm = ab2_pair(stretched, closure, flux_walls, fused)
    assert tm.fused_step == fused and tfs.general_route(tm)
    assert tfs.w_top(tm) == (fused and (stretched or flux_walls))
    vals = bench_values(tm.grid.shape)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(10):
        js = step(js, 0.5)
        ts = tm.step(ts, 0.5)
    compare(jm, js, tm, ts, keys=("pNHS",))


def test_jax_amd_state_steps_in_the_port_and_back():
    """A JAX state with AMD diffusivities (a dict per tracer) goes into the
    port through numpy and steps there as in JAX; the port's state goes
    back and steps in JAX."""
    jm, tm = langmuir(True, (8, 8, 8)), langmuir(False, (8, 8, 8))
    js = jm.initial_state(**initial_values("langmuir", tm.grid, seed=4))
    step = jax.jit(jm.step)
    js = step(js, 1.0)
    ts = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
    assert set(ts["diffusivities"]["kappa_e"]) == {"b"}
    assert tuple(ts["diffusivities"]["nu_e"].shape) == tm.grid.total_shape
    js, ts = step(js, 1.0), tm.step(ts, 1.0)
    compare(jm, js, tm, ts)
    back = state_to_numpy(ts)
    assert isinstance(back["diffusivities"]["kappa_e"]["b"], np.ndarray)
    js2 = jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in back.items()
                                               if k != "clock"})
    js2["clock"] = JClock(jnp.asarray(back["clock"].time),
                          jnp.asarray(back["clock"].iteration))
    compare(jm, step(js2, 1.0), tm, tm.step(ts, 1.0))


def test_closure_tuple_diffusivities_pass_through_interop():
    _, tg = grid_pair((8, 8, 8))
    tm = T.NonhydrostaticModel(tg, advection=T.WENO5(), buoyancy=T.BuoyancyTracer(),
                               closure=(T.AnisotropicMinimumDissipation(),
                                        T.ScalarDiffusivity(nu=1e-5, kappa=1e-5)))
    ts = tm.initial_state(**bench_values(tg.shape, seed=5))
    back = state_from_numpy(tm, state_to_numpy(ts))
    assert back["diffusivities"][1] is None
    for k in ("nu_e",):
        assert torch.equal(back["diffusivities"][0][k], ts["diffusivities"][0][k])
    a, b = tm.step(ts, 0.5), tm.step(back, 0.5)
    for n in tm.prognostic_names():
        assert torch.equal(a["solution"][n], b["solution"][n]), n


SCHEMES = [("WENO5", "WENO5"), ("WENO5", "CenteredSecondOrder"),
           ("CenteredSecondOrder", "WENO5")]


def k2_fields(tg, nt, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tg.total_shape) for _ in range(3 + nt)]


@pytest.mark.parametrize("momentum,tracer", SCHEMES)
def test_k2_plain_version_matches_jax_on_stretched_z(momentum, tracer):
    jg, tg = grid_pair((10, 9, 12))
    f = k2_fields(tg, 2)
    jf = [jnp.asarray(x) for x in f]
    ms, ts = getattr(J, momentum)(), getattr(J, tracer)()
    ref = dict(u=-jfl.div_vu(jg, ms, *jf[:3]), v=-jfl.div_vv(jg, ms, *jf[:3]),
               w=-jfl.div_vw(jg, ms, *jf[:3]))
    for i, c in enumerate(jf[3:]):
        ref[f"c{i}"] = -jfl.div_Uc(jg, ts, *jf[:3], c)
    tf = [torch.as_tensor(x) for x in f]
    got = tft.fused_advective_tendencies(
        tg, getattr(T, momentum)(), getattr(T, tracer)(), *tf[:3],
        {f"c{i}": c for i, c in enumerate(tf[3:])})
    for n in ref:
        r, g = np.asarray(jg.interior(ref[n])), tg.interior(got[n]).numpy()
        assert np.abs(r - g).max() <= 1e-13 * np.abs(r).max(), n


@pytest.mark.parametrize("closure", ["implicit", "explicit, flux walls", "none"])
def test_k1_plain_version_matches_jax_on_stretched_z(closure):
    """K1's plain version (the general route: with-halo ψ′) against the JAX
    plain path's tendencies and AB2 substep, interior and w's top wall
    face."""
    cl = {"implicit": IMPLICIT, "explicit, flux walls": dict(nu=1e-4, kappa=1e-4),
          "none": None}[closure]
    jm, tm = ab2_pair(True, cl, closure.endswith("walls"), True, size=(10, 9, 12))
    tm = T.NonhydrostaticModel(tm.grid, advection=T.WENO5(), buoyancy=T.BuoyancyTracer(),
                               closure=tm.closure, coriolis=T.FPlane(f=1e-4),
                               boundary_conditions={n: tm.bcs[n] for n in ("w",)})
    jm = JN(jm.grid, advection=J.WENO5(), buoyancy=jbuoy.BuoyancyTracer(),
            closure=jm.closure, coriolis=J.FPlane(f=1e-4),
            boundary_conditions={"w": jm.bcs["w"]}, fused_advection=False)
    assert tm.fused_step
    vals = bench_values(tm.grid.shape, seed=7)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    rng = np.random.default_rng(8)
    gp = {n: 1e-2 * rng.standard_normal(tm.grid.total_shape) for n in tm.prognostic_names()}
    js["G_prev"] = {n: jnp.asarray(x) for n, x in gp.items()}
    ts["G_prev"] = {n: torch.as_tensor(x) for n, x in gp.items()}
    G = jm.tendencies(js)
    psi = jab2(js["solution"], G, js["G_prev"], 0.5, jm.ab2_chi, False)
    tpsi, tG = tfs.fused_ab2_advance(tm, ts, 0.5, False)
    g = tm.grid
    (hx, hy, hz), (nx, ny, nz) = g.halo, g.shape
    for n in tm.prognostic_names():
        for ref, got in ((psi[n], tpsi[n]), (G[n], tG[n])):
            r, o = np.asarray(jm.grid.interior(ref)), g.interior(got).numpy()
            assert np.abs(r - o).max() <= 1e-13 * np.abs(r).max(), n
    # w's top wall face, which the general projection reads
    top = lambda a: np.asarray(a)[hx:hx + nx, hy:hy + ny, hz + nz]
    assert np.abs(top(psi["w"]) - top(tpsi["w"].numpy())).max() <= 1e-13 * np.abs(top(psi["w"])).max()


def mirror_reconstruct(rows, c, side, to_f, nz, hz):
    """numpy mirror of table_side: at each interior face (to faces) or
    centre (to centres) K, o the offset of the cell or face above, the
    rows' weights and coefficients with offsets r − 3 (left) or −r (right)
    from o, the Jiang-Shu indicators and the single-division combination."""
    out = {}
    eps = 1e-6
    for K in range(hz + 1, hz + nz):
        o = K if to_f else K + 1
        p, b, d = [], [], []
        for r in range(3):
            base = side * 12 + r * 4
            d.append(rows[base, K])
            cj = rows[base + 1: base + 4, K]
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
        out[K] = (g[0] * p[0] + g[1] * p[1] + g[2] * p[2]) / (g[0] + g[1] + g[2])
    return out


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("to_f", [True, False], ids=["to faces", "to centres"])
def test_z_rows_mirror_weno5_tables(to_f, side):
    """The rows of ``z_rows(grid, tables=True, to_centres=True)`` are
    weno5_tables' (port and JAX), row by row in the layout K1 and K2
    read, and the kernels' offsets reconstruct as
    ``WENO5.table_reconstruct``, on a grid whose axes differ."""
    jg, tg = grid_pair((7, 5, 11))
    rows = z_rows(tg, tables=True, to_centres=True).numpy()
    assert rows.shape == (2 + 2 * TABLE_ROWS, tg.total_shape[2])
    base = 2 + (0 if to_f else TABLE_ROWS)
    block = rows[base: base + TABLE_ROWS]
    s = 0 if side == "left" else 1
    for tables in (weno5_tables(tg, 2, to_f), jweno5_tables(jg, 2, to_f)):
        for r, (d, cj, _voff, _kind) in enumerate(tables[side]):
            b0 = s * 12 + r * 4
            np.testing.assert_allclose(block[b0], np.asarray(d), rtol=1e-14, atol=0)
            for j in range(3):
                np.testing.assert_allclose(block[b0 + 1 + j], np.asarray(cj[j]),
                                           rtol=1e-14, atol=1e-15)
    c = np.random.default_rng(12).standard_normal(tg.total_shape[2])
    ref = T.WENO5().table_reconstruct(
        torch.as_tensor(c).reshape(1, 1, -1).expand(tg.total_shape).contiguous(),
        2, weno5_tables(tg, 2, to_f), side)[0, 0].numpy()
    got = mirror_reconstruct(block, c, s, to_f, tg.Nz, tg.Hz)
    for K, v in got.items():
        assert abs(v - ref[K]) <= 1e-14 * max(1.0, abs(ref[K])), K


def test_z_rows_arg_picks_the_instantiation():
    _, st = grid_pair((6, 5, 8))
    _, rg = grid_pair((6, 5, 8), stretched=False)
    assert tft.z_rows_arg(rg, T.WENO5(), T.WENO5()) == (None, 0)
    zs, tables = tft.z_rows_arg(rg, T.WENO5(), T.WENO5(), general=True)
    assert tables == 0 and tuple(zs.shape) == (2, rg.total_shape[2])
    zs, tables = tft.z_rows_arg(st, T.WENO5(), T.CenteredSecondOrder())
    assert tables == 1 and zs.shape[0] == 2 + 2 * TABLE_ROWS
    zs, tables = tft.z_rows_arg(st, T.CenteredSecondOrder(), T.CenteredSecondOrder())
    assert tables == 0 and zs.shape[0] == 2


def test_pressure_solver_and_projection_follow_the_grid():
    _, st = grid_pair((6, 5, 8))
    _, rg = grid_pair((6, 5, 8), stretched=False)
    ms = T.NonhydrostaticModel(st, advection=T.WENO5())
    mr = T.NonhydrostaticModel(rg, advection=T.WENO5())
    assert isinstance(ms.pressure_solver, FourierTridiagonalSolver)
    assert not ms.projection_kernels and not ms._fast_projection_ok()
    assert not ms.g_interior and ms.fused_step
    assert mr.projection_kernels and mr._fast_projection_ok() and mr.g_interior


#: each case's grid, keywords and the ROADMAP item its refusal names; None:
#: the configuration builds now (a stretched x: the multigrid pressure solve)
REFUSED = {
    "stretched x": (lambda: T.RectilinearGrid(
        size=(6, 5, 8), x=np.cumsum(np.r_[0.0, np.linspace(1, 2, 6)]), y=(0, 1),
        z=(0, 1), topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
        dtype=torch.float64, device=DEVICE), {}, None),
    "another Coriolis": (lambda: grid_pair((6, 5, 8))[1],
                         dict(coriolis=object()), "object Coriolis is not ported \\(FPlane"),
    "another closure": (lambda: grid_pair((6, 5, 8))[1],
                        dict(closure=(T.AnisotropicMinimumDissipation(), object())),
                        "item 7"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_what_stays_out_is_refused_by_name(case):
    make, kw, item = REFUSED[case]
    if item is None:
        m = T.NonhydrostaticModel(make(), advection=T.WENO5(), **kw)
        assert type(m.pressure_solver).__name__ == "MultigridPoissonSolver"
        return
    with pytest.raises(NotImplementedError, match=item):
        T.NonhydrostaticModel(make(), advection=T.WENO5(), **kw)


# -- on the card --------------------------------------------------------------------

def card_models(path, size, dtype=torch.float32):
    z = wind_mixing_faces(size[2])
    g = T.RectilinearGrid(size=size, x=(0, 64), y=(0, 64),
                          z=z if path != "langmuir AMD" else (-32, 0),
                          topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED), dtype=dtype)
    if path == "AB2 stretched implicit":
        return T.NonhydrostaticModel(g, advection=T.WENO5(), buoyancy=T.BuoyancyTracer(),
                                     closure=T.ScalarDiffusivity(**IMPLICIT))
    if path == "langmuir AMD":
        return langmuir(False, size, device="cuda")
    return wind_mixing(False, size, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["wind mixing stretched", "langmuir AMD",
                                  "AB2 stretched implicit"])
def test_cuda_les_paths_match_plain_versions(path):
    """Three steps of each new path at 24×20×16 on the card with the kernels
    and with their plain versions: bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    size = (24, 20, 16)
    m = card_models(path, size, torch.float64 if path == "langmuir AMD" else torch.float32)
    vals = (bench_values(size) if path.startswith("AB2") else
            initial_values("langmuir" if path == "langmuir AMD" else "wind mixing", m.grid))
    out = []
    for kernels in (None, tnm.PLAIN):
        s = m.initial_state(**vals)
        n = ttri.solve_batched_tridiagonal.launches
        for _ in range(3):
            s = m.step(s, 0.5, kernels)
        torch.cuda.synchronize()
        out.append((s, ttri.solve_batched_tridiagonal.launches - n))
    (got, t1), (ref, none) = out
    assert none == 0 and t1 == {"wind mixing stretched": 9, "langmuir AMD": 0,
                                "AB2 stretched implicit": 15}[path]
    for n in got["solution"]:
        assert torch.equal(got["solution"][n], ref["solution"][n]), n
    assert torch.equal(got["pNHS"], ref["pNHS"])


@pytest.mark.cuda
@pytest.mark.parametrize("momentum,tracer", SCHEMES)
def test_cuda_k1_k2_stretched_match_plain_versions(momentum, tracer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    size = (33, 26, 21)
    g = T.RectilinearGrid(size=size, x=(0, 64), y=(0, 64), z=wind_mixing_faces(size[2]),
                          topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED), dtype=torch.float64)
    m = T.NonhydrostaticModel(g, advection=getattr(T, momentum)(),
                              tracer_advection=getattr(T, tracer)(),
                              buoyancy=T.BuoyancyTracer(), tracers=("c",),
                              closure=T.ScalarDiffusivity(**IMPLICIT))
    s = m.initial_state(**bench_values(size), c=np.random.default_rng(1).standard_normal(size))
    s["G_prev"] = {k: 1e-2 * torch.randn(m.grid.total_shape, dtype=torch.float64,
                                         device="cuda") for k in m.prognostic_names()}
    psi, G = tfs.fused_ab2_advance(m, s, 0.5, False)
    rpsi, rG = tfs.fused_ab2_advance_reference(m, s, 0.5, False)
    for n in psi:
        assert torch.equal(psi[n], rpsi[n]) and torch.equal(G[n], rG[n]), n
    sol = s["solution"]
    args = (m.grid, m.advection, m.tracer_advection, sol["u"], sol["v"], sol["w"],
            {n: sol[n] for n in m.tracer_names})
    a = tft.fused_advective_tendencies(*args)
    b = tft.fused_advective_tendencies_reference(*args)
    for n in a:
        assert torch.equal(m.grid.interior(a[n]), m.grid.interior(b[n])), n
