"""Port parity: the conformal cubed sphere, its hydrostatic model, and the
port's copies of the four cubed-sphere validations.

The JAX package's ``CubedSphereGrid`` computes its geometry in numpy
float64 and its model steps in jnp; the port computes the same geometry
with the same arithmetic and steps in PyTorch through
``torch.func.vmap`` over the faces. The same inputs go through both, in
float64 unless a case says otherwise:

- metrics (``_dx``, ``_dy``, ``_az`` at every location), longitude,
  latitude, node positions and halo maps, bitwise, for the conformal and
  the gnomonic map with halos 2 and 3;
- ``fill_halos`` on random scalars and vector pairs, bitwise, leaving its
  arguments untouched; grid files written by either package read by the
  other, bitwise; ``cubed_sphere_tracer_step``, bitwise;
- three Nz = 1 model steps with a tracer and with prescribed velocities,
  bitwise against the JAX step run op by op (``jax.disable_jit()``: XLA
  fuses a jitted step and rounds otherwise);
- the Nz = 4 fp32 multilevel step against the jitted JAX step within
  ``ML_RTOL`` of max|field| (η: of its largest transport term,
  Δt·max|Ay U/Az|, whose differences nearly cancel): XLA's fused
  cumsum and vertical sums round in another order than eager PyTorch
  (op by op the two agree bitwise);
- the JAX suite's own physics checks on the port: total area, halo
  continuity, exact rotated copies, conformal map properties, tracer
  conservation, steady geostrophic flow, gravity-wave volume
  conservation;
- each cubed-sphere validation copy against the JAX model built from
  the script's constants at N = 8, two steps, within ``RTOL``;
- ``weno5_tables`` on a grid without 1D axes (the face grids).

The ``cuda`` case holds the step replayed from its CUDA graph bitwise
against the eager step on the card (``python -m pytest --noconftest -m
cuda tests/test_torch_cubed_sphere.py``).
"""
import functools
import inspect

import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.advection.fluxes import div_Uc
from clima_oceananigans_jl_torch.advection.reconstruction_tables import weno5_tables
from clima_oceananigans_jl_torch.grids import conformal_map as tcm
from clima_oceananigans_jl_torch.grids.cubed_sphere import cubed_sphere_tracer_step
from clima_oceananigans_jl_torch.interop import state_from_numpy, state_to_numpy
from clima_oceananigans_jl_torch.utils.location import C, CENTER, F
from clima_oceananigans_jl_torch.validation import (cubed_sphere_gravity_waves,
                                                    eddying_aquaplanet,
                                                    rossby_haurwitz,
                                                    solid_body_rotation)

try:  # the cuda case also runs on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection.fluxes import div_Uc as jdiv_Uc
    from clima_oceananigans_jl_tpu.grids.cubed_sphere import (
        cubed_sphere_tracer_step as jtracer_step)
    from clima_oceananigans_jl_tpu.timesteppers.steppers import Clock as JClock
    from clima_oceananigans_jl_tpu.utils.location import C as JC, F as JF

    LOCS = (((JC, JC), (C, C)), ((JC, JF), (C, F)), ((JF, JC), (F, C)),
            ((JF, JF), (F, F)))
    JDT = {"f64": jnp.float64, "f32": jnp.float32}
except ImportError:
    pass

torch.set_num_threads(1)

DEVICE = "cpu"
R_E = 6.371e6
RTOL = 1e-12
ML_RTOL = 1e-6
TDT = {"f64": torch.float64, "f32": torch.float32}


@functools.lru_cache(maxsize=None)
def grids(N, halo=3, map_kind="conformal", nz=1, z=None, radius=R_E, dtype="f64"):
    """(JAX grid, port grid) of one configuration, built once a module."""
    kw = dict(size=(N, N, nz), halo=halo, map_kind=map_kind, radius=radius)
    if z is not None:
        kw["z"] = z
    return (J.CubedSphereGrid(dtype=JDT[dtype], **kw),
            T.CubedSphereGrid(dtype=TDT[dtype], device=DEVICE, **kw))


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same(a, b):
    return np.array_equal(host(a), host(b), equal_nan=True)


def random_fields(jg, seed, n=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(jg.total_shape) for _ in range(n)]


def vel(p, speed=38.0):
    n = p / np.linalg.norm(p, axis=-1, keepdims=True)
    return np.cross([0.0, 0.0, speed], n)


# -- geometry -----------------------------------------------------------------
@pytest.mark.parametrize("map_kind", ["conformal", "gnomonic"])
@pytest.mark.parametrize("halo", [2, 3])
def test_metrics_nodes_and_maps_bitwise(map_kind, halo):
    jg, tg = grids(8, halo, map_kind)
    for name in ("_dx", "_dy", "_az"):
        for jl, tl in LOCS:
            assert same(getattr(jg, name)[jl], getattr(tg, name)[tl]), (name, tl)
    assert same(jg.longitude, tg.longitude) and same(jg.latitude, tg.latitude)
    for jl, tl in LOCS:
        for f in range(6):
            assert same(jg._nodes(f, jl), tg._nodes(f, tl)), (tl, f)
    for jl, tl in LOCS[:3]:
        jm, tm = jg._maps[jl], tg._maps[tl]
        assert all(same(a, b) for a, b in zip(jm.hij, tm.hij))
        for k in ("f", "iA", "jA", "wxA", "wyA", "rA", "iB", "jB", "wxB", "wyB", "rB"):
            assert same(getattr(jm, k), getattr(tm, k)), (tl, k)


def test_tangents_bitwise():
    jg, tg = grids(8)
    for (jl, tl), axis in ((LOCS[2], 0), (LOCS[1], 1)):
        X, Y = np.meshgrid(jg._lattice_1d(jl[0]), jg._lattice_1d(jl[1]), indexing="ij")
        X, Y = np.clip(X, -1, 1), np.clip(Y, -1, 1)
        for f in range(6):
            assert same(jg._tangent(f, X, Y, axis), tg._tangents(tl, axis)[f])


def test_conformal_map_bitwise():
    from clima_oceananigans_jl_tpu.grids import conformal_map as jcm
    assert jcm.conformal_coefficients() == tcm.conformal_coefficients()
    z = np.array([0.3 + 0.2j, -0.7 + 0.5j, 1.0 + 1.0j, 0.0 - 1.0j])
    assert same(jcm.conformal_to_stereographic(z), tcm.conformal_to_stereographic(z))
    for a, b in zip(jcm.conformal_cubed_sphere_mapping(0.4, -0.9),
                    tcm.conformal_cubed_sphere_mapping(0.4, -0.9)):
        assert same(a, b)


@pytest.mark.parametrize("nz", [1, 4])
def test_fill_halos_bitwise_and_functional(nz):
    z = (-100.0, 0.0) if nz > 1 else None
    jg, tg = grids(8, 3, "conformal", nz, z)
    c, u, v = random_fields(jg, nz, 3)
    tc, tu, tv = (torch.tensor(a) for a in (c, u, v))
    keep = [t.clone() for t in (tc, tu, tv)]
    assert same(jg.fill_halos(jnp.asarray(c)), tg.fill_halos(tc))
    ju, jv = jg.fill_halos(jnp.asarray(u), vector_pair=(jnp.asarray(u), jnp.asarray(v)))
    pu, pv = tg.fill_halos(tu, vector_pair=(tu, tv))
    assert same(ju, pu) and same(jv, pv)
    assert all(torch.equal(a, b) for a, b in zip((tc, tu, tv), keep))


def test_grid_files_both_ways(tmp_path):
    jg, tg = grids(8)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jg.to_file(jpath)
    tg.to_file(tpath)
    t_from_j = T.CubedSphereGrid.from_file(jpath, dtype=torch.float64, device=DEVICE)
    j_from_t = J.CubedSphereGrid.from_file(tpath, dtype=jnp.float64)
    for name in ("_dx", "_dy", "_az"):
        for jl, tl in LOCS:
            assert same(getattr(jg, name)[jl], getattr(t_from_j, name)[tl])
            assert same(getattr(j_from_t, name)[jl], getattr(tg, name)[tl])
    for jl, tl in LOCS[:3]:
        assert same(jg._maps[jl].wxA, t_from_j._maps[tl].wxA)
    # one model step on the file's grid, each package against the other's file
    eta = lambda p: 0.5 * p[..., 2] / np.linalg.norm(p, axis=-1)
    tm = T.CubedSphereHydrostaticModel(t_from_j, depth=1000.0)
    jm = J.CubedSphereHydrostaticModel(j_from_t, depth=1000.0)
    with jax.disable_jit():
        js = jm.step(jm.initial_state(eta=eta), 60.0)
    ts = tm.step(tm.initial_state(eta=eta), 60.0)
    assert same(js["eta"], ts["eta"])


def test_tracer_step_bitwise():
    jg, tg = grids(8)
    c, u, v = random_fields(jg, 5, 3)
    with jax.disable_jit():
        ref = jtracer_step(jg, jnp.asarray(c), jnp.asarray(0.1 * u),
                           jnp.asarray(0.1 * v), 1e-3, J.UpwindBiasedThirdOrder())
    got = cubed_sphere_tracer_step(tg, torch.tensor(c), torch.tensor(0.1 * u),
                                   torch.tensor(0.1 * v), 1e-3, T.UpwindBiasedThirdOrder())
    assert same(ref, got)


def test_weno5_tables_none_without_1d_axes():
    """A grid without ``_axes`` (the cubed sphere's face grids) has no
    WENO5 tables, and WENO5's ``div_Uc`` runs on a face grid, bitwise the
    JAX package's."""
    assert weno5_tables(object(), 0, True) is None
    jg, tg = grids(8)
    c, u, v = random_fields(jg, 9, 3)
    with jax.disable_jit():
        ref = jax.vmap(lambda g, a, b, q: jdiv_Uc(g, J.WENO5(), a, b, 0 * q, q),
                       in_axes=(jg.face_axes(), 0, 0, 0))(
            jg.face_grids(), jnp.asarray(u), jnp.asarray(v), jnp.asarray(c))
    got = tg.vmap_faces(lambda g, a, b, q: div_Uc(g, T.WENO5(), a, b, 0 * q, q),
                        torch.tensor(u), torch.tensor(v), torch.tensor(c))
    assert same(ref, got)


# -- the model ----------------------------------------------------------------
def models(jg, tg, **kw):
    tkw = {k: getattr(T, type(v).__name__)() if hasattr(v, "required_halo") else v
           for k, v in kw.items()}
    return J.CubedSphereHydrostaticModel(jg, **kw), T.CubedSphereHydrostaticModel(tg, **tkw)


def assert_states(js, ts, names, rtol=0.0):
    for n in names:
        ref = host(js["eta"] if n == "eta" else js["solution"][n])
        got = host(ts["eta"] if n == "eta" else ts["solution"][n])
        assert np.isfinite(got).all(), n
        err = np.abs(ref - got).max()
        assert err <= rtol * np.abs(ref).max(), (n, err, np.abs(ref).max())


@pytest.mark.parametrize("prescribed", [False, True])
def test_model_steps_bitwise(prescribed):
    """Three Nz = 1 steps with a WENO5 tracer (and with the velocities
    held), bitwise against the JAX step op by op; the clock too."""
    jg, tg = grids(8)
    jm, tm = models(jg, tg, tracers=("c",), depth=1000.0, tracer_advection=J.WENO5(),
                    prescribed_velocities=prescribed)
    assert same(jm.f_ff, tm.f_ff)
    init = dict(u=vel, eta=lambda p: -0.5 * (p[..., 2] / np.linalg.norm(p, axis=-1)) ** 2,
                c=lambda p: p[..., 0] / np.linalg.norm(p, axis=-1))
    js, ts = jm.initial_state(**init), tm.initial_state(**init)
    assert_states(js, ts, ("u", "v", "c", "eta"))
    with jax.disable_jit():
        for _ in range(3):
            js = jm.step(js, 50.0)
    for _ in range(3):
        ts = tm.step(ts, 50.0)
    assert_states(js, ts, ("u", "v", "c", "eta"))
    if prescribed:
        assert torch.equal(ts["solution"]["u"], tm.exchange(tm.initial_state(**init))
                           ["solution"]["u"])
    assert float(ts["clock"].time) == float(js["clock"].time) == 150.0
    assert ts["clock"].iteration == 3


def test_multilevel_fp32_step():
    """The JAX suite's multilevel configuration (8×8×4, z ∈ [−100, 0],
    fp32, tracer c) one step against the jitted JAX step within
    ``ML_RTOL`` (XLA's fused cumsum and vertical sums; η against its
    largest transport term), and bitwise against the JAX step op by op."""
    jg, tg = grids(8, 3, "conformal", 4, (-100.0, 0.0), R_E, "f32")
    jm, tm = models(jg, tg, tracers=("c",))

    def c0(p):
        n = p / np.linalg.norm(p, axis=-1, keepdims=True)
        return np.exp(-((n[..., 0] - 1.0) ** 2) / 0.1)

    init = dict(u=lambda p: vel(p, 1.0), c=c0)
    js, ts = jm.initial_state(**init), tm.initial_state(**init)
    assert ts["solution"]["u"].shape == tg.total_shape
    fg, Hz, Nz = tg.face_grids(), tg.Hz, tg.Nz
    U = (ts["solution"]["u"] * fg.dz((F, C, C)))[..., Hz:Hz + Nz].sum(-1, keepdim=True)
    H, N = tg.H, tg.N
    eta_scale = 50.0 * float((fg.Ay((F, C, C)) * U / fg.Az(CENTER))[
        :, H:H + N, H:H + N].abs().max())
    jit_s = jax.jit(jm.step)(js, 50.0)
    with jax.disable_jit():
        js = jm.step(js, 50.0)
    ts = tm.step(ts, 50.0)
    assert_states(jit_s, ts, ("u", "v", "c"), ML_RTOL)
    err = np.abs(host(jit_s["eta"]) - host(ts["eta"])).max()
    assert err <= ML_RTOL * eta_scale, (err, eta_scale)
    assert_states(js, ts, ("u", "v", "c", "eta"))


def test_interop_cubed_sphere_state():
    jg, tg = grids(8)
    jm, tm = models(jg, tg, tracers=("c",), depth=1000.0)
    js = jm.initial_state(u=vel, eta=lambda p: p[..., 2] / np.linalg.norm(p, axis=-1),
                          c=1.0)
    with jax.disable_jit():
        js = jm.step(js, 60.0)
        ts = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
        js2 = jm.step(js, 60.0)
        back = state_to_numpy(ts)
        jb = dict(solution={k: jnp.asarray(v) for k, v in back["solution"].items()},
                  eta=jnp.asarray(back["eta"]),
                  clock=JClock(jnp.asarray(back["clock"].time),
                               jnp.asarray(back["clock"].iteration)))
        js3 = jm.step(jb, 60.0)
    ts2 = tm.step(ts, 60.0)
    assert_states(js2, ts2, ("u", "v", "c", "eta"))
    assert_states(js2, js3, ("u", "v", "c", "eta"))


def test_grids_default_to_the_card():
    assert inspect.signature(T.CubedSphereGrid).parameters["device"].default == "cuda"
    assert inspect.signature(T.CubedSphereGrid.from_file).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            T.CubedSphereGrid(size=(4, 4, 1))


# -- the JAX suite's physics checks, on the port ---------------------------------
def test_total_area_is_sphere_area():
    _, g = grids(16, 2, radius=1.0)
    H = g.H
    total = float(g.face_grids().Az(CENTER)[:, H:H + g.N, H:H + g.N].sum())
    assert abs(total - 4 * np.pi) / (4 * np.pi) < 1e-3


def test_halo_exchange_continuity():
    _, g = grids(16, 2, radius=1.0)
    pos = g._centers3d
    f3 = lambda p: np.sin(2 * p[..., 0]) + 0.5 * p[..., 1] * p[..., 2]
    H, N = g.H, g.N
    data = torch.zeros(g.total_shape, dtype=torch.float64)
    data[:, H:H + N, H:H + N, 0] = torch.tensor(f3(pos)[:, H:H + N, H:H + N])
    got = host(g.fill_halos(data))[..., 0]
    n = N + 2 * H
    mask = np.zeros((n, n), bool)
    mask[H:H + N, :H] = True; mask[H:H + N, H + N:] = True
    mask[:H, H:H + N] = True; mask[H + N:, H:H + N] = True
    expect = f3(pos)
    err = np.abs(got[:, mask] - np.stack([expect[f][mask] for f in range(6)]))
    assert err.max() < 5e-3  # O(dx^2) bilinear interpolation accuracy


def test_exact_rotated_halo_exchange():
    _, g = grids(16, 2, radius=1.0)
    N, H = g.N, g.H
    for loc in ((C, C), (F, C), (C, F)):
        m = g._maps[loc]
        for r, wx, wy in ((m.rA, m.wxA, m.wyA), (m.rB, m.wxB, m.wyB)):
            r = host(r)
            act = np.abs(r) > 1e-12
            assert (np.abs(r - np.round(r)) < 1e-6).all()
            for w in (host(wx), host(wy)):
                off = np.minimum(np.abs(w), np.abs(1 - w))
                assert (off[act] < 1e-6).all()
    ffun = lambda p: p[..., 0] * p[..., 1] + p[..., 2] ** 2 + 0.3 * p[..., 0]
    c = torch.tensor(np.stack([ffun(g._nodes(f, (C, C))) for f in range(6)])[..., None])
    c0 = torch.zeros_like(c)
    c0[:, H:H + N, H:H + N] = c[:, H:H + N, H:H + N]
    assert float((g.fill_halos(c0) - c).abs().max()) < 1e-12


def test_conformal_map_properties():
    X, Y, Z = tcm.conformal_cubed_sphere_mapping(1.0, 1.0)
    assert abs(X - 1 / np.sqrt(3)) < 1e-7 and abs(Z - 1 / np.sqrt(3)) < 1e-7
    X, Y, Z = tcm.conformal_cubed_sphere_mapping(1.0, 0.0)
    assert abs(X - 1 / np.sqrt(2)) < 1e-7 and abs(Z - 1 / np.sqrt(2)) < 1e-7
    eps = 1e-6
    w = tcm.conformal_to_stereographic
    for (x0, y0) in [(0.3, 0.2), (-0.7, 0.5)]:
        wx = (w(x0 + eps + 1j * y0) - w(x0 - eps + 1j * y0)) / (2 * eps)
        wy = (w(x0 + 1j * (y0 + eps)) - w(x0 + 1j * (y0 - eps))) / (2 * eps)
        assert abs(wy - 1j * wx) / abs(wx) < 1e-8
    for t in np.linspace(-0.9, 0.9, 7):
        Xp, Yp, Zp = tcm.conformal_cubed_sphere_mapping(1.0, t)
        assert abs(Xp - Zp) < 1e-7  # edge on great circle X=Z


def test_tracer_conservation_exact():
    _, g = grids(16, 3, radius=1.0)
    N, H = g.N, g.H
    rng = np.random.RandomState(0)
    c = torch.zeros(g.total_shape, dtype=torch.float64)
    u, v = torch.zeros_like(c), torch.zeros_like(c)
    c[:, H:H + N, H:H + N, 0] = torch.tensor(rng.rand(6, N, N))
    u[:, H:H + N, H:H + N, 0] = torch.tensor(0.1 * rng.randn(6, N, N))
    v[:, H:H + N, H:H + N, 0] = torch.tensor(0.1 * rng.randn(6, N, N))
    az = g._az[(C, C)]
    mass = lambda q: float((g.interior(q) * g.interior(torch.broadcast_to(az, q.shape))).sum())
    cs = c
    for _ in range(3):
        cs = cubed_sphere_tracer_step(g, cs, u, v, 1e-3, T.UpwindBiasedThirdOrder())
    assert abs(mass(cs) - mass(c)) < 1e-10 * abs(mass(c))


def test_solid_body_rotation_conserves_tracer():
    _, g = grids(16, 2, radius=1.0)
    pos = g._centers3d
    V = np.stack([-pos[..., 1], pos[..., 0], np.zeros_like(pos[..., 0])], axis=-1)
    e1 = np.gradient(pos, axis=1)
    e2 = np.gradient(pos, axis=2)
    e1 /= np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 /= np.linalg.norm(e2, axis=-1, keepdims=True)
    u = torch.tensor((V * e1).sum(-1))[..., None]
    v = torch.tensor((V * e2).sum(-1))[..., None]
    lon, lat = host(g.longitude), host(g.latitude)
    c = torch.tensor(np.exp(-((lat - 20) ** 2 + lon ** 2) / 400.0))[..., None]
    vol = g.face_grids().V(CENTER)
    total0 = float(g.interior(c * vol).sum())
    for _ in range(100):
        c = cubed_sphere_tracer_step(g, c, u, v, 2e-3, T.CenteredSecondOrder())
    assert torch.isfinite(c).all()
    assert abs(float(g.interior(c * vol).sum()) - total0) / abs(total0) < 2e-2
    assert 0.3 < float(c.max()) < 1.3


def test_solid_body_geostrophic_steady():
    """Williamson et al. (1992) test 2: zonal solid-body flow with the
    balancing free surface stays near steady."""
    _, g = grids(24)
    u0, gg, omega = 20.0, 9.80665, 7.292115e-5

    def eta0(p):
        sinphi = (p / np.linalg.norm(p, axis=-1, keepdims=True))[..., 2]
        return -(R_E * omega * u0 + 0.5 * u0 ** 2) * sinphi ** 2 / gg

    model = T.CubedSphereHydrostaticModel(g, gravitational_acceleration=gg, depth=4000.0)
    state = model.initial_state(u=lambda p: vel(p, u0), eta=eta0)
    core = lambda e: host(e)[:, g.H:g.H + g.N, g.H:g.H + g.N]
    u_init, eta_init = host(g.interior(state["solution"]["u"])), core(state["eta"])
    for _ in range(60):
        state = model.step(state, 100.0)
    u_fin = host(g.interior(state["solution"]["u"]))
    assert np.isfinite(u_fin).all()
    assert np.abs(u_fin).max() < 1.05 * u0
    l2 = np.sqrt(((u_fin - u_init) ** 2).mean()) / np.sqrt((u_init ** 2).mean())
    assert l2 < 0.03, l2
    assert np.abs(core(state["eta"]) - eta_init).max() < 0.15 * np.abs(eta_init).max()


def test_barotropic_gravity_wave_conserves_volume():
    _, g = grids(16)
    model = T.CubedSphereHydrostaticModel(g, coriolis_rotation_rate=0.0, depth=4000.0)

    def eta0(p):
        n = p / np.linalg.norm(p, axis=-1, keepdims=True)
        return np.exp(-((n[..., 0] - 1.0) ** 2 + n[..., 1] ** 2 + n[..., 2] ** 2) / 0.05)

    state = model.initial_state(eta=eta0)
    core = lambda e: host(e)[:, g.H:g.H + g.N, g.H:g.H + g.N, 0]
    az = core(g._az[(C, C)])
    peak0 = core(state["eta"]).max()
    vol0 = float((core(state["eta"]) * az).sum())
    for _ in range(60):
        state = model.step(state, 600.0)
    eta = core(state["eta"])
    assert np.isfinite(eta).all()
    assert abs(float((eta * az).sum()) - vol0) < 1e-9 * max(1.0, abs(vol0))
    assert eta.max() < 0.7 * peak0


# -- the validation copies -------------------------------------------------------
def jax_twin(script, tm, **kw):
    """The JAX model of ``tm``'s configuration built from the script's
    constants (``kw``)."""
    jg = J.CubedSphereGrid(size=(tm.grid.N, tm.grid.N, 1), radius=tm.grid.radius,
                           dtype=jnp.float64, halo=3)
    return J.CubedSphereHydrostaticModel(jg, **kw)


def two_steps(jm, js, tm, ts, dt):
    with jax.disable_jit():
        for _ in range(2):
            js = jm.step(js, dt)
    for _ in range(2):
        ts = tm.step(ts, dt)
    return js, ts


def test_solid_body_rotation_copy_matches_jax():
    s = solid_body_rotation
    tm = s.model_for(8, DEVICE)
    jm = jax_twin(s, tm, tracers=("c",), depth=1000.0, prescribed_velocities=True)
    u, v = s.velocities(tm.grid)
    js = jm.initial_state(u=jnp.asarray(u), v=jnp.asarray(v), c=s.blob)
    _, dt = s.steps_and_dt(8)
    js, ts = two_steps(jm, js, tm, s.initial_state(tm), dt)
    assert_states(js, ts, ("u", "v", "c", "eta"), RTOL)
    drift, _, cmax, c0max = s.run(8, DEVICE, log=lambda *a: None, steps=2)
    assert drift < 1e-3 and np.isfinite(cmax)


def test_rossby_haurwitz_copy_matches_jax():
    s = rossby_haurwitz
    tm = s.model_for(8, DEVICE)
    jm = jax_twin(s, tm, depth=s.H0, gravitational_acceleration=s.G0)
    js, ts = two_steps(jm, jm.initial_state(u=s.vel, eta=s.eta0), tm,
                       s.initial_state(tm), s.DT)
    assert_states(js, ts, ("u", "v", "eta"), RTOL)
    ratio, _, _, finite = s.run(8, DEVICE, log=lambda *a: None, steps=2)
    assert finite and 0.85 < ratio < 1.15


def test_gravity_waves_copy_matches_jax():
    s = cubed_sphere_gravity_waves
    tm = s.model_for(8, DEVICE)
    jm = jax_twin(s, tm, depth=s.DEPTH, gravitational_acceleration=s.G,
                  coriolis_rotation_rate=0.0)
    js, ts = two_steps(jm, jm.initial_state(eta=s.eta_bump), tm, s.initial_state(tm), s.DT)
    assert_states(js, ts, ("u", "v", "eta"), RTOL)
    _, vol_drift, _ = s.run(8, DEVICE, log=lambda *a: None, t1=s.DT, t2=2 * s.DT)
    assert vol_drift < 1e-12


def test_eddying_aquaplanet_copy_matches_jax():
    s = eddying_aquaplanet
    tm = s.model_for(8, DEVICE)
    jm = jax_twin(s, tm, depth=s.H0, gravitational_acceleration=s.G0)
    dt = s.time_step(8)
    js, ts = two_steps(jm, jm.initial_state(u=s.vel, eta=s.eta_init), tm,
                       s.initial_state(tm), dt)
    assert_states(js, ts, ("u", "v", "eta"), RTOL)
    r = s.run(8, DEVICE, days=(dt / s.DAY, 2 * dt / s.DAY))
    assert r["mass_drift"] < 1e-9 and np.isfinite(r["umax"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_cuda_graph_step_is_the_eager_step(dtype):
    """On the card the step replays a CUDA graph captured at its first
    call of each Δt: bitwise the eager step, over several steps, a tracer
    and a second Δt, with the state it was given left as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = T.CubedSphereGrid(size=(8, 8, 4), z=(-100.0, 0.0), radius=R_E, halo=3,
                          dtype=TDT[dtype], device="cuda")
    graphed = T.CubedSphereHydrostaticModel(g, tracers=("c",), tracer_advection=T.WENO5())
    eager = T.CubedSphereHydrostaticModel(g, tracers=("c",), tracer_advection=T.WENO5(),
                                          cuda_graphs=False)
    init = dict(u=lambda p: vel(p, 1.0), c=lambda p: p[..., 0] / np.linalg.norm(p, axis=-1))
    a, b = graphed.initial_state(**init), eager.initial_state(**init)
    for dt in (50.0, 50.0, 50.0, 20.0, 50.0):
        keep = {k: x.clone() for k, x in a["solution"].items()}
        a2, b = graphed.step(a, dt), eager.step(b, dt)
        assert all(torch.equal(x, keep[k]) for k, x in a["solution"].items())
        a = a2
        for k in ("u", "v", "c"):
            assert torch.equal(a["solution"][k], b["solution"][k]), k
        assert torch.equal(a["eta"], b["eta"])
    # a graph for each (Δt, shapes): the multilevel η takes the z levels of
    # Δz in its first step (the reference's η equation), so that step's
    # graph is one of its own beside the two Δt's
    assert len(graphed._graphs) == 3 and not eager._graphs


def test_cpu_steps_run_eagerly():
    _, tg = grids(8)
    model = T.CubedSphereHydrostaticModel(tg, depth=1000.0)
    assert model.cuda_graphs
    model.step(model.initial_state(eta=0.1), 60.0)
    assert not model._graphs
