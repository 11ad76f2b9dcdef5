"""Port parity: the vertically implicit diffusion (backward-Euler column
solves through T1's plain version on the CPU).

- ``implicit_vertical_diffusion_step`` against the JAX function on a
  stretched (Periodic, Periodic, Bounded) grid, for κ a scalar, a callable
  of z (written with ``jnp`` and with ``torch``), a 1D with-halo column
  and a 3D with-halo array; on centred fields (no walls, Value and
  Gradient walls with scalar and plane values, with and without a
  ``linear_coeff``) and on w; within ``1e-13`` of max|field| (the same
  band trees, but XLA's CPU backend may contract a multiply-add of the
  Thomas sweeps into an FMA);
- ``implicit_step_fields`` of a closure with a per-tracer κ dict and a 3D
  ν moved to the u and v staggering, against JAX;
- the port's counterparts of ``tests/test_implicit_diffusion.py``: the
  dense backward-Euler solve, conservation and decay, w's boundary faces,
  a stable model step far above the explicit limit, Value/Gradient walls
  relaxing to the exact steady profile; and a scalar κ bit for bit the
  same κ as a uniform 3D array (1D against 3D bands).

The step hands the solve views: the interior levels of the field (w's
``Hz+1 : Hz+Nz``) and the same levels of the field's copy as ``out``,
whose halos stay the field's; bit for bit the route through contiguous
copies and a scatter, and within ``RTOL`` of JAX.

The ``cuda`` cases hold the implicit step with T1 on the card against the
plain solve, bit for bit, one launch a solve.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.closures import implicit_vertical_diffusion as tivd
from clima_oceananigans_jl_torch.solvers import tridiagonal as ttri

try:  # the cuda cases also run on a machine without JAX
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs
    from clima_oceananigans_jl_tpu.closures import implicit_vertical_diffusion as jivd
    from clima_oceananigans_jl_tpu.closures.scalar_diffusivity import (
        ScalarDiffusivity as JSD)
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-13
SIZE = (6, 5, 12)


def faces(nz, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([[-8.0], -8.0 + np.cumsum(rng.uniform(0.5, 1.5, nz))])


def grids(size=SIZE, topology=("periodic", "periodic", "bounded"), device=DEVICE):
    z = faces(size[2])
    jg = J.RectilinearGrid(size=size, x=(0, 3), y=(0, 2), z=z, topology=topology,
                           dtype=jnp.float64) if device == DEVICE else None
    tg = T.RectilinearGrid(size=size, x=(0, 3), y=(0, 2), z=z,
                           topology=tuple(T.Topology(t) for t in topology),
                           dtype=torch.float64, device=device)
    return jg, tg


def kappas(kind, tg, rng):
    """(jax κ, port κ) of ``kind``."""
    Zt = tg.total_shape[2]
    if kind == "scalar":
        return 0.7, 0.7
    if kind == "callable":
        return (lambda z: 0.2 + 0.1 * jnp.exp(z / 3.0),
                lambda z: 0.2 + 0.1 * torch.exp(z / 3.0))
    if kind == "column":
        col = 0.1 + rng.uniform(0, 1, Zt)
        return jnp.asarray(col), torch.as_tensor(col)
    arr = 0.1 + rng.uniform(0, 1, tg.total_shape)
    return jnp.asarray(arr), torch.as_tensor(arr)


WALLS = ("none", "value+gradient", "gradient+value plane")


def wall_bcs(walls, shape2):
    """(jax bottom, jax top, port bottom, port top) wall BCs."""
    if walls == "none":
        return None, None, None, None
    plane = np.linspace(1.0, 2.0, shape2[0] * shape2[1]).reshape(shape2)
    if walls == "value+gradient":
        return (jbcs.ValueBC(1.5), jbcs.GradientBC(-0.3), T.ValueBC(1.5),
                T.GradientBC(-0.3))
    return (jbcs.GradientBC(0.4), jbcs.ValueBC(plane), T.GradientBC(0.4),
            T.ValueBC(plane))


def close(ref, got, rtol=RTOL):
    ref, got = np.asarray(ref), got.numpy()
    assert np.abs(ref - got).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("walls", WALLS)
@pytest.mark.parametrize("kind", ["scalar", "callable", "column", "array"])
def test_centred_step_matches_jax(kind, walls, linear):
    jg, tg = grids()
    rng = np.random.default_rng(1)
    jk, tk = kappas(kind, tg, rng)
    data = rng.standard_normal(tg.total_shape)
    lin = -np.abs(rng.standard_normal(tg.total_shape)) if linear else None
    jb, jt, tb, tt = wall_bcs(walls, tg.shape[:2])
    ref = jivd.implicit_vertical_diffusion_step(
        jnp.asarray(data), jg, J.CENTER, jk, 0.9,
        None if lin is None else jnp.asarray(lin), bc_bottom=jb, bc_top=jt)
    got = tivd.implicit_vertical_diffusion_step(
        torch.as_tensor(data), tg, T.CENTER, tk, 0.9,
        None if lin is None else torch.as_tensor(lin), bc_bottom=tb, bc_top=tt)
    close(ref, got)


@pytest.mark.parametrize("kind", ["scalar", "callable", "column", "array"])
def test_w_step_matches_jax_and_keeps_boundary_faces(kind):
    jg, tg = grids()
    rng = np.random.default_rng(2)
    jk, tk = kappas(kind, tg, rng)
    data = rng.standard_normal(tg.total_shape)
    ref = jivd.implicit_vertical_diffusion_step(jnp.asarray(data), jg, J.W_LOC, jk, 0.4)
    got = tivd.implicit_vertical_diffusion_step(torch.as_tensor(data), tg, T.W_LOC, tk, 0.4)
    close(ref, got)
    hz, nz = tg.Hz, tg.Nz
    for k in (hz, hz + nz):  # both boundary faces untouched
        assert torch.equal(got[:, :, k], torch.as_tensor(data[:, :, k]))


def test_implicit_step_fields_matches_jax():
    """A vertically implicit closure with a 3D ν_z (moved to the u and v
    staggering) and a per-tracer κ dict with a callable, on every field,
    Value/Gradient walls included."""
    jg, tg = grids()
    rng = np.random.default_rng(3)
    nu = 0.1 + rng.uniform(0, 1, tg.total_shape)
    jcl = JSD(nu=0.0, kappa=0.0, nu_z=jnp.asarray(nu),
              kappa_z={"b": 0.3, "c": lambda z: 0.2 + 0.05 * jnp.cos(z)},
              time_discretization="vertically_implicit")
    tcl = T.ScalarDiffusivity(nu=0.0, kappa=0.0, nu_z=torch.as_tensor(nu),
                              kappa_z={"b": 0.3, "c": lambda z: 0.2 + 0.05 * torch.cos(z)},
                              time_discretization="vertically_implicit")
    locs = dict(u=T.U_LOC, v=T.V_LOC, w=T.W_LOC, b=T.CENTER, c=T.CENTER)
    # the JAX package tests locations with `is`: give it its own
    jlocs = dict(u=J.U_LOC, v=J.V_LOC, w=J.W_LOC, b=J.CENTER, c=J.CENTER)
    sol = {n: rng.standard_normal(tg.total_shape) for n in locs}
    jbc = {"b": jbcs.FieldBCs(bottom=jbcs.ValueBC(0.5), top=jbcs.GradientBC(0.1))}
    tbc = {"b": T.FieldBCs(bottom=T.ValueBC(0.5), top=T.GradientBC(0.1))}
    ref = jivd.implicit_step_fields({n: jnp.asarray(x) for n, x in sol.items()}, jg,
                                    jlocs, jcl, 0.6, bcs=jbc)
    got = tivd.implicit_step_fields({n: torch.as_tensor(x) for n, x in sol.items()},
                                    tg, locs, tcl, 0.6, bcs=tbc)
    for n in locs:
        close(ref[n], got[n])


@pytest.mark.parametrize("closure", [None, "explicit", "implicit", "tuple"])
def test_implicit_step_is_noop(closure):
    imp = T.ScalarDiffusivity(nu=1.0, time_discretization="vertically_implicit")
    cl = {None: None, "explicit": T.ScalarDiffusivity(nu=1.0), "implicit": imp,
          "tuple": (T.AnisotropicMinimumDissipation(), imp)}[closure]
    assert tivd.implicit_step_is_noop(cl) == (closure in (None, "explicit"))
    assert tivd.implicit_step_is_noop(cl) == jivd.implicit_step_is_noop(
        None if cl is None else cl)


@pytest.mark.parametrize("loc", ["centre", "w"])
def test_scalar_kappa_bitwise_uniform_3d_kappa(loc):
    """A scalar κ (1D bands) and the same κ as a uniform 3D array (3D
    bands) give the same solution bit for bit."""
    _, tg = grids()
    data = torch.as_tensor(np.random.default_rng(4).standard_normal(tg.total_shape))
    location = T.CENTER if loc == "centre" else T.W_LOC
    a = tivd.implicit_vertical_diffusion_step(data, tg, location, 0.35, 0.8)
    b = tivd.implicit_vertical_diffusion_step(
        data, tg, location, torch.full(tg.total_shape, 0.35, dtype=torch.float64), 0.8)
    assert torch.equal(a, b)


def column_grid(nz, z):
    return T.RectilinearGrid(size=(1, 1, nz), x=(0, 1), y=(0, 1), z=z,
                             topology=(T.FLAT, T.FLAT, T.BOUNDED),
                             dtype=torch.float64, device=DEVICE)


def test_implicit_solve_matches_dense_backward_euler():
    """One implicit step equals the dense (I − Δt L) solve on a stretched
    column (``tests/test_implicit_diffusion.py:18``)."""
    Nz, kappa, dt = 17, 0.7, 0.3
    z = np.concatenate([[0.0], np.cumsum(np.random.RandomState(0).uniform(0.5, 1.5, Nz))])
    g = column_grid(Nz, z)
    c0 = np.random.RandomState(1).randn(Nz)
    data = g.zeros()
    data[0, 0, g.Hz:g.Hz + Nz] = torch.as_tensor(c0)
    got = tivd.implicit_vertical_diffusion_step(data, g, T.CENTER, kappa, dt)
    got = got[0, 0, g.Hz:g.Hz + Nz].numpy()
    dzc = g._axes[2].dc[g.Hz:g.Hz + Nz].numpy()
    dzf = g._axes[2].df[g.Hz:g.Hz + Nz + 1].numpy()
    L = np.zeros((Nz, Nz))
    for k in range(Nz):
        if k > 0:
            L[k, k - 1] += kappa / (dzc[k] * dzf[k])
            L[k, k] -= kappa / (dzc[k] * dzf[k])
        if k < Nz - 1:
            L[k, k + 1] += kappa / (dzc[k] * dzf[k + 1])
            L[k, k] -= kappa / (dzc[k] * dzf[k + 1])
    assert np.allclose(got, np.linalg.solve(np.eye(Nz) - dt * L, c0), atol=1e-12)


def test_implicit_diffusion_conserves_tracer_and_decays():
    """Neumann walls conserve ∫c dz; the variance decays, stable at a huge
    Δt (``tests/test_implicit_diffusion.py:46``)."""
    Nz = 32
    g = column_grid(Nz, (0, 1))
    z = g.coord(2, T.C).numpy()
    c0 = np.cos(np.pi * z)
    out = g.zeros()
    out[0, 0, g.Hz:g.Hz + Nz] = torch.as_tensor(c0)
    dzc = g._axes[2].dc[g.Hz:g.Hz + Nz].numpy()
    for _ in range(10):
        out = tivd.implicit_vertical_diffusion_step(out, g, T.CENTER, 1.0, 0.5)
    got = out[0, 0, g.Hz:g.Hz + Nz].numpy()
    assert abs(np.sum(got * dzc) - np.sum(c0 * dzc)) < 1e-12
    assert np.sum(got ** 2) < 1e-3 * np.sum(c0 ** 2)


def test_implicit_w_solve_preserves_boundary_faces():
    """``tests/test_implicit_diffusion.py:64``."""
    Nz = 16
    g = column_grid(Nz, (0, 1))
    data = g.zeros()
    data[0, 0, g.Hz + 1: g.Hz + Nz] = torch.as_tensor(np.random.RandomState(2).randn(Nz - 1))
    out = tivd.implicit_vertical_diffusion_step(data, g, T.W_LOC, 0.5, 0.2)
    assert float(out[0, 0, g.Hz]) == 0.0 and float(out[0, 0, g.Hz + Nz]) == 0.0
    assert not torch.allclose(out[0, 0, g.Hz + 1: g.Hz + Nz],
                              data[0, 0, g.Hz + 1: g.Hz + Nz])


@pytest.mark.parametrize("timestepper", ["QuasiAdamsBashforth2", "RungeKutta3"])
def test_model_with_vertically_implicit_closure_runs_stably(timestepper):
    """κ_z = 10 m²/s and Δt = 50 s, far above the explicit limit
    (``tests/test_implicit_diffusion.py:78``, on a (Periodic, Periodic,
    Bounded) 3×3×32 grid)."""
    g = T.RectilinearGrid(size=(3, 3, 32), x=(0, 1), y=(0, 1), z=(0, 100),
                          topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                          dtype=torch.float64, device=DEVICE)
    model = T.NonhydrostaticModel(
        g, tracers=("T",), timestepper=timestepper,
        closure=T.ScalarDiffusivity(nu=1e-2, kappa=1e-2, nu_z=10.0, kappa_z=10.0,
                                    time_discretization="vertically_implicit"))
    state = model.initial_state(T=lambda x, y, z: 20.0 + 1e-2 * z)
    for _ in range(5):
        state = model.step(state, 50.0)
    Tf = model.grid.interior(state["solution"]["T"]).numpy()
    assert np.all(np.isfinite(Tf))
    assert Tf.min() >= 20.0 - 1e-8 and Tf.max() <= 21.0 + 1e-8
    assert np.std(Tf[0, 0]) < np.std(20.0 + 1e-2 * g.coord(2, T.C).numpy())


def test_implicit_solve_honors_value_and_gradient_walls():
    """A diffusion-only column relaxes to the exact steady profiles of its
    Value and Gradient walls (``tests/test_implicit_diffusion.py:97``)."""
    nz, kappa = 32, 0.5
    g = T.RectilinearGrid(size=(4, 3, nz), x=(0, 1), y=(0, 1), z=(0.0, 1.0),
                          topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                          dtype=torch.float64, device=DEVICE)
    model = T.NonhydrostaticModel(
        g, tracers=("c", "d"),
        closure=T.ScalarDiffusivity(nu=0.0, kappa=kappa,
                                    time_discretization="vertically_implicit"),
        boundary_conditions={
            "c": T.FieldBCs(bottom=T.ValueBC(1.0), top=T.ValueBC(3.0)),
            "d": T.FieldBCs(bottom=T.ValueBC(2.0), top=T.GradientBC(4.0))})
    assert model.fused_step
    state = model.initial_state()
    for _ in range(500):
        state = model.step(state, 0.05)
    zc = model.grid.coord(2, T.C).numpy()
    c = model.grid.interior(state["solution"]["c"]).numpy().mean((0, 1))
    d = model.grid.interior(state["solution"]["d"]).numpy().mean((0, 1))
    assert np.abs(c - (1.0 + 2.0 * zc)).max() < 1e-8
    assert np.abs(d - (2.0 + 4.0 * zc)).max() < 1e-8


def contiguous_route(a, b, c, d, out):
    """The solve as the step called it before it passed views: contiguous
    copies of the bands and the right-hand side, the solution scattered
    into ``out``."""
    out[...] = ttri.solve_batched_tridiagonal_reference(
        *(x.contiguous() for x in (a, b, c, d)))
    return out


@pytest.mark.parametrize("loc", ["centre", "w"])
@pytest.mark.parametrize("case", ["scalar", "array", "walls", "linear"])
def test_step_solves_views_into_the_fields_copy(case, loc):
    """The solve gets the field's interior levels as a view of ``data`` (a
    copy only where a wall changes the right-hand side) and writes a view
    of the returned field, whose halos are ``data``'s; the result is bit
    for bit the contiguous route's and within RTOL of JAX."""
    jg, tg = grids()
    rng = np.random.default_rng(6)
    jk, tk = kappas("array" if case == "array" else "scalar", tg, rng)
    data = torch.as_tensor(rng.standard_normal(tg.total_shape))
    location, jloc = (T.CENTER, J.CENTER) if loc == "centre" else (T.W_LOC, J.W_LOC)
    lin = (-np.abs(rng.standard_normal(tg.total_shape)) if case == "linear" and loc == "centre"
           else None)
    jb, jt, tb, tt = (wall_bcs("value+gradient", tg.shape[:2]) if case == "walls"
                      and loc == "centre" else (None,) * 4)
    seen = []

    def spy(a, b, c, d, out):
        seen.append((d, out))
        return ttri.solve_batched_tridiagonal(a, b, c, d, out=out)

    kw = dict(bc_bottom=tb, bc_top=tt)
    tlin = None if lin is None else torch.as_tensor(lin)
    got = tivd.implicit_vertical_diffusion_step(data, tg, location, tk, 0.7, tlin,
                                                solve=spy, **kw)
    (d, out), = seen
    hz, nz = tg.Hz, tg.Nz
    k0, k1 = (hz, hz + nz) if loc == "centre" else (hz + 1, hz + nz)
    assert out.data_ptr() == got[:, :, k0:k1].data_ptr() and out.stride() == got.stride()
    if case != "walls" or loc == "w":
        assert d.data_ptr() == data[:, :, k0:k1].data_ptr()
    for sl in (slice(0, k0), slice(k1, None)):
        assert torch.equal(got[:, :, sl], data[:, :, sl])
    assert torch.equal(got, tivd.implicit_vertical_diffusion_step(
        data, tg, location, tk, 0.7, tlin, solve=contiguous_route, **kw))
    ref = jivd.implicit_vertical_diffusion_step(
        jnp.asarray(data.numpy()), jg, jloc, jk, 0.7,
        None if lin is None else jnp.asarray(lin), bc_bottom=jb, bc_top=jt)
    close(ref, got)


# -- on the card --------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["scalar", "array"])
def test_cuda_implicit_step_through_t1_is_bitwise_plain(kind, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    z = faces(29)
    g = T.RectilinearGrid(size=(67, 45, 29), x=(0, 3), y=(0, 2), z=z,
                          topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED), dtype=dtype)
    rng = np.random.default_rng(5)
    kap = (0.7 if kind == "scalar" else
           torch.as_tensor(0.1 + rng.uniform(0, 1, g.total_shape), dtype=dtype, device="cuda"))
    data = torch.as_tensor(rng.standard_normal(g.total_shape), dtype=dtype, device="cuda")
    for loc, bot, top in ((T.CENTER, T.ValueBC(1.5), T.GradientBC(-0.3)),
                          (T.CENTER, None, None), (T.W_LOC, None, None)):
        got = tivd.implicit_vertical_diffusion_step(data, g, loc, kap, 0.9, bc_bottom=bot, bc_top=top)
        ref = tivd.implicit_vertical_diffusion_step(
            data, g, loc, kap, 0.9, bc_bottom=bot, bc_top=top,
            solve=ttri.solve_batched_tridiagonal_reference)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["scalar", "array", "walls", "linear"])
def test_cuda_implicit_step_views_one_launch(case, dtype):
    """The step on the card at the ¼° grid's 24 levels (one chunk) and at
    33 (several chunks), centred and w: bit for bit the plain solve, one T1
    launch a solve, the halos the field's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    for nz in (24, 33):
        g = T.RectilinearGrid(size=(45, 38, nz), x=(0, 3), y=(0, 2), z=faces(nz),
                              topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED), dtype=dtype)
        kap = (torch.as_tensor(0.1 + rng.uniform(0, 1, g.total_shape), dtype=dtype,
                               device="cuda") if case == "array" else 0.7)
        lin = (-torch.as_tensor(np.abs(rng.standard_normal(g.total_shape)), dtype=dtype,
                                device="cuda") if case == "linear" else None)
        walls = ((T.ValueBC(1.5), T.GradientBC(-0.3)) if case == "walls" else (None, None))
        data = torch.as_tensor(rng.standard_normal(g.total_shape), dtype=dtype, device="cuda")
        for loc in (T.CENTER, T.W_LOC):
            lc = lin if loc is T.CENTER else None
            bot, top = walls if loc is T.CENTER else (None, None)
            n = ttri.solve_batched_tridiagonal.launches
            got = tivd.implicit_vertical_diffusion_step(data, g, loc, kap, 0.9, lc,
                                                        bc_bottom=bot, bc_top=top)
            torch.cuda.synchronize()
            assert ttri.solve_batched_tridiagonal.launches == n + 1
            ref = tivd.implicit_vertical_diffusion_step(
                data, g, loc, kap, 0.9, lc, bc_bottom=bot, bc_top=top,
                solve=ttri.solve_batched_tridiagonal_reference)
            assert torch.equal(got, ref)
