"""Port parity: the nonhydrostatic model decomposed over a mesh of shards
(``parallel/``: ``DistributedModel``, the halo exchange, the pencil
Poisson solvers), held against the JAX package's ``DistributedModel`` on
the same mesh (JAX's virtual 8-device CPU mesh of ``conftest.py``; the
port's shards are threads on the CPU), and against the port's own
single-device model.

Tolerances:
- the rank-id halo exchange, the scatter and the gather: exact (copies);
- the decomposed steps against JAX's: 1e-12 of max|ref| after 3 steps
  (``PENCIL_RTOL``): torch.fft and jnp.fft are different FFT libraries,
  and both pencil solves run complex FFTs where the port's single-device
  solve runs a real one on its first periodic axis;
- decomposed against single-device in the port: the same 1e-12;
- the halo-overlap step against the plain decomposed step: bit for bit
  (the same arithmetic on every point, strips recomputed from the same
  exchanged fields), as the JAX package holds its overlap to its plain
  step.

The ``cuda`` cases hold the decomposed step's kernels against their
plain versions on the card (``python -m pytest --noconftest -m cuda
tests/test_torch_distributed_nonhydrostatic.py``).
"""
import threading

import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.boundary_conditions import bcs as tbcs
from clima_oceananigans_jl_torch.ops import fused_fill as tff
from clima_oceananigans_jl_torch.parallel import decomposition as tdec
from clima_oceananigans_jl_torch.parallel.distributed_fft import (
    DistributedFFTPoissonSolver)
from clima_oceananigans_jl_torch.parallel.mesh import all_to_all, psum

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp
    from jax import lax

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs
    from clima_oceananigans_jl_tpu.parallel import decomposition as jdec
    from clima_oceananigans_jl_tpu.parallel import distributed as jdist
except ImportError:
    pass

torch.set_num_threads(1)

#: decomposed against JAX's decomposed, and against the single-device
#: model: the largest |Δ| over max|ref| after the steps (FFT rounding)
PENCIL_RTOL = 1e-12
DEVICE = "cpu"


def _grid(P, size=(16, 16, 8), topology=("periodic", "periodic", "periodic"),
          z=None):
    kw = dict(size=size, topology=tuple(P.Topology(t) for t in topology))
    if z is None:
        kw["extent"] = (1.0, 1.0, 1.0)
    else:
        kw.update(x=(0.0, 1.0), y=(0.0, 1.0), z=z)
    if P is J:
        kw["dtype"] = jnp.float64
    else:
        kw.update(dtype=torch.float64, device=DEVICE)
    return P.RectilinearGrid(**kw)


def _fields(shape, names, seed, scale=None):
    rng = np.random.default_rng(seed)
    scale = scale or {}
    return {n: scale.get(n, 1.0) * rng.standard_normal(shape) for n in names}


def _both(make, values, meshes=((2, 2),), overlap=False, steps=3, dt=1e-3):
    """The JAX and port models from ``make(P)``, their states from
    ``values``, each stepped decomposed on every mesh of ``meshes``;
    returns (jax model, port model, port single-device state, {mesh: (jax
    gathered, port gathered)})."""
    jm, tm = make(J), make(T)
    js = jm.initial_state(**{k: jnp.asarray(v) for k, v in values.items()})
    ts = tm.initial_state(**{k: torch.tensor(v) for k, v in values.items()})
    single = ts
    for _ in range(steps):
        single = tm.step(single, dt)
    out = {}
    for shape in meshes:
        jd = jdist.DistributedModel(jm, jdist.make_mesh(shape), overlap_halo=overlap)
        sj = jd.scatter_state(js)
        for _ in range(steps):
            sj = jd.step(sj, jnp.float64(dt))
        td = T.DistributedModel(tm, T.make_mesh(shape, "cpu"), overlap_halo=overlap)
        st = td.scatter_state(ts)
        for _ in range(steps):
            st = td.step(st, dt)
        out[shape] = (jd.gather_state(sj), td.gather_state(st))
    return jm, tm, single, out


def _close(a, b, rtol=PENCIL_RTOL, what=""):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(a).max(), 1e-300)
    err = np.abs(a - b).max()
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def _interior(grid, x):
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny,
             grid.Hz:grid.Hz + grid.Nz]


# -- the exchange, the scatter, the gather ------------------------------------------

@pytest.mark.parametrize("mesh_shape", [(4, 1), (1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("topo_x", ["periodic", "bounded"])
def test_rank_id_halo_exchange_matches_jax_exactly(mesh_shape, topo_x):
    """Each shard's interior holds its rank, the fill exchanges: every
    with-halo point of every shard (corners included) is JAX's."""
    from jax.sharding import PartitionSpec as Pspec
    Rx, Ry = mesh_shape
    topo = (topo_x, "periodic", "bounded")
    jg = _grid(J, (8 * Rx, 8 * Ry, 2), topo)
    tg = _grid(T, (8 * Rx, 8 * Ry, 2), topo)
    stacked, specs, local = jdec.partition_grid(jg, mesh_shape)
    jb = jbcs.regularize_bcs(local, J.CENTER)

    def f(g, _):
        rank = (lax.axis_index("x") * Ry + lax.axis_index("y")).astype(jnp.float64)
        data = jnp.zeros(local.total_shape, jnp.float64)
        sl = tuple(slice(h, h + n) for h, n in zip(local.halo, local.shape))
        return jbcs.fill_halos(data.at[sl].set(rank), g, J.CENTER, jb)

    out = np.asarray(jax.jit(jdist.shard_map(
        f, mesh=jdist.make_mesh(mesh_shape), in_specs=(specs, Pspec()),
        out_specs=Pspec("x", "y")))(stacked, jnp.zeros((), jnp.float64)))

    mesh = T.make_mesh(mesh_shape, "cpu")
    grids = tdec.partition_grid(tg, mesh_shape, mesh.devices)
    tb = tbcs.regularize_bcs(grids[0], T.CENTER)

    def g(r):
        d = torch.zeros(grids[r].total_shape, dtype=torch.float64)
        d[grids[r].interior_slices] = float(r)
        return tbcs.fill_halos(d, grids[r], T.CENTER, tb)

    blocks = mesh.run(g)
    lx, ly = local.total_shape[:2]
    for r, blk in enumerate(blocks):
        i, j = mesh.coords(r)
        ref = out[i * lx:(i + 1) * lx, j * ly:(j + 1) * ly]
        np.testing.assert_array_equal(blk.numpy(), ref, err_msg=str((i, j)))


def test_exchange_counts_and_bytes():
    """One exchange of two fields: one collective, each shard moving its
    four halo slabs of each field."""
    tg = _grid(T, (16, 16, 4), ("periodic", "periodic", "bounded"))
    mesh = T.make_mesh((2, 2), "cpu")
    grids = tdec.partition_grid(tg, (2, 2), mesh.devices)
    from clima_oceananigans_jl_torch.parallel.halo_exchange import exchange_axis

    def f(r):
        a = [torch.zeros(grids[r].total_shape, dtype=torch.float64) for _ in range(2)]
        exchange_axis(a, 0, 3, "x", 2, True)

    mesh.run(f)
    slab = 3 * grids[0].total_shape[1] * grids[0].total_shape[2] * 8
    assert mesh.counts == {"exchange": 1}
    assert mesh.copies == {"exchange": 4 * 2 * 2}
    assert mesh.bytes["exchange"] == 4 * 2 * 2 * slab


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8)])
def test_scatter_gather_roundtrip_matches_jax(mesh_shape):
    """The blocks are JAX's stacked blocks, and the gather gives the
    array back, halos included, exactly."""
    jg = _grid(J, (16, 16, 4), ("periodic", "periodic", "bounded"))
    tg = _grid(T, (16, 16, 4), ("periodic", "periodic", "bounded"))
    arr = np.random.default_rng(0).standard_normal(tg.total_shape)
    arr = np.asarray(jbcs.fill_halos(jnp.asarray(arr), jg, J.CENTER,
                                     jbcs.regularize_bcs(jg, J.CENTER)))
    stacked = np.asarray(jdec.scatter_array(jnp.asarray(arr), jg, mesh_shape))
    blocks = tdec.scatter_array(torch.tensor(arr), tg, mesh_shape)
    Rx, Ry = mesh_shape
    lx, ly = blocks[0].shape[:2]
    for r, blk in enumerate(blocks):
        i, j = divmod(r, Ry)
        np.testing.assert_array_equal(
            blk.numpy(), stacked[i * lx:(i + 1) * lx, j * ly:(j + 1) * ly])
    np.testing.assert_array_equal(tdec.gather_array(blocks, tg, mesh_shape).numpy(), arr)
    np.testing.assert_array_equal(
        np.asarray(jdec.gather_array(jnp.asarray(stacked), jg, mesh_shape)), arr)


def test_partition_keeps_global_coordinates():
    tg = _grid(T, (16, 16, 4), ("bounded", "periodic", "bounded"))
    grids = tdec.partition_grid(tg, (2, 2))
    for r, g in enumerate(grids):
        i, j = divmod(r, 2)
        assert g.topology[:2] == (T.FULLY_CONNECTED, T.FULLY_CONNECTED)
        assert g.dist == (("x", 2, T.BOUNDED), ("y", 2, T.PERIODIC), None)
        torch.testing.assert_close(g._axes[0].cc, tg._axes[0].cc[8 * i:8 * i + 14],
                                   rtol=0, atol=0)
        assert g.Lx == tg.Lx / 2


# -- the collectives --------------------------------------------------------------

def test_all_to_all_and_psum_match_their_definitions():
    mesh = T.make_mesh((2, 2), "cpu")
    xs = [torch.arange(4 * 2 * 4, dtype=torch.float64).reshape(4, 2, 4) + 100 * r
          for r in range(4)]

    def f(r):
        y = all_to_all(xs[r], "x", split_axis=2, concat_axis=0)
        s = psum(xs[r].sum(), ("x", "y"))
        sx = psum(xs[r].sum(), ("x",))
        return y, s, sx

    out = mesh.run(f)
    for r, (y, s, sx) in enumerate(out):
        i, j = mesh.coords(r)
        srcs = [mesh.rank_of(k, j) for k in range(2)]
        ref = torch.cat([xs[q][:, :, 2 * i:2 * i + 2] for q in srcs], 0)
        assert torch.equal(y, ref)
        total = xs[0].sum() + xs[1].sum() + xs[2].sum() + xs[3].sum()
        assert torch.equal(s, total)
        assert torch.equal(sx, xs[srcs[0]].sum() + xs[srcs[1]].sum())


def test_a_failing_shard_raises_and_does_not_hang():
    """A shard that fails while the others wait in a collective: the
    others are woken and give up, ``run`` raises the shard's error, and the mesh
    runs again after it."""
    mesh = T.make_mesh((2, 2), "cpu", timeout=30.0)

    def f(r):
        if r == 2:
            raise KeyError("shard 2 failed")
        return psum(torch.ones(()), ("x", "y"))

    with pytest.raises(KeyError, match="shard 2"):
        mesh.run(f)
    out = mesh.run(lambda r: psum(torch.ones(()), ("x", "y")))
    assert all(float(o) == 4.0 for o in out)
    assert threading.active_count() < 20


def test_a_missing_collective_raises():
    """A shard that skips a collective: the other raises at once."""
    mesh = T.make_mesh((2, 1), "cpu", timeout=30.0)
    with pytest.raises(RuntimeError, match="called different collectives"):
        mesh.run(lambda r: psum(torch.ones(()), ("x",)) if r == 0 else None)


def test_a_late_shard_times_out():
    """A shard that does not reach the collective within the timeout."""
    import time
    mesh = T.make_mesh((2, 1), "cpu", timeout=0.3)

    def f(r):
        if r == 1:
            time.sleep(1.0)
        return psum(torch.ones(()), ("x",))

    with pytest.raises(RuntimeError, match="collective waited longer"):
        mesh.run(f)


def test_make_mesh_refuses_more_shards_than_devices():
    with pytest.raises(ValueError, match="needs 4 devices"):
        T.make_mesh((2, 2), [torch.device("cpu")] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices are visible"):
            T.make_mesh((2, 2))
    assert T.make_mesh((2, 2), [torch.device("cpu")] * 4).size == 4


def test_pencil_solver_refuses_nz_off_the_mesh():
    tg = _grid(T, (16, 16, 6), ("periodic", "periodic", "bounded"))
    grids = tdec.partition_grid(tg, (4, 1))
    with pytest.raises(ValueError, match="Nz=6 must divide the mesh 4x1"):
        DistributedFFTPoissonSolver.build(grids[0])


# -- the fills: K6's staging beside the exchange ------------------------------------

def _k6_stand_in(grid, fields, edges=None):
    """The plain meaning of one K6 launch on a cut grid: each field's axes
    in the fill order, a cut axis only on the sides ``edges`` marks."""
    for data, loc, bcs, axes, t in fields:
        bcs = bcs if bcs is not None else tbcs.default_bcs(grid, loc)
        pairs = ((bcs.west, bcs.east), (bcs.south, bcs.north), (bcs.bottom, bcs.top))
        for axis in tff.fill_order(grid):
            if axis not in axes:
                continue
            if grid.topology[axis] is T.FULLY_CONNECTED:
                side = edges[axis] if edges is not None else (False, False)
                for s in (0, 1):
                    if side[s]:
                        slab, cut = tbcs._bounded_slab(data, grid, loc, axis, s,
                                                       pairs[axis][s], t)
                        if slab is not None:
                            sl = [slice(None)] * 3
                            sl[axis] = slice(0, cut) if s == 0 else slice(cut, None)
                            data[tuple(sl)] = slab
                continue
            tbcs.fill_halos_axis(data, grid, loc, axis, *pairs[axis], t=t)
    tff.fused_fill_halos.launches += 1
    return [f[0] for f in fields]


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("topo", [("periodic", "periodic", "bounded"),
                                  ("bounded", "periodic", "bounded"),
                                  ("periodic", "bounded", "bounded")])
def test_staged_fill_is_the_plain_fill(monkeypatch, mesh_shape, topo):
    """``fused_fill_halos``' staging on a cut grid (a run of local axes one
    launch, a cut axis one exchange and its physical sides) with a plain
    stand-in for one K6 launch: every halo point of u, v, w and a tracer
    with value walls is the plain field-by-field fill's, and the launches
    are as many as the runs."""
    monkeypatch.setattr(tff, "_launch", _k6_stand_in)
    tg = _grid(T, (16, 16, 8), topo)
    mesh = T.make_mesh(mesh_shape, "cpu")
    grids = tdec.partition_grid(tg, mesh_shape, mesh.devices)
    g0 = grids[0]
    c_bcs = tbcs.regularize_bcs(g0, T.CENTER, T.FieldBCs(
        west=T.ValueBC(1.5), east=T.GradientBC(0.3), south=T.ValueBC(-0.5),
        bottom=T.ValueBC(2.0), top=T.ValueBC(lambda x, y, t: x + 2 * y)))
    specs = [(T.U_LOC, tbcs.regularize_bcs(g0, T.U_LOC)),
             (T.V_LOC, tbcs.regularize_bcs(g0, T.V_LOC)),
             (T.W_LOC, tbcs.regularize_bcs(g0, T.W_LOC)), (T.CENTER, c_bcs)]
    rng = np.random.default_rng(5)
    data = [[torch.tensor(rng.standard_normal(g.total_shape)) for _ in specs]
            for g in grids]
    tff.fused_fill_halos.launches = 0

    def f(r):
        g = grids[r]
        staged = [d.clone() for d in data[r]]
        plain = [d.clone() for d in data[r]]
        tff._fill_cut_grid(g, [(d, loc, b, (0, 1, 2), 0.5)
                               for d, (loc, b) in zip(staged, specs)])
        tff.fused_fill_halos_reference(g, [(d, loc, b, (0, 1, 2), 0.5)
                                           for d, (loc, b) in zip(plain, specs)])
        return staged, plain

    for staged, plain in mesh.run(f):
        for a, b in zip(staged, plain):
            assert torch.equal(a, b)
    if topo == ("periodic", "periodic", "bounded"):
        # (2, 2): the x and y exchanges, then z: one launch a shard; (4, 1):
        # y, the x exchange, z: two (and (1, 4) likewise)
        runs = 1 if mesh_shape == (2, 2) else 2
        assert tff.fused_fill_halos.launches == 4 * runs


def test_k6_gate_keeps_a_cut_axis():
    tg = _grid(T, (16, 16, 8), ("periodic", "periodic", "bounded"))
    g = tdec.partition_grid(tg, (2, 2))[0]
    ints, _ = tff.fill_plan(g, T.W_LOC, tbcs.regularize_bcs(g, T.W_LOC),
                            (0, 1, 2), g.total_shape)
    assert ints[0][5:7] == (tff.KEEP, tff.KEEP) and ints[1][5:7] == (tff.KEEP, tff.KEEP)
    assert ints[2][5:7] == (tff.MIRROR_F, tff.MIRROR_F)
    tb = _grid(T, (16, 16, 8), ("bounded", "periodic", "bounded"))
    gb = tdec.partition_grid(tb, (2, 2))[0]
    ints, _ = tff.fill_plan(gb, T.U_LOC, tbcs.regularize_bcs(gb, T.U_LOC),
                            (0,), gb.total_shape,
                            [(True, False), (False, False), (False, False)])
    assert ints[0][5:7] == (tff.MIRROR_F, tff.KEEP)


# -- the gates ----------------------------------------------------------------------

def test_gates_decide_on_a_cut_axis():
    """The cut shards take the general AB2 branch and the general
    projection (K1 and the roll-based projection assume one shard), the
    pencil solver, and their local models pass the card's K6 gate."""
    from clima_oceananigans_jl_torch.parallel.distributed_fft import (
        DistributedFourierTridiagonalSolver)
    tm = T.NonhydrostaticModel(_grid(T, topology=("periodic", "periodic", "bounded")),
                               advection=T.WENO5(), tracers=("c",))
    assert tm.fused_step
    dm = T.DistributedModel(tm, T.make_mesh((2, 2), "cpu"))
    for m in dm.local_models:
        assert not m.fused_step and not m._fast_projection_ok()
        assert isinstance(m.pressure_solver, DistributedFFTPoissonSolver)
        assert m.card_unsupported_reason() is None
    z = -np.cos(np.linspace(0, np.pi / 2, 9))
    ts = T.NonhydrostaticModel(_grid(T, topology=("periodic", "periodic", "bounded"),
                                     z=z))
    dm = T.DistributedModel(ts, T.make_mesh((2, 2), "cpu"))
    assert isinstance(dm.local_model.pressure_solver, DistributedFourierTridiagonalSolver)
    with pytest.raises(NotImplementedError, match="particles"):
        T.DistributedModel(T.NonhydrostaticModel(
            _grid(T), particles=T.LagrangianParticles(
                torch.zeros(2), torch.zeros(2), torch.zeros(2))),
            T.make_mesh((2, 2), "cpu"))


# -- the decomposed steps against JAX's ---------------------------------------------

def _make_fft(P):
    return P.NonhydrostaticModel(_grid(P), tracers=("c",))


def test_distributed_fft_matches_jax_and_single_device():
    """test_distributed_nonhydrostatic_fft_matches_single_device's
    configuration on three meshes; the corrected velocity is discretely
    divergence-free."""
    values = _fields((16, 16, 8), ("u", "v", "c"), 1, {"u": 1e-2, "v": 1e-2})
    jm, tm, single, out = _both(_make_fft, values, meshes=((2, 2), (4, 1), (1, 4)))
    g = tm.grid
    for shape, (sj, st) in out.items():
        for name in ("u", "v", "w", "c"):
            _close(_interior(g, sj["solution"][name]), _interior(g, st["solution"][name]),
                   what=f"{shape} {name} vs JAX")
            _close(_interior(g, single["solution"][name]),
                   _interior(g, st["solution"][name]), what=f"{shape} {name} vs single")
    sol = out[(2, 2)][1]["solution"]
    from clima_oceananigans_jl_torch.ops import operators as op
    div = g.interior(op.div_ccc(sol["u"], sol["v"], sol["w"], g))
    assert float(div.abs().max()) < 1e-12


def test_distributed_fourier_tridiagonal_matches_jax():
    z = -np.cos(np.linspace(0, np.pi / 2, 9))

    def make(P):
        return P.NonhydrostaticModel(_grid(P, topology=("periodic", "periodic",
                                                        "bounded"), z=z))

    values = _fields((16, 16, 8), ("u", "v"), 2, {"u": 1e-2, "v": 1e-2})
    _, tm, single, out = _both(make, values)
    g = tm.grid
    sj, st = out[(2, 2)]
    for name in ("u", "v", "w"):
        _close(_interior(g, sj["solution"][name]), _interior(g, st["solution"][name]),
               what=name)
        _close(_interior(g, single["solution"][name]), _interior(g, st["solution"][name]),
               what=f"{name} single")


def test_distributed_bounded_x_weno_rk3_matches_jax():
    """A bounded global x cut over the mesh (``select_edge``: the end
    shards write the walls), WENO5, buoyancy, Coriolis and diffusion, RK3:
    the flagship's terms on (B, P, B)."""
    def make(P):
        return P.NonhydrostaticModel(
            _grid(P, topology=("bounded", "periodic", "bounded")),
            advection=P.WENO5(), buoyancy=P.BuoyancyTracer(),
            coriolis=P.FPlane(f=1e-4),
            closure=P.ScalarDiffusivity(nu=1e-3, kappa=1e-3),
            timestepper="RungeKutta3")

    values = _fields((16, 16, 8), ("u", "v", "b"), 3, {"u": 1e-2, "v": 1e-2, "b": 1e-3})
    _, tm, single, out = _both(make, values, meshes=((2, 2), (4, 1)), steps=2,
                               dt=5e-4)
    g = tm.grid
    for shape, (sj, st) in out.items():
        for name in ("u", "v", "w", "b"):
            _close(_interior(g, sj["solution"][name]), _interior(g, st["solution"][name]),
                   what=f"{shape} {name}")


def test_distributed_immersed_matches_jax():
    """test_distributed_immersed_matches_single_device's configuration:
    per-shard masks sliced from the global ones."""
    def bump(x, y):
        if isinstance(x, torch.Tensor):
            return -1.0 + 0.4 * torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02)
        return -1.0 + 0.4 * jnp.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02)

    def make(P):
        return P.NonhydrostaticModel(_grid(P, topology=("periodic", "periodic", "bounded")),
                                     tracers=("c",),
                                     immersed_boundary=P.GridFittedBottom(bump))

    values = _fields((16, 16, 8), ("u", "c"), 4, {"u": 1e-2})
    _, tm, single, out = _both(make, values)
    g = tm.grid
    sj, st = out[(2, 2)]
    for name in ("u", "v", "w", "c"):
        _close(_interior(g, sj["solution"][name]), _interior(g, st["solution"][name]),
               what=name)
        _close(_interior(g, single["solution"][name]), _interior(g, st["solution"][name]),
               what=f"{name} single")


# -- the halo-overlap step ----------------------------------------------------------

def _port_runs(make, values, shape=(2, 2), steps=3, dt=5e-4):
    tm = make(T)
    ts = tm.initial_state(**{k: torch.tensor(v) for k, v in values.items()})
    runs = {}
    for overlap in (False, True):
        td = T.DistributedModel(tm, T.make_mesh(shape, "cpu"), overlap_halo=overlap)
        s = td.scatter_state(ts)
        for _ in range(steps):
            s = td.step(s, dt)
        runs[overlap] = td.gather_state(s)
    single = ts
    for _ in range(steps):
        single = tm.step(single, dt)
    return tm, single, runs


@pytest.mark.parametrize("stepper", ["QuasiAdamsBashforth2", "RungeKutta3"])
def test_overlap_halo_is_bitwise_the_plain_decomposed_step(stepper):
    """test_overlap_halo_step_matches_single_device and its RK3 twin: the
    interior/edge-split step equals the plain decomposed step on every
    interior point, and the single-device step within the FFT's
    rounding."""
    topo = (("periodic", "periodic", "bounded") if stepper != "RungeKutta3"
            else ("periodic", "periodic", "periodic"))

    def make(P):
        return P.NonhydrostaticModel(
            _grid(P, topology=topo), advection=P.WENO5(), tracers=("c",),
            buoyancy=P.BuoyancyTracer(), coriolis=P.FPlane(f=1e-4),
            closure=P.ScalarDiffusivity(nu=1e-3, kappa=1e-3), timestepper=stepper)

    values = _fields((16, 16, 8), ("u", "v", "b", "c"), 3,
                     {"u": 1e-2, "v": 1e-2, "b": 1e-3})
    tm, single, runs = _port_runs(make, values)
    g = tm.grid
    for name in ("u", "v", "w", "b", "c"):
        a = _interior(g, runs[False]["solution"][name])
        np.testing.assert_array_equal(_interior(g, runs[True]["solution"][name]), a,
                                      err_msg=name)
        _close(_interior(g, single["solution"][name]), a, what=name)


def test_overlap_halo_immersed_background_is_bitwise_the_plain_step():
    def bump(x, y):
        return -1.0 + 0.4 * torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02)

    def make(P):
        return P.NonhydrostaticModel(
            _grid(P, topology=("periodic", "periodic", "bounded")), tracers=("c",),
            immersed_boundary=P.GridFittedBottom(bump),
            background_fields={"u": lambda x, y, z, t: 0.05 * torch.cos(2 * np.pi * y)})

    values = _fields((16, 16, 8), ("u", "c"), 6, {"u": 1e-2})
    tm, single, runs = _port_runs(make, values, dt=1e-3)
    g = tm.grid
    for name in ("u", "v", "w", "c"):
        a = _interior(g, runs[False]["solution"][name])
        np.testing.assert_array_equal(_interior(g, runs[True]["solution"][name]), a,
                                      err_msg=name)
        _close(_interior(g, single["solution"][name]), a, what=name)


# -- checkpoints across mesh shapes ------------------------------------------------

def test_distributed_checkpoint_roundtrip(tmp_path):
    """test_distributed_checkpoint_roundtrip: a checkpoint written under a
    (2, 2) mesh restores on one device and continues as the uninterrupted
    run, a single-device one restores under the mesh, and a JAX state's
    numpy leaves scatter through the port's ``scatter_state``."""
    from clima_oceananigans_jl_torch.output.checkpointer import (_flatten_state,
                                                                 restore_state)
    from clima_oceananigans_jl_tpu.output.checkpointer import (
        _flatten_state as j_flatten)
    values = _fields((16, 16, 8), ("u", "v", "c"), 3, {"u": 1e-2, "v": 1e-2})
    tm, jm = _make_fft(T), _make_fft(J)
    s0 = tm.initial_state(**{k: torch.tensor(v) for k, v in values.items()})
    dt = 1e-3
    ref = s0
    for _ in range(10):
        ref = tm.step(ref, dt)
    dm = T.DistributedModel(tm, T.make_mesh((2, 2), "cpu"))
    g = tm.grid

    def check(s):
        assert int(s["clock"].iteration) == 10
        for name in ("u", "v", "w", "c"):
            _close(_interior(g, ref["solution"][name]), _interior(g, s["solution"][name]),
                   what=name)
            _close(_interior(g, ref["G_prev"][name]) if ref["G_prev"][name].ndim == 3
                   and tuple(ref["G_prev"][name].shape) != g.shape
                   else ref["G_prev"][name].numpy(),
                   _interior(g, s["G_prev"][name]) if tuple(s["G_prev"][name].shape)
                   != g.shape else s["G_prev"][name].numpy(), what=f"G_prev {name}")

    sd = dm.scatter_state(s0)
    for _ in range(5):
        sd = dm.step(sd, dt)
    path = tmp_path / "ckpt_mesh.npz"
    np.savez(path, **_flatten_state(dm.gather_state(sd)))
    template = tm.step(s0, dt)
    s = restore_state(template, str(path), model=tm)
    assert float(s["previous_dt"]) == dt
    for _ in range(5):
        s = tm.step(s, dt)
    check(s)

    single = s0
    for _ in range(5):
        single = tm.step(single, dt)
    path2 = tmp_path / "ckpt_single.npz"
    np.savez(path2, **_flatten_state(single))
    s2 = dm.scatter_state(restore_state(template, str(path2), model=tm))
    for _ in range(5):
        s2 = dm.step(s2, dt)
    check(dm.gather_state(s2))

    # a JAX state (numpy leaves) scatters and steps as the port's own
    js = jm.initial_state(**{k: jnp.asarray(v) for k, v in values.items()})
    npstate = jax.tree_util.tree_map(np.asarray, js)
    s3 = dm.scatter_state(npstate)
    s4 = dm.scatter_state(s0)
    for a, b in zip(s3, s4):
        for name in ("u", "v", "w", "c"):
            assert torch.equal(a["solution"][name], b["solution"][name])
    assert "state/solution/u" in j_flatten(js)


# -- the card --------------------------------------------------------------------------

needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(), reason="needs CUDA")


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_cuda_decomposed_rk3_kernels_are_bitwise_their_plain_versions(shape):
    """Three RK3 steps of the flagship's terms on shards of one card:
    K2, K3b, K3c and K6 (with the exchange) against their plain versions,
    bit for bit, and each kernel launched."""
    from clima_oceananigans_jl_torch.models import nonhydrostatic as nh
    from clima_oceananigans_jl_torch.ops import fused_tendencies as tft
    grid = T.RectilinearGrid(size=(32, 32, 16), extent=(1.0, 1.0, 1.0),
                             topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                             dtype=torch.float32, device="cuda")
    model = T.NonhydrostaticModel(grid, advection=T.WENO5(), buoyancy=T.BuoyancyTracer(),
                                  coriolis=T.FPlane(f=1e-4),
                                  closure=T.ScalarDiffusivity(nu=1e-5, kappa=1e-5),
                                  timestepper="RungeKutta3")
    g = torch.Generator(device="cuda").manual_seed(0)
    s0 = model.initial_state(
        u=1e-2 * torch.randn(grid.shape, device="cuda", generator=g),
        b=1e-3 * torch.randn(grid.shape, device="cuda", generator=g))
    dm = T.DistributedModel(model, T.make_mesh(shape, ["cuda:0"] * 4))
    for w in (tft.fused_advective_tendencies, tft.fused_divergence,
              tft.fused_pressure_gradient, tff.fused_fill_halos):
        w.launches = 0
    a = dm.scatter_state(s0)
    b = dm.scatter_state(s0)
    for _ in range(3):
        a = dm.step(a, 1e-3)
        b = dm.step(b, 1e-3, kernels=nh.PLAIN)
    ga, gb = dm.gather_state(a), dm.gather_state(b)
    for name in ("u", "v", "w", "b"):
        assert torch.equal(grid.interior(ga["solution"][name]),
                           grid.interior(gb["solution"][name])), name
    for w in (tft.fused_advective_tendencies, tft.fused_divergence,
              tft.fused_pressure_gradient, tff.fused_fill_halos):
        assert w.launches > 0


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_cuda_hydrostatic_over_a_cut_grid_is_bitwise_its_plain_versions(shape):
    """The hydrostatic model decomposed on one card: K4a, K4b, K5's cut
    form, K6 and T1 on every shard, three split-explicit steps bit for bit
    the decomposed plain run (``hydrostatic.PLAIN``)."""
    from clima_oceananigans_jl_torch.models import hydrostatic as hy
    from clima_oceananigans_jl_torch.ops import fused_barotropic as tfb
    from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh
    from clima_oceananigans_jl_torch.solvers import tridiagonal as ttri
    grid = T.RectilinearGrid(size=(32, 32, 8), x=(0, 1e5), y=(0, 1e5), z=(-100.0, 0),
                             topology=(T.PERIODIC, T.BOUNDED, T.BOUNDED), device="cuda")
    model = T.HydrostaticFreeSurfaceModel(
        grid, free_surface=T.SplitExplicitFreeSurface(substeps=10),
        coriolis=T.FPlane(f=1e-4), buoyancy=T.BuoyancyTracer(),
        closure=T.ScalarDiffusivity(nu=10.0, kappa=1.0, nu_z=1e-3, kappa_z=1e-4,
                                    time_discretization="vertically_implicit"))
    s0 = model.initial_state(
        eta=lambda x, y: (0.01 * torch.sin(2 * np.pi * x / 1e5)
                          * torch.cos(np.pi * y / 1e5)),
        u=lambda x, y, z: 0.01 * torch.cos(2 * np.pi * y / 1e5),
        b=lambda x, y, z: 1e-5 * z)
    dm = T.DistributedModel(model, T.make_mesh(shape, ["cuda:0"] * 4))
    wrappers = (tfh.hydrostatic_columns, tfh.fused_hydrostatic_tendencies,
                tff.fused_fill_halos, ttri.solve_batched_tridiagonal)
    for w in wrappers:
        w.launches = 0
    tfb.fused_substep_eta.cut_launches = 0
    a = dm.scatter_state(s0)
    b = dm.scatter_state(s0)
    for _ in range(3):
        a = dm.step(a, 300.0)
        b = dm.step(b, 300.0, kernels=hy.PLAIN)
    ga, gb = dm.gather_state(a), dm.gather_state(b)
    for name in ("u", "v", "b"):
        assert torch.equal(grid.interior(ga["solution"][name]),
                           grid.interior(gb["solution"][name])), name
    assert torch.equal(ga["eta"], gb["eta"])
    assert all(w.launches > 0 for w in wrappers)
    assert tfb.fused_substep_eta.cut_launches == 3 * 2 * 10 * 4
