"""Port parity: the hydrostatic and shallow-water models decomposed over
a mesh of shards, held against the JAX package's ``DistributedModel`` on
the same mesh (``tests/test_distributed.py``'s configurations), and
MultiRegion.

Tolerances:
- shallow water: 1e-12 of max|ref| (``SW_RTOL``, the single-device
  tests' tolerance): the same elementwise stencil algebra, the exchange
  only copies, but XLA's CPU backend contracts the jitted step's a·b + c
  into FMAs (the runs differ by ~1e-17);
- the hydrostatic model with pcg: 1e-10 of max|ref| (``CG_RTOL``): CG's
  inner products are summed over the shards in shard order, where XLA's
  psum sums in its own order, so the iterates differ by rounding, and the
  solve stops at its 1e-13 tolerance;
- split-explicit: 1e-12 of max|ref| (``W_RTOL``): w's and pHY′'s
  cumulative sums run in another order in torch than in XLA;
- the halo-overlap step against the plain decomposed step: bit for bit;
- K5's cut form (``ops/fused_barotropic.py::cut_sequence``): its halves'
  plain mirrors, which write interior points only, between the fills,
  bit for bit ``fused_substep_eta_reference`` on every with-halo point.

On the card the shards run K4a, K4b, K6, T1 and K5's cut form: the
``cuda`` case here holds that form against the mirrors' sequence; the
decomposed hydrostatic step's kernels against their plain versions are
in ``tests/test_torch_distributed_nonhydrostatic.py``.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.models.free_surface import column_depths
from clima_oceananigans_jl_torch.ops import fused_barotropic as tfb
from clima_oceananigans_jl_torch.ops import fused_fill as tff
from clima_oceananigans_jl_torch.parallel import multi_region as tmr
from clima_oceananigans_jl_torch.parallel.decomposition import scatter_array

try:
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.parallel import distributed as jdist
except ImportError:
    pass

torch.set_num_threads(1)

SW_RTOL = 1e-12
CG_RTOL = 1e-10
W_RTOL = 1e-12


def _xp(P):
    return jnp if P is J else torch


def _kw(P):
    return dict(dtype=jnp.float64) if P is J else dict(dtype=torch.float64, device="cpu")


def _h(grid, x):
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny]


def _close(a, b, rtol, what):
    scale = max(np.abs(a).max(), 1e-300)
    err = np.abs(a - b).max()
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def _run_both(make, init, shape, steps, dt, overlap=False):
    jm, tm = make(J), make(T)
    js, ts = init(jm, J), init(tm, T)
    jd = jdist.DistributedModel(jm, jdist.make_mesh(shape), overlap_halo=overlap)
    sj = jd.scatter_state(js)
    for _ in range(steps):
        sj = jd.step(sj, jnp.float64(dt))
    td = T.DistributedModel(tm, T.make_mesh(shape, "cpu"), overlap_halo=overlap)
    st = td.scatter_state(ts)
    for _ in range(steps):
        st = td.step(st, dt)
    return tm, jd.gather_state(sj), td.gather_state(st)


# -- shallow water ------------------------------------------------------------------

def _sw(P):
    grid = P.RectilinearGrid(size=(32, 32, 1), x=(0, 4 * np.pi), y=(-4.0, 4.0),
                             topology=(P.PERIODIC, P.BOUNDED, P.FLAT), **_kw(P))
    return P.ShallowWaterModel(grid=grid, gravitational_acceleration=10.0,
                               advection=P.WENO5(), coriolis=P.FPlane(f=1.0))


def _bickley(model, P):
    xp = _xp(P)

    def u0(x, y, z):
        return 1.0 / xp.cosh(y) ** 2 + 1e-4 * xp.sin(2 * x) * xp.exp(-y * y)

    return model.initial_state(uh=u0, vh=lambda x, y, z: 1e-4 * xp.cos(3 * x)
                               * xp.exp(-y * y), h=1.0)


@pytest.mark.parametrize("shape", [(2, 4), (4, 1)])
def test_distributed_shallow_water_matches_jax(shape):
    """test_distributed_shallow_water_matches_single_device's Bickley jet
    on (P, B, F): the bounded y cut on (2, 4), x alone on (4, 1)."""
    tm, sj, st = _run_both(_sw, _bickley, shape, 10, 1e-3)
    for name in ("uh", "vh", "h"):
        _close(_h(tm.grid, sj["solution"][name]), _h(tm.grid, st["solution"][name]),
               SW_RTOL, name)


def test_shallow_water_bathymetry_is_cut_per_shard():
    grid = T.RectilinearGrid(size=(16, 16, 1), extent=(1.0, 1.0),
                             topology=(T.PERIODIC, T.PERIODIC, T.FLAT), **_kw(T))
    g = grid.with_halo((3, 3, 0))
    x, y, _ = g.nodes(T.CENTER, with_halo=True)
    hb = torch.broadcast_to(0.1 * torch.sin(2 * np.pi * x) * torch.cos(2 * np.pi * y),
                            g.total_shape).contiguous()
    model = T.ShallowWaterModel(grid=grid, gravitational_acceleration=9.81,
                                bathymetry=hb)
    s0 = model.initial_state(uh=lambda x, y, z: 0.01 * torch.sin(2 * np.pi * y), h=1.0)
    dm = T.DistributedModel(model, T.make_mesh((2, 2), "cpu"))
    s = dm.scatter_state(s0)
    single = s0
    for _ in range(5):
        s = dm.step(s, 1e-3)
        single = model.step(single, 1e-3)
    s = dm.gather_state(s)
    for name in ("uh", "vh", "h"):
        np.testing.assert_array_equal(_h(model.grid, s["solution"][name]),
                                      _h(model.grid, single["solution"][name]))


# -- the hydrostatic model ----------------------------------------------------------

def _pcg(P):
    grid = P.RectilinearGrid(size=(16, 16, 4), x=(0, 1e5), y=(0, 1e5), z=(-100.0, 0),
                             topology=(P.PERIODIC, P.BOUNDED, P.BOUNDED), **_kw(P))
    return P.HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=P.ImplicitFreeSurface(solver_method="pcg",
                                                      tolerance=1e-13, maxiter=400),
        coriolis=P.FPlane(f=1e-4), closure=P.ScalarDiffusivity(nu=10.0, nu_z=1e-3))


def _pcg_init(model, P):
    xp = _xp(P)
    return model.initial_state(
        eta=lambda x, y: 0.01 * xp.sin(2 * np.pi * x / 1e5) * xp.sin(np.pi * y / 1e5),
        u=lambda x, y, z: 0.01 * xp.cos(2 * np.pi * y / 1e5))


def test_distributed_hydrostatic_pcg_matches_jax():
    """test_distributed_hydrostatic_matches_single_device: the implicit
    free surface's CG with the inner products summed over the shards."""
    tm, sj, st = _run_both(_pcg, _pcg_init, (2, 2), 5, 50.0)
    g = tm.grid
    for name in ("u", "v"):
        _close(_h(g, sj["solution"][name]), _h(g, st["solution"][name]), CG_RTOL, name)
    _close(_h(g, sj["eta"]), _h(g, st["eta"]), CG_RTOL, "eta")


def _split(P):
    grid = P.RectilinearGrid(size=(16, 16, 4), x=(0, 1e5), y=(0, 1e5), z=(-100.0, 0),
                             topology=(P.PERIODIC, P.PERIODIC, P.BOUNDED), **_kw(P))
    return P.HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=P.SplitExplicitFreeSurface(substeps=20),
        coriolis=P.FPlane(f=1e-4), closure=P.ScalarDiffusivity(nu=10.0, nu_z=1e-3))


def _split_init(model, P):
    xp = _xp(P)
    return model.initial_state(
        eta=lambda x, y: 0.01 * xp.sin(2 * np.pi * x / 1e5) + 0 * y,
        u=lambda x, y, z: 0.01 * xp.cos(2 * np.pi * y / 1e5))


def test_distributed_split_explicit_matches_jax():
    """test_distributed_split_explicit_matches_single_device: every
    barotropic substep's fill exchanges (K5's plain version)."""
    tm, sj, st = _run_both(_split, _split_init, (2, 2), 5, 50.0)
    g = tm.grid
    for name in ("u", "v"):
        _close(_h(g, sj["solution"][name]), _h(g, st["solution"][name]), W_RTOL, name)
    _close(_h(g, sj["eta"]), _h(g, st["eta"]), W_RTOL, "eta")


def test_hydrostatic_overlap_is_bitwise_the_plain_decomposed_step():
    """The hydrostatic halo-overlap step (JAX l.405-480) against the plain
    decomposed step: every interior point, η included."""
    model = _split(T)
    s0 = _split_init(model, T)
    runs = {}
    for overlap in (False, True):
        dm = T.DistributedModel(model, T.make_mesh((2, 2), "cpu"), overlap_halo=overlap)
        s = dm.scatter_state(s0)
        for _ in range(3):
            s = dm.step(s, 50.0)
        runs[overlap] = dm.gather_state(s)
    g = model.grid
    for name in ("u", "v"):
        np.testing.assert_array_equal(_h(g, runs[True]["solution"][name]),
                                      _h(g, runs[False]["solution"][name]), err_msg=name)
    np.testing.assert_array_equal(_h(g, runs[True]["eta"]), _h(g, runs[False]["eta"]))


def test_hydrostatic_gates_on_a_cut_grid():
    """The shards take pcg and the two-stage route, and the card's gates
    accept the cut grid (K4a, K4b, K6 and K5's cut form); a stretched x
    is still refused by name (ROADMAP Queue 1 item 6)."""
    model = _split(T)
    assert T.ImplicitFreeSurface(solver_method="fft").resolve_method(model.grid) == "fft"
    dm = T.DistributedModel(model, T.make_mesh((2, 2), "cpu"))
    for lm in dm.local_models:
        assert T.ImplicitFreeSurface(solver_method="fft").resolve_method(lm.grid) == "pcg"
        assert not lm.fused_advance
        assert lm.card_unsupported_reason() is None
        assert tfb.unsupported_reason(lm.grid, lm.eta_bcs) is None
        assert tff.cut_axes(lm.grid) == (0, 1)
    stretched = T.RectilinearGrid(size=(16, 16, 4), x=1e5 * np.linspace(0, 1, 17) ** 1.5,
                                  y=(0, 1e5), z=(-100.0, 0),
                                  topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED), **_kw(T))
    sm = T.HydrostaticFreeSurfaceModel(
        grid=stretched, free_surface=T.SplitExplicitFreeSurface(substeps=20))
    dm = T.DistributedModel(sm, T.make_mesh((2, 2), "cpu"))
    for lm in dm.local_models:
        assert "ROADMAP Queue 1 item 6" in lm.card_unsupported_reason()
        assert "regular x" in tfb.unsupported_reason(lm.grid, lm.eta_bcs)


# -- K5's cut form -------------------------------------------------------------------

def _near_global_k5(dtype=torch.float64, device="cpu"):
    """A 48×24 lat-lon grid (0–360, −60–60: y bounded globally) over the JAX
    suite's near-global ridge and bump, whose depth planes vary in x."""
    grid = T.LatitudeLongitudeGrid(size=(48, 24, 8), longitude=(0, 360),
                                   latitude=(-60, 60), z=(-3000.0, 0.0), dtype=dtype,
                                   device=device)
    bathy = lambda lam, phi: torch.where(
        (lam > 170) & (lam < 190), 100.0,
        -3000.0 + 800.0 * torch.exp(-((lam - 60) / 15.0) ** 2))
    return T.HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=T.SplitExplicitFreeSurface(substeps=12),
        immersed_boundary=T.GridFittedBottom(bathy))


def _k5_inputs(model, shape, seed=0):
    """Per shard: (eta0, U0, V0, GU, GV) from seeded global fields whose
    halos are NaN (neither sequence reads them), wv and wf a Hann filter."""
    g = model.grid
    rng = np.random.default_rng(seed)
    X, Y = g.total_shape[:2]
    fields = []
    for scale in (1e-2, 1.0, 1.0, 1e-5, 1e-5):
        a = torch.full((X, Y, 1), float("nan"), dtype=g.dtype)
        a[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny] = torch.as_tensor(
            scale * rng.standard_normal((g.Nx, g.Ny, 1)), dtype=g.dtype)
        fields.append(scatter_array(a.to(g.device), g, shape))
    n = model.free_surface.substeps
    w = torch.sin(torch.pi * torch.arange(1, n + 1, dtype=g.dtype) / (n + 1)) ** 2
    w = (w / w.sum()).to(g.device)
    return [tuple(f[r] for f in fields) for r in range(shape[0] * shape[1])], w


def _nan_empty_like(t, **kw):
    return torch.full_like(t, float("nan"), **kw)


def _k5_sequences(shape, device, run_a, run_b, monkeypatch, dtype=torch.float64):
    """Both sequences on every shard of the near-global grid cut over
    ``shape``, from the same inputs, their work arrays NaN-filled."""
    model = _near_global_k5(dtype, device)
    dm = T.DistributedModel(model, T.make_mesh(shape, [device] * (shape[0] * shape[1])))
    inputs, w = _k5_inputs(model, shape)
    monkeypatch.setattr(torch, "empty_like", _nan_empty_like)
    fs = model.free_surface
    dt = 600.0
    dtau = 2.0 * dt / fs.substeps

    def shard(r):
        lm = dm.local_models[r]
        eta0, U0, V0, GU, GV = inputs[r]
        Hfc, Hcf = column_depths(lm.grid)
        args = (lm.grid, lm.eta_bcs, eta0, U0, V0, GU, GV, Hfc, Hcf,
                fs.gravitational_acceleration, dtau, w, w, fs.substeps)
        return run_a(*args), run_b(*args), lm.grid

    return dm.mesh.run(shard)


def _mirrors(*args):
    return tfb.cut_sequence(*args, half_uv=tfb.substep_uv_interior_reference,
                            half_eta=tfb.substep_eta_interior_reference,
                            fill=tff.fused_fill_halos_reference)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_k5_cut_sequence_is_bitwise_the_plain_version(shape, monkeypatch):
    """The cut form's sequence with its halves' plain mirrors (interior
    points only) and the fills, on each shard of a lat-lon grid whose y is
    bounded globally (its end shards fill their physical side on (2, 2)),
    bit for bit ``fused_substep_eta_reference`` on every with-halo point
    of η̅, U̅ and V̅, over NaN-filled work arrays and NaN input halos."""
    out = _k5_sequences(shape, "cpu", tfb.fused_substep_eta_reference, _mirrors,
                        monkeypatch)
    for r, (ref, got, grid) in enumerate(out):
        for name, a, b in zip(("eta_av", "U_av", "V_av"), ref, got):
            assert torch.isfinite(a).all(), (r, name)
            assert torch.equal(a, b), (r, name)
        assert float(ref[1][grid.Hx:grid.Hx + grid.Nx].abs().max()) > 0


needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(), reason="needs CUDA")


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_cuda_k5_cut_form_is_bitwise_the_mirrors_sequence(shape, dtype, monkeypatch):
    """K5's cut form (two launches a substep between K6's fills and the
    exchange) against the mirrors' sequence with the plain fills, on every
    with-halo point, its work arrays NaN-filled; 2n launches a shard."""
    def kernel(*args):
        return tfb.fused_substep_eta(*args)

    tfb.fused_substep_eta.launches = tfb.fused_substep_eta.cut_launches = 0
    out = _k5_sequences(shape, "cuda:0", kernel, _mirrors, monkeypatch, dtype)
    n = 12
    assert tfb.fused_substep_eta.cut_launches == 2 * n * shape[0] * shape[1]
    for r, (got, ref, _grid) in enumerate(out):
        for name, a, b in zip(("eta_av", "U_av", "V_av"), ref, got):
            assert torch.isfinite(a).all(), (r, name)
            assert torch.equal(a, b), (r, name)


# -- MultiRegion ----------------------------------------------------------------------

@pytest.mark.parametrize("partition", [tmr.XPartition(4), tmr.YPartition(2)])
def test_multi_region_grid_wraps_a_distributed_model(partition):
    """Regions on periodic axes step bit for bit as the single-device
    model (a cut bounded axis reduces WENO's order only at the global
    walls' shards, as in the JAX package: see the ROADMAP's Not faults)."""
    grid = T.RectilinearGrid(size=(32, 32, 1), x=(0, 4 * np.pi), y=(-4.0, 4.0),
                             topology=(T.PERIODIC, T.PERIODIC, T.FLAT), **_kw(T))
    model = T.ShallowWaterModel(grid=grid, gravitational_acceleration=10.0,
                                advection=T.WENO5(), coriolis=T.FPlane(f=1.0))
    mrg = T.MultiRegionGrid(model.grid, partition=partition,
                            devices=[torch.device("cpu")] * partition.n)
    shape = (partition.n, 1) if isinstance(partition, tmr.XPartition) else (1, partition.n)
    assert mrg.mesh.shape == shape
    dm = mrg.wrap(model)
    s0 = _bickley(model, T)
    s = dm.scatter_state(s0)
    single = s0
    for _ in range(3):
        s = dm.step(s, 1e-3)
        single = model.step(single, 1e-3)
    s = dm.gather_state(s)
    for name in ("uh", "vh", "h"):
        np.testing.assert_array_equal(_h(model.grid, s["solution"][name]),
                                      _h(model.grid, single["solution"][name]))
    out = tmr.apply_regionally(lambda a, b: a + b, [1, 2, 3], 10)
    assert out == [11, 12, 13]
