"""Port parity: the fused advective tendencies (K2).

The plain version ``fused_advective_tendencies_reference`` against
(a) the JAX package's Pallas kernel ``fused_advective_tendencies(...,
interpret=True)`` and (b) the JAX ``div_vu``/``div_vv``/``div_vw``/``div_Uc``,
at 16×12×10 in f64, on (Periodic, Periodic, Bounded) and (Periodic,
Periodic, Periodic), with WENO5 momentum and WENO5 or centred tracers,
0 or 2 tracers, on the same numpy-seeded with-halo fields. Interiors must
agree to max|Δ| ≤ 1e-12·max|ref|, because XLA's CPU backend may fuse and
contract where eager PyTorch does not.

The ``cuda`` cases hold the CUDA kernel against the plain version on the
card bit for bit and skip without one: on the interior, and on a bounded z
axis on w's top wall face too (with-halo z index hz+nz, in the z halo),
which a FluxBC w wall leaves to the time step; on random, smooth and
all-zero fields, sizes off the kernel's 8×12×32 tiles, 16 fields, fp32 and
fp64; every other halo point must be zero without a zero fill. They need no JAX: ``python -m
pytest --noconftest -m cuda tests/test_torch_fused_tendencies.py``.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"

RTOL = 1e-12
SIZE = (16, 12, 10)
TOPOLOGIES = {"ppb": ("periodic", "periodic", "bounded"),
              "ppp": ("periodic", "periodic", "periodic")}


def inputs(shape, ntracers, seed=0):
    rng = np.random.default_rng(seed)
    vel = [s * rng.standard_normal(shape) for s in (1.0, 1.0, 0.5)]
    return vel, {f"c{k}": rng.standard_normal(shape) for k in range(ntracers)}


def torch_grid(topology, size=SIZE, dtype=torch.float64, device=DEVICE,
               halo=3):
    return T.RectilinearGrid(size=size, extent=(1.0, 2.0, 0.5),
                             topology=topology, halo=(halo,) * 3, dtype=dtype,
                             device=device)


def w_top(grid, a):
    """The (nx, ny) plane of w's top wall face: with-halo z index hz+nz."""
    return a[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny,
             grid.Hz + grid.Nz]


def close(ref, got, rtol, what):
    err, scale = np.abs(ref - got).max(), np.abs(ref).max()
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("tracer_scheme", ["weno5", "centered"])
@pytest.mark.parametrize("ntracers", [0, 2])
def test_plain_k2_matches_jax(topo, tracer_scheme, ntracers):
    import jax.numpy as jnp
    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection import fluxes as jfl
    from clima_oceananigans_jl_tpu.ops import fused_tendencies as jft
    jg = J.RectilinearGrid(size=SIZE, extent=(1.0, 2.0, 0.5),
                           topology=TOPOLOGIES[topo], halo=(3, 3, 3),
                           dtype=jnp.float64)
    tg = torch_grid(TOPOLOGIES[topo])
    assert jft.supports_fused_advection(jg) and tft.supports_fused_advection(tg)
    (u, v, w), tracers = inputs(tg.total_shape, ntracers)
    js, jt = J.WENO5(), (J.WENO5() if tracer_scheme == "weno5"
                         else J.CenteredSecondOrder())
    ts, tt = T.WENO5(), (T.WENO5() if tracer_scheme == "weno5"
                         else T.CenteredSecondOrder())
    ju, jv, jw = map(jnp.asarray, (u, v, w))
    pallas = jft.fused_advective_tendencies(
        jg, js, jt, ju, jv, jw, {n: jnp.asarray(c) for n, c in tracers.items()},
        interpret=True)
    plain = dict(u=-jfl.div_vu(jg, js, ju, jv, jw),
                 v=-jfl.div_vv(jg, js, ju, jv, jw),
                 w=-jfl.div_vw(jg, js, ju, jv, jw))
    for n, c in tracers.items():
        plain[n] = -jfl.div_Uc(jg, jt, ju, jv, jw, jnp.asarray(c))
    got = tft.fused_advective_tendencies_reference(
        tg, ts, tt, *map(torch.as_tensor, (u, v, w)),
        {n: torch.as_tensor(c) for n, c in tracers.items()})
    assert set(got) == {"u", "v", "w", *tracers}
    for name, g in got.items():
        assert tuple(g.shape) == tg.total_shape
        g = g[tg.interior_slices].numpy()
        close(np.asarray(pallas[name])[tg.interior_slices], g, RTOL,
              f"{name} vs Pallas")
        close(np.asarray(plain[name])[tg.interior_slices], g, RTOL,
              f"{name} vs div_*")


def test_gates_match_jax():
    import jax.numpy as jnp
    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs
    from clima_oceananigans_jl_tpu.ops import fused_tendencies as jft
    from clima_oceananigans_jl_torch.boundary_conditions import bcs as tbcs
    for topo in (("periodic", "periodic", "bounded"),
                 ("periodic", "periodic", "periodic"),
                 ("bounded", "periodic", "bounded"),
                 ("periodic", "bounded", "periodic")):
        jg = J.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1),
                               topology=topo, dtype=jnp.float64)
        tg = T.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1),
                               topology=topo, dtype=torch.float64, device=DEVICE)
        assert jft.supports_fused_advection(jg) == tft.supports_fused_advection(tg)
        for top in (None, 0.0, 1e-3):
            jb = jbcs.FieldBCs(top=None if top is None else jbcs.ValueBC(top))
            tb = tbcs.FieldBCs(top=None if top is None else tbcs.ValueBC(top))
            jw = jbcs.regularize_bcs(jg, (jbcs.C, jbcs.C, jbcs.F), jb)
            tw = tbcs.regularize_bcs(tg, T.W_LOC, tb)
            assert jft.z_halo_free_ok(jg, jw) == tft.z_halo_free_ok(tg, tw)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    tg = torch_grid(TOPOLOGIES["ppb"])
    (u, v, w), tracers = inputs(tg.total_shape, 1)
    args = (tg, T.WENO5(), T.CenteredSecondOrder(),
            *map(torch.as_tensor, (u, v, w)),
            {n: torch.as_tensor(c) for n, c in tracers.items()})
    before = tft.fused_advective_tendencies.launches
    got = tft.fused_advective_tendencies(*args)
    ref = tft.fused_advective_tendencies_reference(*args)
    assert tft.fused_advective_tendencies.launches == before
    assert all(torch.equal(got[n], ref[n]) for n in ref)


def test_kernel_arguments_refuse_what_the_kernels_do_not_take():
    tg = torch_grid(TOPOLOGIES["ppb"])
    with pytest.raises(ValueError):
        tft.advection_args(tg, T.WENO5(), T.WENO5(), 17)
    with pytest.raises(ValueError):
        tft.kernel_scheme(object())
    stretched_x = T.RectilinearGrid(size=(8, 8, 8), x=np.arange(9) ** 1.5,
                                    y=(0, 1), z=(0, 1), dtype=torch.float64,
                                    device=DEVICE)
    # a stretched x is taken (K2's stretched-x/y form, since the
    # stencil-matrix slice): its rows carry WENO5's tables, the regular y
    # and z theirs without
    ints, _ = tft.advection_args(stretched_x, T.WENO5(), T.WENO5(), 4)
    assert ints[0] == 4
    rows, tables = tft.stretched_rows_arg(stretched_x, T.WENO5(), T.WENO5())
    assert tables == [1, 0, 0]
    assert [tuple(r.shape) for r in rows] == [(50, 14), (2, 14), (2, 14)]
    _, tables = tft.stretched_rows_arg(stretched_x, T.CenteredSecondOrder(),
                                       T.UpwindBiasedThirdOrder())
    assert tables == [0, 0, 0]
    # WENO5 tracers under centred momentum take the WENO5 z bounds in the
    # tracers' set (the centred momentum reduces nowhere); a bounded x its
    # own
    ints, _ = tft.advection_args(tg, T.CenteredSecondOrder(), T.WENO5(), 4)
    assert tuple(ints[7:10]) == (0, 1, 0) and ints[19] == 0 and ints[38] == 1
    bounded_x = torch_grid(("bounded", "periodic", "bounded"))
    ints, _ = tft.advection_args(bounded_x, T.WENO5(), T.WENO5(), 4)
    assert (ints[9], ints[14], ints[19]) == (1, 0, 1)


def wave(shape, kind):
    """a → a numpy field of ``shape`` of phase a: all zero (``kind``
    "zero") or smooth with amplitude ~1e-6 ("smooth"), where WENO5's
    weights fall to ~1e-24 and division meets its slow operands."""
    x, y, z = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    amp = 0.0 if kind == "zero" else 1e-6
    return lambda a: amp * np.sin(0.3 * x + a) * np.cos(0.2 * y + a) * (1.0 + 0.01 * z)


def card_inputs(shape, ntracers, kind, dtype):
    """u, v, w and the tracers on the card: numpy-seeded random fields or
    ``wave`` fields of ``kind``."""
    if kind == "random":
        (u, v, w), tracers = inputs(shape, ntracers)
    else:
        field = wave(shape, kind)
        (u, v, w) = field(0.0), field(1.0), 0.5 * field(2.0)
        tracers = {f"c{k}": field(3.0 + k) for k in range(ntracers)}
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    return (as_t(u), as_t(v), as_t(w)), {n: as_t(c) for n, c in tracers.items()}


def poison_cache(grid, n):
    """Leave n NaN-filled blocks of the outputs' size in the caching
    allocator, so that outputs the kernel does not write stay NaN."""
    blocks = [torch.full(grid.total_shape, float("nan"), dtype=grid.dtype,
                         device="cuda") for _ in range(n)]
    del blocks


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,size,tracer_scheme,ntracers,topo,momentum,halo,kind", [
        (torch.float64, (16, 12, 10), "centered", 2, "ppb", "weno5", 3, "random"),
        (torch.float64, (16, 12, 10), "weno5", 0, "ppp", "weno5", 3, "random"),
        (torch.float32, (32, 24, 16), "weno5", 1, "ppb", "weno5", 3, "random"),
        (torch.float64, (16, 12, 10), "centered", 1, "ppb", "centered", 1,
         "random"),
        (torch.float32, (20, 13, 40), "weno5", 1, "ppb", "weno5", 3, "smooth"),
        (torch.float32, (12, 10, 8), "weno5", 1, "ppb", "weno5", 3, "zero"),
        (torch.float32, (9, 17, 33), "weno5", 13, "ppb", "weno5", 3, "random"),
        (torch.float64, (12, 10, 8), "weno5", 13, "ppb", "centered", 3,
         "random"),
        (torch.float64, (64, 64, 64), "weno5", 1, "ppb", "weno5", 3, "smooth")],
    ids=["f64-centered", "f64-periodic", "f32", "f64-centered-halo1",
         "f32-smooth-off-tile", "f32-zero", "f32-16-fields-off-tile",
         "f64-16-fields", "f64-64-smooth-chunks"])
def test_cuda_kernel_matches_plain_version(dtype, size, tracer_scheme,
                                           ntracers, topo, momentum, halo,
                                           kind):
    """The kernel against the plain version on the card, bit for bit
    (max|Δ| = 0), on the interior, on each of the three levels at each z
    wall that WENO5's order reduction masks, and, on a bounded z axis, on
    w's top wall face (with halo 1 the centre above that face wraps to z
    index 0, as torch.roll wraps it). Every other halo point is zero
    although the outputs were not zero-filled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tg = torch_grid(TOPOLOGIES[topo], size, dtype, "cuda", halo)
    (u, v, w), tracers = card_inputs(tg.total_shape, ntracers, kind, dtype)
    scheme = lambda name: T.WENO5() if name == "weno5" else T.CenteredSecondOrder()
    args = (tg, scheme(momentum), scheme(tracer_scheme), u, v, w, tracers)
    poison_cache(tg, 3 + ntracers)
    before = tft.fused_advective_tendencies.launches
    got = tft.fused_advective_tendencies(*args)
    torch.cuda.synchronize()
    assert tft.fused_advective_tendencies.launches == before + 1
    ref = tft.fused_advective_tendencies_reference(*args)
    bounded = tg.topology[2] is T.BOUNDED
    hz, nz = tg.Hz, tg.Nz
    for name in ref:
        halo_part = got[name].clone()
        halo_part[tg.interior_slices] = 0
        if name == "w" and bounded:
            assert kind == "zero" or w_top(tg, ref[name]).abs().max() > 0
            assert torch.equal(w_top(tg, ref[name]), w_top(tg, got[name])), \
                "w top wall face"
            w_top(tg, halo_part).zero_()
        assert not halo_part.isnan().any() and not halo_part.any(), \
            f"{name}: a halo point other than w's top wall face is not zero"
        interior = lambda a: a[tg.Hx:tg.Hx + tg.Nx, tg.Hy:tg.Hy + tg.Ny]
        for k in (hz, hz + 1, hz + 2, hz + nz - 3, hz + nz - 2, hz + nz - 1):
            assert torch.equal(interior(ref[name])[..., k],
                               interior(got[name])[..., k]), (name, "level", k)
        assert torch.equal(ref[name][tg.interior_slices],
                           got[name][tg.interior_slices]), name
