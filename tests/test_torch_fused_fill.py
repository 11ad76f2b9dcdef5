"""Port parity: the halo fills of K6 (``ops/fused_fill.py``).

The JAX package fills halos with ``fill_halos`` (XLA slab updates) and,
for periodic axes of the (x, z, y) state on the TPU, with the Pallas
``fill_periodic_axis_inplace``; its own tests run that kernel on the CPU in
interpret mode (``tests/test_fused_fill.py``). Here, in f64:

- the wrapper on CPU tensors (its plain version, ``fill_halos`` field by
  field) against the JAX ``fill_halos`` for every field of the hydrostatic
  flagship (u, v, T, S, b, η, w, pHY′): bitwise;
- its periodic x strips against the Pallas ``fill_periodic_axis_inplace``
  in interpret mode: bitwise;
- ``fill_plan``, which the kernel reads, against the plain version: the
  points it marks as written are exactly those the plain fills write, over
  every location and the flux, open and value BCs on bounded and periodic
  axes;
- the static gate.

The ``cuda`` case holds the kernel against its plain version on the card,
bitwise (``python -m pytest --noconftest -m cuda tests/test_torch_fused_fill.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.boundary_conditions.bcs import regularize_bcs
from clima_oceananigans_jl_torch.models.free_surface import ETA_LOC
from clima_oceananigans_jl_torch.ops import fused_fill as tff
from clima_oceananigans_jl_torch.utils.location import CENTER, U_LOC, V_LOC, W_LOC

try:  # the cuda case also runs on a machine without JAX
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.boundary_conditions.bcs import fill_halos as j_fill
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JB
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from clima_oceananigans_jl_tpu.models.free_surface import (
        SplitExplicitFreeSurface as JSplit)
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    from clima_oceananigans_jl_tpu.ops import fused_fill as jff
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
SIZE = (16, 8, 6)


def zfaces(nz, depth=3000.0, p=1.8):
    k = np.arange(nz + 1)
    return -depth * (1.0 - k / nz) ** p


def torch_model(dtype=torch.float64, device=DEVICE, size=SIZE):
    grid = T.LatitudeLongitudeGrid(size=size, longitude=(0, 360), latitude=(-75, 75),
                                   z=zfaces(size[2]), dtype=dtype, device=device)
    return T.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=T.VectorInvariant(scheme="weno_velocity"),
        tracer_advection=T.WENO5(), tracers=("T", "S"),
        free_surface=T.SplitExplicitFreeSurface(substeps=8),
        coriolis=T.HydrostaticSphericalCoriolis(), buoyancy=T.BuoyancyTracer())


def model_fields(m):
    """(name, shape, loc, bcs, axes) of every field the model fills."""
    S = m.grid.total_shape
    out = [(n, S, m._locs()[n], m.bcs[n], (0, 1, 2)) for n in m.prognostic_names()]
    return out + [("eta", S[:2] + (1,), ETA_LOC, m.eta_bcs, (0, 1)),
                  ("w", S, W_LOC, m.w_bcs, (0, 1, 2)),
                  ("pHY", S, CENTER, m.pressure_bcs, (0, 1, 2))]


def test_plain_version_matches_jax_fill_halos_on_the_flagship_fields():
    tm = torch_model()
    jm = JH(JLL(size=SIZE, longitude=(0, 360), latitude=(-75, 75), z=zfaces(SIZE[2]),
                dtype=jnp.float64),
            momentum_advection=J.VectorInvariant(scheme="weno_velocity"),
            tracer_advection=J.WENO5(), tracers=("T", "S"),
            free_surface=JSplit(substeps=8), coriolis=J.HydrostaticSphericalCoriolis(),
            buoyancy=JB(), fused_advection=False)
    assert jm.grid.total_shape == tm.grid.total_shape
    jbcs = dict(jm.bcs, eta=jm.eta_bcs, w=jm.w_bcs, pHY=jm.pressure_bcs)
    # the JAX package's own location objects
    jlocs = dict(jm._locs(), eta=J.W_LOC, w=J.W_LOC, pHY=J.CENTER)
    rng = np.random.default_rng(0)
    specs = model_fields(tm)
    data = [rng.standard_normal(shape) for _n, shape, *_ in specs]
    got = tff.fused_fill_halos(tm.grid, [
        (torch.as_tensor(d), loc, bcs, axes, 0.0)
        for d, (_n, _s, loc, bcs, axes) in zip(data, specs)])
    for d, g, (name, _s, _loc, _b, axes) in zip(data, got, specs):
        ref = j_fill(jnp.asarray(d), jm.grid, jlocs[name], jbcs[name], 0.0, axes=axes)
        assert np.array_equal(np.asarray(ref), g.numpy()), name


@pytest.mark.parametrize("loc", ["u", "v", "c"])
def test_periodic_x_strips_match_the_pallas_kernel_in_interpret_mode(loc):
    tm = torch_model()
    g = tm.grid
    jg = JLL(size=SIZE, longitude=(0, 360), latitude=(-75, 75), z=zfaces(SIZE[2]),
             dtype=jnp.float64).with_halo(g.halo)
    assert jff.supports_inplace_fill(jg, 0)
    tloc = {"u": U_LOC, "v": V_LOC, "c": CENTER}[loc]
    d = np.random.default_rng(1).standard_normal(g.total_shape)
    ref = jff.fill_periodic_axis_inplace(jnp.asarray(d), jg, 0, interpret=True)
    got, = tff.fused_fill_halos(g, [(torch.as_tensor(d), tloc, None, (0,), 0.0)])
    assert np.array_equal(np.asarray(ref), got.numpy())


def written_mask(plan_ints):
    """The points ``fill_plan`` marks as written."""
    along = []
    for S, _N, _H, lo, hi, *_ in plan_ints:
        m = np.zeros(S, bool)
        m[:lo] = True
        m[hi:] = True
        along.append(m)
    return along[0][:, None, None] | along[1][None, :, None] | along[2][None, None, :]


BCS = {"default": None,
       "value": dict(west=T.ValueBC(0.3), east=T.ValueBC(-1.25), south=T.ValueBC(2.0),
                     top=T.ValueBC(0.7), bottom=T.OpenBC(0.0)),
       "open": dict(west=T.OpenBC(0.1), east=T.OpenBC(-0.2), south=T.OpenBC(0.4),
                    north=T.FluxBC(), bottom=T.ValueBC(0.5), top=T.OpenBC(1.5))}


@pytest.mark.parametrize("topology", [("bounded",) * 3, ("periodic", "bounded", "bounded"),
                                      ("bounded", "periodic", "bounded")])
@pytest.mark.parametrize("bcs", sorted(BCS))
def test_fill_plan_marks_exactly_what_the_plain_fills_write(topology, bcs):
    """Random values on each filled axis' interior (its last face included
    on a face-located axis) and on the unfilled axes, NaN elsewhere: the
    plain fills change exactly the points that ``fill_plan`` marks."""
    grid = T.RectilinearGrid(size=(9, 7, 5), x=(0, 1), y=(0, 2), z=zfaces(5, 1.0, 1.5),
                             topology=topology, dtype=torch.float64, device=DEVICE)
    rng = np.random.default_rng(4)
    for loc in (CENTER, U_LOC, V_LOC, W_LOC, (T.F, T.F, T.F)):
        b = regularize_bcs(grid, loc, None if BCS[bcs] is None else T.FieldBCs(**BCS[bcs]))
        for axes, shape in (((0, 1, 2), grid.total_shape), ((1, 2), grid.total_shape),
                            ((0, 1), grid.total_shape[:2] + (1,))):
            keep = [np.arange(n) if a not in axes else
                    np.arange(grid.halo[a], grid.halo[a] + grid.shape[a]
                              + int(loc[a] == T.F))
                    for a, n in enumerate(shape)]
            before = np.full(shape, np.nan)
            before[np.ix_(*keep)] = rng.standard_normal([len(k) for k in keep])
            data = torch.as_tensor(before.copy())
            tff.fused_fill_halos_reference(grid, [(data, loc, b, axes, 0.0)])
            after = data.numpy()
            changed = ((np.isnan(before) & ~np.isnan(after))
                       | (~np.isnan(before) & (before != after)))
            ints, _ = tff.fill_plan(grid, loc, b, axes, shape)
            assert np.array_equal(written_mask(ints), changed), (loc, axes)


def test_gate_refuses_what_the_kernel_lacks():
    grid = T.RectilinearGrid(size=(9, 7, 5), extent=(1, 1, 1),
                             topology=("bounded", "bounded", "bounded"),
                             dtype=torch.float64, device=DEVICE)
    S = grid.total_shape
    grad = T.FieldBCs(west=T.GradientBC(0.1))
    assert "gradient" in tff.unsupported_reason(grid, CENTER, grad, (0, 1, 2), S)
    call = T.FieldBCs(top=T.ValueBC(lambda x, y, t: x + y))
    assert "scalar" in tff.unsupported_reason(grid, CENTER, call, (0, 1, 2), S)
    # an open BC's value is not used on a centred side
    unused = T.FieldBCs(top=T.OpenBC(lambda x, y, t: x + y))
    assert tff.unsupported_reason(grid, CENTER, unused, (0, 1, 2), S) is None
    thin = T.RectilinearGrid(size=(9, 3, 5), extent=(1, 1, 1),
                             topology=("bounded", "bounded", "bounded"),
                             dtype=torch.float64, device=DEVICE)
    assert "H+1" in tff.unsupported_reason(thin, CENTER, None, (0, 1, 2), thin.total_shape)
    assert tff.unsupported_reason(thin, CENTER, None, (0, 2), thin.total_shape) is None
    assert torch_model()._fill_unsupported_reason() is None


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_no_launch():
    m = torch_model()
    n0 = tff.fused_fill_halos.launches
    state = m.initial_state(u=0.1 * np.random.default_rng(2).standard_normal(m.grid.shape))
    m.step(state, 600.0)
    assert tff.fused_fill_halos.launches == n0
    assert tff.fused_fill_halos(m.grid, []) == []


# -- on the card --------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_k6_matches_plain_version(dtype):
    """K6 against its plain version on the flagship's fields and on bounded
    grids with value and open BCs, in one launch per group: bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = torch_model(dtype, "cuda", size=(32, 16, 8))
    cases = [(m.grid, [(s, loc, b, axes) for _n, s, loc, b, axes in model_fields(m)])]
    for topology in (("bounded",) * 3, ("periodic", "bounded", "bounded")):
        g = T.RectilinearGrid(size=(9, 7, 5), x=(0, 1), y=(0, 2), z=zfaces(5, 1.0, 1.5),
                              topology=topology, dtype=dtype, device="cuda")
        specs = [(g.total_shape, loc, regularize_bcs(g, loc, None if v is None
                                                     else T.FieldBCs(**v)), (0, 1, 2))
                 for loc in (CENTER, U_LOC, V_LOC, W_LOC) for v in BCS.values()]
        specs.append((g.total_shape[:2] + (1,), ETA_LOC, None, (0, 1)))
        cases.append((g, specs))
    gen = torch.Generator(device="cuda").manual_seed(3)
    for g, specs in cases:
        base = [torch.randn(s, generator=gen, dtype=dtype, device="cuda") for s, *_ in specs]
        got, ref = [b.clone() for b in base], [b.clone() for b in base]
        n0 = tff.fused_fill_halos.launches
        tff.fused_fill_halos(g, [(a, loc, b, ax, 0.0) for a, (_s, loc, b, ax) in zip(got, specs)])
        assert tff.fused_fill_halos.launches == n0 + -(-len(specs) // tff.MAX_FIELDS)
        tff.fused_fill_halos_reference(g, [(a, loc, b, ax, 0.0)
                                           for a, (_s, loc, b, ax) in zip(ref, specs)])
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
