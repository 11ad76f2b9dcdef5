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
- the plain version against the JAX ``fill_halos`` with gradient BCs on a
  stretched z and with plane and callable values (the callables written
  with torch and with jnp): bitwise;
- ``fill_plan`` through the kernel's passes, block counts and decode of
  its block and thread indices, mirrored in numpy (the kernel's own are
  held only by the ``cuda`` cases): each written point once, no other
  point, at the source's block shape and others;
- ``fill_plan`` and the kernel's per-point rule, mirrored in numpy
  (``traced_fill``), against the plain fills on every written point,
  corners included, with scalar, plane and callable values and gradients;
- the static gate.

The ``cuda`` cases hold the kernel against its plain version on the card,
bitwise, on the hydrostatic fields, on the nonhydrostatic model's and
with gradients, planes and callables (every halo point over NaN-filled
memory) (``python -m pytest --noconftest -m cuda tests/test_torch_fused_fill.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.boundary_conditions import bcs as tbcs
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


def plane(shape, seed):
    """A boundary-plane array of values on the interior points."""
    return np.random.default_rng(seed).standard_normal(shape)


BCS = {"default": None,
       "value": dict(west=T.ValueBC(0.3), east=T.ValueBC(-1.25), south=T.ValueBC(2.0),
                     top=T.ValueBC(0.7), bottom=T.OpenBC(0.0)),
       "open": dict(west=T.OpenBC(0.1), east=T.OpenBC(-0.2), south=T.OpenBC(0.4),
                    north=T.FluxBC(), bottom=T.ValueBC(0.5), top=T.OpenBC(1.5)),
       # gradients (scalar, callable, plane) and plane and callable values;
       # the planes fit the 9×7×5 grid's interior planes (the launch plan
       # evaluates no value)
       "gradient": dict(west=T.GradientBC(0.2), east=T.GradientBC(lambda y, z, t: y - z + t),
                        south=T.GradientBC(-1.5), north=T.GradientBC(0.25),
                        bottom=T.GradientBC(lambda x, y, t: x * y + 1.0), top=T.GradientBC(0.75)),
       "planes": dict(west=T.ValueBC(plane((7, 5), 1)), south=T.OpenBC(plane((9, 5), 2)),
                      north=T.GradientBC(plane((9, 5), 3)), bottom=T.ValueBC(plane((9, 7), 4)),
                      top=T.OpenBC(plane((9, 7), 5))),
       "callables": dict(east=T.OpenBC(lambda y, z, t: 0.5 * y + z + t),
                         south=T.ValueBC(lambda x, z, t: x - 2.0 * z),
                         north=T.OpenBC(lambda x, z, t: x * z),
                         bottom=T.ValueBC(lambda x, y, t: x + y * y + t),
                         top=T.GradientBC(lambda x, y, t: 0.1 * x - y))}


@pytest.mark.parametrize("topology", [("bounded",) * 3, ("periodic", "bounded", "bounded"),
                                      ("bounded", "periodic", "bounded")])
@pytest.mark.parametrize("bcs", sorted(BCS))
def test_fill_plan_marks_exactly_what_the_plain_fills_write(topology, bcs):
    """Random values on each filled axis' interior (its last face included
    on a face-located axis) and on the unfilled axes, NaN elsewhere: the
    plain fills change exactly the points that ``fill_plan`` marks. (A
    plane or callable of (x, z) or (y, z) values has no 2D (X, Y, 1) field
    to fill, so those BCs go on 3D fields only.)"""
    grid = T.RectilinearGrid(size=(9, 7, 5), x=(0, 1), y=(0, 2), z=zfaces(5, 1.0, 1.5),
                             topology=topology, dtype=torch.float64, device=DEVICE)
    rng = np.random.default_rng(4)
    for loc in (CENTER, U_LOC, V_LOC, W_LOC, (T.F, T.F, T.F)):
        b = regularize_bcs(grid, loc, None if BCS[bcs] is None else T.FieldBCs(**BCS[bcs]))
        for axes, shape in FILLS(grid, bcs):
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


def FILLS(grid, bcs):
    """(axes, shape) of the fills a test makes with ``BCS[bcs]``: 3D
    fields on every axis and on y and z, and a 2D (X, Y, 1) field on x and
    y where its BCs are scalars."""
    out = [((0, 1, 2), grid.total_shape), ((1, 2), grid.total_shape)]
    if bcs not in ("gradient", "planes", "callables"):
        out.append(((0, 1), grid.total_shape[:2] + (1,)))
    return out


#: K6 block shapes (threads, points a thread) the launch-plan test decodes:
#: the source's (256, 4) and others
LAUNCH_SHAPES = [(32, 1), (256, 4), (64, 8)]


def kernel_points(ints, threads, items):
    """The (x, y, z) points that the threads of K6's three passes write over
    one field of plan ``ints``, blocks of ``threads`` threads and ``items``
    points a thread, one row a write: a numpy mirror of how the kernel
    counts each pass' blocks (``csrc/fill_halos.cu::launch``) and decodes
    its block, thread and item indices (``pass_point``)."""
    (Sx, _, _, lx, hx, *_), (Sy, _, _, ly, hy, *_), (Sz, _, _, lz, hz, *_) = ints
    wx, wy, wz, cx, cy = lx + Sx - hx, ly + Sy - hy, lz + Sz - hz, hx - lx, hy - ly
    written = lambda lo, hi, n: np.where(n < lo, n, hi + n - lo)
    bx, by, bz = (-(-n // (threads * items))
                  for n in (wx * Sy * Sz, cx * wy * Sz, cx * cy * wz))
    points = lambda blocks: np.arange(blocks * threads * items)
    out = []
    r = points(bx)  # x slabs
    n = r // (Sy * Sz)
    r, n = r[n < wx], n[n < wx]
    y = (r - n * Sy * Sz) // Sz
    out.append(np.stack([written(lx, hx, n), y, r - n * Sy * Sz - y * Sz], 1))
    if by:  # y runs
        r = points(by)
        i = r // (wy * Sz)
        r, i = r[i < cx], i[i < cx]
        n = (r - i * wy * Sz) // Sz
        out.append(np.stack([lx + i, written(ly, hy, n), r - i * wy * Sz - n * Sz], 1))
    if bz:  # z halos
        r = points(bz)
        c = r // wz
        i = c // cy
        r, c, i = r[i < cx], c[i < cx], i[i < cx]
        out.append(np.stack([lx + i, ly + c - i * cy, written(lz, hz, r - c * wz)], 1))
    return np.concatenate(out)


@pytest.mark.parametrize("size", [(13, 7, 5), (16, 12, 10)])
@pytest.mark.parametrize("topology", [("bounded",) * 3, ("periodic", "periodic", "bounded"),
                                      ("periodic",) * 3])
@pytest.mark.parametrize("threads,items", LAUNCH_SHAPES)
def test_launch_plan_writes_each_halo_point_once(size, topology, threads, items):
    """K6's passes and block counts, decoded as the kernel decodes them
    (mirrored in numpy: ``kernel_points``), cover each point that
    ``fill_plan`` marks as written exactly once and no other point, for
    every location, the flux, open and value BCs, 3D and 2D fields, at
    sizes off the blocks, at the source's block shape and at others."""
    grid = T.RectilinearGrid(size=size, x=(0, 1), y=(0, 2), z=zfaces(size[2], 1.0, 1.5),
                             topology=topology, dtype=torch.float64, device=DEVICE)
    for loc in (CENTER, U_LOC, V_LOC, W_LOC):
        for v in BCS.values():
            b = regularize_bcs(grid, loc, None if v is None else T.FieldBCs(**v))
            for axes, shape in (((0, 1, 2), grid.total_shape), ((1, 2), grid.total_shape),
                                ((0, 1), grid.total_shape[:2] + (1,))):
                ints, _ = tff.fill_plan(grid, loc, b, axes, shape)
                count = np.zeros(shape, int)
                np.add.at(count, tuple(kernel_points(ints, threads, items).T), 1)
                assert np.array_equal(count, written_mask(ints).astype(int)), (loc, axes)


def test_launch_plan_cases_include_the_sources_block_shape():
    """The block shape that ``csrc/fill_halos.cu`` is built with is one of
    those the launch-plan test decodes."""
    src = (Path(tff.__file__).parent.parent / "csrc" / "fill_halos.cu").read_text()
    shape = re.search(r"constexpr int FILL_THREADS = (\d+), FILL_ITEMS = (\d+);", src)
    assert shape is not None
    assert tuple(map(int, shape.groups())) in LAUNCH_SHAPES


def test_side_table_layout_matches_the_source():
    """The host's side-table record (``SIDE``) and gradient halo limit are
    the kernel's ``FillSide`` and ``MAX_FILL_HALO``: a pointer, three
    strides, then the distances, 8 bytes each."""
    src = (Path(tff.__file__).parent.parent / "csrc" / "fill_halos.cu").read_text()
    assert int(re.search(r"#define MAX_FILL_HALO (\d+)", src).group(1)) == tff.MAX_HALO
    fields = re.search(r"struct FillSide \{([^}]*)\};", src).group(1)
    assert [l.split()[-1] for l in fields.strip().splitlines()] == [
        "plane;", "st[3];", "dist[MAX_FILL_HALO];"]
    assert tff.SIDE.names == ("plane", "st", "dist")
    assert tff.SIDE.itemsize == 8 * (1 + 3 + tff.MAX_HALO)


def test_gate_refuses_what_the_kernel_lacks():
    """Too few cells for the sources to stay unwritten, a gradient halo past
    the side table; gradient BCs and plane or callable values it takes."""
    grid = T.RectilinearGrid(size=(9, 7, 5), extent=(1, 1, 1),
                             topology=("bounded", "bounded", "bounded"),
                             dtype=torch.float64, device=DEVICE)
    S = grid.total_shape
    for kind in ("gradient", "planes", "callables"):
        assert tff.unsupported_reason(grid, CENTER, T.FieldBCs(**BCS[kind]),
                                      (0, 1, 2), S) is None, kind
    # an open BC's value is not used on a centred side
    unused = T.FieldBCs(top=T.OpenBC(lambda x, y, t: x + y))
    assert tff.unsupported_reason(grid, CENTER, unused, (0, 1, 2), S) is None
    thin = T.RectilinearGrid(size=(9, 3, 5), extent=(1, 1, 1),
                             topology=("bounded", "bounded", "bounded"),
                             dtype=torch.float64, device=DEVICE)
    assert "H+1" in tff.unsupported_reason(thin, CENTER, None, (0, 1, 2), thin.total_shape)
    assert tff.unsupported_reason(thin, CENTER, None, (0, 2), thin.total_shape) is None
    wide = T.RectilinearGrid(size=(20, 7, 5), extent=(1, 1, 1),
                             topology=("bounded", "bounded", "bounded"),
                             halo=(tff.MAX_HALO + 1, 3, 3), dtype=torch.float64,
                             device=DEVICE)
    grad = T.FieldBCs(west=T.GradientBC(0.1))
    assert "gradient" in tff.unsupported_reason(wide, CENTER, grad, (0, 1, 2),
                                                wide.total_shape)
    # a gradient on a face-located axis fills as the zero-gradient mirror
    assert tff.unsupported_reason(wide, U_LOC, grad, (0, 1, 2), wide.total_shape) is None
    assert "size" in tff.unsupported_reason(grid, CENTER, None, (0, 1, 2), (9, 7, 5))
    assert torch_model()._fill_unsupported_reason() is None


def test_gate_over_several_fields_gives_the_first_reason():
    """``fields_unsupported_reason``, the gate both models apply to their
    fills: None when K6 takes every field, else the first field's reason."""
    grid = T.RectilinearGrid(size=(9, 3, 5), extent=(1, 1, 1),
                             topology=("bounded", "bounded", "bounded"),
                             dtype=torch.float64, device=DEVICE)
    S = grid.total_shape
    ok = (CENTER, T.FieldBCs(west=T.GradientBC(0.1)), (0, 2), S)
    thin = (CENTER, None, (0, 1, 2), S)
    shape = (CENTER, None, (0, 1, 2), (S[0] - 1,) + S[1:])
    assert tff.fields_unsupported_reason(grid, [ok, (W_LOC, None, (0,), S)]) is None
    assert "H+1" in tff.fields_unsupported_reason(grid, [ok, thin, shape])
    assert "size" in tff.fields_unsupported_reason(grid, [shape, thin])


def jax_bcs(kind):
    """``BCS[kind]`` for the JAX package: its BC classes, the callables
    written again with jnp (the same arithmetic), the planes as they are."""
    from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jb
    jnp_call = {"gradient": dict(east=lambda y, z, t: y - z + t,
                                 bottom=lambda x, y, t: x * y + 1.0),
                "callables": dict(east=lambda y, z, t: 0.5 * y + z + t,
                                  south=lambda x, z, t: x - 2.0 * z,
                                  north=lambda x, z, t: x * z,
                                  bottom=lambda x, y, t: x + y * y + t,
                                  top=lambda x, y, t: 0.1 * x - y)}
    out = {}
    for side, bc in BCS[kind].items():
        value = jnp_call.get(kind, {}).get(side, bc.value)
        out[side] = jb.BC(bc.kind, value)
    return jb.FieldBCs(**out)


@pytest.mark.parametrize("kind", ["gradient", "planes", "callables"])
@pytest.mark.parametrize("topology", [("bounded",) * 3, ("periodic", "bounded", "bounded")])
def test_plain_version_matches_jax_with_gradients_planes_and_callables(kind, topology):
    """K6's plain version against the JAX ``fill_halos``, bitwise, on a
    stretched z, every location, with gradient BCs (scalar, plane and
    callable b) and with plane and callable values (the callables written
    with torch and with jnp, the same polynomial)."""
    kw = dict(size=(9, 7, 5), x=(0, 1), y=(0, 2), z=zfaces(5, 1.0, 1.5))
    tg = T.RectilinearGrid(topology=topology, dtype=torch.float64, device=DEVICE, **kw)
    jg = J.RectilinearGrid(topology=topology, dtype=jnp.float64, **kw)
    from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jb
    rng = np.random.default_rng(6)
    for tloc, jloc in ((CENTER, J.CENTER), (U_LOC, J.U_LOC), (V_LOC, J.V_LOC),
                       (W_LOC, J.W_LOC)):
        tb = regularize_bcs(tg, tloc, T.FieldBCs(**BCS[kind]))
        jbc = jb.regularize_bcs(jg, jloc, jax_bcs(kind))
        d = rng.standard_normal(tg.total_shape)
        got, = tff.fused_fill_halos(tg, [(torch.as_tensor(d), tloc, tb, (0, 1, 2), 1.5)])
        ref = j_fill(jnp.asarray(d), jg, jloc, jbc, 1.5)
        assert np.array_equal(np.asarray(ref), got.numpy()), tloc


def traced_fill(grid, data, loc, bcs, axes, t):
    """K6's rule in numpy, point by point over ``fill_plan``'s written
    points: each axis' index wrapped or mirrored to its source, the last
    wall face in fill order replacing what came before it, then the axes'
    operations in fill order, a plane read at the destination's index on
    the axes filled before and at the source's on those filled after
    (``csrc/fill_halos.cu::fill_point``)."""
    ints, values = tff.fill_plan(grid, loc, bcs, axes, data.shape)
    order = tff.fill_order(grid)
    dt = data.dtype.type

    def b_at(a, side, c):
        bc = values[a][side]
        if tff._is_scalar(bc.value):
            return dt(bc.value or 0.0)
        shape = list(data.shape)
        shape[a] = 1
        plane = torch.broadcast_to(tbcs._bvalue(bc, grid, a, side, loc, t), shape).numpy()
        c = list(c)
        c[a] = 0
        return plane[tuple(c)]

    def rule(a, i):
        S, N, H, lo, hi, k0, k1, v0, v1 = ints[a]
        side = 0 if i < lo else 1
        if lo <= i < hi:
            return i, "copy", side
        kind, flag = (k0, v0) if side == 0 else (k1, v1)
        if kind == tff.WRAP:
            return (i + N if side == 0 else i - N), "copy", side
        if kind == tff.MIRROR_C:
            m = 2 * H - 1 - i if side == 0 else 2 * (H + N) - 1 - i
            s = min(max(m, H), H + N - 1)
        else:
            face = H if side == 0 else H + N
            if i == face:
                return i, "wall", side
            s = min(max(2 * face - i, H), H + N)
        return s, {tff.NO_VALUE: "copy", tff.VALUE: "reflect",
                   tff.GRADIENT: "shift"}[flag], side

    out = data.copy()
    for p in zip(*np.nonzero(written_mask(ints))):
        rules = [rule(a, int(p[a])) for a in range(3)]
        walls = [n for n, a in enumerate(order) if rules[a][1] == "wall"]
        first = walls[-1] if walls else 0
        c = [r[0] for r in rules]
        for n in range(first):
            c[order[n]] = p[order[n]]
        a0 = order[first]
        v = (b_at(a0, rules[a0][2], c) if walls
             else data[tuple(r[0] for r in rules)])
        c[a0] = p[a0]
        for n in range(first + 1 if walls else 0, 3):
            a = order[n]
            _s, op, side = rules[a]
            if op == "reflect":
                v = dt(2) * b_at(a, side, c) - v
            elif op == "shift":
                S, N, H, *_ = ints[a]
                d = tff.gradient_distances(grid, a, side)[p[a] if side == 0 else p[a] - H - N]
                v = v - b_at(a, side, c) * dt(d)
            c[a] = p[a]
        out[tuple(p)] = v
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["value", "open", "gradient", "planes", "callables"])
@pytest.mark.parametrize("topology", [("bounded",) * 3, ("periodic", "bounded", "bounded"),
                                      ("bounded", "periodic", "bounded")])
def test_fill_plan_traced_point_by_point_matches_the_plain_fills(topology, kind, dtype):
    """``fill_plan`` and the kernel's rule (``traced_fill``, a numpy mirror
    of ``fill_point``) give every written point, corners included, bitwise
    the plain fills' value, from NaN on every written point: every
    location, a stretched z, scalar, plane and callable values and
    gradients. A plane read at the wrong coordinates differs only at the
    corners."""
    grid = T.RectilinearGrid(size=(9, 7, 5), x=(0, 1), y=(0, 2), z=zfaces(5, 1.0, 1.5),
                             topology=topology, dtype=dtype, device=DEVICE)
    rng = np.random.default_rng(9)
    for loc in (CENTER, U_LOC, V_LOC, W_LOC, (T.F, T.F, T.F)):
        b = regularize_bcs(grid, loc, T.FieldBCs(**BCS[kind]))
        for axes, shape in FILLS(grid, kind)[:2]:
            ints, _ = tff.fill_plan(grid, loc, b, axes, shape)
            data = np.full(shape, np.nan, dtype=np.float64 if dtype == torch.float64
                           else np.float32)
            keep = tuple(slice(lo, hi) for _S, _N, _H, lo, hi, *_ in ints)
            data[keep] = rng.standard_normal(data[keep].shape)
            ref = torch.as_tensor(data.copy())
            tff.fused_fill_halos_reference(grid, [(ref, loc, b, axes, 0.75)])
            got = traced_fill(grid, data, loc, b, axes, 0.75)
            assert np.array_equal(got, ref.numpy()), (loc, axes)
            assert not np.isnan(got).any()


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,size", [(torch.float32, (64, 48, 40)),
                                        (torch.float64, (37, 29, 23))])
def test_cuda_k6_on_the_nonhydrostatic_groups_over_nan_halos(dtype, size):
    """The nonhydrostatic model's two groups (u, v, w, b; then pHY′ or
    pNHS) with value, open and flux walls, each point outside the kept
    interior NaN before the fill: K6 and its plain version bitwise on
    every with-halo point, one launch a group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    grid = T.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                             topology=("periodic", "periodic", "bounded"),
                             dtype=dtype, device="cuda")
    model = T.NonhydrostaticModel(
        grid, advection=T.WENO5(), buoyancy=T.BuoyancyTracer(), tracers=("c",),
        boundary_conditions={"w": T.FieldBCs(bottom=T.FluxBC(), top=T.OpenBC(0.0)),
                             "b": T.FieldBCs(top=T.ValueBC(0.25)),
                             "c": T.FieldBCs(bottom=T.ValueBC(-1.0), top=T.FluxBC())},
        timestepper="RungeKutta3")
    assert model.kernels["fill"] is tff.fused_fill_halos
    g = model.grid
    groups = [[(model._locs()[n], model.bcs[n]) for n in model.prognostic_names()],
              [(CENTER, model.pressure_bcs)]]
    gen = torch.Generator(device="cuda").manual_seed(7)
    for group in groups:
        base = []
        for loc, b in group:
            ints, _ = tff.fill_plan(g, loc, b, (0, 1, 2), g.total_shape)
            a = torch.full(g.total_shape, float("nan"), dtype=dtype, device="cuda")
            keep = tuple(slice(lo, hi) for _S, _N, _H, lo, hi, *_r in ints)
            a[keep] = torch.randn(a[keep].shape, generator=gen, dtype=dtype, device="cuda")
            base.append(a)
        got, ref = [a.clone() for a in base], [a.clone() for a in base]
        n0 = tff.fused_fill_halos.launches
        tff.fused_fill_halos(g, [(a, loc, b, (0, 1, 2), 0.0) for a, (loc, b) in zip(got, group)])
        assert tff.fused_fill_halos.launches == n0 + 1
        tff.fused_fill_halos_reference(g, [(a, loc, b, (0, 1, 2), 0.0)
                                           for a, (loc, b) in zip(ref, group)])
        for a, r in zip(got, ref):
            assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["gradient", "planes", "callables"])
def test_cuda_k6_gradients_planes_and_callables_over_nan_halos(kind, dtype):
    """K6 with gradient BCs on a stretched z and plane and callable values,
    every location, on (Bounded, Bounded, Bounded) and (Periodic, Bounded,
    Bounded) grids, with two fields of scalar values in the group, each
    written point NaN before the fill: bitwise its plain version on every
    with-halo point, one launch a group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for topology in (("bounded",) * 3, ("periodic", "bounded", "bounded")):
        g = T.RectilinearGrid(size=(9, 7, 5), x=(0, 1), y=(0, 2), z=zfaces(5, 1.0, 1.5),
                              topology=topology, dtype=dtype, device="cuda")
        specs = [(loc, regularize_bcs(g, loc, T.FieldBCs(**BCS[kind])), axes)
                 for loc in (CENTER, U_LOC, V_LOC, W_LOC, (T.F, T.F, T.F))
                 for axes, _shape in FILLS(g, kind)]
        # fields of scalar values in the same launch read no side table
        specs[1:1] = [(loc, regularize_bcs(g, loc, T.FieldBCs(**BCS["value"])), (0, 1, 2))
                      for loc in (CENTER, W_LOC)]
        gen = torch.Generator(device="cuda").manual_seed(8)
        base = []
        for loc, b, axes in specs:
            ints, _ = tff.fill_plan(g, loc, b, axes, g.total_shape)
            a = torch.full(g.total_shape, float("nan"), dtype=dtype, device="cuda")
            keep = tuple(slice(lo, hi) for _S, _N, _H, lo, hi, *_r in ints)
            a[keep] = torch.randn(a[keep].shape, generator=gen, dtype=dtype, device="cuda")
            base.append(a)
        got, ref = [a.clone() for a in base], [a.clone() for a in base]
        n0 = tff.fused_fill_halos.launches
        tff.fused_fill_halos(g, [(a, loc, b, axes, 0.5) for a, (loc, b, axes) in zip(got, specs)])
        assert tff.fused_fill_halos.launches == n0 + 1
        tff.fused_fill_halos_reference(g, [(a, loc, b, axes, 0.5)
                                           for a, (loc, b, axes) in zip(ref, specs)])
        for a, r in zip(got, ref):
            assert torch.equal(a, r)
