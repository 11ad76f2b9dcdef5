"""Fused stencil kernels of the models' tendencies and projection.

Counterpart of ``clima_oceananigans_jl_tpu/ops/fused_tendencies.py``:

- K2, the Pallas kernel ``fused_advective_tendencies``: −∇·(vψ) of u, v,
  w and every tracer of the nonhydrostatic model in one launch
  (``csrc/fused_advective_tendencies.cu`` for the first codes,
  ``csrc/fused_advective_tendencies_any.cu`` for the ``ANY`` and ``BF``
  instantiations, two libraries built at once, ``k2_library``; on a
  stretched z its stretched
  instantiation, with per-level Δz and the WENO5 family's tables as z
  rows; on a grid stretched in x or y its stretched-x/y form, a source of
  its own (``csrc/fused_advective_tendencies_xy.cu``) with the rows of
  every axis (``ops/metric_rows.py::axis_rows``), counted apart in
  ``fused_advective_tendencies.stretched_launches``; on an immersed grid its IM instantiations, with the clear flags of
  ``immersed/immersed.py::clear_flags``; ``PositiveWENO5``'s limiter, for
  momentum or tracers, in its ANY instantiations), with
  ``supports_fused_advection`` and ``z_halo_free_ok``;
- K3, the generic tiler ``pallas_fuse``, as one concrete kernel for each
  of its three users:
  - K3a ``fused_shallow_water_tendencies``, the shallow-water core
    (``_core_tendencies``: Guh, Gvh, Gh and the tracers;
    ``csrc/fused_shallow_water_tendencies.cu``);
  - K3b ``fused_divergence``, ``div_ccc(u, v, w)`` of the general
    projection, and K3c ``fused_pressure_gradient``, ∇pNHS on the u, v,
    w faces (both ``csrc/fused_projection.cu``).

Each wrapper, on CUDA tensors, launches its hand-written kernel (or
raises; nothing falls back), and on CPU tensors runs its plain PyTorch
version ``<name>_reference``, the JAX package's whole-array stencils. The
kernels write interiors (K2 also each velocity's far wall face on a
bounded axis)
and leave zero halos; the plain versions' halos hold whatever the
whole-array stencils left there. Each wrapper counts
its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ..advection.fluxes import div_Uc, div_vu, div_vv, div_vw
from ..advection.schemes import (BoundsPreservingWENO5, CenteredFourthOrder,
                                 CenteredSecondOrder, PositiveWENO5,
                                 UpwindBiasedFifthOrder, UpwindBiasedFirstOrder,
                                 UpwindBiasedThirdOrder, WENO5,
                                 reduced_order_masks, transport)
from ..grids.topology import BOUNDED, FLAT, PERIODIC
from ..immersed.immersed import clear_flags
from ..utils.location import C, CENTER, F, U_LOC, V_LOC, W_LOC
from . import _build
from . import operators as op
from . import stencil as st
from .metric_rows import axis_rows, z_rows


def supports_fused_advection(grid):
    """The JAX package's gate of its fused advection (x and y regular and
    not bounded, a y halo): it chooses the JAX model's AB2 branch and
    ``G_prev`` layout, which the port keeps (``ops/fused_step.py::
    fused_step_ok``). The port's K2 takes every grid the model accepts (a
    stretched x or y in its stretched-x/y form); this test decides no
    kernel."""
    return (grid.hregular and grid.topology[0] is not BOUNDED
            and grid.topology[1] is not BOUNDED
            and grid.Hy >= 1 and grid.Nz >= 1)


def kernel_order(grid):
    """The kernels' axes as grid axes: the grid's own order, or, with a
    Flat axis, z the last axis that is not Flat, y the first Flat one and
    x the other. Moving an axis of extent 1 keeps the offset of every
    point of a contiguous array, so the kernels read and write the grid's
    tensors as they are, with the fields (and outputs) of the three
    velocities in this order; a Flat y lets K1 and K2 lay their blocks on
    the other two axes, and K3c its columns along an axis that is not
    Flat."""
    flat = [a for a in range(3) if grid.topology[a] is FLAT]
    if not flat:
        return (0, 1, 2)
    if len(flat) == 3:
        raise ValueError(f"the kernels need an axis that is not Flat: {grid}")
    z = max(a for a in range(3) if grid.topology[a] is not FLAT)
    x = ({0, 1, 2} - {flat[0], z}).pop()
    return (x, flat[0], z)


def in_kernel_order(order, xs):
    """The velocities' entries of ``xs`` (u, v, w first) in the kernels'
    axis order, then the rest."""
    return [xs[a] for a in order] + list(xs[3:])


def z_halo_free_ok(grid, w_bcs=None):
    """The JAX package's test for z-halo-free kernel blocks: a regular z
    that is periodic, or bounded with impenetrable (zero open/value) w
    walls. The port's kernels read real z halos either way; the model uses
    this test only to choose the JAX package's ``G_prev`` layout."""
    if grid.shape[2] <= 1 or grid.halo[2] == 0 or not grid.z_regular:
        return False
    topo = grid.topology[2]
    if topo is PERIODIC:
        return True
    if topo is not BOUNDED or w_bcs is None:
        return False
    for bc in (w_bcs.bottom, w_bcs.top):
        if bc is None or bc.kind not in ("open", "value"):
            return False
        v = bc.value
        if not (v is None or (isinstance(v, (int, float)) and v == 0.0)):
            return False
    return True


def fused_advective_tendencies_reference(grid, scheme, tracer_scheme, u, v, w,
                                         tracers):
    """The plain-PyTorch version of the kernel: −div_vu, −div_vv, −div_vw
    and −div_Uc of each tracer, with halos."""
    out = dict(u=-div_vu(grid, scheme, u, v, w),
               v=-div_vv(grid, scheme, u, v, w),
               w=-div_vw(grid, scheme, u, v, w))
    for name, c in tracers.items():
        out[name] = -div_Uc(grid, tracer_scheme, u, v, w, c)
    return out


#: the kernels' codes of the schemes (``csrc/weno5_advection.cuh``
#: ``SCHEME_*``): the JAX package's eight
KERNEL_SCHEMES = {CenteredSecondOrder: 0, WENO5: 1, UpwindBiasedFifthOrder: 2,
                  PositiveWENO5: 3, CenteredFourthOrder: 4,
                  UpwindBiasedFirstOrder: 5, UpwindBiasedThirdOrder: 6,
                  BoundsPreservingWENO5: 7}
#: the schemes whose transports take a stretched axis' tables (JAX's
#: ``transport`` takes them for ``isinstance(scheme, WENO5)``)
TABLE_SCHEMES = (WENO5, BoundsPreservingWENO5, PositiveWENO5)


def bf16_mode(scheme):
    """WENO5's bf16 option as the kernels take it (``csrc/
    weno5_advection.cuh`` ``BF16_*``): 2 for ``fast_bf16`` (which takes
    precedence, as in the plain version), 1 for ``bf16_smoothness`` (which
    the kernels read as 0 on fp64 data, where it does nothing), else 0."""
    if not isinstance(scheme, WENO5):
        return 0
    return 2 if scheme.fast_bf16 else int(scheme.bf16_smoothness)


def kernel_scheme(scheme):
    """(code, eps) of a scheme the kernels take (``KERNEL_SCHEMES``): the
    code plus 16 times its ``bf16_mode``; eps is the WENO schemes' own, 0
    for the others; raises otherwise."""
    code = KERNEL_SCHEMES.get(type(scheme))
    if code is None:
        raise ValueError("the kernels take the JAX package's eight advection "
                         f"schemes, not {type(scheme).__name__}")
    return (code + 16 * bf16_mode(scheme),
            float(scheme.eps) if isinstance(scheme, WENO5) else 0.0)


def positive_bounds(scheme):
    """PositiveWENO5's (lo, hi) as the kernels take them; (0, 0) for the
    other schemes, which read none."""
    if type(scheme) is PositiveWENO5:
        return tuple(float(b) for b in scheme.bounds)
    return 0.0, 0.0


def axis_bounds(grid, axis, scheme):
    """(masked, lo_l, hi_l, lo_r, hi_r) of ``scheme``'s near-wall order
    reduction along ``axis``: the with-halo bounds of
    ``reduced_order_masks`` (its left and right regions; for a centred
    scheme its symmetric region in both places), or (0, 0, -1, 0, -1)
    where nothing reduces."""
    masks = reduced_order_masks(grid, axis, scheme)
    if masks is None:
        return 0, 0, -1, 0, -1
    sym, left, right = masks
    return (1, *sym, *sym) if not scheme.is_upwind else (1, *left, *right)


def spacings(grid):
    """The regular spacings (dx, dy, dz) of the kernels (1 on a Flat
    axis, as the grid holds it; a stretched axis' come as rows, and its
    entry here is read by no instantiation)."""
    return (grid.Lx / grid.Nx, grid.Ly / grid.Ny, grid.Lz / grid.Nz)


def advection_args(grid, scheme, tracer_scheme, nf):
    """The shared advection arguments of K1 and K2 after the pointer
    arrays (``set_advection`` of ``csrc/weno5_advection.cuh``), in the
    kernels' axis order (``kernel_order``): a host array of ints (field
    count, sizes, halos, the two scheme codes, each axis' near-wall bounds
    of the momentum scheme, the grid axis of each kernel axis, whether the
    grid has a Flat axis, each axis' near-wall bounds of the tracer
    scheme) and one of doubles (eps of each scheme, the spacings, then
    ``positive_bounds`` of each scheme)."""
    if not 3 <= nf <= 16:
        raise ValueError(f"the kernels take 3 to 16 fields, got {nf}")
    order = kernel_order(grid)
    code_m, eps_m = kernel_scheme(scheme)
    code_t, eps_t = kernel_scheme(tracer_scheme)
    bounds = lambda s: (b for a in order for b in axis_bounds(grid, a, s))
    ints = (nf, *(grid.shape[a] for a in order), *(grid.halo[a] for a in order),
            code_m, code_t, *bounds(scheme), *order, int(FLAT in grid.topology),
            *bounds(tracer_scheme))
    d = spacings(grid)
    doubles = (eps_m, eps_t, *(d[a] for a in order), *positive_bounds(scheme),
               *positive_bounds(tracer_scheme))
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_double * len(doubles))(*doubles))


#: ctypes types of ``advection_args``
ADVECTION_ARGTYPES = [ctypes.c_void_p] * 2


def z_rows_arg(grid, scheme, tracer_scheme, general=False):
    """(z rows, tables) of K1's and K2's stretched (or general)
    instantiation: on a stretched z, or with ``general``, the z rows of
    ``ops/metric_rows.py`` (Δzᶜ and Δzᶠ per level, then WENO5's to-faces
    and to-centres tables when a scheme is of the WENO5 family,
    ``TABLE_SCHEMES``, and z is stretched) and whether they carry the
    tables; (None, 0) for the regular instantiation."""
    if grid.z_regular and not general:
        return None, 0
    tables = (not grid.z_regular and any(
        type(s) in TABLE_SCHEMES for s in (scheme, tracer_scheme)))
    return z_rows(grid, tables=tables, to_centres=tables), int(tables)


def stretched_rows_arg(grid, scheme, tracer_scheme):
    """(rows, tables) of K2's stretched-x/y form, in the kernels' axis order
    (``kernel_order``): each axis' ``axis_rows``, with WENO5's tables where
    the axis is stretched and a scheme is of the WENO5 family
    (``TABLE_SCHEMES``), and whether each carries them."""
    family = any(type(s) in TABLE_SCHEMES for s in (scheme, tracer_scheme))
    rows, tables = [], []
    for a in kernel_order(grid):
        ax = grid._axes[a]
        t = family and ax.topo is not FLAT and not ax.regular
        rows.append(axis_rows(grid, a, t))
        tables.append(int(t))
    return rows, tables


def check_tensor(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernels take contiguous tensors")


def pointers(ts):
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def kernel_fn(lib, name, dtype, argtypes):
    """The f32 or f64 entry ``<name>_f32/_f64`` of ``csrc/<lib>.cu``, typed:
    ``argtypes`` then the stream; returns the CUDA error code."""
    fn = getattr(_build.load(lib), name + ("_f32" if dtype == torch.float32
                                           else "_f64"))
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(name, fn, device, *args):
    """``fn(*args, stream)`` on the current stream of the tensors' card;
    raises on a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def k2_clear_flags(grid, scheme, tracer_scheme, ntracers):
    """K2's clear flags on an immersed grid: the uint8 tensors of
    ``clear_flags`` at U, V, W (the momentum scheme's buffer) and CENTER
    (the tracer scheme's), None for a field whose scheme reads no cell
    beyond its two (centred: the plain version builds no mask there) or
    for tracers that are not there; None on a grid without an immersed
    boundary."""
    if getattr(grid, "immersed", None) is None:
        return None
    flags = [clear_flags(grid, loc, scheme.buffer) if scheme.buffer > 0 else None
             for loc in (U_LOC, V_LOC, W_LOC)]
    flags.append(clear_flags(grid, CENTER, tracer_scheme.buffer)
                 if ntracers and tracer_scheme.buffer > 0 else None)
    return flags


#: the source of K2's stretched-x/y form (``csrc/<name>.cu``)
STRETCHED_XY_LIB = "fused_advective_tendencies_xy"
#: K2's two sources on a regular x and y (``csrc/<name>.cu``): the first
#: codes (centred, WENO5, UB5) and the ``ANY``/``BF`` instantiations, two
#: libraries built at once
K2_LIB, K2_ANY_LIB = "fused_advective_tendencies", "fused_advective_tendencies_any"
#: the schemes only K2's ``ANY`` instantiations take (``needs_any`` of
#: ``csrc/weno5_advection.cuh``)
ANY_SCHEMES = (CenteredFourthOrder, UpwindBiasedFirstOrder, UpwindBiasedThirdOrder,
               BoundsPreservingWENO5, PositiveWENO5)


def k2_library(scheme, tracer_scheme, dtype):
    """K2's library for a launch on a regular x and y in ``dtype``:
    ``K2_ANY_LIB`` where either scheme needs the ``ANY`` instantiations or
    has a bf16 option the kernels read (``bf16_smoothness`` only on fp32
    data: ``split_scheme``), else ``K2_LIB`` (the launchers'
    ``advection_any``)."""
    def needs(s):
        bf = bf16_mode(s)
        return type(s) in ANY_SCHEMES or bf == 2 or (bf == 1 and dtype == torch.float32)
    return K2_ANY_LIB if needs(scheme) or needs(tracer_scheme) else K2_LIB


def _launch(grid, scheme, tracer_scheme, u, v, w, tracers):
    names = ("u", "v", "w") + tuple(tracers)
    fields = [u, v, w] + list(tracers.values())
    device, dtype = u.device, grid.dtype
    ints, doubles = advection_args(grid, scheme, tracer_scheme, len(fields))
    for n, f in zip(names, fields):
        check_tensor(n, f, grid.total_shape, dtype, device)
    order = kernel_order(grid)
    flags = k2_clear_flags(grid, scheme, tracer_scheme, len(tracers))
    if flags is not None:
        for loc, f in zip(("U", "V", "W", "CENTER"), flags):
            if f is not None:
                check_tensor(f"clear flags at {loc}", f, grid.total_shape,
                             torch.uint8, device)
        flags = (ctypes.c_void_p * 4)(*[None if f is None else f.data_ptr()
                                        for f in in_kernel_order(order, flags)])
    # K2 writes every point: the interior, the zero halos and the wall faces
    out = [torch.empty(grid.total_shape, dtype=dtype, device=device)
           for _ in names]
    # a bounded axis' wall faces; a FULLY_CONNECTED axis (cut over a mesh)
    # reads its exchanged halos as a periodic one does and has none
    walls = sum(1 << a for a in range(3) if grid.topology[order[a]] is BOUNDED)
    # the metric rows: a stretched z's (or none) for the tiled forms, every
    # axis' for the stretched-x/y form (a source of its own)
    if grid.hregular:
        lib = entry = k2_library(scheme, tracer_scheme, dtype)
        zs, tables = z_rows_arg(grid, scheme, tracer_scheme)
        rows = (None if zs is None else zs.data_ptr(), tables)
        rowtypes = [ctypes.c_void_p, ctypes.c_int]
    else:
        lib, entry = STRETCHED_XY_LIB, "fused_advective_tendencies_stretched"
        axes, tables = stretched_rows_arg(grid, scheme, tracer_scheme)
        rows = (pointers(axes), (ctypes.c_int * 3)(*tables))
        rowtypes = [ctypes.c_void_p] * 2
    fn = kernel_fn(lib, entry, dtype,
                   [ctypes.c_void_p] * 2 + ADVECTION_ARGTYPES + [ctypes.c_int]
                   + rowtypes + [ctypes.c_void_p])
    launch("fused_advective_tendencies", fn, device,
           pointers(in_kernel_order(order, fields)),
           pointers(in_kernel_order(order, out)), ints, doubles, walls, *rows,
           flags)
    fused_advective_tendencies.launches += 1
    fused_advective_tendencies.stretched_launches += int(not grid.hregular)
    return dict(zip(names, out))


def fused_advective_tendencies(grid, scheme, tracer_scheme, u, v, w, tracers):
    """−∇·(advective fluxes) of u, v, w and every tracer → a dict of
    with-halo tensors valid on the interior and, on each bounded axis, on
    the far wall face of the velocity normal to it (u's east face, v's
    north face, w's top face: with-halo index h + n), which a wall that is
    not an imposed value leaves to the time step. CUDA tensors go through the
    hand-written kernel (a failure raises; nothing falls back), CPU tensors
    through ``fused_advective_tendencies_reference``."""
    if u.device.type == "cuda":
        return _launch(grid, scheme, tracer_scheme, u, v, w, tracers)
    if u.device.type != "cpu":
        raise ValueError(f"no fused_advective_tendencies for {u.device.type} "
                         "tensors")
    return fused_advective_tendencies_reference(grid, scheme, tracer_scheme,
                                                u, v, w, tracers)


#: kernel launches since the last reset (the plain version adds nothing),
#: and of them those of the stretched-x/y form
fused_advective_tendencies.launches = 0
fused_advective_tendencies.stretched_launches = 0


# -- K3a: the shallow-water core -------------------------------------------------

def _ixyff(h):
    """ℑxyᶠᶠ: 4-point average of a centred field onto (F, F, ·)."""
    return st.ixf(st.iyf(h))


def fused_shallow_water_tendencies_reference(grid, scheme, tracer_scheme, g,
                                             uh, vh, h, tracers=(),
                                             bathymetry=None):
    """The plain-PyTorch version of K3a: the JAX package's
    ``_core_tendencies`` (advection, −∂(gh²/2), bathymetry and mass
    tendencies of the conservative shallow-water form) →
    ``(Guh, Gvh, Gh, *Gc)``, with-halo tensors valid on the interior."""
    u_cc = st.ixc(uh)
    v_ff = st.ixf(vh)
    flux_huu = grid.Ax(CENTER) * transport(scheme, u_cc, uh, 0, False, grid) / h
    flux_hvu = grid.Ay((F, F, C)) * transport(scheme, v_ff, uh, 1, True, grid) / _ixyff(h)
    div_mom_u = (st.dxf(flux_huu) + st.dyc(flux_hvu)) / grid.V(U_LOC)
    Guh = -div_mom_u - st.dxf(0.5 * g * h * h) / grid.dx(U_LOC)
    if bathymetry is not None:
        Guh = Guh + g * st.ixf(h) * st.dxf(bathymetry) / grid.dx(U_LOC)

    u_ff = st.iyf(uh)
    v_cc = st.iyc(vh)
    flux_huv = grid.Ax((F, F, C)) * transport(scheme, u_ff, vh, 0, True, grid) / _ixyff(h)
    flux_hvv = grid.Ay(CENTER) * transport(scheme, v_cc, vh, 1, False, grid) / h
    div_mom_v = (st.dxc(flux_huv) + st.dyf(flux_hvv)) / grid.V(V_LOC)
    Gvh = -div_mom_v - st.dyf(0.5 * g * h * h) / grid.dy(V_LOC)
    if bathymetry is not None:
        Gvh = Gvh + g * st.iyf(h) * st.dyf(bathymetry) / grid.dy(V_LOC)

    Gh = -(st.dxc(grid.Ax(U_LOC) * uh)
           + st.dyc(grid.Ay(V_LOC) * vh)) / grid.V(CENTER)
    outs = [Guh, Gvh, Gh]
    if tracers:
        # tracers ride the velocity u = uh/h̄ˣ, not the transport
        u_vel = uh / st.ixf(h)
        v_vel = vh / st.iyf(h)
        div_U = (st.dxc(grid.Ax(U_LOC) * u_vel)
                 + st.dyc(grid.Ay(V_LOC) * v_vel)) / grid.V(CENTER)
        for c in tracers:
            fx = grid.Ax(U_LOC) * transport(tracer_scheme, u_vel, c, 0, True, grid)
            fy = grid.Ay(V_LOC) * transport(tracer_scheme, v_vel, c, 1, True, grid)
            div_Uc = (st.dxc(fx) + st.dyc(fy)) / grid.V(CENTER)
            outs.append(-div_Uc + c * div_U)
    return tuple(outs)


def shallow_water_args(grid, scheme, tracer_scheme, nf, g):
    """K3a's arguments after the pointers: field count, sizes, halos, the
    two scheme codes, the momentum scheme's x and y near-wall bounds, the
    tracer scheme's, eps of each scheme, spacings, g, ``positive_bounds``
    of each scheme."""
    if not 3 <= nf <= 16:
        raise ValueError(f"K3a takes 3 to 16 fields, got {nf}")
    if grid.topology[2] is not FLAT or grid.shape[2] != 1:
        raise ValueError(f"K3a takes a flat z axis: {grid}")
    code_m, eps_m = kernel_scheme(scheme)
    code_t, eps_t = kernel_scheme(tracer_scheme)
    bounds = lambda s: (*axis_bounds(grid, 0, s), *axis_bounds(grid, 1, s))
    return (nf, grid.Nx, grid.Ny, grid.Hx, grid.Hy, code_m, code_t,
            *bounds(scheme), *bounds(tracer_scheme),
            eps_m, eps_t, grid.Lx / grid.Nx, grid.Ly / grid.Ny, float(g),
            *positive_bounds(scheme), *positive_bounds(tracer_scheme))


def _launch_shallow_water(grid, scheme, tracer_scheme, g, uh, vh, h, tracers,
                          bathymetry):
    fields = [uh, vh, h] + list(tracers)
    device, dtype = uh.device, grid.dtype
    args = shallow_water_args(grid, scheme, tracer_scheme, len(fields), g)
    names = ["uh", "vh", "h"] + [f"tracers[{i}]" for i in range(len(tracers))]
    for n, f in zip(names, fields):
        check_tensor(n, f, grid.total_shape, dtype, device)
    if bathymetry is not None:
        check_tensor("bathymetry", bathymetry, grid.total_shape, dtype, device)
    # K3a writes every point: the interior and the zero halos
    out = [torch.empty(grid.total_shape, dtype=dtype, device=device)
           for _ in fields]
    fn = kernel_fn("fused_shallow_water_tendencies",
                   "fused_shallow_water_tendencies", dtype, [ctypes.c_void_p] * 5)
    ints, doubles = args[:27], args[27:]
    launch("fused_shallow_water_tendencies", fn, device, pointers(fields),
           None if bathymetry is None else bathymetry.data_ptr(),
           pointers(out), (ctypes.c_int * 27)(*ints),
           (ctypes.c_double * len(doubles))(*doubles))
    fused_shallow_water_tendencies.launches += 1
    return tuple(out)


def fused_shallow_water_tendencies(grid, scheme, tracer_scheme, g, uh, vh, h,
                                   tracers=(), bathymetry=None):
    """The conservative shallow-water core → ``(Guh, Gvh, Gh, *Gc)``,
    with-halo tensors valid on the interior. CUDA tensors go through the
    hand-written kernel K3a (a failure raises; nothing falls back), CPU
    tensors through ``fused_shallow_water_tendencies_reference``."""
    if uh.device.type == "cuda":
        return _launch_shallow_water(grid, scheme, tracer_scheme, g, uh, vh,
                                     h, tracers, bathymetry)
    if uh.device.type != "cpu":
        raise ValueError(f"no fused_shallow_water_tendencies for "
                         f"{uh.device.type} tensors")
    return fused_shallow_water_tendencies_reference(
        grid, scheme, tracer_scheme, g, uh, vh, h, tracers, bathymetry)


#: kernel launches since the last reset (the plain version adds nothing)
fused_shallow_water_tendencies.launches = 0


# -- K3b and K3c: the general projection's divergence and gradient ----------------

def fused_divergence_reference(grid, u, v, w):
    """The plain-PyTorch version of K3b: the interior (nx, ny, nz) of
    ``div_ccc(u, v, w)``."""
    return grid.interior(op.div_ccc(u, v, w, grid))


def fused_pressure_gradient_reference(grid, p):
    """The plain-PyTorch version of K3c: (∂xᶠp, ∂yᶠp, ∂zᶠp) on the u, v
    and w faces, with-halo, valid on the interior."""
    return (st.dxf(p) / grid.dx(U_LOC), st.dyf(p) / grid.dy(V_LOC),
            st.dzf(p) / grid.dz(W_LOC))


def _projection_args(grid):
    """K3b's and K3c's arguments after the pointers, in the kernels' axis
    order (``kernel_order``): sizes, halos, spacings."""
    order = kernel_order(grid)
    d = spacings(grid)
    return (*(grid.shape[a] for a in order), *(grid.halo[a] for a in order),
            *(d[a] for a in order))


#: ctypes types of ``_projection_args``
PROJECTION_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_double] * 3


def _launch_divergence(grid, u, v, w):
    args = _projection_args(grid)
    for n, f in (("u", u), ("v", v), ("w", w)):
        check_tensor(n, f, grid.total_shape, grid.dtype, u.device)
    out = torch.empty(grid.shape, dtype=grid.dtype, device=u.device)
    fn = kernel_fn("fused_projection", "fused_divergence", grid.dtype,
                   [ctypes.c_void_p] * 4 + PROJECTION_ARGTYPES)
    velocities = in_kernel_order(kernel_order(grid), (u, v, w))
    launch("fused_divergence", fn, u.device,
           *(f.data_ptr() for f in velocities), out.data_ptr(), *args)
    fused_divergence.launches += 1
    return out


def fused_divergence(grid, u, v, w):
    """∇·(u, v, w) at the interior cell centres → an (nx, ny, nz) tensor.
    CUDA tensors go through the hand-written kernel K3b (a failure raises;
    nothing falls back), CPU tensors through
    ``fused_divergence_reference``. The halos of u, v, w must be filled."""
    if u.device.type == "cuda":
        return _launch_divergence(grid, u, v, w)
    if u.device.type != "cpu":
        raise ValueError(f"no fused_divergence for {u.device.type} tensors")
    return fused_divergence_reference(grid, u, v, w)


def _launch_pressure_gradient(grid, p):
    args = _projection_args(grid)
    check_tensor("p", p, grid.total_shape, grid.dtype, p.device)
    # K3c writes every point: the interior and the zero halos
    out = [torch.empty(grid.total_shape, dtype=grid.dtype, device=p.device)
           for _ in range(3)]
    fn = kernel_fn("fused_projection", "fused_pressure_gradient", grid.dtype,
                   [ctypes.c_void_p] * 4 + PROJECTION_ARGTYPES)
    launch("fused_pressure_gradient", fn, p.device, p.data_ptr(),
           *[o.data_ptr() for o in in_kernel_order(kernel_order(grid), out)],
           *args)
    fused_pressure_gradient.launches += 1
    return tuple(out)


def fused_pressure_gradient(grid, p):
    """(∂xᶠp, ∂yᶠp, ∂zᶠp) on the u, v, w faces → three with-halo tensors
    valid on the interior. CUDA tensors go through the hand-written kernel
    K3c (a failure raises; nothing falls back), CPU tensors through
    ``fused_pressure_gradient_reference``. The halos of p must be filled:
    the wall-face gradient reads them."""
    if p.device.type == "cuda":
        return _launch_pressure_gradient(grid, p)
    if p.device.type != "cpu":
        raise ValueError(f"no fused_pressure_gradient for {p.device.type} "
                         "tensors")
    return fused_pressure_gradient_reference(grid, p)


#: kernel launches since the last reset (the plain versions add nothing)
fused_divergence.launches = 0
fused_pressure_gradient.launches = 0
