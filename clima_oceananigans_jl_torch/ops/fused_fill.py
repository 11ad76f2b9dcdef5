"""Halo fills of several fields in one launch: kernel K6 and its plain version.

Counterpart of ``clima_oceananigans_jl_tpu/ops/fused_fill.py``, whose
Pallas ``fill_periodic_axis_inplace`` rewrites the halo strips of one
periodic axis of one field in place; the JAX hydrostatic model runs it
for the periodic x axis of its (x, z, y) state and leaves the bounded
axes to XLA slab updates. The port keeps the natural (x, y, z) layout,
and its kernel ``csrc/fill_halos.cu`` fills every axis of every field it
is given in one launch: the hydrostatic model's u, v, tracers and η in
``update_state``, then w and pHY′; the nonhydrostatic model's u, v, w and
tracers, then pHY′ (``update_state``), and the general projection's
copies of u, v and w, then pNHS.

``fused_fill_halos_reference``, the plain version, runs
``boundary_conditions/bcs.py::fill_halos`` field by field. The kernel
writes what that sequence of fills writes: each halo point takes the
value of one interior source point (each axis' index wrapped or mirrored)
through the operations of the axes whose halo holds it, in the fill
order: a copy, 2b − x (a value BC), b (a value or open wall face) or
x − b·d (a gradient BC, d the distance from the ghost's centre to its
mirror's). ``fill_plan`` describes that per axis. A BC value b is a
scalar (in the launch's arguments), or a with-halo plane that the wrapper
evaluates on the card with ``bcs.py::_bvalue`` at the fill's t (a plane
array padded to the halo shape, or a callable on the with-halo nodes),
which the kernel reads at the coordinates the value has when its axis is
filled: the destination's on the axes filled before, the source's on
those filled after. ``unsupported_reason`` is the static gate of one
field (enough cells that no source is itself written, a halo the
gradient table holds), ``fields_unsupported_reason`` that of a model's
fills. The wrapper runs the plain version on CPU tensors and the kernel
on CUDA tensors (or raises: nothing falls back), and counts its launches
in ``fused_fill_halos.launches``.

On a grid cut over a mesh of shards K6 fills the local axes, and the
neighbour exchange (``parallel/halo_exchange.py``) the cut ones, in the
fill order of ``fill_halos``: a run of local axes is one launch, each
cut axis one exchange of every field's strips; on the end shards of a
cut axis that is not periodic globally, K6 then writes the physical
side (in the launch of the local axes that follow, or one of its own).
The plain version fills field by field through ``fill_halos``, whose
cut axes exchange too: the same numbers.
"""
from __future__ import annotations

import ctypes
import numbers

import numpy as np
import torch

from ..boundary_conditions.bcs import _bvalue, default_bcs, fill_halos
from ..grids.topology import BOUNDED, FLAT, FULLY_CONNECTED, PERIODIC
from ..utils.location import F
from .fused_tendencies import check_tensor, kernel_fn, launch

#: the most fields one launch takes (``MAX_FILL_FIELDS`` of the source);
#: the wrapper launches once per group of that many
MAX_FIELDS = 16
#: how one side of an axis is filled (the source's enum)
KEEP, WRAP, MIRROR_C, MIRROR_F = range(4)
#: what a bounded side's value does (the source's value flags): nothing,
#: a value BC's b (2b − x, or b on a wall face), a gradient BC's x − b·d
NO_VALUE, VALUE, GRADIENT = range(3)
#: the most halo cells of a gradient side (``MAX_FILL_HALO`` of the source)
MAX_HALO = 8
#: one (field, axis, side) of the kernel's side table (``FillSide``): a
#: plane's device pointer (0: the scalar b) and its three strides, and a
#: gradient side's distances cc[mirror] − cc[ghost], one per ghost
SIDE = np.dtype([("plane", "<i8"), ("st", "<i8", (3,)),
                 ("dist", "<f8", (MAX_HALO,))])


def fused_fill_halos_reference(grid, fields):
    """The plain-PyTorch version of K6: ``fill_halos`` on each
    ``(data, loc, bcs, axes, t)`` of ``fields`` in turn, in place; returns
    the tensors."""
    return [fill_halos(data, grid, loc, bcs, t, axes=axes)
            for data, loc, bcs, axes, t in fields]


def _side(grid, loc, axis, side, bc):
    """(written count, kind, value flag, bc) of one bounded side, as
    ``bcs.py::_bounded_slab`` fills it; the bc is None where the fill reads
    no value."""
    H = grid.halo[axis]
    if bc is None or bc.kind == "periodic":
        return 0, KEEP, NO_VALUE, None
    if loc[axis] != F:
        if bc.kind == "value":
            return H, MIRROR_C, VALUE, bc
        if bc.kind == "gradient":
            if H > MAX_HALO:
                raise NotImplementedError(
                    f"K6 takes gradient BCs on halos of at most {MAX_HALO} cells")
            return H, MIRROR_C, GRADIENT, bc
        return H, MIRROR_C, NO_VALUE, None
    if bc.kind in ("open", "value"):
        return H + 1 if side == 0 else H, MIRROR_F, VALUE, bc
    # flux or gradient on a face-located axis: the zero-gradient mirror
    return H if side == 0 else H - 1, MIRROR_F, NO_VALUE, None


def fill_plan(grid, loc, bcs, axes, shape, edges=None):
    """Per axis (S, N, H, lo, hi, kind0, kind1, value0, value1) of one
    field of ``shape``, its written indices along the axis being [0, lo)
    and [hi, S), and per axis the (side 0, side 1) BCs whose values the
    fill reads (None where it reads none). A ``FULLY_CONNECTED`` axis is
    the exchange's, and K6 keeps it, but for the sides that ``edges``
    (per axis a pair of flags, or None) marks as the global grid's
    bounded sides, which it fills as a bounded axis'. Raises
    NotImplementedError for what K6 lacks."""
    bcs = bcs if bcs is not None else default_bcs(grid, loc)
    pairs = ((bcs.west, bcs.east), (bcs.south, bcs.north), (bcs.bottom, bcs.top))
    ints, values = [], []
    for axis in range(3):
        S, N, H = shape[axis], grid.shape[axis], grid.halo[axis]
        topo = grid.topology[axis]
        sides = edges[axis] if edges is not None else (False, False)
        if (axis not in axes or topo is FLAT
                or (topo is FULLY_CONNECTED and not any(sides))):
            ints.append((S, N, H, 0, S, KEEP, KEEP, NO_VALUE, NO_VALUE))
            values.append((None, None))
            continue
        if topo is FULLY_CONNECTED:
            if S != N + 2 * H:
                raise ValueError(f"axis {axis}: size {S}, expected {N + 2 * H}")
            if N < H + 1:
                raise NotImplementedError("K6 takes at least H+1 cells on a "
                                          "bounded axis")
            (w0, k0, v0, b0), (w1, k1, v1, b1) = (
                _side(grid, loc, axis, s, pairs[axis][s]) if sides[s]
                else (0, KEEP, NO_VALUE, None) for s in (0, 1))
            ints.append((S, N, H, w0, S - w1, k0, k1, v0, v1))
            values.append((b0, b1))
            continue
        if S != N + 2 * H:
            raise ValueError(f"axis {axis}: size {S}, expected {N + 2 * H}")
        if topo is PERIODIC:
            if N < H:
                raise NotImplementedError("K6 takes at least H cells on a periodic axis")
            ints.append((S, N, H, H, N + H, WRAP, WRAP, NO_VALUE, NO_VALUE))
            values.append((None, None))
            continue
        if topo is not BOUNDED:
            raise NotImplementedError(f"{topo!r} axes are not ported yet")
        if N < H + 1:
            raise NotImplementedError("K6 takes at least H+1 cells on a bounded axis")
        (w0, k0, v0, b0), (w1, k1, v1, b1) = (
            _side(grid, loc, axis, s, pairs[axis][s]) for s in (0, 1))
        ints.append((S, N, H, w0, S - w1, k0, k1, v0, v1))
        values.append((b0, b1))
    return ints, values


def fill_order(grid):
    """The axes in ``fill_halos``' order: periodic ones first."""
    return sorted(range(3), key=lambda a: grid.topology[a] is not PERIODIC)


def unsupported_reason(grid, loc, bcs, axes, shape):
    """Why K6 cannot fill a field of ``shape`` at ``loc`` with ``bcs`` on
    ``axes``, or None."""
    try:
        fill_plan(grid, loc, bcs, axes, shape)
    except (NotImplementedError, ValueError) as e:
        return str(e)
    return None


def fields_unsupported_reason(grid, fields):
    """Why K6 cannot fill one of ``fields``, each ``(loc, bcs, axes,
    shape)``, or None: the gate that a model applies to its fills at
    construction."""
    for loc, bcs, axes, shape in fields:
        reason = unsupported_reason(grid, loc, bcs, axes, shape)
        if reason is not None:
            return reason
    return None


def _is_scalar(v):
    """A BC value the launch passes as a number: None (zero), a real
    number, or a 0-d numpy value (a tensor or a callable becomes a plane)."""
    return v is None or isinstance(v, numbers.Real) or (
        isinstance(v, np.ndarray | np.generic) and np.ndim(v) == 0)


def gradient_distances(grid, axis, side):
    """cc[mirror] − cc[ghost] for each ghost of a centred bounded side, in
    the grid's type (as ``bcs.py::_bounded_slab`` forms them), as host
    floats; computed once per grid."""
    key = ("fill_gradient_distances", axis, side)
    if key not in grid._cache:
        N, H = grid.shape[axis], grid.halo[axis]
        cc = grid._axes[axis].cc.detach().cpu()
        clampc = lambda i: min(max(i, H), H + N - 1)
        ghosts = range(0, H) if side == 0 else range(H + N, 2 * H + N)
        mirror = (lambda g: clampc(2 * H - 1 - g)) if side == 0 else (
            lambda g: clampc(2 * (H + N) - 1 - g))
        grid._cache[key] = [float(cc[mirror(g)] - cc[g]) for g in ghosts]
    return grid._cache[key]


def _side_table(group, grid, plans, device, keep):
    """The kernel's side table of a group as a device tensor, or None when
    every value the group reads is a scalar and no side is a gradient.
    Planes made here are appended to ``keep`` (they must outlive the
    launch's enqueueing; the stream orders their reuse)."""
    table = np.zeros((len(group), 3, 2), SIDE)
    needed = False
    for f, ((data, loc, _bcs, _axes, t), (ints, values)) in enumerate(zip(group, plans)):
        for axis in range(3):
            for side in (0, 1):
                bc, flag = values[axis][side], ints[axis][7 + side]
                if flag == GRADIENT:
                    d = gradient_distances(grid, axis, side)
                    table[f, axis, side]["dist"][:len(d)] = d
                    needed = True
                if bc is None or _is_scalar(bc.value):
                    continue
                shape = list(data.shape)
                shape[axis] = 1
                plane = torch.broadcast_to(_bvalue(bc, grid, axis, side, loc, t),
                                           shape)
                if plane.dtype != data.dtype or plane.device != data.device:
                    raise ValueError(f"a BC value of {plane.dtype} on "
                                     f"{plane.device} for a field of "
                                     f"{data.dtype} on {data.device}")
                st = list(plane.stride())
                st[axis] = 0
                table[f, axis, side]["plane"] = plane.data_ptr()
                table[f, axis, side]["st"] = st
                keep.append(plane)
                needed = True
    if not needed:
        return None
    # device copies of the grid's side tables by their bytes: a group whose
    # planes and gradients are those of an earlier launch reuses its table
    # (a copy from pinned memory, so the host does not wait for the card)
    tables = grid._cache.setdefault("fill_side_tables", {})
    raw = table.tobytes()
    if raw not in tables:
        if len(tables) >= 64:
            tables.clear()
        host = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        tables[raw] = host.pin_memory().to(device, non_blocking=True)
    return tables[raw]


def _scalars(values):
    """The 6 scalar b's of one field (0.0 where a plane or nothing is read)."""
    return [float(bc.value or 0.0) if bc is not None and _is_scalar(bc.value)
            else 0.0 for pair in values for bc in pair]


def _launch(grid, fields, edges=None):
    device, dtype = fields[0][0].device, grid.dtype
    ptrs = set()
    for n, (data, loc, bcs, axes, _t) in enumerate(fields):
        check_tensor(f"fields[{n}]", data, data.shape, dtype, device)
        ptrs.add(data.data_ptr())
    if len(ptrs) != len(fields):
        raise ValueError("K6 fills distinct tensors in place")
    fn = kernel_fn("fill_halos", "fill_halos", dtype,
                   [ctypes.c_void_p] * 4 + [ctypes.c_int])
    order = fill_order(grid)
    for g0 in range(0, len(fields), MAX_FIELDS):
        group = fields[g0:g0 + MAX_FIELDS]
        plans = [fill_plan(grid, loc, bcs, axes, data.shape, edges)
                 for data, loc, bcs, axes, _t in group]
        ints, bs = [], []
        for fi, values in plans:
            ints += [v for axis in fi for v in axis] + order
            bs += _scalars(values)
        keep = []
        table = _side_table(group, grid, plans, device, keep)
        data_arr = (ctypes.c_void_p * len(group))(*[f[0].data_ptr() for f in group])
        int_arr = (ctypes.c_int * len(ints))(*ints)
        b_arr = (ctypes.c_double * len(bs))(*bs)
        launch("fill_halos", fn, device, data_arr, int_arr, b_arr,
               None if table is None else table.data_ptr(), len(group))
        fused_fill_halos.launches += 1
    return [f[0] for f in fields]


def cut_axes(grid):
    """The axes of ``grid`` cut over a mesh of shards (exchanged)."""
    return tuple(a for a in range(3) if grid.topology[a] is FULLY_CONNECTED
                 and grid.dist[a] is not None)


def _edges(grid, axis):
    """(side 0, side 1): whether this shard holds the global grid's
    bounded side of the cut ``axis``."""
    from ..parallel.halo_exchange import is_edge
    mesh_axis, n_shards, global_topo = grid.dist[axis]
    if global_topo is not BOUNDED:
        return (False, False)
    return tuple(is_edge(mesh_axis, n_shards, s) for s in (0, 1))


def _fill_cut_grid(grid, fields):
    """K6 and the exchange on a grid with cut axes, in ``fill_halos``'
    order: each run of local axes (and a cut axis' physical sides before
    it) one launch, each cut axis one exchange."""
    from ..parallel.halo_exchange import exchange_axis
    cut = cut_axes(grid)
    group, edges = [], [(False, False)] * 3

    def flush():
        sub = [(d, loc, bcs, tuple(a for a in axes if a in group), t)
               for d, loc, bcs, axes, t in fields]
        sub = [f for f in sub if f[3]]
        if sub:
            _launch(grid, sub, edges)

    for axis in fill_order(grid):
        if axis not in cut:
            group.append(axis)
            continue
        flush()
        group, edges = [], [(False, False)] * 3
        arrays = [d for d, _loc, _bcs, axes, _t in fields if axis in axes]
        if not arrays:
            continue
        mesh_axis, n_shards, global_topo = grid.dist[axis]
        exchange_axis(arrays, axis, grid.halo[axis], mesh_axis, n_shards,
                      global_topo is PERIODIC)
        side = _edges(grid, axis)
        if any(side):
            group, edges = [axis], [side if a == axis else (False, False)
                                    for a in range(3)]
    flush()
    return [f[0] for f in fields]


def fused_fill_halos(grid, fields):
    """Fill the halos of every ``(data, loc, bcs, axes, t)`` of ``fields``
    in place, as ``fill_halos(data, grid, loc, bcs, t, axes=axes)`` does one
    by one; returns the tensors. CUDA tensors go through K6, one launch for
    up to ``MAX_FIELDS`` distinct fields (a failure raises; nothing falls
    back), and on a grid cut over a mesh the exchange of its cut axes; CPU
    tensors through ``fused_fill_halos_reference``."""
    if not fields:
        return []
    device = fields[0][0].device
    if device.type == "cuda":
        if cut_axes(grid):
            return _fill_cut_grid(grid, fields)
        return _launch(grid, fields)
    if device.type != "cpu":
        raise ValueError(f"no fused_fill_halos for {device.type} tensors")
    return fused_fill_halos_reference(grid, fields)


#: kernel launches since the last reset (the plain version adds nothing)
fused_fill_halos.launches = 0
