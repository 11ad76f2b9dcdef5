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
order. ``fill_plan`` describes that per axis; ``unsupported_reason`` is
the static gate of one field (scalar BC values, no gradient BCs, enough
cells that no source is itself written), ``fields_unsupported_reason``
that of a model's fills.
The wrapper runs the plain version on CPU tensors and the kernel on CUDA
tensors (or raises: nothing falls back), and counts its launches in
``fused_fill_halos.launches``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..boundary_conditions.bcs import default_bcs, fill_halos
from ..grids.topology import BOUNDED, FLAT, PERIODIC
from ..utils.location import F
from .fused_tendencies import check_tensor, kernel_fn, launch

#: the most fields one launch takes (``MAX_FILL_FIELDS`` of the source);
#: the wrapper launches once per group of that many
MAX_FIELDS = 16
#: how one side of an axis is filled (the source's enum)
KEEP, WRAP, MIRROR_C, MIRROR_F = range(4)


def fused_fill_halos_reference(grid, fields):
    """The plain-PyTorch version of K6: ``fill_halos`` on each
    ``(data, loc, bcs, axes, t)`` of ``fields`` in turn, in place; returns
    the tensors."""
    return [fill_halos(data, grid, loc, bcs, t, axes=axes)
            for data, loc, bcs, axes, t in fields]


def _scalar(bc):
    """A BC's value as a float; raises when it is not a scalar."""
    v = bc.value
    if v is None:
        return 0.0
    ndim = v.ndim if isinstance(v, torch.Tensor) else np.ndim(v)
    if callable(v) or ndim != 0:
        raise NotImplementedError(f"K6 takes scalar BC values, not {v!r} "
                                  "(ROADMAP Queue 1 item 1)")
    return float(v)


def _side(grid, loc, axis, side, bc):
    """(written count, kind, value flag, b) of one bounded side, as
    ``bcs.py::_bounded_slab`` fills it."""
    H = grid.halo[axis]
    if bc is None or bc.kind == "periodic":
        return 0, KEEP, 0, 0.0
    if bc.kind == "gradient":
        raise NotImplementedError("K6 has no gradient BCs (ROADMAP Queue 1 item 1)")
    if loc[axis] != F:
        if bc.kind == "value":
            return H, MIRROR_C, 1, _scalar(bc)
        return H, MIRROR_C, 0, 0.0
    if bc.kind in ("open", "value"):
        return H + 1 if side == 0 else H, MIRROR_F, 1, _scalar(bc)
    return H if side == 0 else H - 1, MIRROR_F, 0, 0.0


def fill_plan(grid, loc, bcs, axes, shape):
    """Per axis (S, N, H, lo, hi, kind0, kind1, value0, value1) and
    (b0, b1) of one field of ``shape``: its written indices along the axis
    are [0, lo) and [hi, S). Raises NotImplementedError for what K6 lacks."""
    bcs = bcs if bcs is not None else default_bcs(grid, loc)
    pairs = ((bcs.west, bcs.east), (bcs.south, bcs.north), (bcs.bottom, bcs.top))
    ints, bs = [], []
    for axis in range(3):
        S, N, H = shape[axis], grid.shape[axis], grid.halo[axis]
        topo = grid.topology[axis]
        if axis not in axes or topo is FLAT:
            ints.append((S, N, H, 0, S, KEEP, KEEP, 0, 0))
            bs.append((0.0, 0.0))
            continue
        if S != N + 2 * H:
            raise ValueError(f"axis {axis}: size {S}, expected {N + 2 * H}")
        if topo is PERIODIC:
            if N < H:
                raise NotImplementedError("K6 takes at least H cells on a periodic axis")
            ints.append((S, N, H, H, N + H, WRAP, WRAP, 0, 0))
            bs.append((0.0, 0.0))
            continue
        if topo is not BOUNDED:
            raise NotImplementedError(f"{topo!r} axes are not ported yet")
        if N < H + 1:
            raise NotImplementedError("K6 takes at least H+1 cells on a bounded axis")
        (w0, k0, v0, b0), (w1, k1, v1, b1) = (
            _side(grid, loc, axis, s, pairs[axis][s]) for s in (0, 1))
        ints.append((S, N, H, w0, S - w1, k0, k1, v0, v1))
        bs.append((b0, b1))
    return ints, bs


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


def _launch(grid, fields):
    device, dtype = fields[0][0].device, grid.dtype
    ptrs = set()
    for n, (data, loc, bcs, axes, _t) in enumerate(fields):
        check_tensor(f"fields[{n}]", data, data.shape, dtype, device)
        ptrs.add(data.data_ptr())
    if len(ptrs) != len(fields):
        raise ValueError("K6 fills distinct tensors in place")
    fn = kernel_fn("fill_halos", "fill_halos", dtype,
                   [ctypes.c_void_p] * 3 + [ctypes.c_int])
    order = fill_order(grid)
    for g0 in range(0, len(fields), MAX_FIELDS):
        group = fields[g0:g0 + MAX_FIELDS]
        ints, bs = [], []
        for data, loc, bcs, axes, _t in group:
            fi, fb = fill_plan(grid, loc, bcs, axes, data.shape)
            ints += [v for axis in fi for v in axis] + order
            bs += [v for axis in fb for v in axis]
        data_arr = (ctypes.c_void_p * len(group))(*[f[0].data_ptr() for f in group])
        int_arr = (ctypes.c_int * len(ints))(*ints)
        b_arr = (ctypes.c_double * len(bs))(*bs)
        launch("fill_halos", fn, device, data_arr, int_arr, b_arr, len(group))
        fused_fill_halos.launches += 1
    return [f[0] for f in fields]


def fused_fill_halos(grid, fields):
    """Fill the halos of every ``(data, loc, bcs, axes, t)`` of ``fields``
    in place, as ``fill_halos(data, grid, loc, bcs, t, axes=axes)`` does one
    by one; returns the tensors. CUDA tensors go through K6, one launch for
    up to ``MAX_FIELDS`` distinct fields (a failure raises; nothing falls
    back), CPU tensors through ``fused_fill_halos_reference``."""
    if not fields:
        return []
    device = fields[0][0].device
    if device.type == "cuda":
        return _launch(grid, fields)
    if device.type != "cpu":
        raise ValueError(f"no fused_fill_halos for {device.type} tensors")
    return fused_fill_halos_reference(grid, fields)


#: kernel launches since the last reset (the plain version adds nothing)
fused_fill_halos.launches = 0
