"""Fields: located arrays with halos and boundary conditions.

Counterpart of ``clima_oceananigans_jl_tpu/fields/field.py`` (Oceananigans'
``Field``, ``set!``, windowed fields, field reductions, field tuples,
``interpolate``, ``regrid!`` and ``FunctionField``). A ``Field`` holds
``data`` (with halos, shape ``grid.total_shape``), its location ``loc``
and its ``bcs``; the grid is passed explicitly. Arithmetic on fields
builds the lazy operations of ``abstract_operations.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..boundary_conditions.bcs import FieldBCs, fill_halos, regularize_bcs
from ..utils.location import CENTER, U_LOC, V_LOC, W_LOC


@dataclasses.dataclass
class Field:
    data: torch.Tensor
    loc: tuple = CENTER
    bcs: Optional[FieldBCs] = None

    def interior(self, grid):
        return grid.interior(self.data)

    def with_data(self, data):
        return Field(data, self.loc, self.bcs)

    def filled(self, grid, t=0.0):
        """Fill the halos of ``data`` in place; returns the field."""
        fill_halos(self.data, grid, self.loc, self.bcs, t)
        return self

    # -- lazy expressions (abstract_operations.py) ----------------------------
    def _binop(self, fn, other, reverse=False):
        from ..abstract_operations import BinaryOperation
        return (BinaryOperation(fn, other, self) if reverse
                else BinaryOperation(fn, self, other))

    def __add__(self, other):
        return self._binop(torch.add, other)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(torch.sub, other)

    def __rsub__(self, other):
        return self._binop(torch.sub, other, reverse=True)

    def __mul__(self, other):
        return self._binop(torch.mul, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(torch.div, other)

    def __rtruediv__(self, other):
        return self._binop(torch.div, other, reverse=True)

    def __pow__(self, n):
        from ..abstract_operations import UnaryOperation
        return UnaryOperation(lambda a: a ** n, self)

    def __neg__(self):
        from ..abstract_operations import UnaryOperation
        return UnaryOperation(torch.neg, self)


def regularize_indices(grid, indices):
    """Per-axis windows as slices of the interior: each entry None or
    ``slice(None)`` (the whole axis), an int (one interior index, negative
    from the end) or a half-open (start, stop) interior range or slice."""
    out = []
    indices = (None, None, None) if indices is None else indices
    for a, ix in enumerate(indices):
        n = grid.shape[a]
        if ix is None or ix == slice(None):
            out.append(slice(0, n))
        elif isinstance(ix, int):
            ix = ix % n
            out.append(slice(ix, ix + 1))
        else:
            start, stop = (ix.start or 0, ix.stop if ix.stop is not None
                           else n) if isinstance(ix, slice) else ix
            out.append(slice(max(0, start), min(n, stop)))
    return tuple(out)


def windowed(field: Field, grid, indices):
    """A window of a field's interior (Oceananigans'
    ``Field(...; indices)``): a Field of no halos and no BCs whose
    ``indices`` attribute records the interior window."""
    sl_int = regularize_indices(grid, indices)
    sl = tuple(slice(h + s.start, h + s.stop)
               for h, s in zip(grid.halo, sl_int))
    out = Field(field.data[sl], field.loc, None)
    out.indices = sl_int
    return out


def new_field(grid, loc=CENTER, bcs=None, fill=0.0):
    bcs = regularize_bcs(grid, loc, bcs)
    data = torch.full(grid.total_shape, fill, dtype=grid.dtype,
                      device=grid.device)
    return Field(data, loc, bcs)


def CenterField(grid, bcs=None):
    return new_field(grid, CENTER, bcs)


def XFaceField(grid, bcs=None):
    return new_field(grid, U_LOC, bcs)


def YFaceField(grid, bcs=None):
    return new_field(grid, V_LOC, bcs)


def ZFaceField(grid, bcs=None):
    return new_field(grid, W_LOC, bcs)


def set_field(field: Field, grid, value, t=0.0) -> Field:
    """``set!``: writes ``value`` into the field and fills its halos.
    Accepts a scalar, an interior-shaped or with-halo array (numpy or
    torch), a callable ``f(x, y, z)`` of the field's node tensors, a
    ``FunctionField``, another ``Field`` or a lazy operation (computed,
    then interpolated to the field's location)."""
    from ..abstract_operations import Operand, compute
    from ..ops.operators import interp_to
    data = field.data
    if isinstance(value, FunctionField):
        value = value.at_time(grid, t)
    if isinstance(value, Operand):
        value = compute(value, grid, t=t)
    if isinstance(value, Field):
        src = value.data
        if value.loc != field.loc:
            src = interp_to(src, value.loc, field.loc)
        data.copy_(src)
    elif callable(value):
        x, y, z = grid.nodes(field.loc, with_halo=True)
        val = torch.as_tensor(value(x, y, z), dtype=grid.dtype,
                              device=grid.device)
        data.copy_(torch.broadcast_to(val, data.shape))
    elif np.isscalar(value) or getattr(value, "ndim", None) == 0:
        data.fill_(float(value))
    else:
        value = torch.as_tensor(value, dtype=grid.dtype, device=grid.device)
        if tuple(value.shape) == tuple(grid.shape):
            data[grid.interior_slices] = value
        else:
            data.copy_(torch.broadcast_to(value, data.shape))
    return field.filled(grid, t)


# -- metric-weighted reductions -----------------------------------------------
def _reduction_weight(field, grid, dims):
    """The product of the metrics along the reduced dims; on an immersed
    grid, zero at the solid nodes of the field's location."""
    w = torch.ones((), dtype=grid.dtype, device=grid.device)
    metrics = (grid.dx, grid.dy, grid.dz)
    for d in dims:
        w = w * metrics[d](field.loc)
    imm = getattr(grid, "immersed", None)
    if imm is not None:
        w = torch.where(imm.mask_for(tuple(field.loc)), 0.0, w)
    return w


def integral(field: Field, grid, dims=(0, 1, 2)):
    """∫ f dV over the interior, weighted along the reduced dims."""
    w = _reduction_weight(field, grid, dims)
    return torch.sum(grid.interior(field.data * w), dim=tuple(dims))


def average(field: Field, grid, dims=(0, 1, 2)):
    w = torch.broadcast_to(_reduction_weight(field, grid, dims), field.data.shape)
    num = torch.sum(grid.interior(field.data * w), dim=tuple(dims))
    den = torch.sum(grid.interior(w), dim=tuple(dims))
    return num / den


def field_norm(field: Field, grid):
    v = grid.interior(field.data)
    return torch.sqrt(torch.mean(v * v))


# -- field tuples ---------------------------------------------------------------
def VelocityFields(grid, bcs=None):
    bcs = bcs or {}
    return dict(u=XFaceField(grid, bcs.get("u")),
                v=YFaceField(grid, bcs.get("v")),
                w=ZFaceField(grid, bcs.get("w")))


def TracerFields(grid, names, bcs=None):
    bcs = bcs or {}
    return {name: CenterField(grid, bcs.get(name)) for name in names}


# -- interpolation and regridding --------------------------------------------------
def interpolate(field: Field, grid, x, y, z):
    """Trilinear interpolation of a field at points (tensors, arrays or
    scalars; a scalar x gives a 0-d result)."""
    from ..particles.lagrangian import interpolate_field
    as_1d = lambda q: torch.atleast_1d(torch.as_tensor(q, dtype=grid.dtype,
                                                       device=grid.device))
    out = interpolate_field(field.data, grid, field.loc, as_1d(x), as_1d(y), as_1d(z))
    return out[0] if np.ndim(x) == 0 else out


def regrid(field: Field, src_grid, dst_grid, t=0.0) -> Field:
    """The field resampled onto ``dst_grid`` by trilinear interpolation at
    its with-halo nodes, halos then filled (conservative only for smooth
    fields)."""
    from ..particles.lagrangian import interpolate_field
    x, y, z = dst_grid.nodes(field.loc, with_halo=True)
    shape = dst_grid.total_shape
    X, Y, Z = (torch.broadcast_to(q, shape).reshape(-1) for q in (x, y, z))
    vals = interpolate_field(field.data, src_grid, field.loc, X, Y, Z)
    return set_field(new_field(dst_grid, field.loc), dst_grid,
                     vals.reshape(shape), t)


@dataclasses.dataclass
class FunctionField:
    """An analytic field f(x, y, z[, t]) at a location, evaluated on a
    grid's with-halo nodes by ``at_time``."""

    func: Callable
    loc: tuple = CENTER
    time_dependent: bool = False

    def at_time(self, grid, t=0.0):
        x, y, z = grid.nodes(self.loc, with_halo=True)
        val = self.func(x, y, z, t) if self.time_dependent else self.func(x, y, z)
        data = torch.empty(grid.total_shape, dtype=grid.dtype, device=grid.device)
        data.copy_(torch.as_tensor(val, dtype=grid.dtype, device=grid.device))
        return Field(data, self.loc)
