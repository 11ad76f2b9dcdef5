"""Lazy operations over fields: the diagnostics' expression trees.

Counterpart of ``clima_oceananigans_jl_tpu/abstract_operations.py``
(Oceananigans' AbstractOperations: unary, binary and multiary operations,
derivatives, ``@at``, grid metrics, kernel-function and conditional
operations, ``compute`` and the metric-weighted ``Average`` and
``Integral``). Operands at different locations are brought to one by the
2-point interpolations of ``ops/operators.py::interp_to``. ``evaluate``
runs each node of the tree as PyTorch ops on with-halo tensors; where
the JAX package traces the tree into one fused XLA expression, here each
node is its own op.

Usage:
    u, v = model.fields(state)["u"], model.fields(state)["v"]
    omega = partial_x(v) - partial_y(u)        # lazy, at (F, F, C)
    field = compute(omega, grid)               # a Field, halos filled
    Average(omega, dims=(0, 1)).compute(grid)  # metric-weighted
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .fields.field import Field
from .ops import operators as op
from .ops.operators import flip_loc, interp_to
from .utils.location import CENTER


class Operand:
    """Mixin giving expression-building operators to operations."""

    def __add__(self, other):
        return BinaryOperation(torch.add, self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return BinaryOperation(torch.sub, self, other)

    def __rsub__(self, other):
        return BinaryOperation(torch.sub, other, self)

    def __mul__(self, other):
        return BinaryOperation(torch.mul, self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return BinaryOperation(torch.div, self, other)

    def __rtruediv__(self, other):
        return BinaryOperation(torch.div, other, self)

    def __pow__(self, n):
        return UnaryOperation(lambda a: a ** n, self)

    def __neg__(self):
        return UnaryOperation(torch.neg, self)


@dataclasses.dataclass
class FieldOperand(Operand):
    field: Field

    @property
    def loc(self):
        return self.field.loc

    def evaluate(self, grid):
        return self.field.data


def _wrap(x):
    if isinstance(x, Field):
        return FieldOperand(x)
    if isinstance(x, Operand):
        return x
    return ConstantOperand(x)


@dataclasses.dataclass
class ConstantOperand(Operand):
    value: Any
    loc: tuple = CENTER

    def evaluate(self, grid):
        return torch.as_tensor(self.value, dtype=grid.dtype, device=grid.device)


def _at(operand, value, loc):
    """``value`` of ``operand`` interpolated to ``loc`` (constants pass)."""
    if isinstance(operand, ConstantOperand) or operand.loc == loc:
        return value
    return interp_to(value, operand.loc, loc)


@dataclasses.dataclass
class UnaryOperation(Operand):
    fn: Callable
    a: Any

    def __post_init__(self):
        self.a = _wrap(self.a)

    @property
    def loc(self):
        return self.a.loc

    def evaluate(self, grid):
        return self.fn(self.a.evaluate(grid))


@dataclasses.dataclass
class BinaryOperation(Operand):
    """fn(a, b) at a's location (b's when a is a constant, or
    ``target_loc``), the other operand interpolated to it."""

    fn: Callable
    a: Any
    b: Any
    target_loc: Optional[tuple] = None

    def __post_init__(self):
        self.a = _wrap(self.a)
        self.b = _wrap(self.b)

    @property
    def loc(self):
        if self.target_loc is not None:
            return self.target_loc
        if isinstance(self.a, ConstantOperand):
            return self.b.loc
        return self.a.loc

    def evaluate(self, grid):
        loc = self.loc
        return self.fn(_at(self.a, self.a.evaluate(grid), loc),
                       _at(self.b, self.b.evaluate(grid), loc))


@dataclasses.dataclass
class GridMetric(Operand):
    """A grid metric as an operand (``Integral(c * GridMetric("volume"))``):
    one of dx, dy, dz, Ax, Ay, Az, volume at ``at_loc``."""

    metric: str
    at_loc: tuple = CENTER

    @property
    def loc(self):
        return self.at_loc

    def evaluate(self, grid):
        fn = {"dx": grid.dx, "dy": grid.dy, "dz": grid.dz, "Ax": grid.Ax,
              "Ay": grid.Ay, "Az": grid.Az, "volume": grid.V}[self.metric]
        return torch.broadcast_to(fn(self.at_loc), grid.total_shape)


@dataclasses.dataclass
class MultiaryOperation(Operand):
    """fn(*args) with every argument interpolated to one location: the
    first non-constant argument's, or ``target_loc``."""

    fn: Callable
    args: tuple
    target_loc: Optional[tuple] = None

    def __post_init__(self):
        self.args = tuple(_wrap(a) for a in self.args)

    @property
    def loc(self):
        if self.target_loc is not None:
            return self.target_loc
        for a in self.args:
            if not isinstance(a, ConstantOperand):
                return a.loc
        return CENTER

    def evaluate(self, grid):
        loc = self.loc
        return self.fn(*(_at(a, a.evaluate(grid), loc) for a in self.args))


@dataclasses.dataclass
class Derivative(Operand):
    a: Any
    axis: int

    def __post_init__(self):
        self.a = _wrap(self.a)

    @property
    def loc(self):
        return flip_loc(self.a.loc, self.axis)

    def evaluate(self, grid):
        return op.dd(self.a.evaluate(grid), grid, self.axis, self.a.loc)


def partial_x(f):
    """∂x, at the location flipped in x."""
    return Derivative(f, 0)


def partial_y(f):
    return Derivative(f, 1)


def partial_z(f):
    return Derivative(f, 2)


@dataclasses.dataclass
class AtOperation(Operand):
    """An operand interpolated to an explicit location (``@at``)."""

    a: Any
    target: tuple

    def __post_init__(self):
        self.a = _wrap(self.a)

    @property
    def loc(self):
        return self.target

    def evaluate(self, grid):
        return interp_to(self.a.evaluate(grid), self.a.loc, self.target)


def at(loc, f):
    return AtOperation(f, tuple(loc))


@dataclasses.dataclass
class KernelFunctionOperation(Operand):
    """A function of (grid, *args) returning a with-halo tensor at ``loc``."""

    fn: Callable
    loc: tuple = CENTER
    args: tuple = ()

    def evaluate(self, grid):
        return self.fn(grid, *self.args)


@dataclasses.dataclass
class ConditionalOperation(Operand):
    """where(cond, operand, other); ``cond`` a mask or a function of the grid."""

    a: Any
    cond: Any
    other: Any = 0.0

    def __post_init__(self):
        self.a = _wrap(self.a)

    @property
    def loc(self):
        return self.a.loc

    def evaluate(self, grid):
        cond = self.cond(grid) if callable(self.cond) else self.cond
        return torch.where(cond, self.a.evaluate(grid), self.other)


def compute(operand, grid, bcs=None, t=0.0):
    """The operation as a new Field of the grid's with-halo shape, its
    halos filled under ``bcs`` (the location's defaults if None)."""
    from .boundary_conditions.bcs import fill_halos, regularize_bcs
    operand = _wrap(operand)
    data = torch.empty(grid.total_shape, dtype=grid.dtype, device=grid.device)
    data.copy_(operand.evaluate(grid))
    bcs = regularize_bcs(grid, operand.loc, bcs)
    fill_halos(data, grid, operand.loc, bcs, t)
    return Field(data, operand.loc, bcs)


@dataclasses.dataclass
class Average:
    """The metric-weighted mean of an operation over ``dims``."""

    operand: Any
    dims: tuple = (0, 1, 2)

    def compute(self, grid):
        from .fields.field import average
        return average(compute(self.operand, grid), grid, self.dims)


@dataclasses.dataclass
class Integral:
    """The metric-weighted integral of an operation over ``dims``."""

    operand: Any
    dims: tuple = (0, 1, 2)

    def compute(self, grid):
        from .fields.field import integral
        return integral(compute(self.operand, grid), grid, self.dims)
