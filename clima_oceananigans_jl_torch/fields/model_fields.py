"""Named diagnostic fields of a model's state.

Counterpart of ``clima_oceananigans_jl_tpu/fields/model_fields.py``
(Oceananigans' ``BuoyancyField`` and ``PressureField``): functions of
(model, state) returning centre-located ``Field`` s computed now.
"""
from __future__ import annotations

from ..utils.location import CENTER
from .field import Field


def BuoyancyField(model, state):
    """The buoyancy perturbation at cell centres: the ``b`` tracer of a
    ``BuoyancyTracer``, or that of T and S through a ``SeawaterBuoyancy``'s
    equation of state."""
    if model.buoyancy is None:
        raise ValueError("model has no buoyancy")
    sol = state["solution"]
    tracers = {n: sol[n] for n in model.tracer_names}
    return Field(model.buoyancy.buoyancy_perturbation(model.grid, tracers),
                 CENTER)


def PressureField(model, state):
    """The total kinematic pressure pHY′ + pNHS at cell centres."""
    p = None
    for key in ("pHY", "pNHS"):
        if key in state:
            p = state[key] if p is None else p + state[key]
    if p is None:
        raise ValueError("state carries no pressure fields")
    return Field(p, CENTER)
