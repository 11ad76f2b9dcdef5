"""Vertically implicit diffusion: the identity branch only.

Counterpart of ``clima_oceananigans_jl_tpu/closures/
implicit_vertical_diffusion.py``. The backward-Euler column solve is not
ported yet (ROADMAP Queue 1 item 4): the model refuses a closure with
``time_discretization="vertically_implicit"``, so the implicit step is
the identity for every configuration the port accepts.
"""
from __future__ import annotations


def implicit_step_is_noop(closure):
    """True when ``implicit_step_fields`` is the identity for this closure."""
    if closure is None:
        return True
    if isinstance(closure, (tuple, list)):
        return all(implicit_step_is_noop(c) for c in closure)
    return not getattr(closure, "vertically_implicit", False)


def implicit_step_fields(solution, grid, locs, closure, dt, diffusivities=None,
                         bcs=None, t=0.0):
    """The implicit vertical solve of every prognostic field: the
    identity unless a closure is vertically implicit, which raises."""
    if not implicit_step_is_noop(closure):
        raise NotImplementedError(
            "vertically implicit diffusion is not ported yet (ROADMAP "
            "Queue 1 item 4)")
    return solution
