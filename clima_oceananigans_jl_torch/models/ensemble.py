"""Ensembles: a batched state with a leading member axis.

Counterpart of ``clima_oceananigans_jl_tpu/models/ensemble.py`` (in
place of Oceananigans' slice_ensemble_model_mode.jl and
single_column_model_mode.jl, which pack members into a spatial axis):
the state gains a leading member axis on every tensor. The JAX package
``vmap``s its jitted step over that axis. The port's ``model.step``
launches its CUDA kernels and, in its pcg solves, reads scalars on the
host, so ``torch.func.vmap`` cannot take it: ``ensemble_step`` steps the
members one after another through ``model.step``, kernels and all, and
stacks the results. Members are not batched into one launch; each is
bitwise the same member stepped alone.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..timesteppers.steppers import Clock


class _PerMember(tuple):
    """The Python leaves (ints, floats, None, objects) of every member."""


def _stack(xs):
    x0 = xs[0]
    if isinstance(x0, dict):
        return {k: _stack([x[k] for x in xs]) for k in x0}
    if isinstance(x0, Clock):
        return Clock(*(_stack([getattr(x, f.name) for x in xs])
                       for f in dataclasses.fields(Clock)))
    if isinstance(x0, torch.Tensor):
        return torch.stack(xs)
    if isinstance(x0, (np.ndarray, np.generic)):
        return np.stack(xs)
    if isinstance(x0, (tuple, list)) and not isinstance(x0, _PerMember):
        return type(x0)(_stack(list(z)) for z in zip(*xs))
    return _PerMember(xs)


def stack_states(states):
    """List of per-member states → one batched state (leading member axis)."""
    return _stack(list(states))


def member(batched_state, i):
    """Extract member i from a batched state."""
    b = batched_state
    if isinstance(b, dict):
        return {k: member(v, i) for k, v in b.items()}
    if isinstance(b, Clock):
        return Clock(*(member(getattr(b, f.name), i) for f in dataclasses.fields(Clock)))
    if isinstance(b, (torch.Tensor, np.ndarray, _PerMember)):
        return b[i]
    if isinstance(b, (tuple, list)):
        return type(b)(member(x, i) for x in b)
    return b


def _count(batched_state):
    """The number of members of a batched state."""
    return len(batched_state["clock"].iteration)


def ensemble_step(model, dt_per_member=False):
    """A step of every member: ``step(batched_state, dt)``. With
    ``dt_per_member`` each member has its own Δt (a (M,) array);
    otherwise Δt is shared."""
    def step(batched_state, dt):
        dts = (np.asarray(dt.detach().cpu() if isinstance(dt, torch.Tensor) else dt)
               if dt_per_member else None)
        return stack_states([
            model.step(member(batched_state, i), dts[i] if dt_per_member else dt)
            for i in range(_count(batched_state))])
    return step


def ensemble_initial_state(model, members):
    """Build a batched state from per-member init kwargs.

    `members`: list of dicts passed to ``model.initial_state``."""
    return stack_states([model.initial_state(**kw) for kw in members])
