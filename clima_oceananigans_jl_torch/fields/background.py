"""Background fields: a fixed (optionally time-dependent) environment the
prognostic fields perturb.

Counterpart of ``clima_oceananigans_jl_tpu/fields/background.py``
(Oceananigans' ``BackgroundField``): a background field is evaluated as a
whole with-halo tensor at its prognostic field's location, each time the
tendencies are computed, so a ``t``-dependent one follows the clock.
"""
from __future__ import annotations

import torch

from ..utils.location import CENTER


class BackgroundField:
    """``BackgroundField(func, parameters=None)`` with ``func(x, y, z, t)``
    (or ``func(x, y, z, t, parameters)`` when ``parameters`` is given),
    evaluated on the model grid at the matching field's location. Pass it
    in a model's ``background_fields`` dict:

        B = BackgroundField(lambda x, y, z, t, N: N**2 * z, parameters=N)
        model = NonhydrostaticModel(..., background_fields={"b": B})
    """

    def __init__(self, func, parameters=None):
        self.func = func
        self.parameters = parameters

    def evaluate(self, grid, loc, t=0.0):
        x, y, z = grid.nodes(loc, with_halo=True)
        if self.parameters is not None:
            val = self.func(x, y, z, t, self.parameters)
        else:
            val = self.func(x, y, z, t)
        return torch.broadcast_to(
            torch.as_tensor(val, dtype=grid.dtype, device=grid.device),
            grid.total_shape)

    def __repr__(self):
        return (f"BackgroundField({getattr(self.func, '__name__', self.func)}"
                + (f", parameters={self.parameters!r})"
                   if self.parameters is not None else ")"))


def materialize_background(background_fields, grid, locs, t):
    """name → with-halo tensor, evaluating ``BackgroundField`` entries at
    ``t``. A plain callable is taken as ``f(x, y, z, t)``; a tensor passes
    through."""
    out = {}
    for name, f in (background_fields or {}).items():
        if callable(f) and not isinstance(f, BackgroundField):
            f = BackgroundField(f)
        if isinstance(f, BackgroundField):
            out[name] = f.evaluate(grid, locs.get(name, CENTER), t)
        else:
            out[name] = f
    return out
