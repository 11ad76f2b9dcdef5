"""Diagnostics: CFL numbers and state checking.

Counterpart of ``clima_oceananigans_jl_tpu/diagnostics/diagnostics.py``
(Oceananigans' ``AdvectiveCFL``, ``DiffusiveCFL`` and ``StateChecker``).
Each call reads device values back to the host, so each costs one
synchronisation; a simulation runs them only when their schedules fire.
"""
from __future__ import annotations

import logging

import torch

logger = logging.getLogger("clima_oceananigans_jl_torch")


class AdvectiveCFL:
    """CFL = Δt / cell_advection_timescale."""

    def __init__(self, dt=None):
        self.dt = dt

    def __call__(self, sim_or_model, state=None, dt=None):
        if state is None:  # called with a Simulation
            sim = sim_or_model
            model, state = sim.model, sim.state
            dt = sim.dt if dt is None else dt
        else:
            model = sim_or_model
            dt = self.dt if dt is None else dt
        return float(dt / model.cell_advection_timescale(state))


CFL = AdvectiveCFL


class DiffusiveCFL:
    """CFL = Δt / cell_diffusion_timescale over every closure; 0 when
    nothing limits (a vertically implicit part does not)."""

    def __init__(self, dt=None):
        self.dt = dt

    def __call__(self, sim):
        scale = float(sim.model.cell_diffusion_timescale(sim.state))
        dt = sim.dt if self.dt is None else self.dt
        return 0.0 if scale == float("inf") else float(dt / scale)


class StateChecker:
    """Logs the min, max and mean of every prognostic field's interior."""

    def __call__(self, sim):
        sol = sim.state.get("solution", {})
        parts = []
        for name, arr in sol.items():
            v = sim.model.grid.interior(arr)
            parts.append(f"{name}: min={float(torch.min(v)):+.6e} "
                         f"max={float(torch.max(v)):+.6e} "
                         f"mean={float(torch.mean(v)):+.6e}")
        logger.info("[state] it=%d t=%.6g | %s", sim.model_iteration(),
                    sim.model_time(), " | ".join(parts))
