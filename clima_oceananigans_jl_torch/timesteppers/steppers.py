"""Time stepping: the clock, the low-storage RK3 substep and the
quasi-Adams-Bashforth-2 substep.

Counterpart of ``clima_oceananigans_jl_tpu/timesteppers/steppers.py``
(Oceananigans' ``Clock``, ``RungeKutta3TimeStepper`` and
``QuasiAdamsBashforth2TimeStepper``):

* RK3: Le-Moin low-storage table γ = (8/15, 5/12, 3/4),
  ζ = (0, −17/60, −5/12); the stage clock ticks by (γᵐ+ζᵐ)Δt.
* QAB2: u ← u + Δt((3/2+χ)Gⁿ − (1/2+χ)G⁻), with χ = −1/2 (forward Euler)
  at iteration 0 and whenever Δt changed.

The clock lives on the host as Python numbers, so the Euler-or-AB2
choice costs no device synchronisation.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Clock:
    """Model time, iteration and RK3 stage counters."""

    time: float = 0.0
    iteration: int = 0
    stage: int = 0

    def tick(self, dt, stage=False):
        if stage:
            return Clock(self.time + dt, self.iteration, self.stage + 1)
        return Clock(self.time + dt, self.iteration + 1, 0)


RK3_GAMMA = (8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0)
RK3_ZETA = (0.0, -17.0 / 60.0, -5.0 / 12.0)


def rk3_substep(fields, G, G_prev, dt, gamma, zeta):
    """uᵐ⁺¹ = uᵐ + Δt(γᵐ Gᵐ + ζᵐ Gᵐ⁻¹) over a dict of prognostic fields."""
    if zeta == 0.0 or G_prev is None:
        return {k: u + dt * gamma * G[k] for k, u in fields.items()}
    return {k: u + dt * (gamma * G[k] + zeta * G_prev[k])
            for k, u in fields.items()}


def ab2_coefficients(chi, euler):
    """(c1, c2) = (3/2 + χ, 1/2 + χ), with χ = −1/2 on an Euler step."""
    chi = -0.5 if euler else chi
    return 1.5 + chi, 0.5 + chi


def ab2_substep(fields, G, G_prev, dt, chi, euler):
    """AB2 update of a dict of prognostic fields."""
    c1, c2 = ab2_coefficients(chi, euler)
    return {k: u + dt * (c1 * G[k] - c2 * G_prev[k]) for k, u in fields.items()}
