"""Time stepping: the clock, the low-storage RK3 substep and the
quasi-Adams-Bashforth-2 substep.

Counterpart of ``clima_oceananigans_jl_tpu/timesteppers/steppers.py``
(Oceananigans' ``Clock``, ``RungeKutta3TimeStepper`` and
``QuasiAdamsBashforth2TimeStepper``):

* RK3: Le-Moin low-storage table γ = (8/15, 5/12, 3/4),
  ζ = (0, −17/60, −5/12); the stage clock ticks by (γᵐ+ζᵐ)Δt.
* QAB2: u ← u + Δt((3/2+χ)Gⁿ − (1/2+χ)G⁻), with χ = −1/2 (forward Euler)
  at iteration 0 and whenever Δt changed.

The clock lives on the host, so the Euler-or-AB2 choice costs no device
synchronisation. The models keep its ``time`` and ``previous_dt`` as numpy
scalars of the grid's dtype (``host_scalar``), and a tick adds in that
dtype: the JAX package keeps both as 0-d arrays of the grid's dtype, so an
fp32 clock rounds at every tick there, and here the same way.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def host_scalar(dtype, x):
    """``x`` as a numpy scalar of the torch ``dtype`` (float32 → np.float32)."""
    return np.dtype(str(dtype).removeprefix("torch.")).type(x)


def like(ref, x):
    """``x`` in the dtype of ``ref`` when ``ref`` is a numpy scalar (how a
    JAX 0-d array takes a Python float: rounded first); ``x`` otherwise."""
    return ref.dtype.type(x) if isinstance(ref, np.generic) else x


def scaled(c, dt):
    """c·Δt as the JAX step forms it: in Δt's dtype when Δt is a numpy
    scalar (an array there), in Python floats when it is a Python float."""
    return like(dt, c) * dt


def dt_changed(previous_dt, dt):
    """|previous Δt − Δt| > 1e-14, in the dtype of ``previous_dt``: the
    JAX test of whether a quasi-AB2 step falls back to Euler."""
    return bool(abs(previous_dt - like(previous_dt, dt)) > 1e-14)


@dataclasses.dataclass
class Clock:
    """Model time, iteration and RK3 stage counters; ``time`` a numpy
    scalar of the grid's dtype (or a Python float), which ``tick`` keeps."""

    time: float = 0.0
    iteration: int = 0
    stage: int = 0

    def tick(self, dt, stage=False):
        time = self.time + like(self.time, dt)
        if stage:
            return Clock(time, self.iteration, self.stage + 1)
        return Clock(time, self.iteration + 1, 0)


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
