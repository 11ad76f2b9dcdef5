"""Buoyancy: the buoyancy tracer, seawater buoyancy with a linear or
nonlinear equation of state, the tilted-gravity terms and the hydrostatic
pressure anomaly.

Counterpart of ``clima_oceananigans_jl_tpu/buoyancy/buoyancy.py``
(Oceananigans' ``BuoyancyTracer``, ``SeawaterBuoyancy`` with
``LinearEquationOfState`` or an equation of state of ``nonlinear_eos.py``,
``g_dot_b`` and ``update_hydrostatic_pressure``). Every model provides
``buoyancy_perturbation(grid, tracers)``: b at (C, C, C).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import stencil as st
from ..utils.location import CENTER, W_LOC


@dataclasses.dataclass(frozen=True)
class BuoyancyTracer:
    """b is prognostic; requires a tracer named 'b'."""

    gravity_unit_vector: tuple = (0.0, 0.0, -1.0)

    required_tracers = ("b",)

    def buoyancy_perturbation(self, grid, tracers):
        return tracers["b"]


@dataclasses.dataclass(frozen=True)
class LinearEquationOfState:
    """ρ′ ∝ −α T + β S."""

    thermal_expansion: float = 1.67e-4
    haline_contraction: float = 7.80e-4


@dataclasses.dataclass(frozen=True)
class SeawaterBuoyancy:
    """b = g (α T − β S) with a ``LinearEquationOfState``; with any other
    equation of state (an object with ``density_anomaly(T, S, z)`` and,
    optionally, ``reference_density``, 1020 by default) b = −g ρ′(T, S,
    z)/ρ₀ at the with-halo z of the centres. T or S may be held constant
    (``constant_temperature``, ``constant_salinity``), and the tracers the
    model needs are the others."""

    gravitational_acceleration: float = 9.80665
    equation_of_state: object = LinearEquationOfState()
    constant_temperature: object = None
    constant_salinity: object = None
    gravity_unit_vector: tuple = (0.0, 0.0, -1.0)

    def __post_init__(self):
        eos = self.equation_of_state
        if (not isinstance(eos, LinearEquationOfState)
                and not callable(getattr(eos, "density_anomaly", None))):
            raise TypeError(
                f"equation_of_state {type(eos).__name__} has no "
                "density_anomaly(T, S, z) method (a LinearEquationOfState or "
                "an equation of state of buoyancy/nonlinear_eos.py)")

    @property
    def required_tracers(self):
        names = []
        if self.constant_temperature is None:
            names.append("T")
        if self.constant_salinity is None:
            names.append("S")
        return tuple(names)

    def buoyancy_perturbation(self, grid, tracers):
        g = self.gravitational_acceleration
        T = tracers["T"] if self.constant_temperature is None else self.constant_temperature
        S = tracers["S"] if self.constant_salinity is None else self.constant_salinity
        eos = self.equation_of_state
        if isinstance(eos, LinearEquationOfState):
            return g * (eos.thermal_expansion * T - eos.haline_contraction * S)
        zc = grid.nodes(CENTER, with_halo=True)[2]
        rho0 = getattr(eos, "reference_density", 1020.0)
        return -g * eos.density_anomaly(T, S, zc) / rho0


def buoyancy_x_term(buoyancy, grid, tracers):
    """x_dot_g_b at (F, C, C) for tilted gravity: −ĝₓ ℑx b (the stored
    unit vector points down), or None when gravity has no x part."""
    gx = buoyancy.gravity_unit_vector[0]
    if gx == 0.0:
        return None
    return -gx * st.ixf(buoyancy.buoyancy_perturbation(grid, tracers))


def buoyancy_y_term(buoyancy, grid, tracers):
    """y_dot_g_b at (C, F, C) for tilted gravity (see ``buoyancy_x_term``)."""
    gy = buoyancy.gravity_unit_vector[1]
    if gy == 0.0:
        return None
    return -gy * st.iyf(buoyancy.buoyancy_perturbation(grid, tracers))


def hydrostatic_pressure_anomaly(buoyancy, grid, tracers):
    """pHY′ at centres from the downward integral of −ĝ_z b̄ᶻ Δz: a
    with-halo array whose halos are left zero for the caller to fill. The
    integral is a reversed cumulative sum along z; its summation order
    differs from the JAX package's, so the two agree to rounding, not
    bitwise. Under tilted gravity only ĝ_z enters; the x and y parts are
    tendency terms (``buoyancy_x_term``, ``buoyancy_y_term``)."""
    b = buoyancy.buoyancy_perturbation(grid, tracers)
    gz = buoyancy.gravity_unit_vector[2]
    if gz != -1.0:
        b = -gz * b
    S = st.izf(b) * grid.dz(W_LOC)   # b̄(k)·Δzᶠ(k) at faces
    Nz, Hz = grid.Nz, grid.Hz
    S_int = S[:, :, Hz + 1:Hz + Nz + 1]   # faces 1..Nz
    ph_int = -torch.flip(torch.cumsum(torch.flip(S_int, (2,)), 2), (2,))
    out = grid.zeros()
    out[:, :, Hz:Hz + Nz] = ph_int
    return out
