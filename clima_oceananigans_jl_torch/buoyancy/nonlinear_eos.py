"""Nonlinear equations of state for seawater buoyancy.

Counterpart of ``clima_oceananigans_jl_tpu/buoyancy/nonlinear_eos.py``
(Oceananigans' SeawaterPolynomials.jl integration):
``SeawaterBuoyancy(equation_of_state=...)`` takes any object with
``density_anomaly(T, S, z) -> ρ′`` and ``reference_density``.

* ``RoquetIdealizedEquationOfState``: the second-order "realistic
  idealized" equation of state of Roquet et al. (2015, JPO): linear haline
  contraction plus thermal cabbeling (½Cᵇ Θ²) and thermobaricity (Tʰ Θ z).
* ``PolynomialEquationOfState``: ρ′ = Σ c · Θⁱ Sʲ zᵏ from {(i, j, k): c}.
* ``TEOS10EquationOfState``: the 55-term polyTEOS10-bsq fit of Roquet,
  Madec, McDougall & Barker (2015, Ocean Modelling 90), with the paper's
  check value ρ(SA = 30 g/kg, Θ = 10 °C, Z = −1000 m) = 1027.45140 kg/m³.

Each expression keeps the JAX package's order of operations term by term,
so that ρ′ is bit for bit the JAX package's on the same float64 inputs.
The integer powers of ``PolynomialEquationOfState`` are the products of
JAX's ``integer_pow`` (binary exponentiation), not ``torch.pow``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


def _integer_pow(x, n):
    """xⁿ (n ≥ 1) as JAX's ``integer_pow`` forms it: binary
    exponentiation, the accumulator multiplied by the running square."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _tensor(x, like):
    """``x`` as a tensor (of the first tensor in ``like``'s dtype and
    device, else float64), so that ``torch.sqrt`` takes a number too."""
    if isinstance(x, torch.Tensor):
        return x
    ref = next((t for t in like if isinstance(t, torch.Tensor)), None)
    if ref is None:
        return torch.as_tensor(x, dtype=torch.float64)
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


@dataclasses.dataclass(frozen=True)
class RoquetIdealizedEquationOfState:
    """ρ′(Θ,S,z) = −½Cᵇ(Θ−Θ₀)² − Tʰ(Θ−Θ₀)z + β₀(S−S₀) − α₀(Θ−Θ₀)."""

    thermal_expansion: float = 0.1655      # α₀ [kg m⁻³ K⁻¹] (ρ-based)
    haline_contraction: float = 0.7655     # β₀ [kg m⁻³ (g/kg)⁻¹]
    cabbeling: float = 0.011               # Cᵇ [kg m⁻³ K⁻²]
    thermobaricity: float = 2.5e-5         # Tʰ [kg m⁻³ K⁻¹ m⁻¹]
    reference_temperature: float = 10.0
    reference_salinity: float = 35.0
    reference_density: float = 1026.0

    def density_anomaly(self, T, S, z):
        dT = T - self.reference_temperature
        dS = S - self.reference_salinity
        return (-self.thermal_expansion * dT
                - 0.5 * self.cabbeling * dT * dT
                - self.thermobaricity * dT * z
                + self.haline_contraction * dS)


@dataclasses.dataclass(frozen=True)
class PolynomialEquationOfState:
    """ρ′ = Σ_{(i,j,k)} c_{ijk} Θⁱ Sʲ zᵏ (``from_dict`` takes a dict)."""

    coefficients: Tuple[Tuple[Tuple[int, int, int], float], ...]
    reference_density: float = 1026.0

    @classmethod
    def from_dict(cls, coeffs: Dict, reference_density=1026.0):
        return cls(tuple(sorted(coeffs.items())), reference_density)

    def density_anomaly(self, T, S, z):
        pw = lambda x, n: (_integer_pow(x, n) if isinstance(x, torch.Tensor)
                           else x ** n)
        rho = 0.0
        for (i, j, k), c in self.coefficients:
            term = c
            if i:
                term = term * pw(T, i)
            if j:
                term = term * pw(S, j)
            if k:
                term = term * pw(z, k)
            rho = rho + term
        return rho


@dataclasses.dataclass(frozen=True)
class TEOS10EquationOfState:
    """The 55-term polyTEOS10-bsq Boussinesq equation of state.

    ρ(SA, Θ, Z) = r′(s, τ, ζ) + r₀(ζ) in the reduced variables
    s = √((SA+ΔS)/SAu), τ = Θ/Θu, ζ = −Z/Zu of Roquet et al. (2015),
    Appendix A. z is the height (negative below the surface), Θ the
    conservative temperature [°C], SA the absolute salinity [g/kg].
    ``density_anomaly`` is ρ − ``reference_density``."""

    reference_density: float = 1020.0

    # reduced-variable scales (Roquet et al. 2015, Table 3)
    _SAu = 40.0 * 35.16504 / 35.0
    _CTu = 40.0
    _Zu = 1e4
    _deltaS = 32.0

    def density(self, T, S, z):
        ss = torch.sqrt(_tensor((S + self._deltaS) / self._SAu, (T, S, z)))
        tt = T / self._CTu
        zz = -z / self._Zu

        # vertical reference profile r0(ζ)
        R00 = 4.6494977072e+01; R01 = -5.2099962525e+00
        R02 = 2.2601900708e-01; R03 = 6.4326772569e-02
        R04 = 1.5616995503e-02; R05 = -1.7243708991e-03
        r0 = (((((R05 * zz + R04) * zz + R03) * zz + R02) * zz + R01) * zz
              + R00) * zz

        # 55-term density anomaly r′(s, τ, ζ)
        R000 = 8.0189615746e+02; R100 = 8.6672408165e+02
        R200 = -1.7864682637e+03; R300 = 2.0375295546e+03
        R400 = -1.2849161071e+03; R500 = 4.3227585684e+02
        R600 = -6.0579916612e+01; R010 = 2.6010145068e+01
        R110 = -6.5281885265e+01; R210 = 8.1770425108e+01
        R310 = -5.6888046321e+01; R410 = 1.7681814114e+01
        R510 = -1.9193502195e+00; R020 = -3.7074170417e+01
        R120 = 6.1548258127e+01; R220 = -6.0362551501e+01
        R320 = 2.9130021253e+01; R420 = -5.4723692739e+00
        R030 = 2.1661789529e+01; R130 = -3.3449108469e+01
        R230 = 1.9717078466e+01; R330 = -3.1742946532e+00
        R040 = -8.3627885467e+00; R140 = 1.1311538584e+01
        R240 = -5.3563304045e+00; R050 = 5.4048723791e-01
        R150 = 4.8169980163e-01; R060 = -1.9083568888e-01
        R001 = 1.9681925209e+01; R101 = -4.2549998214e+01
        R201 = 5.0774768218e+01; R301 = -3.0938076334e+01
        R401 = 6.6051753097e+00; R011 = -1.3336301113e+01
        R111 = -4.4870114575e+00; R211 = 5.0042598061e+00
        R311 = -6.5399043664e-01; R021 = 6.7080479603e+00
        R121 = 3.5063081279e+00; R221 = -1.8795372996e+00
        R031 = -2.4649669534e+00; R131 = -5.5077101279e-01
        R041 = 5.5927935970e-01; R002 = 2.0660924175e+00
        R102 = -4.9527603989e+00; R202 = 2.5019633244e+00
        R012 = 2.0564311499e+00; R112 = -2.1311365518e-01
        R022 = -1.2419983026e+00; R003 = -2.3342758797e-02
        R103 = -1.8507636718e-02; R013 = 3.7969820455e-01

        rz3 = R013 * tt + R103 * ss + R003
        rz2 = (R022 * tt + R112 * ss + R012) * tt \
            + (R202 * ss + R102) * ss + R002
        rz1 = (((R041 * tt + R131 * ss + R031) * tt
                + (R221 * ss + R121) * ss + R021) * tt
               + ((R311 * ss + R211) * ss + R111) * ss + R011) * tt \
            + (((R401 * ss + R301) * ss + R201) * ss + R101) * ss + R001
        rz0 = (((((R060 * tt + R150 * ss + R050) * tt
                  + (R240 * ss + R140) * ss + R040) * tt
                 + ((R330 * ss + R230) * ss + R130) * ss + R030) * tt
                + (((R420 * ss + R320) * ss + R220) * ss + R120) * ss
                + R020) * tt
               + ((((R510 * ss + R410) * ss + R310) * ss + R210) * ss
                  + R110) * ss + R010) * tt \
            + (((((R600 * ss + R500) * ss + R400) * ss + R300) * ss
                + R200) * ss + R100) * ss + R000

        r_prime = ((rz3 * zz + rz2) * zz + rz1) * zz + rz0
        return r_prime + r0

    def density_anomaly(self, T, S, z):
        return self.density(T, S, z) - self.reference_density
