"""Rossby-Haurwitz wave (Williamson et al. 1992, test 6) on the conformal
cubed sphere (Oceananigans' validation/cubed_sphere_rossby_haurwitz).

Counterpart of the JAX package's ``validation/rossby_haurwitz.py``: an
N×N×1 fp64 ``CubedSphereGrid`` (halo 3), ``CubedSphereHydrostaticModel``
with depth 8 km and g = 9.80665, the wavenumber-4 wave (ω = K =
7.848e-6 s⁻¹, R = 4) in balance, RK3 at Δt = 100 s for one day. The
pattern translates zonally at ν = [R(3+R)ω − 2Ω]/[(1+R)(2+R)]. Checks,
the JAX script's three: the zonal-wavenumber-4 amplitude of η in the
±30° band stays within 15%, its phase shift is within 10° of the
analytic barotropic speed, and u stays finite.

    python -m clima_oceananigans_jl_torch.validation.rossby_haurwitz [N] [--cpu]

runs it at N = 32 by default on the card, or with ``--cpu`` on the CPU.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import CubedSphereGrid, CubedSphereHydrostaticModel
from ..utils.location import C

A = 6.371e6
OMEGA = 7.292115e-5
G0 = 9.80665
K = W = 7.848e-6
R = 4.0
H0 = 8000.0
DT = 100.0
DAY = 86400.0


def model_for(N=32, device="cuda"):
    """The script's grid and model."""
    grid = CubedSphereGrid(size=(N, N, 1), radius=A, dtype=torch.float64, halo=3,
                           device=device)
    return CubedSphereHydrostaticModel(grid, depth=H0, gravitational_acceleration=G0)


def sph(p):
    n = p / np.linalg.norm(p, axis=-1, keepdims=True)
    lam = np.arctan2(n[..., 1], n[..., 0])
    phi = np.arcsin(np.clip(n[..., 2], -1, 1))
    return lam, phi, n


def vel(p):
    lam, phi, n = sph(p)
    c = np.cos(phi); s = np.sin(phi)
    u = A * W * c + A * K * c ** (R - 1) * (R * s * s - c * c) * np.cos(R * lam)
    v = -A * K * R * c ** (R - 1) * s * np.sin(R * lam)
    # east/north unit vectors
    e_lam = np.stack([-np.sin(lam), np.cos(lam), np.zeros_like(lam)], -1)
    e_phi = np.stack([-s * np.cos(lam), -s * np.sin(lam), c], -1)
    return u[..., None] * e_lam + v[..., None] * e_phi


def eta0(p):
    lam, phi, _ = sph(p)
    c = np.cos(phi)
    Aa = (W / 2 * (2 * OMEGA + W) * c ** 2
          + 0.25 * K ** 2 * c ** (2 * R)
          * ((R + 1) * c ** 2 + (2 * R ** 2 - R - 2) - 2 * R ** 2 * c ** -2))
    B = (2 * (OMEGA + W) * K / ((R + 1) * (R + 2)) * c ** R
         * ((R ** 2 + 2 * R + 2) - (R + 1) ** 2 * c ** 2))
    Cc = 0.25 * K ** 2 * c ** (2 * R) * ((R + 1) * c ** 2 - (R + 2))
    return (A * A * (Aa + B * np.cos(R * lam) + Cc * np.cos(2 * R * lam))) / G0


def initial_state(model):
    return model.initial_state(u=vel, eta=eta0)


class Wave4:
    """Amplitude & phase of the zonal wavenumber-4 mode of η in the ±30°
    band, by a direct Fourier projection on the interior cell centres."""

    def __init__(self, grid):
        N, H = grid.N, grid.H
        ll = [sph(np.asarray(grid._nodes(f, (C, C)))) for f in range(6)]
        self.lam = np.stack([x[0] for x in ll])[:, H:H + N, H:H + N]
        self.phi = np.stack([x[1] for x in ll])[:, H:H + N, H:H + N]
        self.N, self.H = N, H

    def __call__(self, s):
        H, N = self.H, self.N
        eta = s["eta"].detach().cpu().numpy()[:, H:H + N, H:H + N, 0]
        band = np.abs(self.phi) < np.radians(30.0)
        e = eta[band] - eta[band].mean()
        l4 = 4 * self.lam[band]
        zc = (e * np.cos(l4)).mean() + 1j * (e * np.sin(l4)).mean()
        return np.abs(zc), np.angle(zc)


def run(N=32, device="cuda", log=print, steps=None):
    """One day (or ``steps`` steps) → (amplitude ratio, phase shift,
    analytic shift, finite u)."""
    model = model_for(N, device)
    grid = model.grid
    state = initial_state(model)
    wave4 = Wave4(grid)
    amp0, ph0 = wave4(state)
    n_steps = int(DAY / DT) if steps is None else steps
    log(f"N={N} dt={DT}s steps={n_steps} wave4 amp0={amp0:.2f}")
    for i in range(n_steps):
        state = model.step(state, DT)
        if i % max(n_steps // 6, 1) == 0:
            amp, ph = wave4(state)
            log(f"  it={i:5d} amp={amp:8.2f} phase={np.degrees(ph):+7.2f}°"
                f" max|u|={float(grid.interior(state['solution']['u']).abs().max()):.1f}")
    amp1, ph1 = wave4(state)
    nu = (R * (3 + R) * W - 2 * OMEGA) / ((1 + R) * (2 + R))
    # η ∝ cos(4λ − 4νt): the projection phase advances by +4ν per unit time
    expected_shift = np.degrees(4 * nu * n_steps * DT)
    shift = np.degrees(np.angle(np.exp(1j * (ph1 - ph0))))
    log(f"amplitude ratio: {amp1 / amp0:.3f}")
    log(f"wave-4 phase shift after {n_steps * DT / DAY:g} day: {shift:+.2f}° "
        f"(analytic barotropic: {expected_shift:+.2f}°)")
    finite = bool(torch.isfinite(state["solution"]["u"]).all())
    return amp1 / amp0, shift, expected_shift, finite


def check(results):
    """The JAX script's three assertions."""
    ratio, shift, expected_shift, finite = results
    assert 0.85 < ratio < 1.15, ratio
    # the divergent shallow-water wave drifts a touch slower than the
    # nondivergent-barotropic analytic speed; allow ~20%
    assert abs(shift - expected_shift) < 10.0, (shift, expected_shift)
    assert finite


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    N = int(next((a for a in argv if not a.startswith("-")), 32))
    check(run(N, "cpu" if "--cpu" in argv else "cuda"))
    print("PASS: Rossby-Haurwitz wave propagates intact on the cubed sphere")


if __name__ == "__main__":
    main()
