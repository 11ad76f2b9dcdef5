"""Surface gravity waves on the conformal cubed sphere: a small Gaussian
free-surface bump radiates a ring whose front travels at the
shallow-water phase speed c = sqrt(g H) (Oceananigans'
validation/cubed_sphere_surface_gravity_waves: H = 4 km, g = 0.1,
A = 1e-5 H, a 15-degree bump).

Counterpart of the JAX package's
``validation/cubed_sphere_gravity_waves.py``: an N×N×1 fp64
``CubedSphereGrid`` (halo 3), ``CubedSphereHydrostaticModel`` without
rotation, RK3 at Δt = 900 s to 4 days. Checks, the JAX script's three:
the η²-weighted ring radius advances at sqrt(gH) = 20 m/s within 10%
between days 2 and 4 (the ring crosses cube edges then), the
area-integrated η is conserved to 1e-12, and the residual at the source
falls below A/2.

    python -m clima_oceananigans_jl_torch.validation.cubed_sphere_gravity_waves [N] [--cpu]

runs it at N = 32 by default on the card, or with ``--cpu`` on the CPU.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import CubedSphereGrid, CubedSphereHydrostaticModel
from ..utils.location import C

R = 6.371e6
DEPTH = 4.0e3                  # barotropic depth [m]
G = 0.1                        # reduced gravity, Oceananigans' value
SPEED = np.sqrt(G * DEPTH)     # = 20 m/s, the analytic phase speed
AMPLITUDE = 1e-5 * DEPTH       # 4 cm bump: linear dynamics
P0 = np.array([1.0, 0.0, 0.0])  # face 1's centre (lon 0, lat 0)
DT = 900.0                     # c*dt = 18 km << min face spacing
DAY = 86400.0
T1, T2 = 2.0 * DAY, 4.0 * DAY


def model_for(N=32, device="cuda"):
    """The script's grid and model."""
    grid = CubedSphereGrid(size=(N, N, 1), radius=R, dtype=torch.float64, halo=3,
                           device=device)
    return CubedSphereHydrostaticModel(grid, depth=DEPTH, gravitational_acceleration=G,
                                       coriolis_rotation_rate=0.0)


def eta_bump(pts):
    n = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    lam = np.degrees(np.arctan2(n[..., 1], n[..., 0]))
    phi = np.degrees(np.arcsin(np.clip(n[..., 2], -1, 1)))
    return AMPLITUDE * np.exp(-lam ** 2 / 15.0 ** 2) * np.exp(-phi ** 2 / 15.0 ** 2)


def initial_state(model):
    return model.initial_state(eta=eta_bump)


class Rings:
    """The interior cell centres' angle from the source and their areas."""

    def __init__(self, grid):
        N, H = grid.N, grid.H
        pts = np.stack([np.asarray(grid._nodes(f, (C, C)))[H:H + N, H:H + N]
                        for f in range(6)])
        nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
        self.theta = np.arccos(np.clip(nrm @ P0, -1, 1))  # (6,N,N)
        self.area = grid.face_grids().Az((C, C, C)).detach().cpu().numpy()[
            :, H:H + N, H:H + N, 0]
        self.N, self.H = N, H

    def eta(self, s):
        H, N = self.H, self.N
        return s["eta"].detach().cpu().numpy()[:, H:H + N, H:H + N, 0]

    def radius(self, e):
        """Energy-weighted mean angular distance of η outside the source
        neighbourhood: the expanding ring's position."""
        w = self.area * e ** 2
        w = np.where(self.theta > np.radians(8.0), w, 0.0)
        return float((w * self.theta).sum() / w.sum())


def run(N=32, device="cuda", log=print, t1=T1, t2=T2):
    """Days 0 → t1 → t2 → (measured phase speed, volume drift, source
    residual)."""
    model = model_for(N, device)
    state = initial_state(model)
    rings = Rings(model.grid)
    vol0 = float((rings.area * rings.eta(state)).sum())
    t = 0.0
    while t < t1 - 1e-9:
        state = model.step(state, DT)
        t += DT
    th1 = rings.radius(rings.eta(state))
    while t < t2 - 1e-9:
        state = model.step(state, DT)
        t += DT
    e2 = rings.eta(state)
    th2 = rings.radius(e2)
    vol2 = float((rings.area * e2).sum())
    c_meas = R * (th2 - th1) / (t2 - t1)
    vol_drift = abs(vol2 - vol0) / abs(vol0)
    residual = float(np.abs(np.where(rings.theta < np.radians(8.0), e2, 0.0)).max())
    log(f"ring radius: {np.degrees(th1):.1f} deg @ {t1 / DAY:g} d -> "
        f"{np.degrees(th2):.1f} deg @ {t2 / DAY:g} d")
    log(f"measured phase speed {c_meas:.2f} m/s vs analytic {SPEED:.2f} m/s "
        f"({100 * (c_meas / SPEED - 1):+.1f}%)")
    log(f"volume drift (relative) {vol_drift:.2e}; "
        f"source residual {residual / AMPLITUDE:.3f} A")
    return c_meas, vol_drift, residual


def check(results):
    """The JAX script's three assertions."""
    c_meas, vol_drift, residual = results
    assert abs(c_meas / SPEED - 1) < 0.10, f"phase speed off: {c_meas} vs {SPEED}"
    assert vol_drift < 1e-12, f"volume not conserved: {vol_drift}"
    assert residual < 0.5 * AMPLITUDE, f"bump did not radiate: residual {residual}"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    N = int(next((a for a in argv if not a.startswith("-")), 32))
    check(run(N, "cpu" if "--cpu" in argv else "cuda"))
    print("PASS: cubed-sphere surface gravity waves at sqrt(gH)")


if __name__ == "__main__":
    main()
