"""Solid-body rotation on the conformal cubed sphere: a Gaussian tracer
blob advected by steady zonal solid-body flow (Williamson et al. (1992)
test 1; Oceananigans' validation/solid_body_rotation and
cubed_sphere_tracer_advection).

Counterpart of the JAX package's ``validation/solid_body_rotation.py``:
an N×N×1 fp64 ``CubedSphereGrid`` (halo 3) under
``CubedSphereHydrostaticModel(prescribed_velocities=True)``, u and v from
a corner streamfunction ψ = −U₀ R sin φ (so that the C-grid transport
divergence telescopes to zero), one revolution in 12 days, RK3 at CFL 0.2
for a quarter revolution (the blob crosses two cube faces). Checks, the
JAX script's four: tracer mass ∬c dA conserved to 1e-3, the centroid
within 2 cells + 0.5° of the exact rotated position, the amplitude not
amplified (< 1.02×) and not over-diffused (> 0.55×).

    python -m clima_oceananigans_jl_torch.validation.solid_body_rotation [N] [--cpu]

runs it at N = 32 by default on the card, or with ``--cpu`` on the CPU.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import CubedSphereGrid, CubedSphereHydrostaticModel
from ..utils.location import C, F

R = 6.371e6
U0 = 2 * np.pi * R / (12.0 * 86400.0)  # one revolution in 12 days
WIDTH = 0.08 * np.pi * R  # radians * R
P0 = np.array([1.0, 0.0, 0.0])  # the blob's centre: the equator at lon 0


def model_for(N=32, device="cuda"):
    """The script's grid and prescribed-velocity model."""
    grid = CubedSphereGrid(size=(N, N, 1), radius=R, dtype=torch.float64, halo=3,
                           device=device)
    return CubedSphereHydrostaticModel(grid, tracers=("c",), depth=1000.0,
                                       prescribed_velocities=True)


def blob(p):
    n = p / np.linalg.norm(p, axis=-1, keepdims=True)
    ang = np.arccos(np.clip(n @ P0, -1, 1))
    return np.exp(-(ang * R / WIDTH) ** 2)


def velocities(grid):
    """(u, v) with halos from the corner streamfunction ψ = −U₀ R sin φ:
    −δyψ/dy at (F,C), +δxψ/dx at (C,F), numpy (6, X, Y, Z)."""
    fgs = grid.face_grids()
    host = lambda t: t.detach().cpu().numpy()
    psi_faces = []
    for f in range(6):
        pts = np.asarray(grid._nodes(f, (F, F)))   # true corner lattice
        nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
        psi_faces.append(-U0 * R * nrm[..., 2])  # −U0 R sinφ at corners
    psi = np.stack(psi_faces)
    dy_fc = host(fgs.dy((F, C)))[..., 0]
    dx_cf = host(fgs.dx((C, F)))[..., 0]
    u2 = -(np.roll(psi, -1, axis=2) - psi) / dy_fc   # −δyψ/dy at (F,C)
    v2 = (np.roll(psi, -1, axis=1) - psi) / dx_cf    # +δxψ/dx at (C,F)
    nzt = grid.total_shape[-1]
    return u2[..., None] * np.ones((nzt,)), v2[..., None] * np.ones((nzt,))


def initial_state(model):
    u, v = velocities(model.grid)
    return model.initial_state(u=u, v=v, c=blob)


def steps_and_dt(N):
    """(steps, Δt) of a quarter revolution at advective CFL 0.2."""
    quarter = 0.25 * 2 * np.pi * R / U0
    dt = 0.2 * (np.pi / 2 * R / N) / U0
    n_steps = int(quarter / dt)
    return n_steps, np.float64(quarter / n_steps)


class Diagnostics:
    """The script's mass, centroid and amplitude on the interior cells."""

    def __init__(self, grid):
        N, H = grid.N, grid.H
        self.Az = grid.face_grids().Az((C, C)).detach().cpu().numpy()[..., 0]
        self.ii = (slice(None), slice(H, H + N), slice(H, H + N))
        pts = np.stack([np.asarray(grid._nodes(f, (C, C))) for f in range(6)])
        self.pts = pts[:, H:H + N, H:H + N]

    def c(self, s):
        return s["solution"]["c"].detach().cpu().numpy()[..., 0]

    def mass(self, s):
        return (self.c(s)[self.ii] * self.Az[self.ii]).sum()

    def centroid(self, s):
        w = (self.c(s)[self.ii] * self.Az[self.ii])[..., None]
        p = (self.pts * w).sum((0, 1, 2)) / w.sum()
        return p / np.linalg.norm(p)

    def cmax(self, s):
        return float(self.c(s)[self.ii].max())


def run(N=32, device="cuda", log=print, steps=None):
    """A quarter revolution (or ``steps`` steps) → (mass drift, centroid
    angular error in degrees, final amplitude, initial amplitude)."""
    model = model_for(N, device)
    state = initial_state(model)
    diag = Diagnostics(model.grid)
    m0, c0max = diag.mass(state), diag.cmax(state)
    n_steps, dt = steps_and_dt(N)
    n_steps = n_steps if steps is None else steps
    log(f"N={N} dt={float(dt):.0f}s steps={n_steps} (quarter revolution)")
    for i in range(n_steps):
        state = model.step(state, dt)
        if i % max(n_steps // 6, 1) == 0:
            log(f"  it={i:5d} mass drift={diag.mass(state) / m0 - 1:+.2e} "
                f"cmax={diag.cmax(state):.4f}")
    drift = abs(diag.mass(state) / m0 - 1)
    # exact: the blob rotated by π/2 about ẑ → at lon 90°E on the equator
    exact = np.array([0.0, 1.0, 0.0])
    ang_err = np.degrees(np.arccos(np.clip(diag.centroid(state) @ exact, -1, 1)))
    cmax = diag.cmax(state)
    log(f"tracer mass drift: {drift:.2e}")
    log(f"centroid angular error: {ang_err:.2f}° (cell size {90.0 / N:.2f}°)")
    log(f"amplitude: {cmax:.4f} (initial {c0max:.4f})")
    return drift, ang_err, cmax, c0max


def check(results, N=32):
    """The JAX script's four assertions."""
    drift, ang_err, cmax, c0max = results
    assert drift < 1e-3, drift
    assert ang_err < 2.0 * 90.0 / N + 0.5, ang_err
    assert cmax < 1.02 * c0max
    assert cmax > 0.55 * c0max  # bounded numerical diffusion at this N


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    N = int(next((a for a in argv if not a.startswith("-")), 32))
    check(run(N, "cpu" if "--cpu" in argv else "cuda"), N)
    print("PASS: cubed-sphere solid-body rotation")


if __name__ == "__main__":
    main()
