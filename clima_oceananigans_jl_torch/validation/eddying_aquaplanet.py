"""Eddying aquaplanet on the conformal cubed sphere: the Galewsky et al.
(2004) barotropic-instability test (Oceananigans'
validation/cubed_sphere_eddying_aquaplanet, reduced to its shallow-water
core: an unstable zonal jet rolling up into an eddy train).

Counterpart of the JAX package's ``validation/eddying_aquaplanet.py``: an
N×N×1 fp64 ``CubedSphereGrid`` (halo 3), ``CubedSphereHydrostaticModel``
with depth 10 km, a jet at 45°N (u_max = 80 m s⁻¹, Galewsky's profile) in
gradient-wind balance with η, Galewsky's 120 m height bump, RK3 at
Δt = 0.45·(0.7 a (π/2)/N)/(sqrt(g H₀) + u_max) for six days. Checks, the
JAX script's four: the zonal-asymmetry eddy variance of η grows ≥ 30×
from day 1 to day 6, the speed stays below 2.5 u_max, the area integral
of η is conserved to 1e-9 of ∬H₀ dA, and the southern band stays below
5% of the northern one. At N = 256 it is Galewsky's resolution (T341,
about 0.35°).

    python -m clima_oceananigans_jl_torch.validation.eddying_aquaplanet [N] [--cpu]

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
H0 = 10_000.0          # mean depth (Galewsky gh0/g ≈ 10 km)
U_MAX = 80.0
PHI0, PHI1 = np.pi / 7.0, np.pi / 2.0 - np.pi / 7.0
EN = np.exp(-4.0 / (PHI1 - PHI0) ** 2)
DAY = 86400.0


def u_profile(phi):
    inside = (phi > PHI0) & (phi < PHI1)
    denom = np.where(inside, (phi - PHI0) * (phi - PHI1), -1.0)
    return np.where(inside, U_MAX / EN * np.exp(1.0 / denom), 0.0)


# gradient-wind balanced surface height: g dη/dφ = −u (a f + u tanφ)
# → η(φ) = −(1/g)∫ u(φ')(a f(φ') + u(φ') tanφ') dφ'
PHIS = np.linspace(-np.pi / 2 + 1e-6, np.pi / 2 - 1e-6, 4001)
_UU = u_profile(PHIS)
_INTEGRAND = _UU * (2 * OMEGA * np.sin(PHIS) * A + _UU * np.tan(PHIS))
ETA_TAB = -np.concatenate([[0.0], np.cumsum(
    0.5 * (_INTEGRAND[1:] + _INTEGRAND[:-1]) * np.diff(PHIS))]) / G0
ETA_TAB -= ETA_TAB.mean()


def sph(pts):
    n = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    lam = np.arctan2(n[..., 1], n[..., 0])
    phi = np.arcsin(np.clip(n[..., 2], -1, 1))
    return lam, phi


def vel(pts):
    lam, phi = sph(pts)
    u = u_profile(phi)
    e_lam = np.stack([-np.sin(lam), np.cos(lam), np.zeros_like(lam)], -1)
    return u[..., None] * e_lam


def eta_init(pts):
    lam, phi = sph(pts)
    base = np.interp(phi, PHIS, ETA_TAB)
    # Galewsky's localized bump: 120 m, α=1/3, β=1/15, centered 45°N
    bump = (120.0 * np.cos(phi)
            * np.exp(-(lam / (1.0 / 3.0)) ** 2)
            * np.exp(-((np.pi / 4.0 - phi) / (1.0 / 15.0)) ** 2))
    return base + bump


def model_for(N=32, device="cuda", grid=None):
    """The script's grid (or ``grid``) and model."""
    grid = grid or CubedSphereGrid(size=(N, N, 1), radius=A, dtype=torch.float64,
                                   halo=3, device=device)
    return CubedSphereHydrostaticModel(grid, depth=H0, gravitational_acceleration=G0)


def initial_state(model):
    return model.initial_state(u=vel, eta=eta_init)


def time_step(N):
    """The script's Δt: CFL 0.45 on the corner-clustered spacing
    0.7 a (π/2)/N at the gravity-wave speed plus u_max."""
    c = np.sqrt(G0 * H0)
    dxmin = 0.7 * A * (np.pi / 2) / N
    return 0.45 * dxmin / (c + U_MAX)


def min_spacing(grid):
    """The grid's smallest interior cell spacing, every location's Δx and
    Δy."""
    H, N = grid.H, grid.N
    return min(float(t[:, H:H + N, H:H + N].min())
               for t in (*grid._dx.values(), *grid._dy.values()))


def grid_time_step(grid):
    """The script's CFL 0.45 at the grid's own smallest spacing. The
    script's rule takes that spacing as 0.7 of the mean; on the conformal
    grid it is 0.32 of it at N = 32 and 0.16 at N = 256, where the rule
    puts the corner cells at CFL 1.95."""
    return 0.45 * min_spacing(grid) / (np.sqrt(G0 * H0) + U_MAX)


class Eddies:
    """Areas, latitude bins and bands of the interior cell centres, and
    the zonal-asymmetry variance of η: area-weighted variance around its
    per-latitude-bin zonal mean (~0 for the balanced jet)."""

    def __init__(self, grid):
        N, H = grid.N, grid.H
        pts = np.stack([np.asarray(grid._nodes(f, (C, C)))[H:H + N, H:H + N]
                        for f in range(6)])
        _, phi_c = sph(pts)
        self.area = grid.face_grids().Az((C, C, C)).detach().cpu().numpy()[
            :, H:H + N, H:H + N, 0]
        self.north = (phi_c > np.radians(20.0)) & (phi_c < np.radians(70.0))
        self.south = (phi_c < np.radians(-20.0)) & (phi_c > np.radians(-70.0))
        self.bins = np.radians(np.arange(-90.0, 90.1, 2.0))
        self.bin_ix = np.digitize(phi_c.ravel(), self.bins)
        self.N, self.H = N, H

    def interior(self, s, name):
        H, N = self.H, self.N
        arr = s["eta"] if name == "eta" else s["solution"][name]
        return arr.detach().cpu().numpy()[:, H:H + N, H:H + N, 0]

    def mass(self, s):
        return float((self.area * self.interior(s, "eta")).sum())

    def var(self, s, band):
        e = self.interior(s, "eta").ravel()
        w = self.area.ravel()
        ix = self.bin_ix
        zonal_mean = np.zeros(len(self.bins) + 1)
        counts = np.zeros(len(self.bins) + 1)
        np.add.at(zonal_mean, ix, w * e)
        np.add.at(counts, ix, w)
        zonal_mean /= np.maximum(counts, 1e-300)
        dev = e - zonal_mean[ix]
        m = band.ravel()
        return float((w[m] * dev[m] ** 2).sum() / w[m].sum())


def run(N=32, device="cuda", log=print, days=(1.0, 6.0)):
    """Day 0 → days[0] → days[1] → {eddy variances, growth, max speed,
    mass drift}."""
    model = model_for(N, device)
    state = initial_state(model)
    ed = Eddies(model.grid)
    dt = time_step(N)
    mass0 = ed.mass(state)
    t = 0.0
    while t < days[0] * DAY - 1e-9:
        state = model.step(state, dt)
        t += dt
    ev1 = ed.var(state, ed.north)
    while t < days[1] * DAY - 1e-9:
        state = model.step(state, dt)
        t += dt
    out = dict(ev1=ev1, ev6=ed.var(state, ed.north), ev6_s=ed.var(state, ed.south),
               umax=max(np.abs(ed.interior(state, "u")).max(),
                        np.abs(ed.interior(state, "v")).max()),
               mass_drift=abs(ed.mass(state) - mass0) / (ed.area.sum() * H0),
               dt=dt, N=N)
    out["growth"] = out["ev6"] / max(ev1, 1e-30)
    return out


def checks(r):
    """The JAX script's four checks: [(name, ok, detail)]."""
    return [
        ("barotropic instability grows", r["growth"] >= 30.0,
         f"(eddy var day1 {r['ev1']:.3e} -> day6 {r['ev6']:.3e}, x{r['growth']:.0f})"),
        ("eddies saturate bounded", r["umax"] < 2.5 * U_MAX and np.isfinite(r["umax"]),
         f"(max speed {r['umax']:.1f} m/s)"),
        ("mass conservation", r["mass_drift"] < 1e-9,
         f"(relative drift {r['mass_drift']:.2e})"),
        ("southern hemisphere quiet", r["ev6_s"] < 0.05 * r["ev6"],
         f"(south {r['ev6_s']:.3e} vs north {r['ev6']:.3e})")]


def check(r, log=print):
    """Print the four checks; raise on a failure."""
    log(f"eddying aquaplanet (Galewsky) N={r['N']}, dt={r['dt']:.0f}s:")
    failures = []
    for name, ok, detail in checks(r):
        log(f"  {'PASS' if ok else 'FAIL'}  {name} {detail}")
        if not ok:
            failures.append(name)
    assert not failures, f"eddying_aquaplanet: FAILED {failures}"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    N = int(next((a for a in argv if not a.startswith("-")), 32))
    check(run(N, "cpu" if "--cpu" in argv else "cuda"))
    print("eddying_aquaplanet: ALL PASS")


if __name__ == "__main__":
    main()
