"""Wind-driven Stommel gyre against the analytic solution.

Counterpart of the JAX package's ``validation/barotropic_gyre.py``
(Oceananigans' validation/stommel_gyre and validation/barotropic_gyre): a
linear β-plane basin of 1000 km on an N×N (Bounded, Bounded, Flat) fp64
grid, depth 1000 m, reduced gravity 0.1 m s⁻², a steady wind curl and a
linear bottom drag, in the conservative ``ShallowWaterModel`` (WENO5,
RK3) with its two forcing callables, stepped for ~4 spin-down times at
Δt = Δx / (4 √(gH)). The steady transport streamfunction of Stommel
(1948),

    β ψ_x + r ∇²ψ = curl τ = −(τ0 π / b) sin(π y / b),

separates as ψ = sin(πy/b) P(x) with r P'' + β P' − r(π/b)² P = −τ0π/b
and P(0) = P(λ) = 0; the script's assertions hold the model's steady
state to it: correlation > 0.98, peak amplitude within 0.85–1.15, western
intensification > 3.

    python -m clima_oceananigans_jl_torch.validation.barotropic_gyre [N] [--cpu]

runs it at N = 64 by default on the card, or with ``--cpu`` on the CPU.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .. import BOUNDED, FLAT, BetaPlane, RectilinearGrid, ShallowWaterModel
from ..utils.location import C, F

N = 64
L = 1.0e6           # basin size (m)
H = 1000.0          # depth (m)
G = 0.1             # reduced gravity → slow, well-resolved gravity waves
BETA = 1e-11
F0 = 1e-5
R = 1e-6            # linear drag (1/s): Stommel layer δ = r/β = 100 km
TAU0 = 1e-4         # kinematic wind stress (m²/s²)


def wind_drag_u(grid, clock, fields):
    """The zonal wind stress −τ0 cos(πy/L) and the linear drag on uh."""
    _, y, _ = grid.nodes((F, C, C), with_halo=True)
    tau = -TAU0 * torch.cos(math.pi * y / L)
    return (tau - R * fields["uh"]) * torch.ones_like(fields["uh"])


def drag_v(grid, clock, fields):
    """The linear drag on vh."""
    return -R * fields["vh"]


def model_for(n=N, device="cuda"):
    """The script's basin model."""
    grid = RectilinearGrid(size=(n, n, 1), x=(0.0, L), y=(0.0, L),
                           topology=(BOUNDED, BOUNDED, FLAT), dtype=torch.float64,
                           device=device)
    return ShallowWaterModel(grid, gravitational_acceleration=G,
                             coriolis=BetaPlane(f0=F0, beta=BETA),
                             forcing={"uh": wind_drag_u, "vh": drag_v})


def time_step(n=N):
    """Δt = Δx / (4 √(gH)) and the steps of ~4 spin-down times."""
    dt = 0.25 * (L / n) / np.sqrt(G * H)
    return dt, int(4.0 / (R * dt))


def stommel(model, state):
    """(ψ numerical, ψ analytic, vh) on the interior: ψ = ∫₀ˣ vh dx' at
    the x-cells' right edges and the y faces, and Stommel's solution
    there."""
    grid = model.grid
    n = grid.Nx
    vh = grid.interior(state["solution"]["vh"])[:, :, 0].double().cpu().numpy()
    dx = L / n
    psi_num = np.cumsum(vh, axis=0) * dx
    xe = (np.arange(1, n + 1)) * dx       # right edges
    yf = grid.coord(1, "f").double().cpu().numpy()[:n]
    kpi = np.pi / L
    Pp = TAU0 * L / (np.pi * R)
    disc = np.sqrt(BETA ** 2 + 4 * R ** 2 * kpi ** 2)
    mp, mm = (-BETA + disc) / (2 * R), (-BETA - disc) / (2 * R)
    Amat = np.array([[1.0, 1.0], [np.exp(mp * L), np.exp(mm * L)]])
    a, c = np.linalg.solve(Amat, [-Pp, -Pp])
    P = Pp + a * np.exp(mp * xe) + c * np.exp(mm * xe)
    psi_ana = np.sin(kpi * yf)[None, :] * P[:, None]
    return psi_num, psi_ana, vh


def scores(model, state):
    """(correlation of ψ with Stommel's, ψ's amplitude ratio at the
    analytic peak, western over eastern boundary-current strength)."""
    psi_num, psi_ana, vh = stommel(model, state)
    n = model.grid.Nx
    corr = np.corrcoef(psi_num.ravel(), psi_ana.ravel())[0, 1]
    ipk = np.unravel_index(np.argmax(np.abs(psi_ana)), psi_ana.shape)
    amp = psi_num[ipk] / psi_ana[ipk]     # gyre strength at the analytic peak
    # western intensification: peak |vh| in the western Stommel layer vs east
    west = np.abs(vh[: n // 8]).max()
    east = np.abs(vh[n // 2:]).max()
    return corr, amp, west / east


def check(corr, amp, ratio):
    """The JAX script's three assertions."""
    assert corr > 0.98, corr
    assert 0.85 < amp < 1.15, amp
    assert ratio > 3.0, ratio


def run(n=N, device="cuda", log=print):
    """The basin from rest to its steady state → (model, state, scores)."""
    model = model_for(n, device)
    state = model.initial_state(h=H)
    dt, n_steps = time_step(n)
    log(f"N={n} dt={dt:.0f}s steps={n_steps} ({n_steps * dt / 86400:.0f} days)")
    for i in range(n_steps):
        state = model.step(state, dt)
        if i % (n_steps // 8) == 0:
            vh = state["solution"]["vh"]
            log(f"  it={i:6d} max|vh|={float(vh.abs().max()):.3f} m²/s")
    corr, amp, ratio = scores(model, state)
    log(f"corr(ψ_num, ψ_Stommel) = {corr:.4f}")
    log(f"amplitude ratio ψ_peak num/ana = {amp:.3f}")
    log(f"western/eastern boundary-current strength = {ratio:.1f}")
    return model, state, (corr, amp, ratio)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(next((a for a in argv if not a.startswith("-")), N))
    check(*run(n, "cpu" if "--cpu" in argv else "cuda")[2])
    print("PASS: Stommel gyre matches the analytic solution")


if __name__ == "__main__":
    main()
