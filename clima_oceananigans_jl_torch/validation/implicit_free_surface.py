"""Implicit free-surface solvers compared: fft, pcg, matrix and multigrid.

Counterpart of the JAX package's ``validation/implicit_free_surface.py``
(Oceananigans' validation/implicit_free_surface, which races its FFT, PCG
and matrix solvers on one seiche): a basin-scale gravity seiche,
η₀ = 0.1 sin(2πx/L) cos(πy/L), on a (Periodic, Bounded, Bounded)
N × N × 8 fp64 grid of L = 100 km and H = 500 m, stepped 50 times at
Δt = 50 s (beyond the explicit gravity-wave limit) by the hydrostatic
model under ``ImplicitFreeSurface(solver_method=m, tolerance=1e-12,
maxiter=800)`` for each of the four methods, whose final η must agree
with fft's within 1e-6, as the JAX script asserts. It prints each
method's time per step and max|η|, each difference, and the analytic
period of the seiche's mode, as the JAX script does.

    python -m clima_oceananigans_jl_torch.validation.implicit_free_surface [N] [--cpu]

runs it at N = 64 by default on the card, or with ``--cpu`` on the CPU.
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .. import (BOUNDED, PERIODIC, HydrostaticFreeSurfaceModel,
                ImplicitFreeSurface, RectilinearGrid)

N = 64
L, H = 1.0e5, 500.0
G = 9.80665
DT = 50.0
N_STEPS = 50
METHODS = ("fft", "pcg", "matrix", "multigrid")
TOLERANCE = 1e-6


def grid_for(n=N, device="cuda"):
    return RectilinearGrid(size=(n, n, 8), x=(0, L), y=(0, L), z=(-H, 0),
                           topology=(PERIODIC, BOUNDED, BOUNDED),
                           dtype=torch.float64, device=device)


def model_for(method, n=N, device="cuda", grid=None):
    """The script's model under ``method``."""
    return HydrostaticFreeSurfaceModel(
        grid=grid if grid is not None else grid_for(n, device),
        free_surface=ImplicitFreeSurface(solver_method=method, tolerance=1e-12,
                                         maxiter=800))


def eta0(x, y):
    return 0.1 * torch.sin(2 * math.pi * x / L) * torch.cos(math.pi * y / L)


def run(method, n=N, device="cuda", steps=N_STEPS, grid=None):
    """The model's state after ``steps`` steps, and ms per step after the
    first."""
    model = model_for(method, n, device, grid)
    state = model.step(model.initial_state(eta=eta0), DT)
    sync = torch.cuda.synchronize if model.grid.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state = model.step(state, DT)
    sync()
    return model, state, (time.perf_counter() - t0) / max(steps - 1, 1) * 1e3


def interior_eta(model, state):
    g = model.grid
    return state["eta"][g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny].double().cpu().numpy()


def differences(results):
    """max|η_m − η_fft| of each method but fft."""
    ref = interior_eta(*results["fft"][:2])
    return {m: float(np.abs(interior_eta(*results[m][:2]) - ref).max())
            for m in METHODS if m != "fft"}


def main(n=N, device="cuda", log=print):
    """The script: each method run, timed and compared with fft (its
    assertion); returns {method: (model, state, ms per step)}."""
    results = {}
    for method in METHODS:
        results[method] = run(method, n, device)
        model, state, ms = results[method]
        log(f"{method:10s}: {ms:8.2f} ms/step  "
            f"max|eta|={float(state['eta'].abs().max()):.4f}")
    for method, err in differences(results).items():
        log(f"max|eta_{method} - eta_fft| = {err:.2e}")
        assert err < TOLERANCE, (method, err)
    c = math.sqrt(G * H)
    T = 2 * math.pi / (c * 2 * math.pi / L)
    log(f"analytic mode period T = {T:.0f} s ({T / DT:.1f} steps)")
    log("PASS: all four implicit free-surface solvers agree")
    return results


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    main(int(args[0]) if args else N, "cpu" if "--cpu" in sys.argv[1:] else "cuda")
