"""One-dimensional periodic advection: every scheme advects a Gaussian
and a square wave through one full period and is scored against the
exact (translated) profile.

Counterpart of the JAX package's ``validation/periodic_advection.py``
(Oceananigans' validation/periodic_advection/periodic_advection.jl): an
N×1×1 (Periodic, Flat, Flat) fp64 grid with x halo 4, u = 1, the tracer c
advected by each of the seven schemes (momentum centred), RK3 at CFL 0.2
for one period. Checks, the JAX script's eight: the high-order schemes
beat the low-order ones on the smooth profile at the expected margins;
WENO5 and BoundsPreservingWENO5 stay essentially non-oscillatory on the
square wave while the centred scheme rings; first-order upwind is
monotone and the most diffusive.

    python -m clima_oceananigans_jl_torch.validation.periodic_advection [N] [--cpu]

runs it at N = 128 by default on the card, or with ``--cpu`` on the CPU.
"""
from __future__ import annotations

import sys

import torch

from .. import (FLAT, PERIODIC, BoundsPreservingWENO5, CenteredFourthOrder,
                CenteredSecondOrder, NonhydrostaticModel, RectilinearGrid,
                UpwindBiasedFifthOrder, UpwindBiasedFirstOrder,
                UpwindBiasedThirdOrder, WENO5)

U = 1.0

SCHEMES = [("centered2", CenteredSecondOrder()),
           ("centered4", CenteredFourthOrder()),
           ("upwind1", UpwindBiasedFirstOrder()),
           ("upwind3", UpwindBiasedThirdOrder()),
           ("upwind5", UpwindBiasedFifthOrder()),
           ("weno5", WENO5()),
           ("weno5_bp", BoundsPreservingWENO5())]

PROFILES = {"gaussian": lambda x: torch.exp(-((x - 0.5) / 0.1) ** 2),
            "square": lambda x: torch.where((x > 0.3) & (x < 0.7), 1.0, 0.0).to(x.dtype)}


def setup(profile, scheme, N=128, device="cuda"):
    """(model, state, Δt, steps) of one run: ``profile`` a name of
    ``PROFILES``, ``scheme`` an advection scheme; one period is ``steps``
    steps of Δt = 1/steps, the nearest to CFL 0.2."""
    grid = RectilinearGrid(size=(N, 1, 1), x=(0, 1), y=(0, 1),
                           topology=(PERIODIC, FLAT, FLAT), halo=(4, 1, 1),
                           dtype=torch.float64, device=device)
    model = NonhydrostaticModel(grid, tracers=("c",), tracer_advection=scheme,
                                advection=CenteredSecondOrder(),
                                timestepper="RungeKutta3")
    f = PROFILES[profile]
    state = model.initial_state(u=U, c=lambda x, y, z: f(x))
    steps = round(1.0 / (U * (0.2 / N / U)))
    return model, state, 1.0 / steps, steps


def score(model, state, profile):
    """(L1 error against the exact profile, over/undershoot)."""
    g = model.grid
    got = g.interior(state["solution"]["c"])[:, 0, 0]
    exact = PROFILES[profile](g.coord(0, "c"))
    l1 = float((got - exact).abs().mean())
    return l1, max(float(got.max()) - 1.0, -float(got.min()))


def run(N=128, device="cuda", log=print):
    """Every (profile, scheme) pair through one period → {(profile,
    name): (L1, over)}."""
    results = {}
    for profile in PROFILES:
        log(f"--- {profile} profile, one period at CFL 0.2, N={N}")
        for name, scheme in SCHEMES:
            model, state, dt, steps = setup(profile, scheme, N, device)
            for _ in range(steps):
                state = model.step(state, dt)
            results[(profile, name)] = score(model, state, profile)
            l1, over = results[(profile, name)]
            log(f"  {name:10s}: L1={l1:.2e}  over/undershoot={over:+.3e}")
    return results


def check(results):
    """The JAX script's eight assertions."""
    r = results
    # smooth profile: the order hierarchy holds
    assert r[("gaussian", "weno5")][0] < r[("gaussian", "upwind3")][0]
    assert r[("gaussian", "upwind5")][0] < r[("gaussian", "upwind3")][0]
    assert r[("gaussian", "upwind3")][0] < r[("gaussian", "upwind1")][0]
    # square wave: WENO is (essentially) non-oscillatory, centred rings hard
    assert r[("square", "weno5")][1] < 2e-2
    assert r[("square", "weno5_bp")][1] < 2e-2
    assert r[("square", "centered2")][1] > 0.1
    # first-order upwind is monotone but the most diffusive of all
    assert r[("square", "upwind1")][1] < 1e-12
    assert r[("square", "upwind1")][0] == max(r[("square", n)][0] for n, _ in SCHEMES)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    N = int(next((a for a in argv if not a.startswith("-")), 128))
    check(run(N, "cpu" if "--cpu" in argv else "cuda"))
    print("PASS: periodic advection scheme hierarchy")


if __name__ == "__main__":
    main()
