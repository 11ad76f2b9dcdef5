"""Biogeochemistry building blocks: reacting tracer pairs with opposed
slip velocities, and a sinking phytoplankton column with light-limited
growth (Oceananigans' validation/biogeochemistry/two_reacting_tracers.jl
and sinking_tracer.jl).

Counterpart of the JAX package's ``validation/biogeochemistry.py``:

Case 1, two reacting tracers: a 1×1×128 (Flat, Flat, Bounded) fp64
column on z ∈ [−10, 10] under ``PrescribedVelocityModel`` (no velocity),
ȧ = −ab and ḃ = +ab, a sinking at 1 m s⁻¹ and b rising through
``AdvectiveForcing(WENO5())`` slip velocities, κ = 10⁻², 400 steps of
0.01. Checks: ∫(a+b) conserved to 1e-10, mass from a to b, a sinks and b
rises by more than 1 m, both stay above −1e-8.

Case 2, sinking phytoplankton: a 64×1×64 (Periodic, Flat, Bounded) fp64
x–z slice, ``NonhydrostaticModel`` (WENO5, BuoyancyTracer, the plain
tendencies as the JAX script asks with ``fused_advection=False``), P
produced at (1/τ) e^{z/h} and sinking at 1 m s⁻¹ through a
bounds-preserving WENO5 slip velocity tapered to 0 at the walls, 400
steps of Δz/10. Checks: the P inventory within 5% of the source
integral, its centre of mass 5 m below the source's, P > −2% of max P.

    python -m clima_oceananigans_jl_torch.validation.biogeochemistry [--cpu]

runs both cases on the card, or with ``--cpu`` on the CPU.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import (BOUNDED, FLAT, PERIODIC, AdvectiveForcing, BoundsPreservingWENO5,
                BuoyancyTracer, Forcing, NonhydrostaticModel, PrescribedVelocityFields,
                PrescribedVelocityModel, RectilinearGrid, ScalarDiffusivity, WENO5)
from ..utils.location import CENTER, W_LOC

DT1, STEPS1 = 1e-2, 400
NX, NZ = 64, 64
TAU, DEPTH_SCALE = 3600.0, 4.0
STEPS2 = 400


def reacting_model(device="cuda", nz=128):
    """Case 1's column model."""
    grid = RectilinearGrid(size=(1, 1, nz), x=(0, 1), y=(0, 1), z=(-10, 10),
                           topology=(FLAT, FLAT, BOUNDED), dtype=torch.float64,
                           device=device)
    return PrescribedVelocityModel(
        grid, PrescribedVelocityFields(), tracers=("a", "b"),
        tracer_advection=WENO5(),
        closure=ScalarDiffusivity(kappa=1e-2),
        forcing={
            "a": (Forcing(lambda x, y, z, t, a, b: -a * b,
                          field_dependencies=("a", "b")),
                  AdvectiveForcing(WENO5(), w=-1.0)),
            "b": (Forcing(lambda x, y, z, t, a, b: +a * b,
                          field_dependencies=("a", "b")),
                  AdvectiveForcing(WENO5(), w=+1.0)),
        })


def reacting_state(model):
    return model.initial_state(a=lambda x, y, z: torch.exp(-(z - 4.0) ** 2),
                               b=lambda x, y, z: torch.exp(-(z + 4.0) ** 2))


def sinking_model(device="cuda"):
    """Case 2's x–z slice."""
    grid = RectilinearGrid(size=(NX, 1, NZ), x=(0, 128), y=(0, 1), z=(-64, 0),
                           topology=(PERIODIC, FLAT, BOUNDED), dtype=torch.float64,
                           device=device)
    growth = Forcing(lambda x, y, z, t: (1.0 / TAU) * torch.exp(z / DEPTH_SCALE))
    # slip velocity tapered to 0 at the walls: sinking particles carry no
    # flux through the surface or the bottom
    zf = grid.nodes(W_LOC, with_halo=True)[2]
    w_slip = torch.where((zf > -64.0 + 1e-9) & (zf < -1e-9), -1.0, 0.0).to(grid.dtype)
    return NonhydrostaticModel(
        grid, advection=WENO5(), tracers=("b", "P"), buoyancy=BuoyancyTracer(),
        forcing={"P": (growth, AdvectiveForcing(BoundsPreservingWENO5(), w=w_slip))},
        fused_advection=False)


def sinking_state(model):
    return model.initial_state(b=lambda x, y, z: 1e-5 * z)


def run_reacting(device="cuda", steps=STEPS1):
    model = reacting_model(device)
    grid = model.grid
    state = reacting_state(model)
    zc = grid.nodes(CENTER, with_halo=False)[2].cpu().numpy().ravel()

    def totals(s):
        return tuple(grid.interior(s["solution"][n])[0, 0].cpu().numpy()
                     for n in ("a", "b"))

    a0, b0 = totals(state)
    for _ in range(steps):
        state = model.step(state, DT1)
    a1, b1 = totals(state)
    return dict(a0=a0, b0=b0, a1=a1, b1=b1, zc=zc)


def run_sinking(device="cuda", steps=STEPS2):
    model = sinking_model(device)
    grid = model.grid
    state = sinking_state(model)
    dt = 0.1 * (64.0 / NZ)
    for _ in range(steps):
        state = model.step(state, dt)
    P = grid.interior(state["solution"]["P"])[:, 0, :].cpu().numpy()
    zc = grid.nodes(CENTER, with_halo=False)[2].cpu().numpy().ravel()
    return dict(P=P, zc=zc, t=steps * dt)


def checks(r1, r2):
    """The JAX script's eight checks: [(case, name, ok, detail)]."""
    a0, b0, a1, b1, zc = (r1[k] for k in ("a0", "b0", "a1", "b1", "zc"))
    com = lambda c: (zc * c).sum() / c.sum()
    tot0, tot1 = (a0 + b0).sum(), (a1 + b1).sum()
    out = [
        ("sum conservation", abs(tot1 - tot0) <= 1e-10 * tot0,
         f"(drift {abs(tot1 - tot0) / tot0:.2e})"),
        ("a->b mass transfer", a1.sum() < a0.sum() and b1.sum() > b0.sum(),
         f"(∫a {a0.sum():.3f}->{a1.sum():.3f}, ∫b {b0.sum():.3f}->{b1.sum():.3f})"),
        ("a sinks", com(a1) < com(a0) - 1.0, f"(com {com(a0):.2f}->{com(a1):.2f})"),
        ("b rises", com(b1) > com(b0) + 1.0, f"(com {com(b0):.2f}->{com(b1):.2f})"),
        ("positivity", a1.min() > -1e-8 and b1.min() > -1e-8, "")]
    P, zc2 = r2["P"], r2["zc"]
    dx, dz = 128.0 / NX, 64.0 / NZ
    inventory = P.sum() * dx * dz
    analytic = r2["t"] / TAU * 128.0 * DEPTH_SCALE * (1.0 - np.exp(-64.0 / DEPTH_SCALE))
    com_P = (P.sum(axis=0) * zc2).sum() / P.sum()
    # production-weighted depth of the light curve alone
    com_g = (np.exp(zc2 / DEPTH_SCALE) * zc2).sum() / np.exp(zc2 / DEPTH_SCALE).sum()
    out += [
        ("production budget", abs(inventory - analytic) <= 0.05 * analytic,
         f"(got {inventory:.3f}, analytic {analytic:.3f})"),
        ("sinking displaces production", com_P < com_g - 5.0,
         f"(P com {com_P:.2f} m vs source com {com_g:.2f} m)"),
        # AB2's extrapolation is not TVD even with bounds-preserving fluxes:
        # a ~1% front undershoot is the expected stepper artifact
        ("near-positivity (AB2 + bounds-preserving WENO)", P.min() > -0.02 * P.max(),
         f"(min {P.min():.2e}, max {P.max():.2e})")]
    return out


def check(r1, r2, log=print):
    """Print the eight checks; raise on a failure."""
    failures = []
    for name, ok, detail in checks(r1, r2):
        log(f"  {'PASS' if ok else 'FAIL'}  {name} {detail}")
        if not ok:
            failures.append(name)
    assert not failures, f"biogeochemistry: FAILED {failures}"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    check(run_reacting(device), run_sinking(device))
    print("biogeochemistry: ALL PASS")


if __name__ == "__main__":
    main()
