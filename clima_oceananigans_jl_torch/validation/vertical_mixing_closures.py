"""Free-convection column: the three boundary-layer closures against the
classical mixed-layer scaling.

Counterpart of the JAX package's ``validation/vertical_mixing_closures.py``
(Oceananigans' validation/vertical_mixing_closures, a side-by-side
closure comparison): a resting, linearly stratified (N² = 1e-5 s⁻²)
(Flat, Flat, Bounded) fp64 column of ``nz`` cells over 128 m is cooled at
the surface with a constant buoyancy flux B₀ = 1e-7 m² s⁻³ for 12 hours,
720 steps of 60 s, under CATKE, convective adjustment and the Ri-based
closure, with momentum and tracer advection off and the pcg implicit free
surface. Each closure must deepen the mixed layer like the
zero-entrainment budget

    h(t) ≈ √(2(1+2A) B₀ t / N²),   A ≈ 0.2 (entrainment coefficient)

within a generous factor, keep the profile statically near-neutral in the
mixed layer, and conserve buoyancy up to the surface input: the JAX
script's assertions.

    python -m clima_oceananigans_jl_torch.validation.vertical_mixing_closures [nz] [--cpu]

runs it at nz = 64 by default on the card, or with ``--cpu`` on the CPU.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .. import (BOUNDED, FLAT, BuoyancyTracer, CATKEVerticalDiffusivity,
                ConvectiveAdjustmentVerticalDiffusivity, FieldBCs, FluxBC,
                HydrostaticFreeSurfaceModel, ImplicitFreeSurface,
                RectilinearGrid, RiBasedVerticalDiffusivity)

NZ, H = 64, 128.0
N2 = 1e-5
B0 = 1e-7  # surface buoyancy LOSS (cooling): flux out of the ocean
T_END = 12 * 3600.0
DT = 60.0

CLOSURES = (("CATKE", CATKEVerticalDiffusivity),
            ("convective_adjustment",
             lambda: ConvectiveAdjustmentVerticalDiffusivity(
                 convective_kappa_z=1.0, background_kappa_z=1e-5)),
            ("Ri_based", RiBasedVerticalDiffusivity))


def expected_depth():
    """The zero-entrainment mixed-layer depth after ``T_END``, m."""
    return math.sqrt(2 * 1.4 * B0 * T_END / N2)


def model_for(closure, nz=NZ, device="cuda"):
    """The script's column model under ``closure``."""
    grid = RectilinearGrid(size=(1, 1, nz), x=(0, 1), y=(0, 1), z=(-H, 0.0),
                           topology=(FLAT, FLAT, BOUNDED), dtype=torch.float64,
                           device=device)
    return HydrostaticFreeSurfaceModel(
        grid, buoyancy=BuoyancyTracer(), momentum_advection=None,
        tracer_advection=None, closure=closure,
        free_surface=ImplicitFreeSurface(solver_method="pcg"),
        boundary_conditions={"b": FieldBCs(top=FluxBC(B0))})


def initial_state(model):
    """b = N²z at rest, and e = 1e-7 where the closure carries it."""
    init = {"b": lambda x, y, z: N2 * z}
    if "e" in model.tracer_names:
        init["e"] = 1e-7
    return model.initial_state(**init)


def run_closure(name, closure, nz=NZ, device="cuda", steps=None, log=print):
    """One closure's column through ``steps`` steps (``T_END / DT`` by
    default) → (h, the budget ∫Δb dz over −B₀t, the mixed layer's
    max|∂b/∂z| or None where it holds three cells or fewer, the model, the
    final state); asserts the budget within 2% and the gradient below
    N²/2, as the JAX script does."""
    steps = int(T_END / DT) if steps is None else steps
    model = model_for(closure, nz, device)
    state = initial_state(model)
    g = model.grid
    zc = g.coord(2, "c").double().cpu().numpy()
    dz = H / nz
    b0 = g.interior(state["solution"]["b"])[0, 0].double().cpu().numpy()
    for _ in range(steps):
        state = model.step(state, DT)
    b = g.interior(state["solution"]["b"])[0, 0].double().cpu().numpy()
    # mixed-layer depth: shallowest level where b returns to the initial
    # stratification (within 2%)
    mixed = np.abs(b - N2 * zc) > 0.02 * N2 * H
    h = -zc[mixed].min() if mixed.any() else 0.0
    # buoyancy budget: ∫(b − b0)dz = −B0·t
    budget = (b - b0).sum() * dz / (-B0 * steps * DT)
    log(f"{name:22s}: h = {h:6.1f} m  (h/h_exp = {h / expected_depth():.2f})  "
        f"∫Δb dz / (−B0 t) = {budget:.3f}")
    assert abs(budget - 1.0) < 0.02, (name, budget)
    # interior of the mixed layer is much less stratified than ambient
    # (exclude the surface cells that carry the flux-injection gradient)
    inml = (zc > -0.6 * h) & (zc < -3 * dz)
    grad = None
    if inml.sum() > 3:
        grad = np.abs(np.diff(b[inml]) / dz).max()
        assert grad < 0.5 * N2, (name, grad)
    return h, budget, grad, model, state


def run(nz=NZ, device="cuda", log=print):
    """Every closure through 12 hours → {name: (h, budget, gradient)}."""
    log(f"expected mixed-layer depth after {T_END / 3600:.0f} h: "
        f"{expected_depth():.1f} m")
    return {name: run_closure(name, make(), nz, device, log=log)[:3]
            for name, make in CLOSURES}


def check(results):
    """The JAX script's last assertion: each depth within 0.5–1.8 of the
    scaling (the budget and the gradient are asserted per closure)."""
    h_exp = expected_depth()
    for name, (h, _, _) in results.items():
        assert 0.5 * h_exp < h < 1.8 * h_exp, (name, h, h_exp)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    nz = int(next((a for a in argv if not a.startswith("-")), NZ))
    check(run(nz, "cpu" if "--cpu" in argv else "cuda"))
    print("PASS: all three closures deepen like the convective scaling")


if __name__ == "__main__":
    main()
