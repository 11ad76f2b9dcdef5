"""Stretched-z wind-driven mixing column: CATKE and its implicit vertical
diffusion under a surface wind stress.

Counterpart of the JAX package's ``validation/wind_mixing_column.py``
(Oceananigans' ocean_wind_mixing_and_convection example): a (Flat, Flat,
Bounded) fp64 column of ``nz`` cells over 100 m, refined towards the
surface (faces at −100 (1 − k/nz)^1.5 m), stratified b = 1e-5 (z + 100)/100,
under a kinematic wind stress of −1e-4 m² s⁻² (a ``FluxBC`` on u's top
and CATKE's surface momentum flux), momentum and tracer advection off,
the pcg implicit free surface, 240 ``Simulation`` iterations of 60 s with
a progress line every 60. The JAX script asserts nothing; it prints the
final TKE profile, as this copy does.

    python -m clima_oceananigans_jl_torch.validation.wind_mixing_column [nz] [--cpu]

runs it at nz = 48 by default on the card, or with ``--cpu`` on the CPU.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import (BOUNDED, FLAT, BuoyancyTracer, Callback,
                CATKEVerticalDiffusivity, FieldBCs, FluxBC,
                HydrostaticFreeSurfaceModel, ImplicitFreeSurface,
                IterationInterval, RectilinearGrid, Simulation)

NZ = 48
WIND_STRESS = -1e-4  # kinematic, m^2/s^2
DT = 60.0
STOP_ITERATION = 240


def z_faces(nz=NZ):
    """The stretched z faces: fine near the surface."""
    k = np.arange(nz + 1)
    return -100.0 * (1 - (k / nz)) ** 1.5


def model_for(nz=NZ, device="cuda"):
    """The script's column model."""
    grid = RectilinearGrid(size=(1, 1, nz), x=(0, 1), y=(0, 1), z=z_faces(nz),
                           topology=(FLAT, FLAT, BOUNDED), dtype=torch.float64,
                           device=device)
    return HydrostaticFreeSurfaceModel(
        grid, free_surface=ImplicitFreeSurface(solver_method="pcg"),
        momentum_advection=None, tracer_advection=None,
        buoyancy=BuoyancyTracer(),
        closure=CATKEVerticalDiffusivity(
            surface_momentum_flux=(WIND_STRESS, 0.0)),
        boundary_conditions={"u": FieldBCs(top=FluxBC(WIND_STRESS))})


def initial_state(model):
    return model.initial_state(b=lambda x, y, z: 1e-5 * (z + 100.0) / 100.0,
                               e=1e-7)


def simulation(nz=NZ, device="cuda", stop_iteration=STOP_ITERATION, log=print):
    """The script's ``Simulation`` with its progress callback."""
    model = model_for(nz, device)
    sim = Simulation(model, state=initial_state(model), dt=DT,
                     stop_iteration=stop_iteration)

    def progress(s):
        sol = s.state["solution"]
        log(f"it={s.model_iteration():4d} t={s.model_time() / 3600:.2f}h "
            f"max u={float(sol['u'].max()):.4f} max e={float(sol['e'].max()):.2e}")

    sim.callbacks["progress"] = Callback(progress, IterationInterval(60))
    return sim


def tke_profile(sim, top=5):
    """The final TKE of the ``top`` uppermost cells."""
    e = sim.model.grid.interior(sim.state["solution"]["e"])[0, 0]
    return e[-top:].double().cpu().numpy()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    nz = int(next((a for a in argv if not a.startswith("-")), NZ))
    sim = simulation(nz, "cpu" if "--cpu" in argv else "cuda")
    sim.run()
    print("final TKE profile (top 5):", tke_profile(sim))


if __name__ == "__main__":
    main()
