"""Near-global lat-lon hydrostatic ocean with immersed continents.

Counterpart of the JAX package's ``validation/near_global_lat_lon.py``
(Oceananigans' validation/near_global_lat_lon, its ETOPO bathymetry
replaced by an analytic function of continents and a mid-ocean ridge): a
(360/deg) × (150/deg) × 24 lat-lon grid over (0, 360) × (−75, 75) with z
faces −3000 (1 − k/24)^1.8, ``SplitExplicitFreeSurface(substeps=50)``,
``HydrostaticSphericalCoriolis``, ``BuoyancyTracer``, the closure
``ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
vertically implicit)``, a zonal wind stress on u's top face and a
quadratic drag through the bottom (discrete immersed flux BCs on u and
v), b = 2e-5 (z + 3000)/3000 + 1e-6 cos(πφ/180) and Δt = 1200 s, run
216 iterations (3 days) through ``Simulation``. Its checks, as the JAX
script asserts them: u and v exactly 0 at solid faces, u, v and b finite,
and 1e-3 < max|u| < 3.

The script's bottom is ``GridFittedBottom``; ``model_for(...,
partial_cells=True)`` builds the same run over ``PartialCellBottom`` of
the same bathymetry (the ridge's 1200 m and the continents' sigmoid
flanks cut cells), which the port's hydrostatic kernels take in their
3D-Δz forms.

    python -m clima_oceananigans_jl_torch.validation.near_global_lat_lon [deg] [--partial] [--cpu]

runs it at deg = 3 (as the JAX script by default) in fp32 on the card,
or with ``--cpu`` on the CPU. The script's Δt = 1200 s holds at 3°; at ¼°
the fields go non-finite within a few steps, so ``chip_smoke.py``'s ¼°
path runs ``run(..., dt=600.0)``, the ¼° Δt of
``benchmark/bench_near_global.py``.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .. import (Callback, FieldBCs, FluxBC, GridFittedBottom, IterationInterval,
                PartialCellBottom, ScalarDiffusivity, Simulation)
from ..buoyancy.buoyancy import BuoyancyTracer
from ..coriolis.coriolis import HydrostaticSphericalCoriolis
from ..grids.latlon import LatitudeLongitudeGrid
from ..models.free_surface import SplitExplicitFreeSurface
from ..models.hydrostatic import HydrostaticFreeSurfaceModel
from ..utils.location import U_LOC, V_LOC

DEG = 3.0
NZ = 24
DT = 1200.0
ITERATIONS = 216  # 3 days
SUBSTEPS = 50
#: the quadratic bottom drag coefficient
CD = 2.5e-3


def z_faces(nz=NZ):
    """~20 m surface cells, ~400 m abyssal."""
    k = np.arange(nz + 1)
    return -3000.0 * (1.0 - k / nz) ** 1.8


def grid_for(deg=DEG, dtype=torch.float32, device="cuda"):
    return LatitudeLongitudeGrid(size=(int(360 / deg), int(150 / deg), NZ),
                                 longitude=(0, 360), latitude=(-75, 75), z=z_faces(),
                                 dtype=dtype, device=device)


def bathymetry(lam, phi):
    """Idealised continents (above sea level: solid columns) and a
    mid-ocean ridge at 330°E, standing in for the reference's ETOPO data."""
    s = torch.sigmoid

    def block(lo, hi, w=8.0):
        return s((lam - lo) / w) * s((hi - lam) / w)

    def band(lo, hi, w=6.0):
        return s((phi - lo) / w) * s((hi - phi) / w)

    americas = block(255.0, 300.0) * band(-55.0, 70.0)
    afr_eurasia = (block(0.0, 50.0) * band(-35.0, 70.0)
                   + block(25.0, 120.0) * band(10.0, 70.0))
    australia = block(112.0, 154.0) * band(-40.0, -11.0)
    land = torch.clamp(americas + afr_eurasia + australia, 0.0, 1.0)
    ridge = 1200.0 * torch.exp(-((lam - 330.0) / 12.0) ** 2) * band(-60.0, 60.0)
    return torch.where(land > 0.5, torch.full((), 100.0, dtype=lam.dtype,
                                              device=lam.device), -3000.0 + ridge)


def wind_stress(lam, phi, t):
    """Easterlies in the tropics, westerlies at mid-latitudes."""
    return -1e-4 * torch.cos(3.0 * math.pi * phi / 180.0)


def u_drag(grid, t, fields):
    return -CD * torch.sqrt(fields["u"] ** 2 + fields["v"] ** 2) * fields["u"]


def v_drag(grid, t, fields):
    return -CD * torch.sqrt(fields["u"] ** 2 + fields["v"] ** 2) * fields["v"]


def initial_b(lam, phi, z):
    return 2e-5 * (z + 3000.0) / 3000.0 + 1e-6 * torch.cos(math.pi * phi / 180.0)


def model_for(deg=DEG, dtype=torch.float32, device="cuda", partial_cells=False,
              substeps=SUBSTEPS, **kw):
    """The script's model at ``deg`` (``partial_cells``: over
    ``PartialCellBottom`` of its bathymetry in place of
    ``GridFittedBottom``); ``kw`` more model options (``fused_advection``)."""
    bottom = (PartialCellBottom if partial_cells else GridFittedBottom)(bathymetry)
    return HydrostaticFreeSurfaceModel(
        grid_for(deg, dtype, device),
        free_surface=SplitExplicitFreeSurface(substeps=substeps),
        coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer(),
        closure=ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
                                  time_discretization="vertically_implicit"),
        immersed_boundary=bottom,
        boundary_conditions={
            "u": FieldBCs(top=FluxBC(wind_stress), immersed=FluxBC(u_drag, discrete=True)),
            "v": FieldBCs(immersed=FluxBC(v_drag, discrete=True))}, **kw)


def initial_state(model):
    return model.initial_state(b=initial_b)


def run(model, state=None, iterations=ITERATIONS, dt=DT, log=print):
    """``iterations`` iterations from ``state`` (the script's initial state
    by default) through ``Simulation``, its progress printed every 24;
    returns the simulation."""
    sim = Simulation(model, state=state if state is not None else initial_state(model),
                     dt=dt, stop_iteration=iterations)

    def progress(s):
        sol = s.state["solution"]
        log(f"it={s.model_iteration():4d} t={s.model_time() / 3600:6.1f}h "
            f"max|u|={float(sol['u'].abs().max()):.4f} "
            f"max|eta|={float(s.state['eta'].abs().max()):.4f}")

    sim.callbacks["progress"] = Callback(progress, IterationInterval(24))
    sim.run()
    return sim


def check(model, state, log=print):
    """The script's checks: u and v exactly 0 at solid faces, u, v and b
    finite, 1e-3 < max|u| < 3; returns max|u|."""
    imm = model.grid.immersed
    sol = state["solution"]
    u_land = float((sol["u"] * imm.mask_for(U_LOC)).abs().max())
    v_land = float((sol["v"] * imm.mask_for(V_LOC)).abs().max())
    log(f"max|u| on land: {u_land}")
    assert u_land == 0.0 and v_land == 0.0, (u_land, v_land)
    for name in ("u", "v", "b"):
        assert bool(torch.isfinite(sol[name]).all()), name
    umax = float(sol["u"].abs().max())
    log(f"3-day spinup complete; max|u| = {umax} max|eta| = "
        f"{float(state['eta'].abs().max())}")
    assert 1e-3 < umax < 3.0, umax
    return umax


def main(deg=DEG, device="cuda", partial_cells=False, log=print):
    """The script: build, run 3 days, check; returns (model, state)."""
    model = model_for(deg, device=device, partial_cells=partial_cells)
    sim = run(model, log=log)
    check(model, sim.state, log)
    log("PASS: near-global spinup with immersed continents"
        + (" (partial bottom cells)" if partial_cells else ""))
    return model, sim.state


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(float(args[0]) if args else DEG, "cpu" if "--cpu" in sys.argv[1:] else "cuda",
         "--partial" in sys.argv[1:])
