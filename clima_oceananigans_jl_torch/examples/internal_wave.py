"""Internal (inertia-gravity) wave packet in a rotating stratified fluid.

Counterpart of the JAX package's ``examples/internal_wave.py``
(Oceananigans' examples/internal_wave.jl): a 2D (x, z) periodic domain on
[−π, π]², ``FPlane(f=0.2)``, the background buoyancy B(z) = N²z as a
``BackgroundField``, ``CenteredFourthOrder`` advection,
``ScalarDiffusivity(nu=1e-6, kappa=1e-6)``, RK3, and a Gaussian wave
packet set from the polarization relations of the pressure field
p = a(x, z) cos(kx + mz − ωt), stepped by a ``Simulation`` for 100
iterations at Δt = 0.02·2π/ω.

Self-check, the JAX script's: a linear wave packet propagates at the
group velocity while conserving energy, so (i) the perturbation energy
drifts by less than 3e-2 over the run and (ii) the packet's energy
centroid moves by the analytic group velocity times t within 25%.

    python -m clima_oceananigans_jl_torch.examples.internal_wave [N] [--cpu]

runs it on an N×1×N grid (N = 128 by default, the script's) on the card,
or with ``--cpu`` on the CPU.
"""
from __future__ import annotations

import math
import sys

import torch

from .. import (FLAT, PERIODIC, BackgroundField, BuoyancyTracer,
                CenteredFourthOrder, FPlane, NonhydrostaticModel,
                RectilinearGrid, ScalarDiffusivity, Simulation)

#: buoyancy frequency and the wave packet's numbers, the example's own
N_BUOY = 1.0
F_CORIOLIS = 0.2
M_WAVE, K_WAVE = 16, 8
OMEGA2 = ((N_BUOY ** 2 * K_WAVE ** 2 + F_CORIOLIS ** 2 * M_WAVE ** 2)
          / (K_WAVE ** 2 + M_WAVE ** 2))
OMEGA = math.sqrt(OMEGA2)
AMPLITUDE, DELTA = 1e-9, 2 * math.pi / 15
#: 50 steps a wave period (energy conservation needs it: RK3's amplitude
#: error is O((ω Δt)⁴))
DT = 0.02 * 2 * math.pi / OMEGA
ITERATIONS = 100
#: the analytic group velocity cg_x = ∂ω/∂k
CG_X = (K_WAVE * M_WAVE ** 2 * (N_BUOY ** 2 - F_CORIOLIS ** 2)
        / ((K_WAVE ** 2 + M_WAVE ** 2) ** 2 * OMEGA))


def build(N=128, device="cuda", dtype=torch.float64, **kw):
    """The example's model on an N×1×N grid; ``kw`` goes to the model
    (``fused_advection``)."""
    grid = RectilinearGrid(size=(N, 1, N), x=(-math.pi, math.pi), y=(0, 1),
                           z=(-math.pi, math.pi),
                           topology=(PERIODIC, FLAT, PERIODIC),
                           dtype=dtype, device=device)
    B = BackgroundField(lambda x, y, z, t, N: N ** 2 * z, parameters=N_BUOY)
    return NonhydrostaticModel(grid, coriolis=FPlane(f=F_CORIOLIS),
                               advection=CenteredFourthOrder(),
                               timestepper="RungeKutta3",
                               closure=ScalarDiffusivity(nu=1e-6, kappa=1e-6),
                               buoyancy=BuoyancyTracer(),
                               background_fields={"b": B}, **kw)


def initial_state(model):
    """The wave packet from the polarization relations."""
    k, m, f, N = K_WAVE, M_WAVE, F_CORIOLIS, N_BUOY
    a = lambda x, z: AMPLITUDE * torch.exp(-(x ** 2 + z ** 2) / (2 * DELTA ** 2))
    u0 = lambda x, y, z: a(x, z) * k * OMEGA / (OMEGA2 - f ** 2) * torch.cos(k * x + m * z)
    v0 = lambda x, y, z: a(x, z) * k * f / (OMEGA2 - f ** 2) * torch.sin(k * x + m * z)
    w0 = lambda x, y, z: a(x, z) * m * OMEGA / (OMEGA2 - N ** 2) * torch.cos(k * x + m * z)
    b0 = lambda x, y, z: a(x, z) * m * N ** 2 / (OMEGA2 - N ** 2) * torch.sin(k * x + m * z)
    return model.initial_state(u=u0, v=v0, w=w0, b=b0)


def energy(model, state):
    """Volume-integrated perturbation energy (KE + APE b²/2N²), summed in
    the grid's type on its device."""
    g, sol = model.grid, state["solution"]
    tot = 0.0
    for name in ("u", "v", "w"):
        tot += 0.5 * float(torch.sum(g.interior(sol[name]) ** 2))
    return tot + 0.5 / N_BUOY ** 2 * float(torch.sum(g.interior(sol["b"]) ** 2))


def centroid_x(model, state):
    """x of the packet's energy centroid, from w² summed over z."""
    w = model.grid.interior(state["solution"]["w"])[:, 0, :]
    x = model.grid.nodes(("c", "c", "f"))[0].reshape(-1)
    e = (w ** 2).sum(dim=1)
    return float((x * e).sum() / e.sum())


def run(N=128, device="cuda", iterations=ITERATIONS, dtype=torch.float64):
    """Build, set, run ``iterations`` through a ``Simulation``; returns the
    energy drift, the centroid's move, the analytic move and the
    simulation."""
    model = build(N, device, dtype)
    state = initial_state(model)
    E0, x0 = energy(model, state), centroid_x(model, state)
    sim = Simulation(model, state=state, dt=DT, stop_iteration=iterations)
    sim.run()
    E1, x1 = energy(model, sim.state), centroid_x(model, sim.state)
    t = sim.model_time()
    return dict(drift=abs(E1 - E0) / E0, moved=x1 - x0, expected=CG_X * t,
                time=t, simulation=sim)


def check(result):
    """The example's two assertions. The continuous polarization relations
    are not an exact eigenmode of the discrete operators, so ~1% of the
    packet's energy a period is shed into other modes."""
    assert result["drift"] < 3e-2, result["drift"]
    assert abs(result["moved"] - result["expected"]) < 0.25 * abs(result["expected"]), (
        result["moved"], result["expected"])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    N = int(next((a for a in argv if not a.startswith("-")), 128))
    r = run(N, "cpu" if "--cpu" in argv else "cuda")
    print(f"t = {r['time']:.2f}  energy drift = {r['drift']:.2e}  "
          f"centroid moved {r['moved']:.3f} (analytic {r['expected']:.3f})")
    check(r)
    print("internal_wave: PASS")


if __name__ == "__main__":
    main()
