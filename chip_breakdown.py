"""Where the time of the port's steps goes, on one NVIDIA GPU.

    python3 chip_breakdown.py [ab2] [rk3] [general-projection] [hydrostatic]
                              [langmuir] [wind-mixing] [hydrostatic-wind]
                              [shallow-water] [k6-k3c] [division]
                              [k3a-division] [k4b-phases] [k5-barriers]
                              [langmuir-amd] [wind-mixing-stretched]
                              [ab2-implicit] [t1] [t1-variants]
                              [near-global] [near-global-weno] [diffusive]
                              [near-global-catke] [horizontal-convection] [2d-turbulence]
                              [seamount] [simulation] [internal-wave]
                              [weno5-kernels] [hydrostatic-positive]
                              [near-global-ub5] [ptxas-schemes]
                              [sass-regular --parent DIR] [ab2-bf16]
                              [front-slice] [gyre] [stretched-channel]
                              [implicit-free-surface] [multigrid-iterations]
                              [k2xy [--parent DIR]] [cubed-sphere]
                              [near-global-partial] [k4b-parent --parent DIR]
                              [distributed] [distributed-near-global]
                              [sass-k5 --parent DIR] [--steps N]

With no part named, runs them all. Prints the card's name and power
limit first. Needs a card; without one it exits with an error.

- ``ab2``: the 256³ ``bench.py`` configuration of ``chip_smoke.py``'s AB2
  path (quasi-AB2, the fused branch), its warm-up steps, then ``steps``
  steps with CUDA events around K1 (the fused AB2 advance), the roll-based
  projection on interiors and ``update_state`` (pHY′), with K6's fills of
  ``update_state`` as a part of their own; "the rest" is the step's
  CUDA-event time minus their sum (the pads of the corrected fields, dict
  work, Python).
- ``ab2-bf16``: the ``AB2 bf16 smoothness`` path of ``chip_smoke.py``
  (``BF16_PATHS``: the AB2 configuration with WENO5(bf16_smoothness=True),
  K1's ANY instantiation with the bf16 forms), broken down as ``ab2``,
  then the fp32 WENO5 model from the same state likewise, in the same call.
- ``rk3``: the 256³ RK3 flagship of ``chip_smoke.py``'s RK3 path (FPlane,
  ScalarDiffusivity), likewise, around K2, the rest of ``tendencies``
  (the eager Coriolis, −∂pHY′, ∇·(κ∇ψ) and flux BCs: ``tendencies`` less
  K2), ``rk3_substep``, ``project_velocities`` (with its with-halo
  copies) and ``update_state`` less its K6 fills, three of each a step.
  Both parts also print the kernel's ms a call on the path's fields. They
  use only names that ``chip_smoke.py`` and the port have had since the
  RK3 path came (K6's fills are a part where the port's ``KERNELS`` has a
  ``fill`` entry), so the same file measures an older tree of the port in
  its place.
- ``general-projection``: the 256³ RK3 flagship with ``FluxBC()`` w
  walls of ``chip_smoke.py``'s general-projection path, likewise, around
  K2, the eager terms (``tendencies`` less K2), ``rk3_substep``, the
  projection's copies of u, v, w and the pad of pNHS with their K6 fills,
  K3b, the FFT solve, K3c, the correction (``project_velocities`` less
  those parts: ∇·u/Δt, u − Δt∇p, dict work), ``update_state`` less its
  K6 fills, and those fills.
- ``hydrostatic``: the ¼° flagship of ``benchmark/bench_hydro_flagship.py``
  built through the public API (as ``chip_smoke.py`` does), 3 warm-up
  steps, then ``steps`` steps (default 5) with CUDA events around each
  part of the split-explicit step: K4b's advance, the barotropic modes,
  K5 (with its wrapper), the corrector, K4a, and K6's two halo fills of
  ``update_state``; "the rest" is the step's CUDA-event time minus their
  sum (c₁G − c₂G⁻, the weight vectors, Python).
- ``langmuir``, ``wind-mixing``: the 256³ surface-forced paths of
  ``chip_smoke.py`` (``SURFACE``), likewise, around K2, the boundary
  fluxes (``apply_flux_bcs``, every field, three stages), the Stokes
  drift's six terms (langmuir), the other eager terms (``tendencies``
  less those), ``rk3_substep``, ``project_velocities``, ``update_state``
  less its K6 fills, and those fills.
- ``langmuir-amd``, ``wind-mixing-stretched``, ``ab2-implicit``: the
  256³ uncut LES paths of ``chip_smoke.py`` (``LES``), likewise, around
  K2 (K1 on ``ab2-implicit``), the eager terms, ``rk3_substep``, the
  implicit step (its T1 solves apart from forming its bands), the
  projection (its K6 fills, and the pressure solve with T1 apart from its
  FFTs and gauge), ``update_state`` (its K6 fills and the AMD
  diffusivities apart).
- ``t1``: ptxas's registers, stack and spills for every T1 instantiation
  (``csrc/batched_tridiagonal.cu``), then T1 alone (torch.profiler device
  time, two rounds, held bit for bit) in the four forms of
  ``chip_smoke.t1_forms``: the Fourier mode on the 256³ wind-mixing
  spectrum (129×256×256 complex64; fp64 too), the implicit step's 1D and
  3D bands on 262×262×256 fp32 and its 1D bands on the ¼° grid's
  1446×606×24, each beside a copy of d, with the launcher's plan, each
  after ~200 ms of warm-up calls, by torch.profiler and by ``queued_ms``,
  with the card's clocks and power after.
- ``t1-variants``: T1 as built against copies of its source with one
  change each (``T1_VARIANTS``: the sweeps not unrolled, no table for 1D
  bands (the column mode), 1, 2, 4 or 8 warps a block, each but the
  source's own), held bit for bit, timed in
  turns in the four forms of ``t1`` after ~200 ms of warm-up calls by
  CUDA events around calls queued behind a spin of the card
  (``queued_ms``: the host's time between launches does not count): what
  each compile-time choice of the source is worth.
- ``hydrostatic-wind``: the ¼° flagship under the near-global wind stress
  (``chip_smoke.py``'s ``hydrostatic wind`` path: the two-stage route),
  like ``hydrostatic``, around K4b's tendency form, the flux BC, the
  eager ``ab2_substep``, the barotropic modes, K5, the corrector, K4a and
  K6; run it with ``hydrostatic`` in one call to read what the two-stage
  route costs over the fused advance.
- ``near-global``, ``near-global-weno``, ``diffusive``: the ¼° paths of
  ``chip_smoke.py``'s ``NEAR_GLOBAL`` (benchmark/bench_near_global.py as
  written, its WENO variant, the flagship with the near-global closure),
  like ``hydrostatic-wind``, around K4b (tendency form, or the advance
  with its in-kernel closure), the eager diffusion (``momentum_diffusion``
  and ``tracer_diffusion``, their fluxes zeroed at solid faces), the
  masking (``mask_state`` in ``update_state``, ``mask_tendency`` in
  ``tendencies``), the flux BCs and the immersed bottom's fluxes, the
  eager ``ab2_substep``, the barotropic modes, K5 (on depth planes over
  the bottom), the implicit step (its T1 solves a part of their own, the
  bands apart), the corrector, K4a and K6; run them with
  ``hydrostatic-wind`` in one call to read what the bottom and the closure
  cost.
- ``near-global-catke``: ``chip_smoke.py``'s ``near-global CATKE`` path
  (the near-global run under CATKE and TEOS-10, ``OCEAN``), likewise, with
  TEOS-10's b for K4a, N² (TEOS-10's b again) inside CATKE's
  diffusivities, the rest of CATKE's diffusivities and ``tke_tendency``
  as parts of their own beside those of ``near-global``; its idle share
  by torch.profiler.
- ``horizontal-convection``, ``2d-turbulence``: ``chip_smoke.py``'s
  walls-and-Flat paths (``WALLS``: examples/horizontal_convection.py at
  4096×1×2048 on (Bounded, Flat, Bounded), its b ValueBC a callable;
  examples/two_dimensional_turbulence.py at 8192²×1 with UB5) after their
  warm-up steps, like ``general-projection``: K2, the eager terms,
  ``rk3_substep``, the copies and pads with their K6 fills, K3b, the
  pressure solve (a DCT along each bounded axis, eigenvalue 0 on the Flat
  one), K3c, the correction, ``update_state`` and its K6 fills.
- ``seamount``: ``chip_smoke.py``'s seamount path (validation/seamount.py
  at 4096×1×2048 fp64 on (Periodic, Flat, Bounded): an immersed bottom,
  PositiveWENO5 tracers, quasi-AB2 on the general branch) after its
  warm-up steps: first ptxas's registers, stack and spills of every K2
  instantiation (``ptxas``), then K2, the eager diffusion (fluxes zeroed
  at solid faces), ``mask_state`` and ``mask_tendency``, the immersed
  bottom's fluxes, the rest of ``tendencies``, ``ab2_substep``, the
  projection's copies and pads with their K6 fills, K3b, the pressure
  solve, K3c, the correction, ``update_state`` and its K6 fills.
- ``simulation``: ``chip_smoke.py``'s simulation path (horizontal
  convection at 4096×1×2048 fp32 through ``Simulation``: the wizard, the
  NaN checker, two classic NetCDF writers, one of a device average, and
  a checkpointer) after its warm-up, over 20 × ``steps`` iterations, with
  CUDA events around ``model.step``, the wizard, the NaN checker, the
  device average, the writers (their copies to the host apart from their
  file writes) and the checkpoint write (its copies apart); then the
  idle share over 50 iterations.
- ``internal-wave``: ``chip_smoke.py``'s internal-wave path
  (examples/internal_wave.py at 4096×1×4096 fp64 on (Periodic, Flat,
  Periodic): C4, RK3, FPlane, ScalarDiffusivity, the background buoyancy
  N²z) after 2 warm-up steps (``ptxas-schemes`` lists the registers and
  spills of K1's, K2's and K3a's instantiations): K2, the
  background fields' cross terms (the plain ``div_*`` fluxes of the JAX
  package's route), the other eager terms (``tendencies`` less those),
  ``rk3_substep``, the projection's copies and pads with their K6 fills,
  K3b, the pressure solve (FFTs on x and z), K3c, the correction,
  ``update_state`` and its K6 fills.
- ``weno5-kernels``: K1 on the 256³ bench configuration, K2 with WENO5
  on the RK3 path's fields' shapes (random fields) at 256³ fp32, on a
  regular and on the wind-mixing example's stretched z, K2's immersed form
  on the seamount path's fp64 fields, and K3a with WENO5 on 16384² fp32
  random uh, vh, h, each by CUDA
  events over 20 calls and by torch.profiler: the WENO5 forms whose time a
  change of the shared advection core could move. It uses only names the
  port and ``chip_smoke.py`` have had since the seamount slice, so a
  copy of this file inside an older tree measures that tree.
- ``hydrostatic-positive``, ``near-global-ub5``: the schemes slice's ¼°
  paths of ``chip_smoke.py`` (``SCHEME_PATHS``), likewise, around K4b (its
  fused advance with PositiveWENO5 tracers; its tendency form with UB5
  momentum and BoundsPreservingWENO5 tracers), K4a, K5, K6's fills and,
  on the two-stage route, the eager terms, ``ab2_substep`` and the
  implicit step.
- ``ptxas-schemes``: ptxas's registers, stack and spills of every
  instantiation of K1, K2, K3a and K4b, the four kernels that take the
  advection schemes (one nvcc each, all at once).
- ``sass-regular``: K1's, K2's, K3a's and K4b's instantiations without
  ``ANY``, and (since the bf16 slice) their ``ANY`` instantiations without
  the bf16 sub-form ``BF`` (since the partial-cell slice, whose K4a and
  K4b take a trailing flag ``D3``, every instantiation of both without
  it), as built here and from the parent tree's
  ``csrc`` (``--parent DIR``; a trailing template flag the parent lacks
  is dropped to find its counterpart, and since the Flat slice any
  trailing arguments the parent lacks, K4b's layout and Cartesian flag),
  their SASS by ``cuobjdump``:
  instruction counts, and whether the sequences are identical, and
  identical with constants masked (the argument struct grew, so
  constant-bank offsets may move).
- ``front-slice``: ``chip_smoke.py``'s front slice (``FRONT``: the
  baroclinic-adjustment physics on a (Flat, Bounded, Bounded)
  1×8192×128 fp32 y–z slice, K4b's Flat-x layout), its 2 warm-up steps,
  then ``steps`` steps with CUDA events around K4b (its fused advance),
  K4a, K5 and its wrapper, the K6 fills, the barotropic modes and the
  corrector; then the profiler's idle share.
- ``gyre``: ``chip_smoke.py``'s Stommel gyre at its timed reading's
  N = 1024 fp64 (``GYRE_TIMED``, the validation's basin, its two
  forcing callables), 2 warm-up steps, then ``steps`` steps with CUDA
  events around K3a, the Coriolis terms, the forcing callables,
  ``apply_flux_bcs``, ``rk3_substep`` and ``fill_all_halos``, three of
  each a step; then the profiler's idle share.
- ``shallow-water``: the 16384² headline of
  ``benchmark/bench_shallow_water.py`` (as ``chip_smoke.py`` runs it), 2
  warm-up steps, then ``steps`` steps with CUDA events around K3a,
  ``rk3_substep`` and ``fill_all_halos``, three of each a step; "the
  rest" as above (``apply_flux_bcs``, dict work, Python).
- ``k6-k3c``: ptxas's registers, stack and spills for K6 and K3b/K3c
  (``csrc/fill_halos.cu``, ``csrc/fused_projection.cu`` built as the port
  builds them, with ``-Xptxas -v``); then K6 on the ¼° first group and
  the 256³ nonhydrostatic u, v, w, b (and the langmuir path's u, v, w, b,
  whose gradient wall reads the side table), and K3c at 256³ fp32 and fp64, each
  held bit for bit against the plain version and timed alone (the
  kernel's own device time by torch.profiler, two rounds); beside them
  three with-halo fields zeroed and one copied, the bytes K3c writes and a
  read with a write.
- Each of the step parts then runs ``torch.profiler`` over 3 more steps: the
  device's busy time (kernel durations summed) against the host clock,
  the idle share, and the kernels that took the most device time.
- ``division``: the time of one fp32 and one fp64 division, by CUDA
  events over 2^30 divisions, as written (``x / y``: IEEE, correctly
  rounded) and through ``ieee_div`` of ``csrc/weno5_advection.cuh``, on
  operand classes the kernels meet: random, WENO5's weights on smooth
  fields (den ≈ 1e-24, num = p·den with |p| ~ 0.1 or ~ 1e-6), a tiny
  numerator (~1e-32) over an ordinary denominator, a subnormal quotient,
  a zero numerator over 6 or over 1e-24. The two agree bit for bit on every
  class (checked). Then a map of where fp32 ``x / y`` leaves its fast
  path: its time for |x| ~ 2^a and y ~ 2^b over a grid of exponents,
  relative to the random class.
- ``k3a-division``: K3a on the 16384² path's fields (after 2 steps) and on
  random fields (as ``chip_smoke.py`` phase 5 makes them), as built and
  built with nvcc's ``-prec-div=false`` (approximate division: not
  bitwise, so never used by the port; a diagnostic of how much of K3a's
  time its divisions still take on each kind of field).
- ``k4b-phases``: where a K4b block's time goes on the ¼° path's fields
  (after 3 steps): a copy of ``csrc/fused_hydrostatic_tendencies.cu`` with
  ``clock64()`` stamps at the phase boundaries, summed over thread 0 of
  every block (issuing the copies and the halo zeros, waiting for u, v
  and w, the momentum arrays, the momentum outputs, each tracer's wait,
  face fluxes and outputs), each phase's share of the total.
- ``k5-barriers``: K5 at ¼° fp32 (30 substeps) as built and as a copy of
  ``csrc/fused_substep_eta.cu`` whose passes are skipped (the same
  cooperative grid, prologue, 2N barriers and epilogue), in turns: the
  share of K5's time that is not the substeps' work.
- ``stretched-channel``: ``chip_smoke.py``'s stretched channel (the JAX
  suite's fully stretched configuration at 256×256×128 fp64 with 2²⁰
  particles) after its warm-up steps: ptxas's counts of every
  instantiation of K2's stretched-x/y form (its own source), then K2 (its
  stretched-x/y form), the eager terms (``tendencies`` less K2),
  ``ab2_substep``, the projection's copies and pad with their K6 fills,
  the whole-array divergence and gradient, the multigrid pressure solve
  (its V-cycles apart from the CG's matvecs and reductions) and the
  correction, ``update_state`` and its K6 fills, and the particles'
  step; the multigrid-CG iterations a solve.
- ``implicit-free-surface``: the ¼° flagship of ``chip_smoke.py``'s
  ``implicit free surface`` paths under ImplicitFreeSurface("matrix") and
  ("multigrid"), maxiter 50, after 2 warm-up steps each: K4b, K4a, K6's
  fills, the barotropic modes and the solve's right-hand side, the
  free-surface solve (the multigrid's V-cycles apart), the η correction
  and the rest; the CG iterations a step.
- ``multigrid-iterations``: the stretched channel's pressure solve at
  32×32×16, 64×64×32, 128×128×64 and 256×256×128 (``MG_SIZES``; its
  grid, faces and initial state at each size, no particles): the rhs of
  the first step's solve, solved with the model's tolerance 1e-9 and
  maxiter 200, then with maxiter 2000; the CG iterations, the final
  relative residual and the seconds of each.
- ``k2xy``: K2's stretched-x/y form alone, as the port builds it, in the
  builds of ``K2XY_VARIANTS`` (other threads a block) and, with
  ``--parent DIR`` (an older tree's ``csrc``), as that tree builds it, all
  built at once with ptxas's registers and spills and each build's
  seconds; then on the stretched channel's initial fields and on every
  case of ``chip_smoke.K2XY_CASES``, each build timed in turns by CUDA
  events and held bit for bit against the form as built. Without
  ``--parent`` it runs only when named.
- ``cubed-sphere``: ``chip_smoke.py``'s ``Galewsky C256``
  (eddying_aquaplanet.py at N = 256 fp64, its Δt) after 2 warm-up steps:
  CUDA events around the halo exchange (``exchange``, four a step), the
  vmapped tendencies (``tendencies``, three) and the RK3 update
  (``rk3_update``, three), the rest (the clock, dict work, Python) apart,
  of the eager step (``cuda_graphs`` off); then the profiler's idle
  share; then the step replayed from its CUDA graph, timed and profiled
  the same way.
- ``near-global-partial``: ``chip_smoke.py``'s ``near-global partial
  cells`` (validation/near_global_lat_lon.py at ¼° fp32 over
  PartialCellBottom of its bathymetry, Δt = 600 s) after its 2 warm-up
  steps, checked finite after the timed ones: CUDA
  events around K4b's 3D-Δz tendency form, K4a's 3D-Δz form, K5 and its
  wrapper, T1, K6's fills, the eager diffusion, the quadratic bottom drag
  (the immersed flux BCs), the wind (the flux BCs), the masks, the AB2
  substep, the barotropic modes and the corrector; then the profiler's
  idle share.
- ``k4b-parent``: K4b's run-time instantiation, as built here and from an
  older tree's ``csrc`` (``--parent DIR``, whose entry
  ``fused_hydrostatic_tendencies_f32`` takes the same arguments), both
  built at once, timed in turns (as built, parent, parent, as built) by
  CUDA events in its tendency form on the fields of ``chip_smoke.py``'s
  ``near-global``, ``near-global UB5`` and ``near-global CATKE`` after
  their warm-up steps, each held bit for bit against the form as built.
  Without ``--parent`` it runs only when named.
- ``distributed``: ``chip_smoke.py``'s ``distributed RK3`` path (the RK3
  flagship at 256³ fp32 on a (2, 2) mesh of four shards on the card) after
  2 warm-up steps: the device time of one step's exchanges and transposes,
  recorded and made again behind a spin of the card (``queued_ms``: the
  host's gaps, 80% of the step, do not count), then torch.profiler's
  device time of K2, K3b/K3c, K6 and cuFFT's kernels by name, the rest of
  the busy time, and the device's idle share.
- ``distributed-near-global``: ``chip_smoke.py``'s ``distributed
  near-global`` path (the ¼° near-global ocean at 1440×600×24 fp32 on a
  (2, 2) mesh of four shards on the card), likewise: the exchanges' device
  time behind a spin, then the profiler's device time of K4a, K4b, K5's
  cut form, K6 and T1 by name, the rest and the idle share.
- ``sass-k5``: K5's cooperative form (every instantiation of
  ``fused_substep_eta_kernel``) as built here and from an older tree's
  ``csrc`` (``--parent DIR``), their SASS compared as ``sass-regular``
  compares its kernels: the cut form's kernels share its source. Without
  ``--parent`` it runs only when named.
"""
from __future__ import annotations

import collections
import ctypes
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from clima_oceananigans_jl_torch import (PERIODIC, FLAT, CATKEVerticalDiffusivity,
                                         RectilinearGrid, ShallowWaterModel, WENO5)
from clima_oceananigans_jl_torch.closures import vertical_mixing as vm
from clima_oceananigans_jl_torch.models import hydrostatic as hm
from clima_oceananigans_jl_torch.models import nonhydrostatic as nm
from clima_oceananigans_jl_torch.models import shallow_water as swm
from clima_oceananigans_jl_torch.models.free_surface import (ImplicitFreeSurface,
                                                             SplitExplicitFreeSurface)
from clima_oceananigans_jl_torch.ops import _build
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft
from clima_oceananigans_jl_torch.solvers import stencil_matrix as tsm

import chip_smoke


def timed(events, name, fn):
    """``fn`` with a pair of CUDA events recorded around each call."""
    def run(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        events[name].append((start, end))
        return out
    return run


def breakdown(label, step, state, events, patches, steps, inner=None,
              profile_steps=3):
    """``steps`` calls of ``step`` with ``patches`` [(object, attribute,
    label)] timed by CUDA events; prints each part's ms per step and
    share (a part of ``inner`` {outer: (inner parts, label or None)} less
    the inner parts timed within it), then the profiler's idle share over
    ``profile_steps`` more steps."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, part in patches:
        setattr(obj, name, timed(events, part, getattr(obj, name)))
    total = []
    try:
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state = step(state, timed_parts=True)
            end.record()
            total.append((start, end))
        torch.cuda.synchronize()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    step_ms = sum(s.elapsed_time(e) for s, e in total) / steps
    parts = {name: sum(s.elapsed_time(e) for s, e in pairs) / steps
             for name, pairs in events.items()}
    calls = {name: len(pairs) // steps for name, pairs in events.items()}
    for outer, (within, name) in (inner or {}).items():
        if outer not in parts:  # a part this step does not call
            continue
        less = name or f"{outer} less {' and '.join(within)}"
        parts[less] = parts.pop(outer) - sum(parts.get(p, 0.0) for p in within)
        calls[less] = calls.pop(outer)
    parts["the rest"] = step_ms - sum(parts.values())
    print(f"{label}, {steps} steps, CUDA events: {step_ms:.4f} ms/step")
    for name, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        n = calls.get(name)
        each = f", {n} calls, {ms / n:.4f} ms a call" if n and n > 1 else ""
        print(f"  {name}: {ms:.4f} ms ({100 * ms / step_ms:.1f}%{each})")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(profile_steps):
            state = step(state, timed_parts=False)
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) * 1e3
    n = profile_steps
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    if busy > 0:
        print(f"torch.profiler, {n} steps: {elapsed / n:.4f} ms/step elapsed, "
              f"{busy / n:.4f} ms/step in kernels, device idle "
              f"{100 * (1 - busy / elapsed):.1f}%")
    else:
        print("torch.profiler saw no device time: idle share not measured")
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"  {e.key[:60]}: {e.self_device_time_total / (n * 1e3):.4f} ms/step, "
              f"{e.count / n:.2f} calls/step")


def warm_nonhydrostatic(path):
    """The model of chip_smoke.py's 256³ ``path`` and its state after the
    path's warm-up steps; returns (model, state, Δt)."""
    timestepper, dt, warmup, _, kw = chip_smoke.PATHS[path]
    model = chip_smoke.model_for(chip_smoke.N, torch.float32,
                                timestepper=timestepper, **kw)
    rng = np.random.default_rng(0)
    shape = model.grid.shape
    state = model.initial_state(u=1e-2 * rng.standard_normal(shape),
                                v=1e-2 * rng.standard_normal(shape),
                                b=1e-4 * rng.standard_normal(shape))
    for _ in range(warmup):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    return model, state, dt


def nonhydrostatic(path, steps, warmed=None):
    """The 256³ AB2 or RK3 path of chip_smoke.py, broken down (``warmed``:
    another AB2 model, its state and Δt, with ``path`` its label)."""
    model, state, dt = warmed or warm_nonhydrostatic(path)
    events = collections.defaultdict(list)
    if path.startswith("AB2"):
        kernels = {"advance": timed(events, "K1", nm.KERNELS["advance"])}
        patches = [(model, "_fast_project_interior", "projection"),
                   (model, "update_state", "update_state")]
        inner = {}
    else:
        kernels = {"advect": timed(events, "K2", nm.KERNELS["advect"])}
        patches = [(model, "tendencies", "tendencies"),
                   (nm, "rk3_substep", "rk3_substep"),
                   (model, "project_velocities", "project_velocities"),
                   (model, "update_state", "update_state")]
        inner = {"tendencies": (("K2",), None)}
    if "fill" in nm.KERNELS:  # update_state's fills (eager before K6 took them)
        kernels["fill"] = timed(events, "K6 fills", nm.KERNELS["fill"])
        inner["update_state"] = (("K6 fills",), None)
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    breakdown(f"{path} {chip_smoke.N}^3 fp32 step", step, state, events, patches,
              steps, inner)


def ab2_bf16(steps):
    """chip_smoke.py's ``AB2 bf16 smoothness`` path (bench.py with
    CLIMA_BF16S: WENO5(bf16_smoothness=True)) after its warm-up steps,
    broken down as ``ab2``, then the fp32 AB2 model from the same state
    likewise (the docstring's ``ab2-bf16``)."""
    path = "AB2 bf16 smoothness"
    dt, warmup, _ = chip_smoke.BF16_PATH_STEPS
    for option, label in ((chip_smoke.BF16_PATHS[path], path), (None, "AB2 fp32")):
        model, state = chip_smoke.bf16_path_model(path, option)
        for _ in range(warmup):
            state = model.step(state, dt)
        torch.cuda.synchronize()
        nonhydrostatic(label, steps, (model, state, dt))
        del model, state
        torch.cuda.empty_cache()


def general_projection(steps):
    """The 256³ flux-wall RK3 step of chip_smoke.py's general-projection
    path, broken down: K2, the eager terms, ``rk3_substep``, the
    projection's copies and pads with their K6 fills, K3b, the FFT solve,
    K3c, the correction, and ``update_state`` with its K6 fills apart."""
    model, state, dt = warm_nonhydrostatic("general projection")
    events = collections.defaultdict(list)
    fill = nm.KERNELS["fill"]
    update_state = model.update_state
    model.update_state = lambda s, kernels=None: update_state(
        s, dict(kernels or {}, fill=timed(events, "update_state's K6 fills", fill)))
    kernels = {"advect": timed(events, "K2", nm.KERNELS["advect"]),
               "divergence": timed(events, "K3b", nm.KERNELS["divergence"]),
               "gradient": timed(events, "K3c", nm.KERNELS["gradient"])}
    copies = "copies and pads with their K6 fills"
    patches = [(model, "tendencies", "tendencies"),
               (nm, "rk3_substep", "rk3_substep"),
               (model, "project_velocities", "project_velocities"),
               (model, "_filled_velocity_copies", copies),
               (model, "_filled_pressure", copies),
               (model.pressure_solver, "solve", "FFT solve"),
               (model, "update_state", "update_state")]
    inner = {"tendencies": (("K2",), "the eager terms (tendencies less K2)"),
             "project_velocities": ((copies, "K3b", "FFT solve", "K3c"),
                                    "the correction (project_velocities less "
                                    "its other parts)"),
             "update_state": (("update_state's K6 fills",), None)}
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    breakdown(f"general projection {chip_smoke.N}^3 fp32 step (FluxBC w walls)",
              step, state, events, patches, steps, inner)


def walls(path, steps):
    """A walls-and-Flat RK3 step of chip_smoke.py (``WALLS``: horizontal
    convection at 4096×1×2048, 2D turbulence at 8192²) after its warm-up
    steps, broken down as ``general_projection``: K2, the eager terms,
    ``rk3_substep``, the projection's copies and pads with their K6 fills,
    K3b, the pressure solve (DCTs along the bounded axes), K3c, the
    correction, and ``update_state`` with its K6 fills apart."""
    model, state, dt = chip_smoke.wall_path_model(path)
    for _ in range(chip_smoke.WALLS[path][0]):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    fill = nm.KERNELS["fill"]
    update_state = model.update_state
    model.update_state = lambda s, kernels=None: update_state(
        s, dict(kernels or {}, fill=timed(events, "update_state's K6 fills", fill)))
    kernels = {"advect": timed(events, "K2", nm.KERNELS["advect"]),
               "divergence": timed(events, "K3b", nm.KERNELS["divergence"]),
               "gradient": timed(events, "K3c", nm.KERNELS["gradient"])}
    copies = "copies and pads with their K6 fills"
    patches = [(model, "tendencies", "tendencies"),
               (nm, "rk3_substep", "rk3_substep"),
               (model, "project_velocities", "project_velocities"),
               (model, "_filled_velocity_copies", copies),
               (model, "_filled_pressure", copies),
               (model.pressure_solver, "solve", "pressure solve"),
               (model, "update_state", "update_state")]
    inner = {"tendencies": (("K2",), "the eager terms (tendencies less K2)"),
             "project_velocities": ((copies, "K3b", "pressure solve", "K3c"),
                                    "the correction (project_velocities less "
                                    "its other parts)"),
             "update_state": (("update_state's K6 fills",), None)}
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    size = "x".join(map(str, model.grid.shape))
    breakdown(f"{path} {size} fp32 step", step, state, events, patches, steps, inner)


def ptxas(source, label, echo=True):
    """ptxas's registers, stack and spills of every instantiation in
    ``csrc/<source>.cu``, one line each, from a build as the port builds it
    plus ``-Xptxas -v``; returns the lines (printed unless not ``echo``)."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               f"{tmp}/lib.so", str(_build.CSRC / f"{source}.cu")]
        log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    lines = ptxas_lines(log, source, label)
    if echo:
        print("\n".join(lines))
    return lines


def ptxas_lines(log, source, label):
    """One line for each instantiation's registers, stack and spills in the
    ``-Xptxas -v`` log of a build of ``csrc/<source>.cu``, and their count."""
    entry, props, rows = None, "", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "bytes stack frame" in line:
            props = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and entry:
            rows.append((entry, line.split(":", 1)[-1].strip(), props))
            entry = None
    names = subprocess.run(["c++filt"], input="\n".join(e for e, _, _ in rows),
                           capture_output=True, text=True).stdout.splitlines()
    if len(names) != len(rows):
        names = [e for e, _, _ in rows]
    lines = [f"ptxas {label} {name.replace(source + '_kernel', 'kernel')}: {used}; {props}"
             for name, (_, used, props) in zip(names, rows)]
    lines.append(f"ptxas {label}: {len(rows)} instantiations")
    return lines


def ptxas_schemes(steps):
    """ptxas's registers, stack and spills of every instantiation of the
    four kernels that take the advection schemes (K1, K2, K3a, K4b), built
    at once, one nvcc each."""
    import concurrent.futures
    sources = ("fused_ab2_advance", tft.K2_LIB, tft.K2_ANY_LIB,
               "fused_shallow_water_tendencies", "fused_hydrostatic_tendencies")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        for lines in ex.map(lambda s: ptxas(s, s, echo=False), sources):
            print("\n".join(lines))


def kernel_sass(csrc, name):
    """{demangled kernel: [instruction text]} of ``csrc/<name>.cu`` built as
    the port builds it, by ``cuobjdump -sass``."""
    import re
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{tmp}/lib.so",
                        f"{csrc}/{name}.cu"], check=True, capture_output=True)
        dump = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
                               f"{tmp}/lib.so"], check=True, capture_output=True,
                              text=True).stdout
    out, cur = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
        elif cur is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
            if m:
                cur.append(m.group(1))
    names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True,
                           text=True).stdout.splitlines()
    return dict(zip(names, out.values()))


def counterpart(fn, there):
    """The name in ``there`` of the kernel ``fn`` with its trailing template
    arguments dropped one at a time (the parent lacks the newer
    parameters), or None."""
    import re
    m = re.match(r"(.*?<)(.*)(>\(.*)", fn)
    if m is None:
        return fn if fn in there else None
    head, args, tail = m.group(1), m.group(2).split(", "), m.group(3)
    while args:
        cand = head + ", ".join(args) + tail
        if cand in there:
            return cand
        args.pop()
    return None


def sass_regular(steps, parent, names=None, every=False):
    """K1's, K2's, K3a's, K4b's and K4a's instantiations whose last template
    flag is false (without ``ANY``: the first codes; with ``ANY``, without
    the bf16 sub-form ``BF``; K4a's and K4b's without ``D3``) as built here against the same ones built from
    the parent tree's ``csrc`` (``--parent DIR``), all built at once: their SASS
    instruction sequences, counted, and compared with constants
    (immediates and constant-bank offsets) masked, which differ where the
    argument struct grew. ``names`` other sources' kernels (``<name>_kernel``)
    in place of those; with ``every``, all their instantiations."""
    import concurrent.futures
    import re
    mask = lambda ins: re.sub(r"0x[0-9a-f]+", "#", ins)
    names = names or ("fused_ab2_advance", "fused_advective_tendencies",
                      "fused_shallow_water_tendencies", "fused_hydrostatic_tendencies",
                      "hydrostatic_columns")
    def parts(csrc, name):
        """``name``'s sources in ``csrc``: K2's two since its split."""
        extra = tft.K2_ANY_LIB
        return ([name, extra] if name == tft.K2_LIB and (Path(csrc) / f"{extra}.cu").exists()
                else [name])

    with concurrent.futures.ThreadPoolExecutor(4 * len(names)) as ex:
        built = {(csrc, part): ex.submit(kernel_sass, csrc, part)
                 for name in names for csrc in (_build.CSRC, parent)
                 for part in parts(csrc, name)}

    def sass_of(csrc, name):
        out = {}
        for part in parts(csrc, name):
            out.update(built[(csrc, part)].result())
        return out

    for name in names:
        kernel = name + "_kernel"
        here = sass_of(_build.CSRC, name)
        there = sass_of(parent, name)
        print(f"sass {name}: {sum(kernel in fn for fn in here)} kernels here from "
              f"{parts(_build.CSRC, name)}, {sum(kernel in fn for fn in there)} in the "
              f"parent from {parts(parent, name)}")
        for fn, ins in sorted(here.items()):
            if kernel not in fn:
                continue
            if not every and ", false>(" not in fn:
                continue
            # a parent kernel without this tree's newer template
            # parameters (ANY; K4b's layout and Cartesian flag): this
            # tree's form with its trailing arguments dropped until one
            # matches
            old = there.get(counterpart(fn, there))
            if old is None:
                print(f"sass {fn}: {len(ins)} instructions; no parent counterpart")
                continue
            here_m, old_m = [mask(a) for a in ins], [mask(b) for b in old]
            differ = sum(a != b for a, b in zip(here_m, old_m))
            regs = lambda seq: sorted(set(re.findall(r"\bR\d+\b", " ".join(seq))))
            print(f"sass {fn}: {len(ins)} instructions here, {len(old)} in the parent; "
                  f"identical {ins == old}, identical with constants masked "
                  f"{here_m == old_m} ({differ} lines differ; opcodes alike "
                  f"{[a.split()[0] for a in here_m] == [b.split()[0] for b in old_m]}; "
                  f"registers {len(regs(ins))} here, {len(regs(old))} in the parent)")
            for a, b in [(a, b) for a, b in zip(here_m, old_m) if a != b][:3]:
                print(f"    here: {a}\n    parent: {b}")


def seamount(steps):
    """chip_smoke.py's seamount path (validation/seamount.py at 4096×1×2048
    fp64: an immersed bottom, PositiveWENO5 tracers, quasi-AB2 on the
    general branch) after its warm-up steps: ptxas's counts of every K2
    instantiation, then K2, the eager diffusion (``momentum_diffusion`` and
    ``tracer_diffusion``, their fluxes zeroed at solid faces), the masks
    (``mask_state``, ``mask_tendency``), the immersed bottom's fluxes,
    ``ab2_substep``, the rest of ``tendencies`` (Coriolis-free: −∂pHY′ and
    the flux BCs), the projection's copies and pads with their K6 fills,
    K3b, the pressure solve (FFT in x, DCT in z), K3c, the correction, and
    ``update_state`` with its K6 fills apart."""
    ptxas(tft.K2_LIB, "K2")
    ptxas(tft.K2_ANY_LIB, "K2")
    model = chip_smoke.seamount_model()
    state = chip_smoke.seamount_state(model)
    c = chip_smoke.SEAMOUNT
    dt = min(60.0, 0.25 * c["Lx"] / c["size"][0])
    for _ in range(c["warmup"]):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    fill = nm.KERNELS["fill"]
    update_state = model.update_state
    model.update_state = lambda s, kernels=None: update_state(
        s, dict(kernels or {}, fill=timed(events, "update_state's K6 fills", fill)))
    kernels = {"advect": timed(events, "K2", nm.KERNELS["advect"]),
               "divergence": timed(events, "K3b", nm.KERNELS["divergence"]),
               "gradient": timed(events, "K3c", nm.KERNELS["gradient"])}
    copies = "copies and pads with their K6 fills"
    patches = [(model, "tendencies", "tendencies"),
               (nm, "momentum_diffusion", "eager diffusion"),
               (nm, "tracer_diffusion", "eager diffusion"),
               (nm, "apply_immersed_flux_bcs", "immersed flux BCs"),
               (model.immersed_boundary, "mask_state", "mask_state"),
               (model.immersed_boundary, "mask_tendency", "mask_tendency"),
               (nm, "ab2_substep", "ab2_substep"),
               (model, "project_velocities", "project_velocities"),
               (model, "_filled_velocity_copies", copies),
               (model, "_filled_pressure", copies),
               (model.pressure_solver, "solve", "pressure solve"),
               (model, "update_state", "update_state")]
    inner = {"tendencies": (("K2", "eager diffusion", "immersed flux BCs", "mask_tendency"),
                            "the rest of tendencies (-dpHY', flux BCs, dict work)"),
             "project_velocities": ((copies, "K3b", "pressure solve", "K3c"),
                                    "the correction (project_velocities less "
                                    "its other parts)"),
             "update_state": (("update_state's K6 fills", "mask_state"), None)}
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    size = "x".join(map(str, model.grid.shape))
    breakdown(f"seamount {size} fp64 step", step, state, events, patches, steps, inner)


def k6_k3c(steps):
    """K6 and K3c as built: ptxas's registers, stack and spills, then each
    kernel's device time alone (torch.profiler), every result held bit for
    bit against the plain version: K6 on the ¼° first group and on the 256³
    nonhydrostatic group (u, v, w, b), K3c at 256³ fp32 and fp64; beside
    them the yardsticks of K3c's bytes."""
    from clima_oceananigans_jl_torch.ops import fused_fill as ff
    from clima_oceananigans_jl_torch.ops import fused_tendencies as ft
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("fill_halos", "fused_projection"):
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                   f"{tmp}/lib.so", str(_build.CSRC / f"{name}.cu")]
            log = subprocess.run(cmd, capture_output=True, text=True,
                                 check=True).stderr
            for line in log.splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")
    reps = max(steps, 20)
    cases = []
    model = chip_smoke.latlon_flagship()
    first, _ = chip_smoke.hydro_fill_fields(model)
    cases.append(("1/4 deg fp32 u, v, T, S, b, eta", model.grid, first))
    nh = chip_smoke.model_for(chip_smoke.N, torch.float32,
                              timestepper="RungeKutta3")
    group, _ = chip_smoke.nonhydrostatic_fill_fields(nh)
    cases.append((f"{chip_smoke.N}^3 fp32 u, v, w, b", nh.grid, group))
    if hasattr(chip_smoke, "langmuir_model"):  # trees with the langmuir path
        lm = chip_smoke.langmuir_model()
        group, _ = chip_smoke.nonhydrostatic_fill_fields(lm)
        cases.append((f"{chip_smoke.N}^3 fp32 langmuir u, v, w, b (b's gradient "
                      "wall: the side table)", lm.grid, group))
    for label, g, fields in cases:
        got = chip_smoke.nan_halos(g, fields, 21)
        ref = [(d.clone(), *rest) for d, *rest in got]
        ff.fused_fill_halos_reference(g, ref)
        ff.fused_fill_halos(g, got)
        if not all(torch.equal(a[0], b[0]) for a, b in zip(got, ref)):
            raise AssertionError(f"K6 {label}: not bitwise")
        ms = [chip_smoke.device_ms(lambda: ff.fused_fill_halos(g, got), reps,
                                   "fill_halos_kernel") for _ in range(2)]
        print(f"K6 {label}: kernel ms (torch.profiler), two rounds: {ms}")
        del got, ref
    del model, nh
    torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.float64):
        grid = chip_smoke.RectilinearGrid(
            size=(chip_smoke.N,) * 3, extent=(1.0, 1.0, 1.0),
            topology=(PERIODIC, PERIODIC, chip_smoke.BOUNDED), dtype=dtype,
            device=chip_smoke.DEVICE)
        gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(22)
        p = torch.randn(grid.total_shape, generator=gen, dtype=dtype,
                        device=chip_smoke.DEVICE)
        got = ft.fused_pressure_gradient(grid, p)
        ref = ft.fused_pressure_gradient_reference(grid, p)
        if not all(torch.equal(grid.interior(a), grid.interior(b))
                   for a, b in zip(got, ref)):
            raise AssertionError(f"K3c {str(dtype)[6:]}: not bitwise")
        del got, ref
        ms = [chip_smoke.device_ms(lambda: ft.fused_pressure_gradient(grid, p),
                                   reps, "pressure_gradient_kernel")
              for _ in range(2)]
        print(f"K3c {chip_smoke.N}^3 {str(dtype)[6:]}: kernel ms "
              f"(torch.profiler), two rounds: {ms}")
        if dtype == torch.float32:
            # yardsticks: the same bytes written (three with-halo fields
            # zeroed) and p copied once (one read, one write)
            out = [torch.empty_like(p) for _ in range(3)]
            zero_ms = chip_smoke.device_ms(lambda: [o.zero_() for o in out], reps, "")
            copy_ms = chip_smoke.device_ms(lambda: out[0].copy_(p), reps, "")
            print(f"yardsticks at {chip_smoke.N}^3 fp32 with halos: three "
                  f"fields zeroed {zero_ms} ms, one copied {copy_ms} ms "
                  "(torch.profiler)")
            del out
        del p
        torch.cuda.empty_cache()


def surface(path, steps):
    """The 256³ ``langmuir`` or ``wind mixing`` path of chip_smoke.py
    (RK3, surface fluxes, gradient walls; Stokes drift on langmuir),
    broken down like ``rk3``, with the Stokes drift's six terms and the
    boundary fluxes (``apply_flux_bcs``) as parts of their own inside
    ``tendencies``."""
    from clima_oceananigans_jl_torch.stokes_drift import UniformStokesDrift
    model = (chip_smoke.langmuir_model if path == "langmuir"
             else chip_smoke.wind_mixing_model)()
    state = chip_smoke.surface_state(path, model)
    dt, warmup, _ = chip_smoke.SURFACE[path]
    for _ in range(warmup):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    kernels = {"advect": timed(events, "K2", nm.KERNELS["advect"]),
               "fill": timed(events, "K6 fills", nm.KERNELS["fill"])}
    patches = [(model, "tendencies", "tendencies"),
               (nm, "apply_flux_bcs", "flux BCs"),
               (nm, "rk3_substep", "rk3_substep"),
               (model, "project_velocities", "project_velocities"),
               (model, "update_state", "update_state")]
    within = ["K2", "flux BCs"]
    if path == "langmuir":
        patches += [(UniformStokesDrift, name, "Stokes drift") for name in (
            "x_curl_Us_cross_U", "y_curl_Us_cross_U", "z_curl_Us_cross_U",
            "dt_us", "dt_vs", "dt_ws")]
        within.append("Stokes drift")
    inner = {"tendencies": (tuple(within), "the other eager terms (tendencies "
                            "less " + ", ".join(within) + ")"),
             "update_state": (("K6 fills",), None)}
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    breakdown(f"{path} {chip_smoke.N}^3 fp32 step", step, state, events, patches,
              steps, inner)


def les(path, steps):
    """The 256³ uncut LES paths of chip_smoke.py (``LES``), broken down
    like ``rk3``: K2 (or K1 on the AB2 path), the eager terms
    (``tendencies`` less K2), ``rk3_substep``, the implicit step (its T1
    solves apart from its bands), the projection (its K6 fills and its
    pressure solve apart, and in the Fourier-tridiagonal solve T1 apart
    from the FFTs and the gauge), ``update_state`` (its K6 fills and the AMD
    diffusivities apart)."""
    from clima_oceananigans_jl_torch.closures.eddy_viscosity import (
        AnisotropicMinimumDissipation)
    model = chip_smoke.les_model(path)
    state = (chip_smoke.bench_state(model) if path == "AB2 stretched implicit"
             else chip_smoke.surface_state(path, model))
    dt, warmup, _ = chip_smoke.LES[path]
    for _ in range(warmup):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    fill = nm.KERNELS["fill"]
    update_state = model.update_state
    model.update_state = lambda s, kernels=None: update_state(
        s, dict(kernels or {}, fill=timed(events, "update_state's K6 fills", fill)))
    adv, key = (("K1", "advance") if path == "AB2 stretched implicit"
                else ("K2", "advect"))
    kernels = {key: timed(events, adv, nm.KERNELS[key]),
               "fill": timed(events, "the projection's K6 fills", fill),
               "tridiagonal": timed(events, "T1 (implicit step)",
                                    nm.KERNELS["tridiagonal"]),
               "fourier": timed(events, "T1 (pressure solve)", nm.KERNELS["fourier"])}
    patches = [(model, "tendencies", "tendencies"),
               (nm, "rk3_substep", "rk3_substep"),
               (model, "project_velocities", "project_velocities"),
               (model.pressure_solver, "solve", "pressure solve"),
               (AnisotropicMinimumDissipation, "compute_diffusivities",
                "AMD diffusivities"),
               (model, "update_state", "update_state")]
    inner = {"tendencies": (("K2",), "the eager terms (tendencies less K2)"),
             "implicit step": (("T1 (implicit step)",),
                               "the implicit step's bands (less T1)"),
             "project_velocities": (("the projection's K6 fills", "pressure solve"),
                                    "the projection's divergence, gradient and "
                                    "correction (project_velocities less its "
                                    "fills and solve)"),
             "pressure solve": (("T1 (pressure solve)",),
                                "the pressure solve's FFTs and gauge (less T1)"),
             "update_state": (("update_state's K6 fills", "AMD diffusivities"),
                              None)}
    if model.closure.vertically_implicit:
        patches.append((nm, "implicit_step_fields", "implicit step"))
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    try:
        breakdown(f"{path} {chip_smoke.N}^3 fp32 step", step, state, events,
                  patches, steps, {k: v for k, v in inner.items()
                                   if k in {name for _, _, name in patches}})
    finally:
        model.update_state = update_state


def t1(steps):
    """T1 as built: ptxas's registers, stack and spills of every
    instantiation, then its device time alone (torch.profiler, two rounds),
    held bit for bit against its plain version, in each form of
    ``chip_smoke.t1_forms`` (the Fourier solve of the 256³ wind-mixing
    grid, the implicit step's 1D and 3D bands on 262×262×256 fp32 and 1D
    bands on the ¼° grid's 1446×606×24, read and written through views),
    with the launcher's plan of each; the
    Fourier solve also in fp64, and beside the forms a copy of d (one read,
    one write)."""
    from clima_oceananigans_jl_torch.solvers import tridiagonal as tt
    ptxas("batched_tridiagonal", "T1")
    reps = max(steps, 20)
    kernel_ms = lambda fn: ([chip_smoke.device_ms(fn, reps, "tridiagonal") for _ in range(2)],
                            [queued_ms(fn, reps) for _ in range(2)])
    for f in chip_smoke.t1_forms():
        got, ref = f["call"](), f["plain"]()
        if not torch.equal(got, ref):
            raise AssertionError(f"T1 {f['part']}: not bitwise")
        warm(f["call"])
        b_ms = chip_smoke.bound(chip_smoke.T1, f["nbytes"], f["points"])[0]
        line = (f"T1 {f['part']} {f['shape']}{' (views)' if f['view'] else ''}: "
                f"kernel ms (torch.profiler; queued CUDA events), two rounds each: "
                f"{kernel_ms(f['call'])}; "
                f"bound {b_ms:.4f} ms")
        src = f["plain"]()
        copy_ms = chip_smoke.device_ms(lambda: torch.empty_like(src).copy_(src), reps, "")
        print(f"{line}; d copied {copy_ms} ms; clocks, memory clock, power after: "
              f"{clocks()}")
        print(f"T1 {f['part']}: plan {f['plan']()} (mode 0 table, 1 column, "
              f"2 Fourier; levels a chunk; shared bytes a block)")
        del f, got, ref, src
        torch.cuda.empty_cache()
    grid = chip_smoke.surface_grid(chip_smoke.N, torch.float64, stretched=True)
    args = chip_smoke.fourier_args(grid, 31)
    if not torch.equal(tt.fourier_tridiagonal(*args), tt.fourier_tridiagonal_reference(*args)):
        raise AssertionError("T1 Fourier fp64: not bitwise")
    b = args[6]
    print(f"T1 Fourier {'x'.join(map(str, b.shape))} {b.dtype}: kernel ms "
          f"(torch.profiler; queued CUDA events): {kernel_ms(lambda: tt.fourier_tridiagonal(*args))}")


#: the copies of csrc/batched_tridiagonal.cu that ``t1-variants`` holds
#: against T1 as built: (label, text as built, text in the copy)
T1_VARIANTS = [("sweeps not unrolled", "#pragma unroll (S::UNROLL)\n    for (int kk",
                "#pragma unroll 1\n    for (int kk"),
               ("no table (1D bands in the column mode)", "(any3d || !table_fits)", "(true)")]
T1_VARIANTS += [(f"{w} warps a block", "constexpr int T1_WARPS = ",
                 f"constexpr int T1_WARPS = {w}; //") for w in (1, 2, 4, 8)]


def warm(fn, ms=200.0):
    """Runs ``fn`` for about ``ms`` milliseconds of device time, so that the
    card's clocks have risen before a short timing."""
    t = chip_smoke.cuda_ms(fn, 5)
    for _ in range(int(ms / max(t, 1e-3))):
        fn()
    torch.cuda.synchronize()


def queued_ms(fn, reps):
    """Device time of a call of ``fn`` in ms: CUDA events around ``reps``
    calls queued behind a spin of the card (``torch.cuda._sleep``) long
    enough for the host to enqueue them all, so that neither the host's
    time between launches nor a dropped profiler record counts."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / 3  # host and device, an upper bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * reps * per_call * 2e9))  # ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clocks():
    """The card's SM and memory clocks and power draw, by nvidia-smi."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def t1_variants(steps):
    """T1 as built against copies of its source with one change each
    (``T1_VARIANTS``), each held bit for bit, in the four forms of
    ``chip_smoke.t1_forms``: torch.profiler device time alone, in turns
    (built, the copies, the copies again in reverse, built)."""
    from clima_oceananigans_jl_torch.solvers import tridiagonal as tt
    name = "batched_tridiagonal"
    src = (_build.CSRC / f"{name}.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {"as built": _build.load(name)}
    for i, (label, old, new) in enumerate(T1_VARIANTS):
        if src.count(old) < 1:
            raise RuntimeError(f"t1-variants: the kernel changed at {old!r}")
        if new.endswith("//") and new[:-3] in src:
            continue  # the block shape the source is built with
        cu = _build.BUILD_DIR / f"{name}_variant{i}.cu"
        lib_path = _build.BUILD_DIR / f"lib{name}_variant{i}.so"
        cu.write_text(src.replace(old, new))
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                        str(lib_path), str(cu)], check=True)
        libs[label] = ctypes.CDLL(str(lib_path))
    order = list(libs) + list(libs)[:0:-1] + ["as built"]
    reps = max(steps, 20)
    load = _build.load
    try:
        for f in chip_smoke.t1_forms():
            ref = f["plain"]()
            times = collections.defaultdict(list)
            warm(f["call"])
            for label in order:
                _build.load = lambda n, lib=libs[label]: lib if n == name else load(n)
                tt._plan.cache_clear()  # the copy's own launch plan
                try:
                    got = f["call"]()
                except RuntimeError as e:  # a block shape whose tiles do not fit
                    times[label].append(f"no launch ({e})")
                    continue
                if not torch.equal(got, ref):
                    raise AssertionError(f"T1 {f['part']}, {label}: not bitwise")
                times[label].append(round(queued_ms(f["call"], reps), 5))
            print(f"T1 {f['part']} {f['shape']}: kernel ms (queued CUDA events) in turns: "
                  + "; ".join(f"{k} {v}" for k, v in times.items())
                  + f"; clocks, memory clock, power after: {clocks()}")
            del f, ref
            torch.cuda.empty_cache()
    finally:
        _build.load = load
        tt._plan.cache_clear()


def hydrostatic_wind(steps):
    """The ¼° flagship under the near-global wind stress (chip_smoke.py's
    ``hydrostatic wind`` path): the two-stage route, K4b's tendency form,
    the boundary flux, ``ab2_substep``, then as ``hydrostatic``."""
    model = chip_smoke.latlon_flagship(wind=True)
    if model.fused_advance:
        raise AssertionError("hydrostatic wind: expected the two-stage route")
    dt = chip_smoke.HYDRO["dt"]
    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(0)
    state = model.initial_state(
        u=0.1 * torch.randn(model.grid.shape, generator=gen, device=chip_smoke.DEVICE),
        b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    for _ in range(3):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    kernels = {k: timed(events, label, hm.KERNELS[k]) for k, label in (
        ("tendencies", "K4b (tendencies)"), ("columns", "K4a"),
        ("barotropic", "K5 and its wrapper"), ("fill", "K6 fills"))}
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    breakdown("hydrostatic wind 1/4 deg step (two-stage route)", step, state,
              events, [(hm, "barotropic_mode", "barotropic modes"),
                       (SplitExplicitFreeSurface, "corrector", "corrector"),
                       (hm, "apply_flux_bcs", "flux BC"),
                       (hm, "ab2_substep", "ab2_substep")], steps)


def hydrostatic(steps):
    model = chip_smoke.latlon_flagship()
    dt = chip_smoke.HYDRO["dt"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = model.initial_state(
        u=0.1 * torch.randn(model.grid.shape, generator=gen, device="cuda"),
        b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    for _ in range(3):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    kernels = {k: timed(events, label, hm.KERNELS[k]) for k, label in (
        ("tendencies", "K4b (advance)"), ("columns", "K4a"),
        ("barotropic", "K5 and its wrapper"), ("fill", "K6 fills"))}
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    breakdown("hydrostatic 1/4 deg step", step, state, events,
              [(hm, "barotropic_mode", "barotropic modes"),
               (SplitExplicitFreeSurface, "corrector", "corrector")], steps)


def near_global(path, steps):
    """A ¼° ``NEAR_GLOBAL`` path of chip_smoke.py, its warm-up steps, then
    ``steps`` steps with its parts timed."""
    model = chip_smoke.near_global_model(path)
    dt = chip_smoke.HYDRO["dt"]
    b = lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0
    if path == "1/4 deg diffusive":
        gen = torch.Generator(device="cuda").manual_seed(0)
        state = model.initial_state(
            u=0.1 * torch.randn(model.grid.shape, generator=gen, device="cuda"), b=b)
    else:
        state = model.initial_state(b=b)
    for _ in range(3):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    form = "advance" if model.fused_advance else "tendencies"
    kernels = {k: timed(events, label, hm.KERNELS[k]) for k, label in (
        ("tendencies", f"K4b ({form})"), ("columns", "K4a"),
        ("barotropic", "K5 and its wrapper"), ("fill", "K6 fills"),
        ("tridiagonal", "T1 (implicit step)"))}
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    patches = [(hm, "momentum_diffusion", "eager diffusion"),
               (hm, "tracer_diffusion", "eager diffusion"),
               (hm, "apply_flux_bcs", "flux BCs"),
               (hm, "apply_immersed_flux_bcs", "immersed flux BCs"),
               (hm, "ab2_substep", "ab2_substep"),
               (hm, "barotropic_mode", "barotropic modes"),
               (hm, "implicit_step_fields", "implicit step"),
               (SplitExplicitFreeSurface, "corrector", "corrector")]
    if model.immersed_boundary is not None:
        patches += [(model.immersed_boundary, "mask_state", "mask_state"),
                    (model.immersed_boundary, "mask_tendency", "mask_tendency")]
    breakdown(f"{path} 1/4 deg step", step, state, events, patches, steps,
              inner={"implicit step": (["T1 (implicit step)"],
                                       "implicit step's bands and copies")})


def scheme_path(path, steps):
    """A ¼° ``SCHEME_PATHS`` path of chip_smoke.py (``hydrostatic
    positive``: K4b's fused advance with PositiveWENO5 tracers;
    ``near-global UB5``: the two-stage route with UB5 momentum and
    BoundsPreservingWENO5 tracers over the continent), its model and state
    as chip_smoke.py builds them, 3 warm-up steps, then ``steps`` steps
    with its parts timed."""
    model, state = chip_smoke.hydro_path_model(path)
    dt = chip_smoke.HYDRO["dt"]
    for _ in range(3):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    form = "advance" if model.fused_advance else "tendencies"
    kernels = {k: timed(events, label, hm.KERNELS[k]) for k, label in (
        ("tendencies", f"K4b ({form})"), ("columns", "K4a"),
        ("barotropic", "K5 and its wrapper"), ("fill", "K6 fills"),
        ("tridiagonal", "T1 (implicit step)"))}
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    patches = [(hm, "barotropic_mode", "barotropic modes"),
               (SplitExplicitFreeSurface, "corrector", "corrector")]
    if not model.fused_advance:
        patches += [(hm, "momentum_diffusion", "eager diffusion"),
                    (hm, "tracer_diffusion", "eager diffusion"),
                    (hm, "apply_flux_bcs", "flux BCs"),
                    (hm, "apply_immersed_flux_bcs", "immersed flux BCs"),
                    (hm, "ab2_substep", "ab2_substep"),
                    (hm, "implicit_step_fields", "implicit step"),
                    (model.immersed_boundary, "mask_state", "mask_state"),
                    (model.immersed_boundary, "mask_tendency", "mask_tendency")]
    breakdown(f"{path} 1/4 deg step", step, state, events, patches, steps,
              inner={"implicit step": (["T1 (implicit step)"],
                                       "implicit step's bands and copies")}
              if not model.fused_advance else None)


def near_global_catke(steps):
    """chip_smoke.py's ``near-global CATKE`` path (the ocean-physics
    configuration at ¼°), its warm-up steps, then ``steps`` steps with its
    parts timed: TEOS-10's b for K4a, N² (TEOS-10's b again) inside CATKE's
    diffusivities, the rest of CATKE's diffusivities, ``tke_tendency``, the
    eager horizontal diffusion, K4b, the AB2 substep, T1's five solves and
    the implicit step's bands, the barotropic modes, K5, K4a and K6."""
    model = chip_smoke.ocean_model("CATKE")
    dt = chip_smoke.HYDRO["dt"]
    state = chip_smoke.ocean_state(model)
    for _ in range(chip_smoke.HYDRO["warmup"]):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    kernels = {k: timed(events, label, hm.KERNELS[k]) for k, label in (
        ("tendencies", "K4b (tendencies)"), ("columns", "K4a"),
        ("barotropic", "K5 and its wrapper"), ("fill", "K6 fills"),
        ("tridiagonal", "T1 (implicit step)"))}
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    patches = [(model, "_buoyancy_field", "TEOS-10 b for K4a"),
               (vm, "buoyancy_gradient_faces", "N2 (TEOS-10 b) in CATKE"),
               (CATKEVerticalDiffusivity, "compute_diffusivities", "CATKE diffusivities"),
               (CATKEVerticalDiffusivity, "tke_tendency", "tke_tendency"),
               (hm, "momentum_diffusion", "eager horizontal diffusion"),
               (hm, "tracer_diffusion", "eager horizontal diffusion"),
               (hm, "apply_flux_bcs", "flux BCs"),
               (hm, "ab2_substep", "ab2_substep"),
               (hm, "barotropic_mode", "barotropic modes"),
               (hm, "implicit_step_fields", "implicit step"),
               (SplitExplicitFreeSurface, "corrector", "corrector"),
               (model.immersed_boundary, "mask_state", "mask_state"),
               (model.immersed_boundary, "mask_tendency", "mask_tendency")]
    breakdown("near-global CATKE 1/4 deg step", step, state, events, patches, steps,
              inner={"implicit step": (["T1 (implicit step)"],
                                       "implicit step's bands and copies"),
                     "CATKE diffusivities": (["N2 (TEOS-10 b) in CATKE"],
                                             "CATKE diffusivities less N2")})


def shallow_water(steps):
    n = chip_smoke.N_SW
    dt, warmup, _ = chip_smoke.SW_PATH
    grid = RectilinearGrid(size=(n, n, 1), x=(0, 2 * math.pi), y=(0, 2 * math.pi),
                           topology=(PERIODIC, PERIODIC, FLAT),
                           dtype=torch.float32, device="cuda")
    model = ShallowWaterModel(grid, gravitational_acceleration=10.0,
                              advection=WENO5())
    state = model.initial_state(
        uh=lambda x, y, z: 0.1 * torch.sin(x) * torch.cos(y), h=1.0)
    for _ in range(warmup):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    kernels = {"core": timed(events, "K3a", swm.KERNELS["core"])}
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    breakdown(f"shallow water {n}^2 fp32 step", step, state, events,
              [(swm, "rk3_substep", "rk3_substep"),
               (model, "fill_all_halos", "fill_all_halos")], steps)


def front_slice(steps):
    """chip_smoke.py's front slice after its warm-up steps, broken down."""
    model, state = chip_smoke.front_model_state()
    c = chip_smoke.FRONT
    for _ in range(c["warmup"]):
        state = model.step(state, c["dt"])
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    kernels = {k: timed(events, label, hm.KERNELS[k]) for k, label in (
        ("tendencies", "K4b (advance, Flat-x layout)"), ("columns", "K4a"),
        ("barotropic", "K5 and its wrapper"), ("fill", "K6 fills"))}
    step = lambda s, timed_parts: model.step(s, c["dt"], kernels if timed_parts else None)
    g = model.grid
    breakdown(f"front slice {g.Nx}x{g.Ny}x{g.Nz} fp32 step", step, state, events,
              [(hm, "barotropic_mode", "barotropic modes"),
               (SplitExplicitFreeSurface, "corrector", "corrector")], steps)


def gyre(steps):
    """chip_smoke.py's Stommel gyre at its timed size after 2 warm-up
    steps, broken down: K3a, Coriolis, the forcing callables, the flux BCs,
    the RK3 substep and the halo fills."""
    bg, n = chip_smoke.barotropic_gyre, chip_smoke.GYRE_TIMED["N"]
    model = bg.model_for(n, "cuda")
    dt = bg.time_step(n)[0]
    state = model.initial_state(h=bg.H)
    for _ in range(chip_smoke.GYRE_TIMED["warmup"]):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    kernels = {"core": timed(events, "K3a", swm.KERNELS["core"])}
    model.forcing = {k: timed(events, "forcing callables", f)
                     for k, f in model.forcing.items()}
    step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
    breakdown(f"Stommel gyre {n}^2 fp64 step", step, state, events,
              [(type(model.coriolis), "x_f_cross_U", "Coriolis"),
               (type(model.coriolis), "y_f_cross_U", "Coriolis"),
               (swm, "apply_flux_bcs", "apply_flux_bcs"),
               (swm, "rk3_substep", "rk3_substep"),
               (model, "fill_all_halos", "fill_all_halos")], steps)


def stretched_channel(steps):
    """chip_smoke.py's stretched channel after its warm-up steps, broken
    down (module docstring)."""
    ptxas(tft.STRETCHED_XY_LIB, "K2XY")
    model, state = chip_smoke.channel_model()
    c = chip_smoke.CHANNEL
    for _ in range(c["warmup"]):
        state = model.step(state, c["dt"])
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    fill = nm.KERNELS["fill"]
    update_state = model.update_state
    model.update_state = lambda s, kernels=None: update_state(
        s, dict(kernels or {}, fill=timed(events, "update_state's K6 fills", fill)))
    kernels = {"advect": timed(events, "K2 (stretched-x/y form)", nm.KERNELS["advect"])}
    copies = "copies and pad with their K6 fills"
    solve = "multigrid pressure solve"
    cg = "the solve's CG matvecs, reductions and host reads"
    patches = [(model, "tendencies", "tendencies"),
               (nm, "ab2_substep", "ab2_substep"),
               (model, "project_velocities", "project_velocities"),
               (model, "_filled_velocity_copies", copies),
               (model, "_filled_pressure", copies),
               (nm, "fused_divergence_reference", "divergence (whole-array)"),
               (nm, "fused_pressure_gradient_reference", "gradient (whole-array)"),
               (model.pressure_solver, "solve", solve),
               (tsm, "v_cycle", "V-cycles"),
               (model, "update_state", "update_state"),
               (model, "_step_particles", "particles' step")]
    inner = {"tendencies": (("K2 (stretched-x/y form)",),
                            "the eager terms (tendencies less K2)"),
             solve: (("V-cycles",), cg),
             "project_velocities": ((copies, "divergence (whole-array)", cg, "V-cycles",
                                     "gradient (whole-array)"),
                                    "the correction (project_velocities less its "
                                    "other parts)"),
             "update_state": (("update_state's K6 fills",), None)}
    tsm.SOLVES.update(solves=0, iterations=0, residual=0.0)
    step = lambda s, timed_parts: model.step(s, c["dt"], kernels if timed_parts else None)
    size = "x".join(map(str, model.grid.shape))
    breakdown(f"stretched channel {size} fp64 step, {len(state['particles'])} particles",
              step, state, events, patches, steps, inner)
    print(f"stretched channel: {tsm.SOLVES['iterations'] / tsm.SOLVES['solves']:.1f} "
          f"multigrid-CG iterations a solve over {tsm.SOLVES['solves']} solves")


#: builds of K2's stretched-x/y form that ``k2xy`` times beside the one the
#: port builds: its threads a block in fp32 and fp64 (``XY_THREADS_F32``,
#: ``XY_THREADS_F64``: 768 and 512 as built)
K2XY_VARIANTS = {"fp32 1024, fp64 1024 threads": ("-DXY_THREADS_F32=1024",
                                                  "-DXY_THREADS_F64=1024"),
                 "fp32 512, fp64 768 threads": ("-DXY_THREADS_F32=512",
                                                "-DXY_THREADS_F64=768")}


def build_library(source, flags=()):
    """``source`` (a .cu file) built as the port builds it plus ``flags`` and
    ``-Xptxas -v`` into a temporary directory; returns (the library's path,
    the build's log, its seconds)."""
    t0 = time.perf_counter()
    out = Path(tempfile.mkdtemp(prefix="k2xy-")) / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", str(out),
           str(source)]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    return out, log, time.perf_counter() - t0


def k2xy(steps, parent=None):
    """K2's stretched-x/y form alone: ptxas's counts of each build (as the
    port builds it, ``K2XY_VARIANTS`` and, with ``--parent DIR``, the parent
    tree's ``fused_advective_tendencies.cu``, whose entry of the same name
    takes the same arguments), all built at once; then on the stretched
    channel's initial fields (``chip_smoke.channel_model``: 256×256×128 fp64,
    u, v, w, c, WENO5 with x and z tables) and on each of
    ``chip_smoke.K2XY_CASES``, each build in turns (as built, the others,
    then back), every one held bit for bit against the form as built over
    the whole with-halo outputs, by CUDA events."""
    import concurrent.futures
    src = _build.CSRC / f"{tft.STRETCHED_XY_LIB}.cu"
    builds = {"as built": (src, ()), **{k: (src, f) for k, f in K2XY_VARIANTS.items()}}
    if parent is not None:
        builds["parent"] = (Path(parent) / "fused_advective_tendencies.cu", ())
    libs = {}
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as ex:
        futures = {k: ex.submit(build_library, *b) for k, b in builds.items()}
        for k, fut in futures.items():
            path, log, secs = fut.result()
            print(f"k2xy build {k}: {secs:.1f} s")
            source = Path(builds[k][0]).stem
            print("\n".join(line for line in ptxas_lines(log, source, f"K2XY {k}")
                            if "stretched" in line or "instantiations" in line))
            libs[k] = ctypes.CDLL(str(path))
    load = _build.load

    def call(lib, args):
        _build.load = lambda name: lib if name == tft.STRETCHED_XY_LIB else load(name)
        try:
            return tft.fused_advective_tendencies(*args)
        finally:
            _build.load = load

    def cases():
        model, state = chip_smoke.channel_model(particles=False)
        sol = state["solution"]
        yield ("the stretched channel's initial fields 256x256x128 fp64",
               (model.grid, model.advection, model.tracer_advection, sol["u"], sol["v"],
                sol["w"], {"c": sol["c"]}))
        del model, state, sol
        for label, *case in chip_smoke.K2XY_CASES:
            yield label, chip_smoke.k2xy_args(*case)

    order = list(libs) + list(libs)[::-1]
    for label, args in cases():
        ref = call(libs["as built"], args)
        times = collections.defaultdict(list)
        for k in order:
            got = call(libs[k], args)
            for n in ref:
                if not torch.equal(got[n], ref[n]):
                    raise AssertionError(f"k2xy {label}: {k} differs from the form as built "
                                         f"in {n}")
            times[k].append(chip_smoke.cuda_ms(lambda: call(libs[k], args), 10))
        print(f"k2xy {label}: " + ", ".join(
            f"{k} {' / '.join(f'{t:.4f}' for t in ts)} ms" for k, ts in times.items())
              + f" (CUDA events, in turns; {chip_smoke.card_line()})")
        del args, ref
        torch.cuda.empty_cache()


#: the stretched channel's sizes at which ``multigrid_iterations`` solves
MG_SIZES = ((32, 32, 16), (64, 64, 32), (128, 128, 64), (256, 256, 128))


def multigrid_iterations(steps):
    """The stretched channel's multigrid-CG pressure solve at ``MG_SIZES``
    (the channel's grid, faces and initial state at each size, no
    particles): the rhs of its first step's solve, solved as the model
    solves it (tolerance 1e-9, maxiter 200) and with maxiter 2000, each
    with its CG iterations, final relative residual and seconds."""
    for size in MG_SIZES:
        model, state = chip_smoke.channel_model(size, particles=False)
        solver = model.pressure_solver
        rhs = []
        solve = solver.solve
        solver.solve = lambda r, *a, **k: (rhs.append(r.clone()), solve(r, *a, **k))[1]
        model.step(state, chip_smoke.CHANNEL["dt"])
        solver.solve = solve
        b = solver.vol * rhs[0]
        mg = solver.mg
        for maxiter in (mg.maxiter, 2000):
            trial = tsm.MultigridSolver(mg.A, mg.shape, tolerance=mg.tolerance,
                                        maxiter=maxiter, project_mean=True)
            trial._levels = mg.levels
            tsm.SOLVES.update(solves=0, iterations=0, residual=0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trial.solve(b)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            print(f"multigrid iterations: stretched channel {'x'.join(map(str, size))} "
                  f"fp64, {len(mg.levels)} levels, tolerance {mg.tolerance:g}, maxiter "
                  f"{maxiter}: {tsm.SOLVES['iterations']} CG iterations, final relative "
                  f"residual {tsm.SOLVES['residual']:.3e}, {seconds:.3f} s")
        del model, state, solver, rhs, b, mg, trial
        torch.cuda.empty_cache()


def implicit_free_surface(steps):
    """The ¼° flagship under the matrix and the multigrid implicit free
    surface, broken down (module docstring)."""
    for method in chip_smoke.IMPLICIT_FS["methods"]:
        model, state = chip_smoke.flagship_implicit(method)
        dt = chip_smoke.HYDRO["dt"]
        for _ in range(chip_smoke.HYDRO["warmup"]):
            state = model.step(state, dt)
        torch.cuda.synchronize()
        events = collections.defaultdict(list)
        kernels = {k: timed(events, label, hm.KERNELS[k]) for k, label in (
            ("tendencies", "K4b"), ("columns", "K4a"), ("fill", "K6 fills"))}
        solve = "free-surface solve"
        patches = [(hm, "barotropic_mode", "barotropic modes and rhs"),
                   (hm, "div_xy_2d", "barotropic modes and rhs"),
                   (ImplicitFreeSurface, "solve", solve),
                   (tsm, "v_cycle", "V-cycles"),
                   (hm, "grad_x", "eta correction"), (hm, "grad_y", "eta correction")]
        inner = {solve: (("V-cycles",), None)}
        tsm.SOLVES.update(solves=0, iterations=0, residual=0.0)
        step = lambda s, timed_parts: model.step(s, dt, kernels if timed_parts else None)
        g = model.grid
        breakdown(f"1/4 deg {g.Nx}x{g.Ny}x{g.Nz} fp32 step, ImplicitFreeSurface("
                  f"{method!r}, maxiter {chip_smoke.IMPLICIT_FS['maxiter']})", step, state,
                  events, patches, steps, inner)
        print(f"implicit free surface {method}: "
              f"{tsm.SOLVES['iterations'] / tsm.SOLVES['solves']:.1f} CG iterations a "
              f"solve over {tsm.SOLVES['solves']} solves")
        del model, state
        torch.cuda.empty_cache()


PROBE = r"""
#include <cuda_runtime.h>
#include "weno5_advection.cuh"

template <typename T, bool EXACT>
__global__ void probe(const T* x, const T* y, T* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T xi = x[i];
  T yi = y[i], acc = T(0);
#pragma unroll 8
  for (int r = 0; r < 64; ++r) {
    acc = acc + (EXACT ? ieee_div(xi, yi) : xi / yi);
    yi = yi * T(1.0000001);
  }
  out[i] = acc;
}

template <typename T>
static int run(const void* x, const void* y, void* out, int n, int exact, void* s) {
  const int threads = 256, blocks = (n + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(s);
  if (exact) probe<T, true><<<blocks, threads, 0, st>>>((const T*)x, (const T*)y, (T*)out, n);
  else probe<T, false><<<blocks, threads, 0, st>>>((const T*)x, (const T*)y, (T*)out, n);
  return (int)cudaGetLastError();
}

extern "C" {
int division_probe_f32(const void* x, const void* y, void* out, int n, int exact, void* s) {
  return run<float>(x, y, out, n, exact, s);
}
int division_probe_f64(const void* x, const void* y, void* out, int n, int exact, void* s) {
  return run<double>(x, y, out, n, exact, s);
}
}
"""


def division():
    """Time of one division per operand class, as written and through
    ``ieee_div``; 2^24 elements × 64 divisions a call."""
    src = _build.BUILD_DIR / "division_probe.cu"
    lib = _build.BUILD_DIR / "libdivision_probe.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    n = 1 << 24
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fn = getattr(so, f"division_probe_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=gen, dtype=dtype,
                                                        device="cuda")
        tiny = 1e-24 * u(1.0, 3.0)
        classes = {
            "random x, y in [0.5, 2]": (torch.randn(n, generator=gen, dtype=dtype,
                                                    device="cuda"), u(0.5, 2.0)),
            "den ~1e-24, num = p den, |p| ~ 0.1": (0.1 * u(-1.0, 1.0) * tiny, tiny),
            "den ~1e-24, num = p den, |p| ~ 1e-6": (1e-6 * u(-1.0, 1.0) * tiny, tiny),
            "num ~1e-32, den in [0.5, 2]": (1e-32 * u(-1.0, 1.0), u(0.5, 2.0)),
            "subnormal quotient: num ~1e-42, den in [0.5, 2]": (1e-42 * u(-1.0, 1.0),
                                                                u(0.5, 2.0)),
            "0 / 6": (torch.zeros(n, dtype=dtype, device="cuda"),
                      torch.full((n,), 6.0, dtype=dtype, device="cuda")),
            "0 / ~1e-24": (torch.zeros(n, dtype=dtype, device="cuda"), tiny),
        }
        stream = torch.cuda.current_stream().cuda_stream
        for name, (x, y) in classes.items():
            outs, ms = [], []
            for exact in (0, 1):
                out = torch.empty_like(x)
                call = lambda: fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
                                  exact, stream)
                if call() != 0:
                    raise RuntimeError("division probe launch failed")
                ms.append(chip_smoke.cuda_ms(call, 10))
                outs.append(out)
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"division {suffix} {name}: ieee_div is not "
                                     "bitwise x / y")
            per = [1e6 * t / (64 * n) for t in ms]
            print(f"division {suffix} {name}: x / y {ms[0]:.4f} ms "
                  f"({per[0]:.4f} ns each), ieee_div {ms[1]:.4f} ms "
                  f"({per[1]:.4f} ns each), bitwise equal")
    # where fp32 x / y is slow: |x| ~ 2^a, y ~ 2^b, time over the random class's
    fn = so.division_probe_f32
    m = 1 << 20
    sign = torch.where(torch.rand(m, generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    mant = lambda: 1.0 + torch.rand(m, generator=gen, device="cuda")
    out = torch.empty(m, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    time_of = lambda x, y: chip_smoke.cuda_ms(
        lambda: fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, 0, stream), 5)
    base = time_of(sign * mant(), mant())
    bs = list(range(-120, 121, 12))
    print("division f32 x / y time over random (rows |x| ~ 2^a, columns y ~ 2^b):")
    print("   a \\ b " + " ".join(f"{b:>5d}" for b in bs))
    for a in range(-144, 121, 12):
        x = sign * mant() * 2.0 ** a
        row = [time_of(x, mant() * 2.0 ** b) / base for b in bs]
        print(f"  {a:>6d} " + " ".join(f"{r:5.2f}" for r in row))


def k3a_division(steps):
    n = chip_smoke.N_SW
    dt, warmup, _ = chip_smoke.SW_PATH
    grid = RectilinearGrid(size=(n, n, 1), x=(0, 2 * math.pi), y=(0, 2 * math.pi),
                           topology=(PERIODIC, PERIODIC, FLAT),
                           dtype=torch.float32, device="cuda")
    model = ShallowWaterModel(grid, gravitational_acceleration=10.0,
                              advection=WENO5())
    state = model.initial_state(
        uh=lambda x, y, z: 0.1 * torch.sin(x) * torch.cos(y), h=1.0)
    for _ in range(warmup):
        state = model.step(state, dt)
    sol = state["solution"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    rand = lambda s, o=0.0: o + s * torch.randn(grid.total_shape, generator=gen,
                                                device="cuda")
    cases = {"path's fields": (sol["uh"], sol["vh"], sol["h"]),
             "random fields": (rand(0.1), rand(0.1), rand(0.05, 1.0))}
    name = "fused_shallow_water_tendencies"
    variant = _build.BUILD_DIR / f"lib{name}-prec-div-false.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-prec-div=false", "-o",
                    str(variant), str(_build.CSRC / f"{name}.cu")], check=True)
    libs = {"as built": _build.load(name), "-prec-div=false": ctypes.CDLL(str(variant))}
    load = _build.load
    try:
        for label, lib in libs.items():
            _build.load = lambda n, lib=lib: lib if n == name else load(n)
            for case, (uh, vh, h) in cases.items():
                call = lambda: swm.KERNELS["core"](grid, model.advection,
                                                   model.tracer_advection, model.g,
                                                   uh, vh, h, [], None)
                ms = chip_smoke.cuda_ms(call, 20)
                print(f"K3a {n}^2 fp32 {label}, {case}: {ms:.4f} ms (CUDA events)")
    finally:
        _build.load = load


#: (where in K4b's source a phase ends, the phase): a stamp goes after each
K4B_STAMPS = (
    ("  if (advect) copy_async_wait<1>(); else copy_async_wait<0>();\n  __syncthreads();\n",
     "issuing the copies and the halo zeros, waiting for u, v, w"),
    ("        mbern[s] = bernoulli(su, sv, at(i, j, k), sx, sy);\n      }\n    }\n"
     "    __syncthreads();\n", "the momentum arrays"),
    ("    store<T, ADV>(A, 1, p, sv[P.o], g);\n  }\n", "the momentum outputs"),
    ("    __syncthreads();  // tracer f staged; the momentum arrays, or tracer f-1's "
     "buffer and fluxes, free\n", "waiting for each tracer"),
    ("clear_at(clr_c, i * gsx + j * gsy + k, 2));\n      }\n    }\n    __syncthreads();\n",
     "the tracers' face fluxes"),
    ("      store<T, ADV>(A, f, p, sc[at(I, J, K)], g);\n    }\n", "the tracers' outputs"),
)


def k4b_phase_source():
    """csrc/fused_hydrostatic_tendencies.cu with a clock64() stamp at the
    end of each phase of K4B_STAMPS (thread 0 of each block adds the
    cycles since the last stamp to phase_cycles[i])."""
    src = (_build.CSRC / "fused_hydrostatic_tendencies.cu").read_text()
    edits = [('#include "weno5_advection.cuh"\n',
              "__device__ unsigned long long phase_cycles[8];\n"),
             ("  const int tid = threadIdx.x;\n",
              "  unsigned long long phase_t0 = clock64();\n"),
             ('extern "C" {\n',
              "int k4b_phase_cycles(void* host, int to_device) {\n"
              "  return to_device ? (int)cudaMemcpyToSymbol(phase_cycles, host, 64)\n"
              "                   : (int)cudaMemcpyFromSymbol(host, phase_cycles, 64);\n}\n")]
    edits += [(anchor, "{ if (threadIdx.x == 0) { const unsigned long long now = clock64(); "
                       f"atomicAdd(&phase_cycles[{i}], now - phase_t0); phase_t0 = now; }} }}\n")
              for i, (anchor, _) in enumerate(K4B_STAMPS)]
    for anchor, text in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"k4b-phases: the kernel changed at {anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src


def k4b_phases(steps):
    name = "fused_hydrostatic_tendencies"
    cu = _build.BUILD_DIR / f"{name}_phases.cu"
    lib_path = _build.BUILD_DIR / f"lib{name}_phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu.write_text(k4b_phase_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(lib_path), str(cu)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.k4b_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    model = chip_smoke.latlon_flagship()
    dt = chip_smoke.HYDRO["dt"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = model.initial_state(
        u=0.1 * torch.randn(model.grid.shape, generator=gen, device="cuda"),
        b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    for _ in range(3):
        state = model.step(state, dt)
    load = _build.load
    cycles = (ctypes.c_ulonglong * 8)()
    try:
        _build.load = lambda n: lib if n == name else load(n)
        call = lambda: hm.KERNELS["tendencies"](model, state, (dt, False))
        call()
        torch.cuda.synchronize()
        lib.k4b_phase_cycles(cycles, 1)  # zeros
        ms = chip_smoke.cuda_ms(call, steps)
        lib.k4b_phase_cycles(cycles, 0)
    finally:
        _build.load = load
    total = sum(cycles)
    print(f"K4b 1/4 deg advance on the path's fields, {steps + 1} calls with clock64 "
          f"stamps (thread 0 of each block): {ms:.4f} ms a call")
    for i, (_, label) in enumerate(K4B_STAMPS):
        print(f"  {label}: {100 * cycles[i] / total:.1f}%")


def k5_barrier_source():
    """csrc/fused_substep_eta.cu with both passes of a substep skipped: the
    same cooperative grid, prologue, barriers and epilogue, no substep
    work."""
    src = (_build.CSRC / "fused_substep_eta.cu").read_text()
    anchor = "    for (int k0 = 0; k0 < count; k0 += SE_CHUNK) {\n"
    if src.count(anchor) != 2:
        raise RuntimeError("k5-barriers: the kernel's passes changed")
    return src.replace(anchor, anchor.replace("k0 < count", "k0 < (A.n < 0 ? count : 0)"))


def k5_barriers(steps):
    """K5 at 1/4 deg fp32 (30 substeps, random inputs as chip_smoke.py's
    phase 12 makes them) as built and with its passes skipped: the share of
    its time that the 2N grid barriers, the prologue and the epilogue take."""
    name = "fused_substep_eta"
    cu = _build.BUILD_DIR / f"{name}_barriers.cu"
    lib_path = _build.BUILD_DIR / f"lib{name}_barriers.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu.write_text(k5_barrier_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(lib_path), str(cu)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    model = chip_smoke.latlon_flagship()
    g = model.grid
    gen = torch.Generator(device="cuda").manual_seed(12)
    shape = g.total_shape[:2] + (1,)
    rand = lambda s: s * torch.randn(shape, generator=gen, device="cuda")
    eta = chip_smoke.fill2d(rand(0.1), g, chip_smoke.ETA_LOC, model.eta_bcs)
    wv = model.free_surface._weight_vec(None, eta)
    n = chip_smoke.HYDRO["substeps"]
    args = (g, model.eta_bcs, eta, rand(10.0), rand(10.0), rand(1e-3), rand(1e-3),
            *chip_smoke.column_depths(g), 9.80665, 40.0, wv, wv, n)
    call = lambda: hm.KERNELS["barotropic"](*args)
    load = _build.load
    times = {}
    for label in ("as built", "passes skipped", "as built", "passes skipped"):
        try:
            if label == "passes skipped":
                _build.load = lambda k: lib if k == name else load(k)
            times.setdefault(label, []).append(chip_smoke.cuda_ms(call, max(steps, 10)))
        finally:
            _build.load = load
    grid = chip_smoke.cooperative_grid(g)
    full, bare = (min(times[k]) for k in ("as built", "passes skipped"))
    print(f"K5 1/4 deg fp32, {n} substeps, cooperative grid {grid}: as built "
          f"{times['as built']} ms, passes skipped {times['passes skipped']} ms; "
          f"barriers, prologue and epilogue {100 * bare / full:.1f}% of the call, "
          f"{1e3 * bare / (2 * n):.3f} us a barrier at most")


def simulation(steps):
    """chip_smoke.py's simulation path: horizontal convection at
    4096×1×2048 fp32 through ``Simulation`` with its wizard, NaN checker,
    writers and checkpointer (``chip_smoke.simulation_path``), after the
    warm-up, over ``20 × steps`` iterations (100 by default: every
    activity fires) with CUDA events around ``model.step``, the wizard's
    and the NaN checker's reductions and reads, the device average's
    accumulation, the two writers (their copies to the host apart from
    their file writes) and the checkpoint write (its copies apart); the
    rest is the loop's host work (schedules, ``aligned_dt``, the stop
    checks). Then the profiler's idle share over 50 iterations, which hold
    two fields-writer firings, a checkpoint and an averaged write."""
    from clima_oceananigans_jl_torch import Callback, WindowedTimeAverage
    from clima_oceananigans_jl_torch.output import checkpointer, writers
    model, state, dt = chip_smoke.wall_path_model("horizontal convection")
    iterations = 20 * steps
    with tempfile.TemporaryDirectory() as tmp:
        sim, _ = chip_smoke.simulation_path(model, state, dt, tmp)
        del state
        for _ in range(chip_smoke.SIMULATION["warmup"]):
            sim.time_step()
        torch.cuda.synchronize()
        events = collections.defaultdict(list)
        for key, name in (("wizard", "wizard"), ("nan_checker", "NaN checker")):
            cb = sim.callbacks[key]
            sim.callbacks[key] = Callback(timed(events, name, cb.func), cb.schedule)
        for key, item in list(sim.diagnostics.items()):
            if isinstance(item, WindowedTimeAverage):
                sim.diagnostics[key] = Callback(timed(events, "device average", item),
                                                item.schedule)
        copies = "writers' copies to the host"
        saved = (writers.to_numpy, checkpointer._flatten_state)
        writers.to_numpy = timed(events, copies, writers.to_numpy)
        checkpointer._flatten_state = timed(events, "checkpoint copies to the host",
                                            checkpointer._flatten_state)
        patches = [(model, "step", "model.step"),
                   (sim.output_writers["fields"], "write", "writers"),
                   (sim.output_writers["averages"], "write", "writers"),
                   (sim.output_writers["checkpointer"], "write", "checkpoint write")]
        inner = {"writers": ((copies,), "writers' file writes (less their copies)"),
                 "checkpoint write": (("checkpoint copies to the host",), None)}

        def step(s, timed_parts):
            sim.time_step()
            return sim.state

        try:
            breakdown(f"simulation path, {'x'.join(map(str, model.grid.shape))} fp32 "
                      f"horizontal convection, one iteration", step, None, events,
                      patches, iterations, inner, profile_steps=50)
        finally:
            writers.to_numpy, checkpointer._flatten_state = saved
        for w in sim.output_writers.values():
            if hasattr(w, "close"):
                w.close()


def internal_wave(steps):
    """chip_smoke.py's internal-wave path after its warm-up steps, broken
    down (the docstring's ``internal-wave``)."""
    from clima_oceananigans_jl_torch.examples import internal_wave as iw
    model = iw.build(chip_smoke.INTERNAL_WAVE["N"], "cuda")
    state = iw.initial_state(model)
    for _ in range(chip_smoke.INTERNAL_WAVE["warmup"]):
        state = model.step(state, iw.DT)
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    fill = nm.KERNELS["fill"]
    update_state = model.update_state
    model.update_state = lambda s, kernels=None: update_state(
        s, dict(kernels or {}, fill=timed(events, "update_state's K6 fills", fill)))
    kernels = {"advect": timed(events, "K2", nm.KERNELS["advect"]),
               "divergence": timed(events, "K3b", nm.KERNELS["divergence"]),
               "gradient": timed(events, "K3c", nm.KERNELS["gradient"])}
    copies = "copies and pads with their K6 fills"
    cross = "background cross terms (plain div_*)"
    patches = [(model, "tendencies", "tendencies"),
               (nm, "div_vu", cross), (nm, "div_vv", cross), (nm, "div_vw", cross),
               (nm, "rk3_substep", "rk3_substep"),
               (model, "project_velocities", "project_velocities"),
               (model, "_filled_velocity_copies", copies),
               (model, "_filled_pressure", copies),
               (model.pressure_solver, "solve", "pressure solve"),
               (model, "update_state", "update_state")]
    inner = {"tendencies": (("K2", cross), "the other eager terms (tendencies less K2 "
                                           "and the cross terms)"),
             "project_velocities": ((copies, "K3b", "pressure solve", "K3c"),
                                    "the correction (project_velocities less "
                                    "its other parts)"),
             "update_state": (("update_state's K6 fills",), None)}
    step = lambda s, timed_parts: model.step(s, iw.DT, kernels if timed_parts else None)
    size = "x".join(map(str, model.grid.shape))
    breakdown(f"internal wave {size} fp64 step", step, state, events, patches, steps, inner)


def weno5_kernels(steps):
    """K1 and K2's WENO5 forms at 256³ fp32 (the docstring's
    ``weno5-kernels``)."""
    n = chip_smoke.N
    model = chip_smoke.model_for(n, torch.float32)
    state = chip_smoke.random_state(model, 1)
    call = lambda: chip_smoke.fused_ab2_advance(model, state, 1e-4, False)
    print(f"weno5-kernels K1 bench {n}^3 fp32: {chip_smoke.cuda_ms(call, 20):.4f} ms "
          f"(CUDA events), {chip_smoke.device_ms(call, 20, 'fused_ab2_advance')} ms "
          f"(torch.profiler)")
    for z in ("regular", "stretched"):
        grid = (chip_smoke.surface_grid(stretched=True) if z == "stretched" else model.grid)
        gen = torch.Generator(device="cuda").manual_seed(2)
        f = [torch.randn(grid.total_shape, generator=gen, device="cuda") for _ in range(4)]
        args = (grid, chip_smoke.WENO5(), chip_smoke.WENO5(), *f[:3], {"b": f[3]})
        call = lambda: chip_smoke.fused_advective_tendencies(*args)
        print(f"weno5-kernels K2 WENO5/WENO5 {n}^3 fp32 {z} z: "
              f"{chip_smoke.cuda_ms(call, 20):.4f} ms (CUDA events), "
              f"{chip_smoke.device_ms(call, 20, 'fused_advective_tendencies')} ms "
              f"(torch.profiler)")
        del f, args
    del model, state
    torch.cuda.empty_cache()
    # K2's IM form (flags, the limiter) on the seamount path's fp64 fields
    model = chip_smoke.seamount_model()
    sol = chip_smoke.seamount_state(model)["solution"]
    args = (model.grid, model.advection, model.tracer_advection, sol["u"], sol["v"],
            sol["w"], {n: sol[n] for n in model.tracer_names})
    call = lambda: chip_smoke.fused_advective_tendencies(*args)
    print(f"weno5-kernels K2 seamount 4096x1x2048 fp64 (immersed, WENO5 / PositiveWENO5): "
          f"{chip_smoke.cuda_ms(call, 20):.4f} ms (CUDA events), "
          f"{chip_smoke.device_ms(call, 20, 'fused_advective_tendencies')} ms "
          f"(torch.profiler)")
    del model, sol, args
    torch.cuda.empty_cache()
    m = chip_smoke.N_SW
    grid = chip_smoke.RectilinearGrid(
        size=(m, m, 1), x=(0, 2 * math.pi), y=(0, 2 * math.pi),
        topology=(chip_smoke.PERIODIC, chip_smoke.PERIODIC, chip_smoke.FLAT),
        halo=(3, 3, 0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    rand = lambda s, o=0.0: o + s * torch.randn(grid.total_shape, generator=gen,
                                                device="cuda")
    args = (grid, chip_smoke.WENO5(), chip_smoke.WENO5(), 10.0, rand(0.1), rand(0.1),
            rand(0.05, 1.0), [], None)
    call = lambda: chip_smoke.fused_shallow_water_tendencies(*args)
    print(f"weno5-kernels K3a WENO5 {m}x{m} fp32: {chip_smoke.cuda_ms(call, 20):.4f} ms "
          f"(CUDA events), "
          f"{chip_smoke.device_ms(call, 20, 'fused_shallow_water_tendencies')} ms "
          f"(torch.profiler)")


def cubed_sphere(steps):
    """``chip_smoke.py``'s Galewsky C256 after 2 warm-up steps: the step's
    exchange, vmapped tendencies and RK3 update by CUDA events, then the
    idle share (``breakdown``)."""
    from clima_oceananigans_jl_torch.validation import eddying_aquaplanet as ea
    c = chip_smoke.GALEWSKY
    model = ea.model_for(c["N"], "cuda")
    state = ea.initial_state(model)
    dt = ea.grid_time_step(model.grid)
    model.cuda_graphs = False  # the parts of the eager step
    for _ in range(2):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    breakdown(f"Galewsky C256 (6 x {c['N']}^2 fp64, dt {dt:.3f} s), eager",
              lambda s, timed_parts: model.step(s, dt), state,
              collections.defaultdict(list),
              [(model, "exchange", "exchange"), (model, "tendencies", "vmapped tendencies"),
               (model, "rk3_update", "RK3 update")], steps)
    model.cuda_graphs = True
    state = model.step(state, dt)  # captures the graph
    torch.cuda.synchronize()
    breakdown("Galewsky C256, the step replayed from its CUDA graph",
              lambda s, timed_parts: model.step(s, dt), state,
              collections.defaultdict(list), [], steps)


def near_global_partial(steps):
    """chip_smoke.py's ``near-global partial cells`` path after its warm-up
    steps, broken down (module docstring)."""
    ng = chip_smoke.near_global_lat_lon
    c = chip_smoke.NEAR_GLOBAL_PARTIAL
    model = ng.model_for(c["deg"], torch.float32, "cuda", partial_cells=True)
    state = ng.initial_state(model)
    for _ in range(c["warmup"]):
        state = model.step(state, c["dt"])
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    kernels = {k: timed(events, label, hm.KERNELS[k]) for k, label in (
        ("tendencies", "K4b (3D-dz tendencies)"), ("columns", "K4a (3D dz)"),
        ("barotropic", "K5 and its wrapper"), ("fill", "K6 fills"),
        ("tridiagonal", "T1 (implicit step)"))}
    step = lambda s, timed_parts: model.step(s, c["dt"], kernels if timed_parts else None)
    patches = [(hm, "momentum_diffusion", "eager diffusion"),
               (hm, "tracer_diffusion", "eager diffusion"),
               (hm, "apply_flux_bcs", "flux BCs (wind)"),
               (hm, "apply_immersed_flux_bcs", "immersed flux BCs (drag)"),
               (hm, "ab2_substep", "ab2_substep"),
               (hm, "barotropic_mode", "barotropic modes"),
               (hm, "implicit_step_fields", "implicit step"),
               (SplitExplicitFreeSurface, "corrector", "corrector"),
               (model.immersed_boundary, "mask_state", "mask_state"),
               (model.immersed_boundary, "mask_tendency", "mask_tendency")]
    breakdown("near-global partial cells 1/4 deg step", step, state, events, patches,
              steps, inner={"implicit step": (["T1 (implicit step)"],
                                              "implicit step's bands and copies")})
    for _ in range(steps):
        state = model.step(state, c["dt"])
    chip_smoke.check_finite("near-global partial cells", model, state, ("w", "pHY", "eta"))


def k4b_parent(steps, parent):
    """K4b's run-time instantiation as built and from the parent tree's
    ``csrc``, in turns on three near-global paths' fields (module
    docstring)."""
    from clima_oceananigans_jl_torch.ops import fused_hydrostatic as fh
    libs = {}
    builds = {"as built": _build.CSRC / "fused_hydrostatic_tendencies.cu",
              "parent": Path(parent) / "fused_hydrostatic_tendencies.cu"}
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futures = {k: ex.submit(build_library, src) for k, src in builds.items()}
        for k, fut in futures.items():
            path, _log, secs = fut.result()
            print(f"k4b-parent build {k}: {secs:.1f} s")
            libs[k] = ctypes.CDLL(str(path))
    load = _build.load

    def call(lib, model, state):
        _build.load = lambda name: lib if name == "fused_hydrostatic_tendencies" else load(name)
        try:
            return fh.fused_hydrostatic_tendencies(model, state)
        finally:
            _build.load = load

    for path in ("near-global", "near-global UB5", "near-global CATKE"):
        if path == "near-global CATKE":
            model = chip_smoke.ocean_model("CATKE")
            state = chip_smoke.ocean_state(model)
        else:
            model, state = chip_smoke.hydro_path_model(path)
        for _ in range(chip_smoke.HYDRO["warmup"]):
            state = model.step(state, chip_smoke.HYDRO["dt"])
        ref = call(libs["as built"], model, state)
        times = collections.defaultdict(list)
        for k in ("as built", "parent", "parent", "as built"):
            got = call(libs[k], model, state)
            for n in ref:
                if not torch.equal(got[n], ref[n]):
                    raise AssertionError(f"k4b-parent {path}: {k} differs in {n}")
            times[k].append(chip_smoke.cuda_ms(lambda: call(libs[k], model, state), 20))
        mean = {k: sum(ts) / len(ts) for k, ts in times.items()}
        print(f"k4b-parent {path} 1/4 deg fp32 tendencies: " + ", ".join(
            f"{k} {' / '.join(f'{t:.4f}' for t in ts)} ms" for k, ts in times.items())
              + f"; as built / parent {mean['as built'] / mean['parent']:.4f} "
              f"(CUDA events, in turns; {chip_smoke.card_line()})")
        del model, state, ref, got
        torch.cuda.empty_cache()


#: kernels of the decomposed step by name (the profiler's CUDA records)
DIST_KERNELS = (("K2", ("fused_advective_tendencies_kernel",)),
                ("K3b/K3c", ("divergence_kernel", "pressure_gradient_kernel")),
                ("K6", ("fill_halos_kernel",)),
                ("pencil FFTs (cuFFT)", ("fft", "radix")))


def _recorded(calls, module, name, kind):
    """``module.name`` that also records, per shard, what each call is
    given (the shapes, types and arguments), for ``_replay``."""
    from clima_oceananigans_jl_torch.parallel.mesh import current
    fn = getattr(module, name)

    def run(first, *args, **kw):
        _, rank = current()
        shapes = ([(t.shape, t.dtype, t.device) for t in first] if kind == "exchange"
                  else (first.shape, first.dtype, first.device))
        calls[kind][rank].append((shapes, args, kw))
        return fn(first, *args, **kw)

    return fn, run


def _replay(mesh, calls, kind, fn):
    """A function that makes every shard's recorded calls of one kind again
    on fresh tensors of the recorded shapes, in one ``Mesh.run``."""
    def fresh(shapes):
        if kind == "exchange":
            return [torch.zeros(sh, dtype=dt, device=d) for sh, dt, d in shapes]
        sh, dt, d = shapes
        return torch.zeros(sh, dtype=dt, device=d)

    inputs = {r: [fresh(shapes) for shapes, _, _ in cs] for r, cs in calls[kind].items()}

    def body(r):
        for x, (_, args, kw) in zip(inputs[r], calls[kind][r]):
            fn(x, *args, **kw)

    return lambda: mesh.run(body)


def distributed(steps):
    """chip_smoke.py's ``distributed RK3`` path (the RK3 flagship at 256³
    fp32 decomposed on a (2, 2) mesh of four shards on the card) after 2
    warm-up steps, broken down by ``decomposed_step``."""
    from clima_oceananigans_jl_torch import DistributedModel, make_mesh
    timestepper, dt, _, _, kw = chip_smoke.PATHS["RK3"]
    model = chip_smoke.model_for(chip_smoke.N, torch.float32,
                                timestepper=timestepper, **kw)
    rng = np.random.default_rng(0)
    shape = model.grid.shape
    state = model.initial_state(u=1e-2 * rng.standard_normal(shape),
                                v=1e-2 * rng.standard_normal(shape),
                                b=1e-4 * rng.standard_normal(shape))
    mesh = make_mesh(chip_smoke.DISTRIBUTED["mesh"], [torch.device("cuda", 0)] * 4)
    dm = DistributedModel(model, mesh)
    states = dm.scatter_state(state)
    del state
    decomposed_step(f"distributed RK3 {chip_smoke.N}^3 fp32 on a (2, 2) mesh of 4 "
                    "shards on one card", dm, states, dt, DIST_KERNELS,
                    "the rest (eager terms, copies, RK3 substeps)", steps)


#: the decomposed near-global step's kernels by name
DIST_NEAR_GLOBAL_KERNELS = (("K4a", ("hydrostatic_columns_kernel",)),
                            ("K4b", ("fused_hydrostatic_tendencies_kernel",)),
                            ("K5 cut form", ("substep_uv_kernel", "substep_eta_kernel")),
                            ("K6", ("fill_halos_kernel",)),
                            ("T1", ("batched_tridiagonal_kernel",)))


def distributed_near_global(steps):
    """chip_smoke.py's ``distributed near-global`` path (the ¼° near-global
    ocean decomposed on a (2, 2) mesh of four shards on the card) after 2
    warm-up steps, broken down by ``decomposed_step``."""
    from clima_oceananigans_jl_torch import DistributedModel, make_mesh
    model, state = chip_smoke.hydro_path_model("near-global")
    mesh = make_mesh(chip_smoke.DIST_NEAR_GLOBAL["mesh"], [torch.device("cuda", 0)] * 4)
    dm = DistributedModel(model, mesh)
    states = dm.scatter_state(state)
    del state
    g = model.grid
    decomposed_step(f"distributed near-global 1/4 deg {g.Nx}x{g.Ny}x{g.Nz} fp32 on a "
                    "(2, 2) mesh of 4 shards on one card", dm, states,
                    chip_smoke.HYDRO["dt"], DIST_NEAR_GLOBAL_KERNELS,
                    "the rest (eager diffusion, masks, AB2 substep, barotropic modes, "
                    "corrector, copies)", steps)


def decomposed_step(label, dm, states, dt, kernels, rest, steps):
    """A decomposed step after 2 warm-up steps: the device time of one
    step's exchanges and transposes, recorded and made again on fresh
    tensors of the same shapes behind a spin of the card (``queued_ms``),
    so that the host's gaps do not count; then, over ``steps`` more steps,
    torch.profiler's device time of ``kernels`` ((part, name keys)) by
    name, the rest of the busy time (``rest``), and the device's idle share
    (1 − busy/elapsed on the host clock)."""
    from clima_oceananigans_jl_torch.parallel import distributed_fft, halo_exchange
    from torch.profiler import ProfilerActivity, profile
    mesh = dm.mesh
    for _ in range(2):
        states = dm.step(states, dt)
    torch.cuda.synchronize()
    # one step's collectives, recorded and made again behind a spin
    calls = {k: collections.defaultdict(list) for k in ("exchange", "all_to_all")}
    ex_fn, ex_rec = _recorded(calls, halo_exchange, "exchange_axis", "exchange")
    a2a_fn, a2a_rec = _recorded(calls, distributed_fft, "all_to_all", "all_to_all")
    halo_exchange.exchange_axis, distributed_fft.all_to_all = ex_rec, a2a_rec
    try:
        states = dm.step(states, dt)
        torch.cuda.synchronize()
    finally:
        halo_exchange.exchange_axis, distributed_fft.all_to_all = ex_fn, a2a_fn
    comm, n_calls = {}, {}
    for kind, name, fn in (("exchange", "exchange", ex_fn),
                           ("all_to_all", "transposes", a2a_fn)):
        if calls[kind][0]:
            comm[name] = queued_ms(_replay(mesh, calls, kind, fn), 2)
            n_calls[name] = len(calls[kind][0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            states = dm.step(states, dt)
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) * 1e3 / steps
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in cuda) / 1e3 / steps
    print(f"{label}, {steps} steps: {elapsed:.4f} ms/step elapsed (host clock), "
          f"{busy:.4f} ms/step in kernels (torch.profiler)")
    if busy <= 0:
        print("torch.profiler saw no device time: parts and idle share not measured")
        return
    parts = {}
    for name, keys in kernels:
        parts[name] = sum(e.self_device_time_total for e in cuda
                          if any(k in e.key.lower() for k in keys)) / 1e3 / steps
    parts.update(comm)
    parts[rest] = busy - sum(parts.values())
    for name, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        n = n_calls.get(name)
        each = f", {n} collectives a shard a step, queued" if n else ""
        print(f"  {name}: {ms:.4f} ms ({100 * ms / busy:.1f}% of busy{each})")
    print(f"  device idle {100 * (1 - busy / elapsed):.1f}% of the elapsed time; "
          f"{sum(e.count for e in cuda) / steps:.0f} kernels a step")
    top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        print(f"  {e.key[:60]}: {e.self_device_time_total / (steps * 1e3):.4f} ms/step, "
              f"{e.count / steps:.2f} calls/step")


def sass_k5(steps, parent):
    """K5's cooperative form (``fused_substep_eta_kernel``, every
    instantiation) as built here against the parent tree's (``--parent
    DIR``): the cut form's kernels beside it in the same source must leave
    its SASS as it was."""
    sass_regular(steps, parent, names=("fused_substep_eta",), every=True)


PARTS = {"ab2": lambda steps: nonhydrostatic("AB2", steps), "ab2-bf16": ab2_bf16,
         "rk3": lambda steps: nonhydrostatic("RK3", steps),
         "general-projection": general_projection, "k6-k3c": k6_k3c,
         "langmuir": lambda steps: surface("langmuir", steps),
         "wind-mixing": lambda steps: surface("wind mixing", steps),
         "hydrostatic": hydrostatic, "hydrostatic-wind": hydrostatic_wind,
         "shallow-water": shallow_water,
         "division": division, "k3a-division": k3a_division,
         "k4b-phases": k4b_phases, "k5-barriers": k5_barriers,
         "langmuir-amd": lambda steps: les("langmuir AMD", steps),
         "wind-mixing-stretched": lambda steps: les("wind mixing stretched", steps),
         "ab2-implicit": lambda steps: les("AB2 stretched implicit", steps),
         "t1": t1, "t1-variants": t1_variants,
         "near-global": lambda steps: near_global("near-global", steps),
         "near-global-weno": lambda steps: near_global("near-global WENO", steps),
         "diffusive": lambda steps: near_global("1/4 deg diffusive", steps),
         "near-global-catke": near_global_catke,
         "horizontal-convection": lambda steps: walls("horizontal convection", steps),
         "2d-turbulence": lambda steps: walls("2D turbulence", steps),
         "seamount": seamount, "simulation": simulation,
         "internal-wave": internal_wave, "weno5-kernels": weno5_kernels,
         "hydrostatic-positive": lambda steps: scheme_path("hydrostatic positive", steps),
         "near-global-ub5": lambda steps: scheme_path("near-global UB5", steps),
         "ptxas-schemes": ptxas_schemes, "sass-regular": sass_regular,
         "front-slice": front_slice, "gyre": gyre,
         "stretched-channel": stretched_channel, "k2xy": k2xy,
         "implicit-free-surface": implicit_free_surface,
         "multigrid-iterations": multigrid_iterations, "cubed-sphere": cubed_sphere,
         "near-global-partial": near_global_partial, "k4b-parent": k4b_parent,
         "distributed": distributed, "distributed-near-global": distributed_near_global,
         "sass-k5": sass_k5}


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this breakdown needs a GPU")
    steps, parent = 5, None
    if "--steps" in argv:
        i = argv.index("--steps")
        steps = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if "--parent" in argv:
        i = argv.index("--parent")
        parent = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    parts = argv or [p for p in PARTS
                     if p not in ("sass-regular", "sass-k5", "k2xy", "k4b-parent")
                     or parent]
    for p in parts:
        if p not in PARTS:
            raise SystemExit(f"unknown part {p!r}: choose from {list(PARTS)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for p in parts:
        if p == "division":
            division()
        elif p in ("sass-regular", "sass-k5"):
            if parent is None:
                raise SystemExit(f"{p} needs --parent DIR (the parent "
                                 "tree's clima_oceananigans_jl_torch/csrc)")
            PARTS[p](steps, parent)
        elif p == "k2xy":
            k2xy(steps, parent)
        elif p == "k4b-parent":
            if parent is None:
                raise SystemExit("k4b-parent needs --parent DIR (the parent tree's "
                                 "clima_oceananigans_jl_torch/csrc)")
            k4b_parent(steps, parent)
        else:
            PARTS[p](steps)


if __name__ == "__main__":
    main(sys.argv[1:])
