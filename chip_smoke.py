"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through ``clima_oceananigans_jl_torch``
on the card, in phases; each prints one line or a few:

1. device: the card's name and power limit as nvidia-smi gives them, on a
   line of their own; no card → error;
2. build: compiles ``csrc/fused_ab2_advance.cu`` (K1),
   ``csrc/fused_advective_tendencies.cu`` (K2),
   ``csrc/fused_advective_tendencies_xy.cu`` (K2's stretched-x/y form),
   ``csrc/fused_shallow_water_tendencies.cu`` (K3a),
   ``csrc/fused_projection.cu`` (K3b, K3c),
   ``csrc/hydrostatic_columns.cu`` (K4a),
   ``csrc/fused_hydrostatic_tendencies.cu`` (K4b),
   ``csrc/fused_substep_eta.cu`` (K5), ``csrc/fill_halos.cu`` (K6) and
   ``csrc/batched_tridiagonal.cu`` (T1) with nvcc (sm_90a), one process
   each, all at once;
3. K1 against its plain PyTorch version on the same inputs, bit for bit
   (max|Δ| = 0, or the phase raises), Euler and AB2 form, on every point of
   ψ′ and G: the ``bench.py`` configuration at 256³ fp32 and 64³ fp64;
   with its options, ``FPlane(f=1e-4)`` + ``ScalarDiffusivity(nu=1e-5,
   kappa=1e-5)`` at 256³ fp32 and ``BetaPlane`` + the same diffusivity at
   64³ fp64; the with-halo G layout (an imposed w value at the top wall,
   G's halos written as zeros), 16 fields, sizes off the kernel's 8×12×32
   tiles, all-zero and smooth fields (``K1_CASES``); K1's time on random
   fields at 256³ (CUDA events, 20 calls) and the plain version's (3
   calls);
4. K2 against its plain version bit for bit, on the interior, w's top wall
   face and the zero halos: 256³ fp32 WENO5/WENO5 with u, v, w, b, then
   fp64 with centred tracers, 16 fields, sizes off the tiles, all-zero
   and smooth fields (``K2_CASES``); times at 256³ on random fields;
5. K3a against its plain version, bit for bit (max|Δ| = 0, or the phase
   raises): 16384² fp32 uh, vh, h (the shallow-water headline), 1000×777
   fp32 (Bounded, Bounded) and 1024×768 fp64 (Periodic, Bounded), both
   with two tracers and bathymetry (sizes that are not multiples of the
   16×64 tile); times at 16384²;
6. K3b and K3c against their plain versions: 256³ fp32, 64³ fp64 and
   100×77×45 fp32 (off K3c's block of 4 columns); K3b within the bounds of
   phase 3, K3c bit for bit on the interior with every halo point exactly
   0, its outputs allocated over a cache of NaNs; times at 256³;
7. AB2 path: the ``bench.py`` configuration built through the public API,
   2 warm-up and 20 timed steps at Δt = 1e-4, with K1 and K6 and then with
   the plain versions; the model's fill route is K6; fields finite, one K1
   and two K6 launches per step (no other),
   max|∇·u|·Δx/max|u| ≤ 1e-5, and the two runs agree exactly; K1 held
   bit for bit and timed against its plain version on the path's fields
   after the kernel run, which go into K1's record;
8. RK3 path: the flagship configuration of ``__graft_entry__.py``
   (WENO5, BuoyancyTracer, FPlane(f=1e-4), ScalarDiffusivity(nu=1e-5,
   kappa=1e-5), RK3), 2 warm-up and 10 timed steps at Δt = 1e-3, with K2
   and K6 and then with their plain versions; the same checks, with
   exactly 3 K2 and 6 K6 launches per step (no other); K2's times on the
   path's fields go into its record;
9. shallow-water path: the headline of ``benchmark/bench_shallow_water.py``
   (16384² fp32, (Periodic, Periodic, Flat) on [0, 2π]², g = 10, WENO5,
   uh = 0.1 sin x cos y, h = 1, RK3 at Δt = 1e-4), 2 warm-up and 10 timed
   steps with K3a and then with its plain version; exactly 3 K3a launches
   per step (no other), fields finite, Σh (summed in fp64) conserved to
   ≤ 1e-6 relative, the runs agree to ≤ 1e-4 of max|field|; K3a's and
   its plain version's times on the path's fields (held bit for bit there
   too), which go into K3a's record;
10. general-projection path: the RK3 flagship at 256³ fp32 with
   ``FluxBC()`` at both z walls of w, 2 warm-up and 5 timed steps with the
   kernels and then the plain versions; exactly 3 K2, 3 K3b, 3 K3c and
   12 K6 launches per step (no other); the flux walls keep a net wall flux, so
   the check is max|∇·u − mean ∇·u|·Δx/max|u| ≤ 1e-5; the runs agree
   exactly;
11. K4a and K4b against their plain versions: the ¼° flagship
   (1440×600×24 lat-lon, stretched z, weno_velocity momentum, WENO5 T, S,
   b, spherical Coriolis) in fp32 on random fields, K4b in both forms,
   and 130×97×16 fp64 with flux-form WENO5 momentum, a β-plane and
   bounded x and y (not multiples of the 16×8 tile); K4b bit for bit on
   the interior, K4a (with b and w only) on every with-halo point (max|Δ|
   = 0, or the phase raises), its outputs allocated over a cache of NaNs;
   K4a's launch shape and registers; times at ¼° on random fields (K4b in
   its advance form);
12. K5 against its plain version: ¼° fp32 with 30 substeps and 128×96
   fp64 bounded x and y with 8, bit for bit on every with-halo point, its
   outputs allocated over a cache of NaNs; its cooperative grid (blocks,
   threads, blocks an SM) and registers; times at ¼°, one cooperative
   launch a call;
13. K6 against its plain version bit for bit on every with-halo point,
   from NaN on every point a fill writes, one launch a group: the ¼°
   flagship's u, v, T, S, b and η (the hydrostatic path's first fill of a
   step) and w and pHY′ in fp32, the 128×96×16 fp64 model's fields, the
   256³ fp32 nonhydrostatic groups (u, v, w, b; pNHS, with FluxBC w
   walls), 67×45×29 fp64 (Bounded, Periodic, Bounded) with every
   location under value, open and flux walls (sizes off K6's blocks), and
   67×45×29 fp64 and fp32 with a stretched z on (Bounded, Bounded,
   Bounded) and (Periodic, Bounded, Bounded), every location, with
   gradient BCs (scalar, plane and callable b), plane-array values and
   callable values on every side (``k6_value_fields``), and the langmuir
   path's 256³ groups (b's gradient wall: K6's side table); the first
   group's halo points, compulsory bytes and the 32-byte L2 sectors and
   64-byte DRAM blocks it reads and writes (what bounds it at the
   memory's granularity); times of the first group at ¼°, of both groups
   at 256³ and of the langmuir groups;
14. the forced hold: RK3 at 64³ fp32 on the examples' box with a sponge
   ``Relaxation(rate, GaussianMask(z), LinearTarget(N²z))`` on b, a
   ``Forcing`` with a field dependency on u and tilted gravity
   (``BuoyancyTracer(gravity_unit_vector=(sin 3°, 0, −cos 3°))``), 3 steps
   with K2 and K6 and 3 with their plain versions, every field, pHY′ and
   pNHS held bit for bit (max|Δ| = 0; a comparison, so its launches go
   into no record); then background fields of u and b, 3 steps with the
   kernels and 3 with the plain versions, held bit for bit and finite
   (the JAX package's branch, their cross terms as PyTorch ops, 3 K2 and
   6 K6 a step);
15. hydrostatic path: the ¼° flagship of
   ``benchmark/bench_hydro_flagship.py`` (split-explicit with 30
   substeps, Δt = 600 s, u = 0.1·N(0,1), b = 2e-5 (z+3000)/3000) built
   through the public API, 2 warm-up and 5 timed steps with K4a, K4b, K5
   and K6 and then with their plain versions; exactly 1 K4a, 1 K4b, 1 K5
   and 2 K6 launches per step (no other), fields finite, |Σ η·Az| ≤
   1e-5·Σ|η|·Az (fp64 sums), the runs agree exactly;
   K4b's and its plain version's times on the path's fields after the
   kernel run (K4b held bit for bit there), which go into K4b's record;
16. langmuir and wind mixing paths (``SURFACE``): the examples'
   surface-forced upper ocean at 256³ fp32 on their 64 m × 64 m × 32 m
   box, 2 warm-up and 5 timed RK3 steps with K2 and K6 and then with their
   plain versions; exactly 3 K2 and 6 K6 launches per step, fields
   finite, max|∇·u|·Δx/max|u| ≤ 1e-5, the wind drives the top layer's
   mean u positive (and the heat loss cools the wind-mixing top layer),
   the runs agree exactly;
17. hydrostatic wind path: the ¼° flagship under the near-global run's
   wind stress (the two-stage route: K4b's tendency form, the flux, the
   AB2 substep), 2 warm-up and 5 timed steps, exactly 1 K4a, 1 K4b, 1 K5
   and 2 K6 launches per step, the checks of the hydrostatic path, K4b's
   tendency form held bit for bit on the path's fields, the runs agree
   exactly;
18. K1 and K2 on the wind-mixing example's stretched z (``STRETCHED_CASES``:
   256³ fp32 with a vertically implicit closure, so K1's horizontal-only
   diffusion; 64³ fp64 with centred tracers; 100×77×45 fp32 with FluxBC w
   walls, so w's top wall face; 72×40×36 fp64 centred momentum; K1's
   general instantiation on a regular 64³ z), bit for bit over NaN-filled
   outputs against their plain versions, and their times at 256³;
19. T1 against its plain version bit for bit over NaN-filled outputs, in
   each of its forms (``t1_forms``): the Fourier-tridiagonal system of the
   256³ wind-mixing grid (129×256×256 complex64, the (0, 0) pin), the
   implicit step's solve on that grid (262×262×256 fp32, 1D and 3D bands)
   and on the ¼° grid (1446×606×24 fp32, 1D bands; 3D bands, CATKE's, at
   the halo of the near-global CATKE model), the implicit forms
   through views of with-halo fields whose halos must stay NaN; 67×45×29
   fp64 in the Fourier mode (with and without the pin); the implicit step
   at 256³ fp32 with a scalar κ (1D bands) and AMD's κ (3D bands) with
   Value and Gradient walls and on w; each form's time against its bound,
   and the whole implicit step's;
20. the uncut upper-ocean LES paths (``LES``) at 256³ fp32, 2 warm-up and
   5 timed steps each with the kernels and with their plain versions:
   ``langmuir AMD`` (the langmuir path with its own AMD; 3 K2 and 6 K6 a
   step), ``wind mixing stretched`` (the wind-mixing example on its own
   stretched z with its AMD and UpwindBiasedFifthOrder, uncut; 3 K2, 3 T1
   and 12 K6) and
   ``AB2 stretched implicit`` (the bench configuration on that z with a
   vertically implicit ScalarDiffusivity; 1 K1, 5 T1 and 4 K6); fields
   finite, max|∇·u|·Δx_min/max|u| ≤ 1e-5 (Δz per level), the wind drives
   the top layer (and cools it on wind mixing), the runs agree exactly;
21. (run right after phases 11 and 12) K4b's
   newer parts against its plain version, both forms, bit for bit on the
   interior over NaN-filled outputs, halos exactly 0 (``k4b_form_cases``):
   the in-kernel closure (¼° fp32 with the near-global closure; 128×96×16
   fp64 bounded β-plane with an explicit νz and a per-tracer κ), the
   solid masks (¼° fp32 under the near-global bottom, CENTER; 128×96×16
   fp64 with a ridge, flux-form WENO5: CENTER and U/V) and a stretched
   latitude (1440×600×24 fp32, 67×45×29 fp64 flux-form), the ¼° cases
   timed against their bounds; K5 on the near-global bottom's depth planes
   (¼° fp32, 30 substeps) bit for bit on every with-halo point, timed;
22. the near-global paths (``NEAR_GLOBAL``) at ¼° fp32, 2 warm-up and 5
   timed steps each with the kernels and with their plain versions:
   ``near-global`` (benchmark/bench_near_global.py as written: 1 K4a,
   1 K4b, 1 K5, 2 K6, 3 T1 a step), ``near-global WENO`` (1 K4a, 1 K4b,
   1 K5, 2 K6, 5 T1) and ``1/4 deg diffusive`` (K4b's advance with the
   in-kernel closure; 1 K4a, 1 K4b, 1 K5, 2 K6, 5 T1) and ``near-global
   CATKE`` (the ocean-physics configuration ``OCEAN``: the near-global run
   under (HorizontalScalarDiffusivity, CATKE) and TEOS-10 with T, S and e;
   1 K4a, 1 K4b on five fields, 1 K5, 2 K6, 5 T1 in the 3D-band form);
   fields finite, |Σ η·Az| ≤ 1e-5·Σ|η|·Az, u and v exactly 0 at every
   solid face (the validation's check), K4b held bit for bit and timed on
   the path's fields, the runs agree exactly; on ``near-global CATKE`` the
   top layer's mean e under the wind (|τx| > 1e-5) above the calm cells'
   and its ms/step and M points/s beside the card's name and power limit;
23. (since the walls-and-Flat slice) K2, K3b and K3c against their plain
   versions bit for bit over NaN-filled outputs on the Flat and bounded
   topologies (``FLAT_BOUNDED``: (P, F, B) 1000×1×333, (B, F, B)
   777×1×129, (P, P, F) 1024×1000×1, (F, F, B) 1×1×1000, (F, P, B)
   1×1000×333, (P, B, B) 100×77×45, (B, B, B) 67×45×29), fp32 and fp64:
   K2 with WENO5, UpwindBiasedFifthOrder and centred schemes on random
   and all-zero fields, on the interior and each bounded axis' velocity
   wall face (u's east, v's north, w's top), every other halo point 0;
   K3b on the interior, K3c on the interior with its halos 0; K1 (its
   general instantiation, Coriolis, diffusion, tracers, Euler and AB2) on
   (P, P, F) 1024×1000×1 and (F, P, B) 1×1000×333 with each scheme, its
   Flat-z case timed against its bound;
24. the walls-and-Flat paths (``WALLS``), 2 warm-up and 5 (3) timed steps
   with the kernels and with their plain versions: ``horizontal
   convection`` (examples/horizontal_convection.py at 4096×1×2048 fp32 on
   (Bounded, Flat, Bounded): Ra = 1e8, Pr = 1, the callable top ValueBC
   b = −cos(2πx/Lx), WENO5, RK3, ScalarDiffusivity(ν, κ), BuoyancyTracer;
   u, w, b ~ 1e-3·N(0,1) from a seeded torch.Generator; Δt from CFL 0.5 and
   half the explicit diffusive limit Δ²/(2dκ); 3 K2, 3 K3b, 3 K3c, 12 K6
   a step) and ``2D
   turbulence`` (examples/two_dimensional_turbulence.py at 8192²×1 fp32
   on (Periodic, Periodic, Flat): UpwindBiasedFifthOrder, RK3,
   ScalarDiffusivity(nu=1e-5), its band-limited streamfunction (k = 2–6,
   phases from a seeded numpy generator, max|u, v| = 0.5), Δt from CFL
   0.5; 3 K2, 3 K3b, 3 K3c, 9 K6 a step); fields finite, max|∇·u|·Δx/
   max|u| ≤ 1e-5, b within ±1.001 b* on horizontal convection (the
   example's maximum principle), the runs agree exactly; K2, K3b and K3c
   held bit for bit and timed on each path's fields, beside the card's
   name and power limit; K6 held bit for bit on each path's two fill
   groups from NaN on every point it writes (horizontal convection's b
   with its callable top value);
25. (since the seamount slice) K2 over an immersed bottom and with
   PositiveWENO5 tracers against its plain version bit for bit over
   NaN-filled outputs (``K2_IMMERSED_CASES``: (P, P, B) 256×256×128 fp32
   with WENO5 momentum and PositiveWENO5 b, c over tests/test_immersed.py's
   seamount scaled to the unit box; 100×77×45 fp64 with centred momentum
   and WENO5 tracers; (P, F, B) 1000×1×333 fp64 with PositiveWENO5; 100×77×45
   fp32 UB5 with a PositiveWENO5 tracer and no bottom), masked random
   velocities and tracers in [−0.1, 1.1], on the interior and w's top
   wall face, every other halo point 0, each timed against its bound (the
   clear flags' bytes and the limiter's operations counted);
26. the seamount path (``SEAMOUNT``): validation/seamount.py at
   4096×1×2048 fp64 through the public constructors ((Periodic, Flat,
   Bounded), WENO5, PositiveWENO5(bounds=(0, 1)) for b and c,
   BuoyancyTracer, ScalarDiffusivity(nu=1e-3, kappa=1e-4), quasi-AB2,
   GridFittedBottom of its Gaussian seamount, u = 0.1, b = 1e-5(z + 1000),
   its Gaussian c, Δt = min(60, 0.25 Lx/N)), 2 warm-up and 5 timed steps
   with the kernels (1 K2, 1 K3b, 1 K3c and 4 K6 a step: the general
   AB2 branch and the general projection, as the JAX package takes them
   over an immersed bottom) and then with their plain versions, which
   must agree exactly; fields finite, max|∇·u|·Δx/max|u| ≤ 1e-5 over the
   fluid cells none of whose faces is solid (printed over every fluid cell
   too: the masking after the parent grid's solve leaves divergence in
   the cells that touch a solid face, as in the JAX package), u, v and w
   exactly 0 at every solid face; K2, K3b and K3c held bit for bit and
   timed on the path's fields, K6 on its two fill groups from NaN; then
   200 more steps with the kernels and the validation's checks: Σc over
   the fluid conserved to 1e-3, max|c| in the solid ≤ 1e-10, c within
   [−1e-9, 1 + 1e-9];
27. (since the user-surface slice, run right after phase 24) the
   simulation path (``SIMULATION``): examples/horizontal_convection.py's
   loop, ``Simulation(model, state=..., dt=..., stop_iteration=...)``, on
   the horizontal-convection path's model and seeded state (4096×1×2048
   fp32) with the example's ``TimeStepWizard(cfl=0.7, max_change=1.2,
   max_dt=0.1)`` every 50 iterations and ``diffusive_cfl=0.125`` (its one
   cut: at this size the explicit diffusive limit binds, and the wizard
   keeps Δt at the path's), the automatic NaN checker, a classic NetCDF
   writer of b and w's top 64 levels every 25 iterations, a classic
   writer of b averaged (on the card) over the last half of every 50
   iterations' model time, and a ``Checkpointer`` every 50 iterations, in
   a temporary directory; 2 warm-up and 100 timed iterations (host clock,
   ended by a synchronize), exactly 3 K2, 3 K3b, 3 K3c and 12 K6 launches
   an iteration; each firing timed; fields finite, b within ±1.001 b*,
   max|∇·u|·Δx/max|u| ≤ 1e-5; the last b record read back with scipy
   equal to the state's interior then (max|Δ| = 0); ms/iteration printed
   with and without the firings beside the horizontal-convection path's
   bare ``model.step`` ms/step; then the device average of b held bit for
   bit against a ``WindowedTimeAverage`` of host copies of the same
   samples (numpy sums) in one writer, and two pickup holds, each a run A
   with a ``Checkpointer`` and a new ``Simulation`` B that picks up A's
   file and runs to A's end with a fixed Δt: horizontal convection (a
   checkpoint at 30, run to 40, ``pickup=True``) and the 256³ AB2 bench
   path (K1's fused branch, ``G_prev`` in K1's interior layout; a
   checkpoint at 10, run to 20): B's state equals A's, max|Δ| = 0 on
   every tensor (the solution, ``G_prev``, pNHS, pHY′) and the clock and
   ``previous_dt`` equal in the grid's dtype;
28. (since the schemes slice, after phase 26) the ``schemes`` hold: K1
   (the bench configuration, Euler and AB2) and K2 at 256³ fp32 with each
   of CenteredFourthOrder (C4), UpwindBiasedFirstOrder (UB1),
   UpwindBiasedThirdOrder (UB3) and BoundsPreservingWENO5 (BP) as the
   momentum and the tracer scheme; K2 on ``K2_SCHEME_CASES`` (WENO5
   momentum with UB3 tracers on (P, P, B) and (B, B, B), so two sets of
   near-wall bounds, K1 too on (P, P, B); BP on the wind-mixing stretched
   z; C4 / UB3 over the immersed seamount at 256×256×128); K3a at 16384²
   fp32 with one tracer and ``K3A_SCHEMES`` (UB3, C4, UB5, BP); each bit
   for bit over NaN-filled outputs and timed against its bound (the
   records' ``forms``, no launches of their own);
29. the internal-wave path (``INTERNAL_WAVE``): examples/internal_wave.py
   at 4096×1×4096 fp64 (32× its 128² on each axis; (Periodic, Flat,
   Periodic), C4, FPlane(0.2), ScalarDiffusivity(1e-6, 1e-6), RK3,
   BuoyancyTracer, the background buoyancy N²z, its wave packet and Δt =
   0.02·2π/ω): 2 steps with the kernels against 2 with the plain versions
   (max|Δ| = 0), then its 100 iterations through ``Simulation``, 2 warm-up
   and 98 timed, 3 K2, 3 K3b, 3 K3c and 12 K6 an iteration, and the
   example's two checks (energy drift < 3e-2, the centroid within 25% of
   c_g·t), max|∇·u|·Δx/max|u| ≤ 1e-5, K2/K3b/K3c held and timed on its
   fields, K6 on its fill groups;
30. the periodic-advection path (``PERIODIC_ADVECTION``):
   validation/periodic_advection.py as written, N = 128 fp64, its 7
   schemes × 2 profiles × 640 RK3 steps, each run's first 3 steps also
   with the plain versions (max|Δ| = 0), 3 K2, 3 K3b, 3 K3c and 9 K6 a
   step over the sweep, and the validation's eight assertions;
31. (since the ocean-physics slice) the closures hold (``CLOSURES_HOLD``):
   the ``OCEAN`` configuration at 1° (360×150×24 fp32) with CATKE replaced
   in turn by ConvectiveAdjustmentVerticalDiffusivity(convective_kappa_z=1,
   background_kappa_z=1e-5), RiBasedVerticalDiffusivity() and
   IsopycnalSkewSymmetricDiffusivity() beside a vertically implicit
   VerticalScalarDiffusivity(nu=1e-3, kappa=1e-4), and CATKE under
   RoquetIdealizedEquationOfState(); 3 steps with the kernels (1 K4a, 1
   K4b, 1 K5, 2 K6 and 4 or 5 T1 a step) and 3 with the plain versions,
   max|Δ| = 0 on every field, η and pHY′, finite;
32. the free-convection path (``FREE_CONVECTION``): the physics of
   validation/vertical_mixing_closures.py (H = 128 m, nz = 64, N² = 1e-5,
   ImplicitFreeSurface("pcg"), no advection) under each of its three
   closures on a (Periodic, Periodic, Bounded) 32×32×64 fp64 grid, 4
   steps of 60 s with the kernels (1 K4a, 1 K4b, 3 K6 and 3 or 4 T1 a
   step, K4b's regular layout with no advection, counted as the path's
   launches) against 4 with their plain versions, bit for bit (the
   script's column itself runs uncut as phase 39, which replaced the
   720 steps this path ran before);
33. the nonhydrostatic closures hold (``NONHYDROSTATIC_HOLD``): the wind
   mixing path's configuration at 128³ fp32 under TEOS10EquationOfState(),
   under RoquetIdealizedEquationOfState() and with CATKEVerticalDiffusivity()
   beside its ScalarDiffusivity (e = 1e-7 at the start), 3 RK3 steps with
   the kernels (3 K2 and 6 K6 a step; with CATKE 18 T1 too) and 3 with
   the plain versions, max|Δ| = 0, finite;
34. (since the hydrostatic schemes slice, after phase 22) the two ¼°
   paths of ``SCHEME_PATHS``, run as phase 22's: ``hydrostatic positive``
   (the flagship with PositiveWENO5() tracers, T = 2 + 18 exp(z/500) and
   S = 35 each plus 1e-2·N(0,1): K4b's fused advance with the limiter on
   the stretched-z tables; 1 K4a, 1 K4b, 1 K5, 2 K6 a step; min T, S and b
   after the steps printed, a reading and not a gate) and ``near-global
   UB5`` (the ``near-global WENO`` path with UpwindBiasedFifthOrder()
   flux-form momentum and BoundsPreservingWENO5() tracers: K4b's tendency
   form reading the U, V and CENTER clear flags; 1 K4a, 1 K4b, 1 K5, 2 K6,
   5 T1 a step); ms/step, points/s and launches a step beside the card's
   name and power limit, K4b held bit for bit and timed against its bound
   on each path's fields, the runs agree exactly;
35. (after phase 28) the hydrostatic schemes hold (``SCHEMES_HOLD``): K4b
   at 1° (360×150×24 fp32) with each of ``K4B_SCHEMES`` (UB5,
   PositiveWENO5, C4, UB1, UB3, BoundsPreservingWENO5) as flux-form
   momentum and tracer scheme, on the flagship's flat bottom and over the
   near-global bottom, fused advance and tendency form after 3 steps, and
   on stretched latitudes with PositiveWENO5 and BoundsPreservingWENO5 (the
   y tables), bit for bit over NaN-filled outputs with zero halos, the flat
   advance forms timed against their bounds; K1 and K2 at 256³ fp32 with
   PositiveWENO5 momentum and tracers, K2 with PositiveWENO5 tracers on the
   wind-mixing stretched z and K3a at 16384² fp32 with PositiveWENO5, each
   bit for bit and timed against its bound (the records' ``forms``);
36. (since the bf16 slice, in place of the refusals) the bf16 holds
   (``phase_bf16_holds``): the bf16 forms of K1, K2, K3a and K4b
   (WENO5, BoundsPreservingWENO5 and PositiveWENO5 under
   ``bf16_smoothness`` and ``fast_bf16``: K1 and K2 at 256³ fp32, both
   with fast_bf16 at 128³ fp64, K2 on the wind-mixing stretched z, K3a at
   16384² fp32 and 4096² fp64, K2 on (B, B, B) and over an immersed
   bottom and K1 on a Flat x (``BF16_WALLS``), K4b at 1° flat, over the
   near-global bottom, on stretched latitudes and in fp64, and the ¼°
   flagship's advance with bf16_smoothness tracers), each bit for bit over
   NaN-filled outputs and timed against its bound, each bf16 operation
   counted once at the card's bf16 rate (``transport_ops``);
37. the two paths of ``BF16_PATHS`` at 256³ fp32: ``AB2 bf16 smoothness``
   (bench.py with CLIMA_BF16S) and ``AB2 fast bf16``
   (benchmark/bench_bf16.py), 2 warm-up and 5 timed steps, 1 K1 and 2 K6 a
   step, finite, the AB2 divergence bound, K1 bit for bit and timed on the
   path's fields, within 5e-3 of each field's scale from the fp32 run
   after the same steps (its ms/step printed beside), and the plain run
   bit for bit;
38. (since the Flat slice, after phase 12) the Flat holds
   (``phase_flat_holds``): K4a (with b and w only), K4b (both forms, WENO5
   and vector-invariant momentum, a β-plane and the in-kernel closure)
   and K5 (8 substeps) on the five Flat topologies of ``FLAT_HYDRO``
   ((F,P,B) and (F,B,B) 1×256×32, (P,F,B) and (B,F,B) 256×1×32, (F,F,B)
   1×1×64), fp32 and fp64, and K4b with ``ConstantCartesianCoriolis`` and
   ``NonTraditionalBetaPlane`` on (P,B,B) 256×128×32 (``CARTESIAN``), each
   bit for bit over NaN-filled outputs, 3 model steps with the kernels
   against 3 with the plain versions exactly (fp64 Flat, both Cartesian),
   the fp32 forms timed against their bounds;
39. (after phase 33) ``column closures``: validation/vertical_mixing_closures.py
   as written through the port's copy, the (Flat, Flat, Bounded) 1×1×64
   fp64 column, 720 steps under each closure, 1 K4a, 1 K4b, 3 K6 and 3 or
   4 T1 a step (plus the initial state's K4a and two K6), the
   validation's assertions; ``wind mixing column``:
   validation/wind_mixing_column.py as written through the port's copy
   (1×1×48 fp64 stretched z, CATKE, its wind, 240 ``Simulation``
   iterations; 1 K4a, 1 K4b, 3 K6, 4 T1 an iteration), its final TKE
   profile, finite, e > 0 in the top five cells, the top layer's u along
   the wind; after each column's counts are read, ``COLUMN_HOLD_STEPS``
   model steps with the kernels against as many with the plain versions
   (K4a, K4b's tendency form, T1, K6), bit for bit, from a rebuilt model's
   initial state and from the run's end state; ``Stommel gyre 1024``:
   validation/barotropic_gyre.py's model through the port's copy at
   ``GYRE_TIMED``'s 1024² fp64 (its forcing callables, 3 K3a a step; 2
   warm-up and 5 timed steps, K3a against its plain version exactly, the
   forcing's share of a step; since the decomposed near-global path came
   the validation's own ~10⁴ steps at 64² are not run, and its scores and
   assertions are checked on the CPU on the analytic Stommel state,
   tests/test_torch_flat_hydrostatic.py::test_gyre_copy_checks_its_scores);
   ``front slice`` (``FRONT``:
   the baroclinic-adjustment physics on a (Flat, Bounded, Bounded)
   1×8192×128 fp32 y–z slice with a split-explicit free surface), 2
   warm-up and 5 timed steps with the kernels (1 K4a, 1 K4b in its fused
   advance with the in-kernel closure, 1 K5, 2 K6 a step) and then with
   the plain versions, bit for bit, finite, |Σ η·Az| ≤ 1e-5·Σ|η|·Az, K4b
   held and timed on the path's fields.

Since the stencil-matrix slice it ends (after phase 42) with

43. K2's stretched-x/y form against its plain version (``K2XY_CASES``): a
   stretched x, y, x and y, x and z, Periodic and Bounded x, a (Bounded,
   Flat, Bounded) grid, every scheme (WENO5, UB3, PositiveWENO5, C4, UB1,
   UB5, BoundsPreservingWENO5) and WENO5's two bf16 options, two immersed
   cases, one whose extents are off the 8×12 tiles with nz below one
   chunk, fp32 and fp64, random fields, bit for bit over NaN-filled
   outputs, each timed against its bound (the form's record's ``forms``);
44. ``stretched channel`` (``CHANNEL``): the JAX suite's fully stretched
   configuration at 256×256×128 fp64 with WENO5, a tracer and 2²⁰
   particles, 1 warm-up and 1 timed quasi-AB2 step with the kernels (1
   K2 in its stretched-x/y form and 3 K6 a step; the multigrid pressure
   solve and the projection's operators are PyTorch ops), checked (finite,
   max|∇·u|·Δx_min/max|u| ≤ 1e-5, every particle in the domain), the
   form held and timed on its fields (its record), then with the plain
   versions, every field and particle bit for bit;
45. ``implicit free surface``: validation/implicit_free_surface.py as
   written through the port's copy (N = 64, four methods, 50 steps each,
   its assertion; 1 K4a, 1 K4b, 3 K6 a step), then the ¼° flagship under
   ImplicitFreeSurface("matrix" and "multigrid", maxiter 50), 1 warm-up
   and 2 timed steps each with the kernels and then the plain versions,
   bit for bit, with the CG iterations a step;
46. the particle holds (``PARTICLES_HOLD``): 2¹⁶ particles in the
   shallow-water model at 1024² and in the ¼° flagship, 3 steps with the
   kernels against 3 with their plain versions, bit for bit;
47. the four cubed-sphere validations as written through the port's
   copies (``CUBED_SPHERE``: solid_body_rotation, rossby_haurwitz,
   cubed_sphere_gravity_waves, eddying_aquaplanet at N = 32 fp64, their own
   step counts and assertions; the cubed-sphere model launches no kernel
   of the port, checked);
48. ``biogeochemistry`` as written (the reacting column under the
   prescribed-velocity model, the sinking slice with
   ``fused_advection=False``; its eight checks);
49. ``Galewsky C256`` (``GALEWSKY``): eddying_aquaplanet's configuration at
   N = 256 fp64, its grid built on the host (seconds printed), 2 warm-up
   and 20 timed steps: ms/step by CUDA events, device launches a step and
   the idle share by torch.profiler, peak memory; finite fields and the
   script's mass gate 1e-9;
50. ``cubed sphere 3D C256x32`` (``CS3D``): the JAX suite's multilevel
   configuration at 256×256×32 fp32 (z ∈ [−4000, 0], Δt at CFL 0.5 of
   its free-surface wave: see ``CS3D``), its host geometry shared with
   phase 49's, the same reading;
   finite fields and |Σ η·Az| ≤ 1e-5·Σ|η|·Az;
51. ``ensemble columns`` (``ENSEMBLE``): the CATKE column as 32 members
   (N² from 1e-6 to 1e-5), 10 ensemble steps (1 K4a, 1 K4b, 3 K6, 4 T1 a
   member-step), members 0 and 31 held bit for bit against the same
   member stepped alone.
45. (since the partial-cell slice) ``phase_partial_holds``: K4a's and K4b's
   3D-Δz forms (partial bottom cells) at 1° (``PARTIAL_HOLD``: 360×150×24
   over validation/near_global_lat_lon.py's bathymetry with
   PartialCellBottom, fp32 and fp64; K4b under the default schemes, WENO5
   and UB5 / BoundsPreservingWENO5, both forms), each bit for bit its
   plain version over NaN-filled outputs and timed against its bound;
46. ``phase_near_global_partial``: ``near-global partial cells``
   (``NEAR_GLOBAL_PARTIAL``: the validation at ¼° fp32 as written but for
   PartialCellBottom, at the ¼° Δt of benchmark/bench_near_global.py,
   600 s): the count of cut cells and the smallest fraction, 2 + 5 timed
   steps (1 K4a, 1 K4b, 1 K5, 2 K6, 3 T1 a step), the profiler's idle
   share, K4a and K4b held and timed on the path's fields, 3 steps with
   the kernels against 3 with the plain versions from one state bit for
   bit, then the validation's 3 days (432 iterations) through
   ``Simulation`` with its three checks and the free surface's volume
   check;
47. (since the distributed slice) ``phase_distributed``: ``distributed
   RK3`` (``DISTRIBUTED``: the RK3 path's model at 256³ fp32 in
   ``DistributedModel`` over a (2, 2) mesh of four shards on cuda:0): 3
   steps held (the kernel run exactly its decomposed plain run, within
   ``pencil_tolerance`` (4096 fp32 eps) of the single-device run, the ∇·u
   gate), then 5 timed beside the single-device RK3 step of the same call;
   12 K2, 12 K3b, 12 K3c, 48 K6 a step; the exchange's and the
   transposes' collectives, copies and bytes a step;
48. ``phase_distributed_holds``: one step each, 64³ fp32 RK3 on meshes
   (4, 1), (1, 4) and (2, 4); a bounded global x (centred scheme); a stretched z (T1 per
   shard); overlap_halo against no overlap, bit for bit; a
   GridFittedBottom (AB2); shallow water at 1024² on (2, 4) (K3a per
   shard, exactly the single-device run); each kernel run exactly its
   decomposed plain run;
49. (since the decomposed-hydrostatic slice, between 47 and 48)
   ``phase_distributed_near_global``: ``distributed near-global``
   (``DIST_NEAR_GLOBAL``: benchmark/bench_near_global.py at ¼°, 1440×600×24
   fp32, built as the ``near-global`` path builds it, in DistributedModel
   over a (2, 2) mesh of four 720×300×24 shards on cuda:0); what the
   shards' K4b and K5 read confirmed (no near-wall bounds on a cut axis,
   the shards' own rows, flags and depth planes); 3 steps held (finite, u
   and v exactly 0 at solid faces, |Σ η·Az| ≤ 1e-5·Σ|η|·Az; bit for bit
   the decomposed plain run and the overlap_halo run; within
   ``pencil_tolerance`` of the single-device kernel run), then 5 timed
   beside the single-device near-global step and 2 under the profiler
   (idle share); K4a and K4b held on each shard's fields over NaN-filled
   outputs; per shard a step 1 K4a, 1 K4b, 60 K5 in its cut form, 63
   K6 (61 in the barotropic substeps), 3 T1; K5's cut form held bit for
   bit on the four shards against its plain version and timed on one
   (its record, ``fused_substep_eta_cut``); phase 48 then also holds the
   hydrostatic model decomposed: a (P, B, B) 32×32×8 split-explicit(10)
   box on (2, 2) and the JAX suite's near-global stack at 48×24×8 on (2,
   2) and (4, 1) in fp32 and fp64, and with WENO5 (the shards' clear
   flags), each bit for bit its plain decomposed run.

K2 builds as two libraries at once (``K2_SOURCES``: its first-code
instantiations and its ``ANY``/``BF`` ones, one kernel in
``csrc/fused_advective_tendencies.cuh``); its record names both in
``sources``. K2's stretched-x/y form and K5's cut form have records of
their own (``K2XY``, ``K5CUT``: their launches out of K2's and K5's).

Each kernel's record carries its bound: the larger of its compulsory
bytes (each input read once, each output written once, from this run's
tensors) over 3.35 TB/s and its operations (per-point counts of what the
function needs, ``FLOPS``) over the 67 TFLOP/s fp32 peak (WENO5's bf16
operations at twice that rate, ``transport_ops``); no single
PyTorch call computes any of these kernels' functions, so ``library_ms``
is null.

Each path's launch counts are set to 0 just before it and read just after;
each kernel's record counts its launches on every path that runs it
(printed by path). Then a JSON line with each kernel's record (K4b's and
K5's and T1's with ``forms``: the same keys for K4b's closure, masked and
stretched-latitude forms, for K5 over the near-global bottom and for T1's
five forms (with their shapes), with the launches of the path that runs
each; K1's, K2's, K3b's and K3c's with their Flat and bounded geometries
as ``forms``, timed on the walls-and-Flat and seamount paths' fields (K1
on its Flat z hold, which no path runs; K2's immersed and PositiveWENO5
holds with no launches of their own); T1's also by path, its Fourier-mode launches counted apart by
``fourier_tridiagonal.launches``), and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. The port is imported first, so a copy of this file
outside the repository fails at once.
"""
from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from clima_oceananigans_jl_torch import (BOUNDED, FLAT, PERIODIC,
                                         AnisotropicMinimumDissipation,
                                         AveragedTimeInterval, BetaPlane,
                                         Callback, Checkpointer,
                                         IterationInterval,
                                         NetCDFOutputWriter, Simulation,
                                         TimeStepWizard, WindowedTimeAverage,
                                         windowed,
                                         BackgroundField, BuoyancyTracer,
                                         CenteredSecondOrder, FieldBCs, FluxBC,
                                         ConstantCartesianCoriolis,
                                         NonTraditionalBetaPlane,
                                         Forcing, FPlane, GaussianMask,
                                         GradientBC, GridFittedBottom,
                                         HydrostaticFreeSurfaceModel,
                                         HydrostaticSphericalCoriolis,
                                         LatitudeLongitudeGrid,
                                         LinearEquationOfState, LinearTarget,
                                         NonhydrostaticModel, OpenBC,
                                         PartialCellBottom,
                                         PositiveWENO5, RectilinearGrid,
                                         Relaxation,
                                         ScalarDiffusivity, SeawaterBuoyancy,
                                         ShallowWaterModel,
                                         SplitExplicitFreeSurface,
                                         UniformStokesDrift,
                                         UpwindBiasedFifthOrder, ValueBC,
                                         VectorInvariant, WENO5,
                                         BoundsPreservingWENO5,
                                         CenteredFourthOrder,
                                         UpwindBiasedFirstOrder,
                                         UpwindBiasedThirdOrder,
                                         CATKEVerticalDiffusivity,
                                         ConvectiveAdjustmentVerticalDiffusivity,
                                         HorizontalScalarDiffusivity,
                                         ImplicitFreeSurface,
                                         IsopycnalSkewSymmetricDiffusivity,
                                         RiBasedVerticalDiffusivity,
                                         RoquetIdealizedEquationOfState,
                                         TEOS10EquationOfState,
                                         VerticalScalarDiffusivity)
from clima_oceananigans_jl_torch.examples import internal_wave
from clima_oceananigans_jl_torch.particles.lagrangian import LagrangianParticles
from clima_oceananigans_jl_torch.solvers.stencil_matrix import (MultigridPoissonSolver,
                                                                SOLVES)
from clima_oceananigans_jl_torch.validation import (barotropic_gyre,
                                                    biogeochemistry,
                                                    cubed_sphere_gravity_waves,
                                                    eddying_aquaplanet,
                                                    implicit_free_surface,
                                                    near_global_lat_lon,
                                                    periodic_advection,
                                                    rossby_haurwitz,
                                                    solid_body_rotation,
                                                    vertical_mixing_closures,
                                                    wind_mixing_column)
from clima_oceananigans_jl_torch.grids.cubed_sphere import CubedSphereGrid
from clima_oceananigans_jl_torch.models.cubed_sphere_hydrostatic import (
    CubedSphereHydrostaticModel)
from clima_oceananigans_jl_torch.models.ensemble import (ensemble_initial_state,
                                                         ensemble_step, member)
from clima_oceananigans_jl_torch.boundary_conditions.bcs import regularize_bcs
from clima_oceananigans_jl_torch.models import (hydrostatic, nonhydrostatic,
                                                shallow_water)
from clima_oceananigans_jl_torch.models.free_surface import (ETA_LOC,
                                                             column_depths,
                                                             fill2d)
from clima_oceananigans_jl_torch.ops import _build
from clima_oceananigans_jl_torch.ops.fused_barotropic import (
    cooperative_grid, cut_kernel_halves, cut_sequence, depth_inputs,
    fused_substep_eta, fused_substep_eta_reference,
    substep_eta_interior_reference, substep_uv_interior_reference)
from clima_oceananigans_jl_torch.ops.fused_fill import (
    MIRROR_C, MIRROR_F, WRAP, fill_plan, fused_fill_halos,
    fused_fill_halos_reference)
from clima_oceananigans_jl_torch.ops.fused_hydrostatic import (
    _mask_locs, kernel_y_rows,
    columns_config, fused_hydrostatic_tendencies,
    fused_hydrostatic_tendencies_reference, hydrostatic_columns,
    hydrostatic_columns_reference)
from clima_oceananigans_jl_torch.closures.implicit_vertical_diffusion import (
    implicit_vertical_diffusion_step)
from clima_oceananigans_jl_torch.ops.fused_step import (
    fused_ab2_advance, fused_ab2_advance_reference, general_route, w_top)
from clima_oceananigans_jl_torch.immersed.immersed import clear_flags
from clima_oceananigans_jl_torch.ops.metric_rows import dz3_pack, y_tables
from clima_oceananigans_jl_torch.parallel.decomposition import _windows, scatter_array
from clima_oceananigans_jl_torch.ops.fused_tendencies import (
    TABLE_SCHEMES, axis_bounds, bf16_mode, fused_advective_tendencies,
    fused_advective_tendencies_reference, k2_clear_flags, stretched_rows_arg,
    fused_divergence, fused_divergence_reference, fused_pressure_gradient,
    fused_pressure_gradient_reference, fused_shallow_water_tendencies,
    fused_shallow_water_tendencies_reference, K2_ANY_LIB)
from clima_oceananigans_jl_torch.solvers.fourier_tridiagonal import (
    FourierTridiagonalSolver)
from clima_oceananigans_jl_torch.solvers.tridiagonal import (
    fourier_tridiagonal, fourier_tridiagonal_reference,
    solve_batched_tridiagonal, solve_batched_tridiagonal_reference)
from clima_oceananigans_jl_torch.utils.location import (C, CENTER, U_LOC, V_LOC,
                                                        W_LOC)

N = 256
N_SW = 16384
DEVICE = "cuda"
K1, K2 = "fused_ab2_advance", "fused_advective_tendencies"
K3A, K3B, K3C = ("fused_shallow_water_tendencies", "fused_divergence",
                 "fused_pressure_gradient")
K4A, K4B, K5, K6 = ("hydrostatic_columns", "fused_hydrostatic_tendencies",
                    "fused_substep_eta", "fused_fill_halos")
T1 = "batched_tridiagonal"
#: K2's stretched-x/y form, whose launches K2's wrapper also counts apart
#: (``fused_advective_tendencies.stretched_launches``)
K2XY = "fused_advective_tendencies_stretched"
#: K5's cut form (a shard of a grid cut over a mesh: one launch a
#: half-substep between the fills), whose launches K5's wrapper also counts
#: apart (``fused_substep_eta.cut_launches``)
K5CUT = "fused_substep_eta_cut"
WRAPPERS = {K1: fused_ab2_advance, K2: fused_advective_tendencies,
            K3A: fused_shallow_water_tendencies, K3B: fused_divergence,
            K3C: fused_pressure_gradient, K4A: hydrostatic_columns,
            K4B: fused_hydrostatic_tendencies, K5: fused_substep_eta,
            K6: fused_fill_halos, T1: solve_batched_tridiagonal}
SOURCES = {K1: "fused_ab2_advance", K2: "fused_advective_tendencies",
           K2XY: "fused_advective_tendencies_xy",
           K3A: "fused_shallow_water_tendencies", K3B: "fused_projection",
           K3C: "fused_projection", K4A: "hydrostatic_columns",
           K4B: "fused_hydrostatic_tendencies", K5: "fused_substep_eta",
           K5CUT: "fused_substep_eta", K6: "fill_halos", T1: "batched_tridiagonal"}
REPLACES = {K1: "clima_oceananigans_jl_tpu/ops/fused_step.py:129",
            K2: "clima_oceananigans_jl_tpu/ops/fused_tendencies.py:397",
            K2XY: "clima_oceananigans_jl_tpu/ops/fused_tendencies.py:397",
            K3A: "clima_oceananigans_jl_tpu/ops/fused_tendencies.py:238",
            K3B: "clima_oceananigans_jl_tpu/ops/fused_tendencies.py:238",
            K3C: "clima_oceananigans_jl_tpu/ops/fused_tendencies.py:238",
            K4A: "clima_oceananigans_jl_tpu/ops/fused_hydrostatic.py:550",
            K4B: "clima_oceananigans_jl_tpu/ops/fused_hydrostatic.py:550",
            K5: "clima_oceananigans_jl_tpu/ops/fused_barotropic.py:102",
            K5CUT: "clima_oceananigans_jl_tpu/ops/fused_barotropic.py:102",
            K6: "clima_oceananigans_jl_tpu/ops/fused_fill.py:139",
            T1: "clima_oceananigans_jl_tpu/solvers/tridiagonal.py:25"}
#: operations per point that each kernel's function needs, each face flux
#: counted once, as the kernels compute it (a WENO5 reconstruction ~60
#: with its divisions, a transport ~64 with the velocity and metric
#: products): K1/K2 four fields × three transports (768) plus the
#: divergences (~32) and K1's −∂pHY′ and AB2 epilogue (~20); K3a four
#: transports and the pressure
#: terms; K4b two weno_velocity vorticity reconstructions and Coriolis
#: (~400), three tracers × three fluxes, the z one two-sided with the
#: tables (~850), and the divergences and AB2 epilogue (~50); K5 ~32 per
#: with-halo point per substep; K6 at most 2 (2b − x) per written halo
#: point; T1 ~8 per point and part (a multiply, a subtraction and a
#: division for the denominator and each of cp and dp, then the back
#: sweep's multiply and subtraction)
FLOPS = {K1: 820, K2: 800, K3A: 300, K3B: 12, K3C: 9, K4A: 25, K4B: 1300,
         K5: 32, K5CUT: 32, K6: 2, T1: 8}
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
FLAGSHIP = dict(coriolis=FPlane(f=1e-4),
                closure=ScalarDiffusivity(nu=1e-5, kappa=1e-5))
FLUX_WALLS = {"w": FieldBCs(bottom=FluxBC(), top=FluxBC())}
#: (timestepper, Δt, warm-up steps, timed steps, model options)
PATHS = {
    "AB2": ("QuasiAdamsBashforth2", 1e-4, 2, 20, {}),
    "RK3": ("RungeKutta3", 1e-3, 2, 10, FLAGSHIP),
    "general projection": ("RungeKutta3", 1e-3, 2, 5,
                           dict(FLAGSHIP, boundary_conditions=FLUX_WALLS)),
}
SW_PATH = (1e-4, 2, 10)  # shallow water: Δt, warm-up steps, timed steps
#: the surface-forced 256³ fp32 paths: (Δt, warm-up steps, timed steps).
#: Both run the examples' 64 m × 64 m × 32 m box at full width (256³),
#: RK3, WENO5, FPlane(1e-4), the examples' surface fluxes and initial
#: states (their noise from a seeded torch.Generator), with these cuts:
#: - "langmuir", examples/langmuir_turbulence.py (Wagner et al. 2021 §4):
#:   u top FluxBC(-3.72e-5), b top FluxBC(2.307e-8), b bottom
#:   GradientBC(1.936e-5), UniformStokesDrift (0.8 m, 60 m wave); AMD
#:   replaced by ScalarDiffusivity(nu=1e-5, kappa=1e-5), the RK3
#:   flagship's (AMD waits for ROADMAP Queue 1 item 4, closures); Δt = 1 s
#:   (the example's 20 s over a 16× finer grid);
#: - "wind mixing", examples/ocean_wind_mixing_and_convection.py:
#:   SeawaterBuoyancy(LinearEquationOfState(2e-4, 8e-4)) with T and S,
#:   u top FluxBC(Qu), T top FluxBC(QT), T bottom GradientBC(0.01), S top
#:   the discrete-form evaporation flux QS, its UpwindBiasedFifthOrder; a
#:   regular z instead of the stretched faces (the path "wind mixing
#:   stretched" runs them), AMD → the same ScalarDiffusivity; Δt = 0.5 s.
SURFACE = {"langmuir": (1.0, 2, 5), "wind mixing": (0.5, 2, 5)}
#: the uncut upper-ocean LES paths at 256³ fp32: (Δt, warm-up steps, timed
#: steps).
#: - "langmuir AMD": the "langmuir" path with its own
#:   AnisotropicMinimumDissipation() in place of the ScalarDiffusivity cut
#:   (no cut left);
#: - "wind mixing stretched": examples/ocean_wind_mixing_and_convection.py
#:   on its own stretched z faces (refinement 1.2, stretching 12, Lz = 32 m,
#:   l.31-38; Δz from 0.104 m at the top to 0.249 m at the bottom at
#:   Nz = 256) with its AMD closure and its UpwindBiasedFifthOrder: no cut
#:   left;
#: - "AB2 stretched implicit": the bench.py configuration (WENO5,
#:   BuoyancyTracer, quasi-AB2, random u, v, b) on the examples' 64 m box
#:   with that stretched z and ScalarDiffusivity(nu=1e-5, kappa=1e-5,
#:   time_discretization="vertically_implicit"): K1's general
#:   instantiation, the implicit step and the general projection.
LES = {"langmuir AMD": (1.0, 2, 5), "wind mixing stretched": (0.5, 2, 5),
       "AB2 stretched implicit": (0.5, 2, 5)}
IMPLICIT = dict(nu=1e-5, kappa=1e-5, time_discretization="vertically_implicit")
#: kernel launches per step of each path
PER_STEP = {"AB2": {K1: 1, K6: 2}, "RK3": {K2: 3, K6: 6},
            "shallow water": {K3A: 3},
            "general projection": {K2: 3, K3B: 3, K3C: 3, K6: 12},
            "hydrostatic": {K4A: 1, K4B: 1, K5: 1, K6: 2},
            "langmuir": {K2: 3, K6: 6}, "wind mixing": {K2: 3, K6: 6},
            "hydrostatic wind": {K4A: 1, K4B: 1, K5: 1, K6: 2},
            "forced": {K2: 3, K6: 6}, "background": {K2: 3, K6: 6},
            "langmuir AMD": {K2: 3, K6: 6},
            "wind mixing stretched": {K2: 3, T1: 3, K6: 12},
            "AB2 stretched implicit": {K1: 1, T1: 5, K6: 4},
            "near-global": {K4A: 1, K4B: 1, K5: 1, K6: 2, T1: 3},
            "near-global WENO": {K4A: 1, K4B: 1, K5: 1, K6: 2, T1: 5},
            "1/4 deg diffusive": {K4A: 1, K4B: 1, K5: 1, K6: 2, T1: 5},
            "horizontal convection": {K2: 3, K3B: 3, K3C: 3, K6: 12},
            "2D turbulence": {K2: 3, K3B: 3, K3C: 3, K6: 9},
            "seamount": {K2: 1, K3B: 1, K3C: 1, K6: 4},
            "simulation": {K2: 3, K3B: 3, K3C: 3, K6: 12},
            "internal wave": {K2: 3, K3B: 3, K3C: 3, K6: 12},
            "periodic advection": {K2: 3, K3B: 3, K3C: 3, K6: 9},
            "near-global CATKE": {K4A: 1, K4B: 1, K5: 1, K6: 2, T1: 5},
            "closures hold: convective adjustment": {K4A: 1, K4B: 1, K5: 1, K6: 2, T1: 4},
            "closures hold: Ri-based": {K4A: 1, K4B: 1, K5: 1, K6: 2, T1: 4},
            "closures hold: GM/Redi": {K4A: 1, K4B: 1, K5: 1, K6: 2, T1: 4},
            "closures hold: CATKE Roquet": {K4A: 1, K4B: 1, K5: 1, K6: 2, T1: 5},
            "nonhydrostatic closures hold: TEOS-10": {K2: 3, K6: 6},
            "nonhydrostatic closures hold: Roquet": {K2: 3, K6: 6},
            "nonhydrostatic closures hold: CATKE": {K2: 3, K6: 6, T1: 18},
            "hydrostatic positive": {K4A: 1, K4B: 1, K5: 1, K6: 2},
            "near-global UB5": {K4A: 1, K4B: 1, K5: 1, K6: 2, T1: 5},
            "AB2 bf16 smoothness": {K1: 1, K6: 2}, "AB2 fast bf16": {K1: 1, K6: 2},
            "column closures: CATKE": {K4A: 1, K4B: 1, K6: 3, T1: 4},
            "column closures: convective_adjustment": {K4A: 1, K4B: 1, K6: 3, T1: 3},
            "column closures: Ri_based": {K4A: 1, K4B: 1, K6: 3, T1: 3},
            "wind mixing column": {K4A: 1, K4B: 1, K6: 3, T1: 4},
            "Stommel gyre 1024": {K3A: 3},
            "front slice": {K4A: 1, K4B: 1, K5: 1, K6: 2},
            "free convection: CATKE": {K4A: 1, K4B: 1, K6: 3, T1: 4},
            "free convection: convective adjustment": {K4A: 1, K4B: 1, K6: 3, T1: 3},
            "free convection: Ri-based": {K4A: 1, K4B: 1, K6: 3, T1: 3},
            "stretched channel": {K2XY: 1, K6: 3},
            "implicit free surface validation": {K4A: 1, K4B: 1, K6: 3},
            "implicit free surface: matrix": {K4A: 1, K4B: 1, K6: 3},
            "implicit free surface: multigrid": {K4A: 1, K4B: 1, K6: 3},
            # the cubed-sphere slice: the cubed-sphere model and the
            # prescribed-velocity model are PyTorch ops (no kernel of either
            # package serves them); the ensemble steps the CATKE column's
            # members one by one
            "solid body rotation": {}, "Rossby-Haurwitz": {},
            "cubed sphere gravity waves": {}, "eddying aquaplanet": {},
            "biogeochemistry": {}, "Galewsky C256": {}, "cubed sphere 3D C256x32": {},
            "ensemble columns": {K4A: 1, K4B: 1, K6: 3, T1: 4},
            "near-global partial cells": {K4A: 1, K4B: 1, K5: 1, K6: 2, T1: 3}}
#: of T1's launches a step, those of its Fourier mode (the pressure solve)
T1_FOURIER_PER_STEP = {"wind mixing stretched": 3, "AB2 stretched implicit": 1}
T1F = "fourier_tridiagonal"
#: T1's forms (``t1_forms``) and the paths whose T1 launches take each:
#: "fourier" counts the path's Fourier-mode launches, "implicit" the rest
T1_FORM_PATHS = {"Fourier": {"wind mixing stretched": "fourier",
                             "AB2 stretched implicit": "fourier"},
                 "implicit 1D": {"AB2 stretched implicit": "implicit"},
                 "implicit 3D": {},
                 "1/4 deg implicit 1D": {"near-global": "implicit",
                                         "near-global WENO": "implicit",
                                         "1/4 deg diffusive": "implicit"},
                 "1/4 deg implicit 3D": {"near-global CATKE": "implicit"}}
#: how far the kernel and plain runs of a path may differ, of max|field|;
#: every kernel is bitwise its plain version, so a gap (such as an
#: unwritten wall face) is a fault, not rounding: the 256³ paths of K1 and
#: K2 and the ¼° hydrostatic paths are held to exact agreement
AGREE = {"AB2": 0.0, "RK3": 0.0, "shallow water": 1e-4,
         "general projection": 0.0, "hydrostatic": 0.0, "langmuir": 0.0,
         "wind mixing": 0.0, "hydrostatic wind": 0.0, "langmuir AMD": 0.0,
         "wind mixing stretched": 0.0, "AB2 stretched implicit": 0.0,
         "near-global": 0.0, "near-global WENO": 0.0, "1/4 deg diffusive": 0.0,
         "horizontal convection": 0.0, "2D turbulence": 0.0, "seamount": 0.0,
         "internal wave": 0.0, "near-global CATKE": 0.0, "hydrostatic positive": 0.0,
         "near-global UB5": 0.0, "AB2 bf16 smoothness": 0.0, "AB2 fast bf16": 0.0,
         "stretched channel": 0.0}
#: the ¼° hydrostatic flagship (benchmark/bench_hydro_flagship.py:24-41);
#: its "hydrostatic wind" path adds the near-global run's wind stress (u
#: top FluxBC((λ, φ, t) ↦ −1e-4 cos(3πφ/180)),
#: benchmark/bench_near_global.py:35-36) and so takes the two-stage route
#: (K4b's tendency form, the flux, the AB2 substep); the near-global run
#: itself, with its immersed bottom and closure, is ``NEAR_GLOBAL``'s
HYDRO = dict(size=(1440, 600, 24), dt=600.0, substeps=30, warmup=2, steps=5)
#: the near-global paths at ¼° fp32 (1440×600×24, full width and depth),
#: each run as HYDRO's paths are, with the near-global run's closure
#: ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
#: vertically implicit) (benchmark/bench_near_global.py:33-38):
#: - "near-global": benchmark/bench_near_global.py at deg = 0.25 as
#:   written: the default schemes (VectorInvariant, centred b), the
#:   GridFittedBottom of its sigmoid continent, its wind stress, b =
#:   2e-5 (z + 3000)/3000 and u = 0; the two-stage route (K4b's tendency
#:   form, no kernel closure over an immersed grid, no solid masks with
#:   these schemes), the eager diffusion with zeros at solid faces, T1 on
#:   u, v and b, K5 on depth planes;
#: - "near-global WENO": the same with the flagship's schemes and tracers
#:   (weno_velocity, WENO5 T, S and b): K4b's tendency form reading the
#:   CENTER clear flags, T1 on five fields;
#: - "1/4 deg diffusive": the flagship (its u = 0.1·N(0,1) and b) with
#:   that closure on a flat bottom, no wind: K4b's advance with the
#:   in-kernel closure (its horizontal part; the z part through T1).
#: - "near-global CATKE": the ocean-physics configuration at ¼° (``OCEAN``).
NEAR_GLOBAL = ("near-global", "near-global WENO", "1/4 deg diffusive",
               "near-global CATKE")
NEAR_GLOBAL_CLOSURE = dict(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
                           time_discretization="vertically_implicit")
#: whether each ¼° path steps through K4b's fused advance
FUSED_ADVANCE = {"hydrostatic": True, "hydrostatic wind": False, "near-global": False,
                 "near-global WENO": False, "1/4 deg diffusive": True,
                 "near-global CATKE": False, "hydrostatic positive": True,
                 "near-global UB5": False}
#: the schemes slice's ¼° paths (1440×600×24 fp32, full width and depth),
#: each run as HYDRO's paths are:
#: - "hydrostatic positive": the flagship (its u = 0.1·N(0,1) and b) with
#:   PositiveWENO5() tracers (bounds (0, ∞)) in place of WENO5, T = 2 +
#:   18 exp(z/500) and S = 35, each plus 1e-2·N(0,1) from a seeded
#:   torch.Generator, so that the limiter has work: K4b's fused advance
#:   (its ANY instantiation) with the limiter on the stretched-z tables.
#:   Its users: global runs whose salinity and biogeochemical tracers must
#:   stay non-negative;
#: - "near-global UB5": the "near-global WENO" path (bench_near_global.py at
#:   ¼°, its continent, wind and closure) with UpwindBiasedFifthOrder()
#:   flux-form momentum and BoundsPreservingWENO5() tracers: K4b's tendency
#:   form (ANY) reading the U, V and CENTER clear flags.
SCHEME_PATHS = ("hydrostatic positive", "near-global UB5")
#: the ocean-physics configuration, the near-global ocean as ClimaOcean
#: sets up its global runs (a prognostic-TKE boundary layer and TEOS-10):
#: benchmark/bench_near_global.py as written (its lat-lon grid and z faces,
#: SplitExplicitFreeSurface(substeps=30), HydrostaticSphericalCoriolis, the
#: GridFittedBottom of its sigmoid continent, its wind FluxBC on u, its
#: default schemes, Δt = 600 s) with
#: - the closure (HorizontalScalarDiffusivity(nu=1e4, kappa=1e3),
#:   CATKEVerticalDiffusivity(surface_momentum_flux=(τx, 0))), τx the same
#:   −1e-4 cos(3πφ/180) at the cell centres as a with-halo (x, y) plane;
#: - SeawaterBuoyancy(equation_of_state=TEOS10EquationOfState()), tracers
#:   T, S and CATKE's e;
#: - T = 2 + 18 exp(z/500) °C, S = 35 g/kg, e = 1e-7 m²/s² (the value of
#:   validation/wind_mixing_column.py:30), u = v = 0.
#: "near-global CATKE" runs it at ¼° (1440×600×24 fp32) as NEAR_GLOBAL's
#: paths run; the closures hold at 1° (``CLOSURES_HOLD``) replaces its
#: CATKE in turn
OCEAN = dict(nu=1e4, kappa=1e3, e=1e-7)
#: the closures hold: (360×150×24 fp32, steps with the kernels and with the
#: plain versions) and the closures that stand in for CATKE ("CATKE Roquet"
#: keeps CATKE under RoquetIdealizedEquationOfState())
CLOSURES_HOLD = dict(size=(360, 150, 24), steps=3,
                     kinds=("convective adjustment", "Ri-based", "GM/Redi",
                            "CATKE Roquet"))
#: validation/vertical_mixing_closures.py (l.31-86)'s physics, a resting
#: column with N² = 1e-5 cooled at B₀ = 1e-7 under each closure, H = 128 m,
#: nz = 64, fp64, ImplicitFreeSurface("pcg"), no advection, on a
#: horizontally periodic 32×32×64 grid: the free-convection path (K4b's
#: regular layout with no advection), 4 steps. Its 720 steps stood in for
#: the script's (Flat, Flat, Bounded) column until K4 took Flat axes; the
#: column runs uncut as the "column closures" path
FREE_CONVECTION = dict(size=(32, 32, 64), H=128.0, N2=1e-5, B0=1e-7, dt=60.0,
                       kinds=("CATKE", "convective adjustment", "Ri-based"))
#: the nonhydrostatic closures hold: the wind-mixing path's configuration
#: at 128³ fp32 under TEOS-10, under Roquet, and with CATKE beside its
#: ScalarDiffusivity; 3 RK3 steps with the kernels and 3 with the plain
#: versions
NONHYDROSTATIC_HOLD = dict(n=128, steps=3, kinds=("TEOS-10", "Roquet", "CATKE"))


def model_for(n, dtype, **kw):
    """The nonhydrostatic WENO5 model on the card with n³ cells, or with
    ``n`` = (nx, ny, nz) cells."""
    size = n if isinstance(n, tuple) else (n, n, n)
    grid = RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED),
                           dtype=dtype, device=DEVICE)
    return NonhydrostaticModel(grid, advection=WENO5(),
                               buoyancy=BuoyancyTracer(), **kw)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms, by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, kernel):
    """Mean device time in ms of the CUDA kernels whose names hold
    ``kernel``, per call of ``fn``, by torch.profiler over ``reps`` calls
    after one warm-up: the kernel alone, without the host time between
    launches that ``cuda_ms`` counts when the host is slower than the card.
    None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if kernel in e.key and e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps if us else None


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")


#: K2's sources: the first codes (``SOURCES[K2]``) and the ANY/BF
#: instantiations, two libraries built at once
K2_SOURCES = (SOURCES[K2], K2_ANY_LIB)


def phase_build():
    t0 = time.perf_counter()
    libs = sorted(set(SOURCES.values()) | set(K2_SOURCES))
    _build.build(*libs)
    for k in libs:
        print(f"build: {k} in {_build.build_seconds[k]:.1f} s "
              f"({_build.library_path(k).name})")
    print(f"build: all {len(libs)} at once in {time.perf_counter() - t0:.1f} s")


def hold(label, got, ref, dtype, interior=None, exact=False):
    """max|Δ| of each pair of dicts of tensors against its bound (with
    ``exact``, bit for bit); raises on the first one over it. Returns the
    largest max|Δ|."""
    tol = 0.0 if exact else TOL[dtype]
    worst, rel, bitwise = 0.0, 0.0, True
    for kind in got:
        for name, r in ref[kind].items():
            g = got[kind][name]
            if interior is not None:
                g, r = interior(g), interior(r)
            err = float((g - r).abs().max())
            scale = float(r.abs().max())
            if not err <= tol * scale or (exact and not torch.equal(g, r)):
                raise AssertionError(f"{label} {kind}[{name}]: max|diff| "
                                     f"{err:.3e} > {tol * scale:.3e}"
                                     + (" (held bit for bit)" if exact else ""))
            worst = max(worst, err)
            rel = max(rel, err / scale if scale else 0.0)
            bitwise &= torch.equal(g, r)
    print(f"{label}: max|diff| {worst:.3e}, {rel:.3e} of max|ref| (bound "
          f"{'0, bit for bit' if exact else f'{tol:g}'}), bitwise={bitwise}")
    return worst


def poison_cache(shape, dtype, n=8):
    """Leave n NaN-filled blocks of ``shape`` in the caching allocator, so
    that an output point a kernel does not write stays NaN (and fails a
    bit-for-bit hold)."""
    blocks = [torch.full(shape, float("nan"), dtype=dtype, device=DEVICE)
              for _ in range(n)]
    del blocks


def tensor_bytes(*groups):
    """Bytes held by the tensors of the given groups."""
    return sum(t.numel() * t.element_size() for group in groups for t in group)


def bound(name, nbytes, points, flops=None):
    """(bound_ms, bound_by): the least time the card could take for a call
    of kernel ``name`` moving ``nbytes`` compulsory bytes and computing
    ``points`` points at ``FLOPS[name]`` (or ``flops``) operations each,
    the larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s (fp32)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops or FLOPS[name]) * points / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wave(shape, kind):
    """a → a numpy field of ``shape`` of phase a: all zero (``kind``
    "zero") or smooth with amplitude ~1e-6 ("smooth"), where WENO5's
    weights fall to ~1e-24 and division meets its slow operands."""
    x, y, z = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    amp = 0.0 if kind == "zero" else 1e-6
    return lambda a: amp * np.sin(0.3 * x + a) * np.cos(0.2 * y + a) * (1.0 + 0.01 * z)


def random_state(model, seed, kind="random"):
    """A state of ``model`` on the card with G_prev in its layout:
    numpy-seeded random fields, or ``wave`` fields of ``kind``."""
    rng = np.random.default_rng(seed)
    shape = model.grid.shape
    if kind == "random":
        rand = lambda s: s * rng.standard_normal(shape)
        state = model.initial_state(u=rand(1e-2), v=rand(1e-2), w=rand(1e-3),
                                    **{n: rand(1e-4 if n == "b" else 1.0)
                                       for n in model.tracer_names})
    else:
        field = wave(shape, kind)
        state = model.initial_state(**{n: field(a) for a, n in
                                       enumerate(model.prognostic_names())})
    g_shape = shape if model.g_interior else model.grid.total_shape
    state["G_prev"] = {
        k: torch.as_tensor(1e-2 * rng.standard_normal(g_shape),
                           dtype=model.grid.dtype, device=DEVICE)
        for k in model.prognostic_names()}
    return state


def hold_k1(label, model, state, dt=1e-4):
    """K1 against its plain version bit for bit, Euler and AB2 form, on
    every point of psi' and G (in the with-halo layout G's halos, which
    the kernel writes as zeros); returns the AB2 form's outputs and the
    largest max|Δ| of both forms."""
    worst = 0.0
    for euler in (True, False):
        psi_k, g_k = fused_ab2_advance(model, state, dt, euler)
        psi_r, g_r = fused_ab2_advance_reference(model, state, dt, euler)
        worst = max(worst, hold(f"{label} {'euler' if euler else 'ab2'}"
                                + ("" if model.g_interior else ", G with halos"),
                                {"psi'": psi_k, "G": g_k}, {"psi'": psi_r, "G": g_r},
                                model.grid.dtype, exact=True))
    return psi_k, g_k, worst


#: K1's cases beyond the bench configuration: (size, dtype, name, model
#: options, fields): its options, the with-halo G layout (an imposed w
#: value at the top wall), sizes off the kernel's 8×12×32 tiles, 16 fields,
#: and all-zero and smooth fields
K1_CASES = (
    ((64, 64, 64), torch.float64, "bench", "none", "random"),
    ((N, N, N), torch.float32, "fplane+diffusion", "fplane", "random"),
    ((64, 64, 64), torch.float64, "betaplane+diffusion", "beta", "random"),
    ((100, 77, 45), torch.float32, "bench, with-halo G", "w_top", "random"),
    ((100, 77, 45), torch.float32, "fplane+diffusion, 16 fields", "sixteen", "random"),
    ((72, 40, 36), torch.float64, "betaplane+diffusion, 16 fields", "beta16", "smooth"),
    ((64, 64, 64), torch.float32, "fplane+diffusion", "fplane", "zero"),
    ((64, 64, 64), torch.float32, "bench", "none", "smooth"),
)


def k1_options(name):
    diffusivity = ScalarDiffusivity(nu=1e-5, kappa=1e-5)
    sixteen = dict(tracers=tuple(f"c{i}" for i in range(12)))
    return {"none": {},
            "fplane": dict(coriolis=FPlane(f=1e-4), closure=diffusivity),
            "beta": dict(coriolis=BetaPlane(f0=1e-4, beta=1e-2),
                         closure=diffusivity),
            "w_top": dict(boundary_conditions={
                "w": FieldBCs(top=ValueBC(1e-3))}),
            "sixteen": dict(coriolis=FPlane(f=1e-4), closure=diffusivity,
                            **sixteen),
            "beta16": dict(coriolis=BetaPlane(f0=1e-4, beta=1e-2),
                           closure=diffusivity, **sixteen)}[name]


def phase_k1():
    """K1 against its plain version bit for bit; returns (max_abs_err over
    every case, ms, plain_ms, bound_ms, bound_by), the times those of the
    bench configuration at 256³ fp32 on random fields."""
    model = model_for(N, torch.float32)
    if not model.fused_step or not model.g_interior:
        raise AssertionError("K1 bench: the model does not take K1")
    state = random_state(model, 1)
    psi_k, g_k, worst = hold_k1(f"K1 bench {N}^3 fp32", model, state)
    ms = cuda_ms(lambda: fused_ab2_advance(model, state, 1e-4, False), 20)
    plain_ms = cuda_ms(lambda: fused_ab2_advance_reference(
        model, state, 1e-4, False), 3)
    nb = tensor_bytes(state["solution"].values(), state["G_prev"].values(),
                      [state["pHY"]], psi_k.values(), g_k.values())
    k1_bound = bound(K1, nb, N ** 3)
    print(f"K1 bench {N}^3 fp32 ab2 time on random fields: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (CUDA events)")
    del model, state, psi_k, g_k
    torch.cuda.empty_cache()
    for size, dtype, name, options, kind in K1_CASES:
        model = model_for(size, dtype, **k1_options(options))
        if not model.fused_step or model.g_interior != (options != "w_top"):
            raise AssertionError(f"K1 {name}: the model does not take K1")
        state = random_state(model, 1, kind)
        worst = max(worst, hold_k1(
            f"K1 {name} {'x'.join(map(str, size))} {str(dtype)[6:]} {kind}",
            model, state)[2])
        if options == "fplane" and kind == "random":
            opt_ms = cuda_ms(lambda: fused_ab2_advance(model, state, 1e-4, False), 20)
            opt_plain_ms = cuda_ms(lambda: fused_ab2_advance_reference(
                model, state, 1e-4, False), 3)
            print(f"K1 {name} {N}^3 fp32 ab2 time: kernel {opt_ms:.4f} ms, plain "
                  f"{opt_plain_ms:.4f} ms (CUDA events)")
        del model, state
        torch.cuda.empty_cache()
    return worst, ms, plain_ms, *k1_bound


def wall_faces(grid):
    """(velocity, axis) of each bounded axis: the velocity whose far wall
    face (with-halo index h + n) K2 writes there."""
    return [(name, a) for a, name in enumerate("uvw")
            if grid.topology[a] is BOUNDED]


def wall_face(grid, axis, a):
    """The wall face of ``a`` along bounded ``axis``: with-halo index
    h + n over the interior of the other axes."""
    sl = list(grid.interior_slices)
    sl[axis] = grid.halo[axis] + grid.shape[axis]
    return a[tuple(sl)]


def hold_k2(label, args, dtype):
    """K2 against its plain version bit for bit on the interior of every
    field and on each bounded axis' velocity wall face (u's east, v's
    north, w's top: with-halo index h + n), which K2 also writes, and its
    other halo points zero; returns the largest max|Δ|."""
    grid = args[0]
    got = fused_advective_tendencies(*args)
    ref = fused_advective_tendencies_reference(*args)
    worst = hold(label, {"G": got}, {"G": ref}, dtype, grid.interior, exact=True)
    for name, axis in wall_faces(grid):
        worst = max(worst, hold(
            f"{label}, {name}'s wall face", {"G": {name: wall_face(grid, axis, got[name])}},
            {"G": {name: wall_face(grid, axis, ref[name])}}, dtype, exact=True))
    for name, g in got.items():
        rest = g.clone()
        rest[grid.interior_slices] = 0
        for face, axis in wall_faces(grid):
            if face == name:
                wall_face(grid, axis, rest).zero_()
        if rest.isnan().any() or rest.any():
            raise AssertionError(f"{label} {name}: a halo point is not zero")
    return worst


#: K2's cases beyond 256³ fp32: (size, dtype, momentum, tracer scheme,
#: tracers, fields): sizes off the 8×12×32 tiles, 16 fields, fp64 chunks,
#: all-zero and smooth fields
K2_CASES = (
    ((64, 64, 64), torch.float64, WENO5, CenteredSecondOrder, 2, "random"),
    ((100, 77, 45), torch.float32, WENO5, WENO5, 13, "random"),
    ((72, 40, 36), torch.float64, CenteredSecondOrder, WENO5, 13, "smooth"),
    ((64, 64, 64), torch.float32, WENO5, WENO5, 1, "zero"),
    ((100, 77, 45), torch.float32, WENO5, WENO5, 1, "smooth"),
)


def k2_args(grid, momentum, tracer_scheme, ntracers, kind, seed=3):
    """K2's arguments on ``grid`` with fields of ``kind`` (as random_state)."""
    rng = np.random.default_rng(seed)
    shape = grid.total_shape
    field = ((lambda a: rng.standard_normal(shape)) if kind == "random"
             else wave(shape, kind))
    f = [torch.as_tensor(field(a), dtype=grid.dtype, device=DEVICE)
         for a in range(3 + ntracers)]
    return (grid, momentum(), tracer_scheme(), f[0], f[1], f[2],
            {f"c{i}": c for i, c in enumerate(f[3:])})


def phase_k2():
    """K2 against its plain version bit for bit; returns (max_abs_err over
    every case, ms, plain_ms, bound_ms, bound_by), the times at 256³ fp32
    on random fields."""
    model = model_for(N, torch.float32)
    sol = random_state(model, 2)["solution"]
    grid = model.grid
    args = (grid, WENO5(), WENO5(), sol["u"], sol["v"], sol["w"],
            {"b": sol["b"]})
    worst = hold_k2(f"K2 WENO5/WENO5 {N}^3 fp32", args, torch.float32)
    ms = cuda_ms(lambda: fused_advective_tendencies(*args), 20)
    plain_ms = cuda_ms(lambda: fused_advective_tendencies_reference(*args), 3)
    print(f"K2 WENO5/WENO5 {N}^3 fp32 time on random fields: kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms (CUDA events)")
    # four with-halo fields in, four with-halo tendencies out
    k2_bound = bound(K2, 2 * tensor_bytes(args[3:6], [sol["b"]]), N ** 3)
    del model, sol, args
    torch.cuda.empty_cache()
    for size, dtype, momentum, tracer_scheme, nt, kind in K2_CASES:
        grid = RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                               topology=(PERIODIC, PERIODIC, BOUNDED),
                               dtype=dtype, device=DEVICE)
        worst = max(worst, hold_k2(
            f"K2 {momentum.__name__}/{tracer_scheme.__name__} "
            f"{'x'.join(map(str, size))} {str(dtype)[6:]}, {3 + nt} fields, "
            f"{kind}", k2_args(grid, momentum, tracer_scheme, nt, kind), dtype))
        torch.cuda.empty_cache()
    return worst, ms, plain_ms, *k2_bound


def phase_k3a():
    """K3a against its plain version; returns (max_abs_err over both
    cases, ms, plain_ms, bound_ms, bound_by), the times at 16384² fp32
    (uh, vh, h: the shallow-water headline's core)."""
    worst, ms = 0.0, None
    for n, dtype, topo, nt, bath in (
            ((N_SW, N_SW), torch.float32, (PERIODIC, PERIODIC), 0, False),
            ((1000, 777), torch.float32, (BOUNDED, BOUNDED), 2, True),
            ((1024, 768), torch.float64, (PERIODIC, BOUNDED), 2, True)):
        grid = RectilinearGrid(size=n + (1,), x=(0, 2 * math.pi),
                               y=(0, 2 * math.pi),
                               topology=topo + (FLAT,), halo=(3, 3, 0),
                               dtype=dtype, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(4)
        rand = lambda s, o=0.0: o + s * torch.randn(
            grid.total_shape, generator=gen, dtype=dtype, device=DEVICE)
        args = (grid, WENO5(), WENO5(), 10.0, rand(0.1), rand(0.1),
                rand(0.05, 1.0), [rand(1.0) for _ in range(nt)],
                rand(0.05) if bath else None)
        bounded = "".join(a for a, t in zip("xy", topo) if t is BOUNDED)
        label = (f"K3a {n[0]}x{n[1]} {str(dtype)[6:]}"
                 + (f", {nt} tracers, bathymetry, bounded {' and '.join(bounded)}"
                    if nt else ""))
        names = ["uh", "vh", "h"] + [f"c{i}" for i in range(nt)]
        got = dict(zip(names, fused_shallow_water_tendencies(*args)))
        ref = dict(zip(names, fused_shallow_water_tendencies_reference(*args)))
        worst = max(worst, hold(label, {"G": got}, {"G": ref}, dtype,
                                grid.interior, exact=True))
        del got, ref
        if ms is None:
            ms = cuda_ms(lambda: fused_shallow_water_tendencies(*args), 20)
            plain_ms = cuda_ms(
                lambda: fused_shallow_water_tendencies_reference(*args), 3)
            print(f"{label} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  "(CUDA events)")
            k3a_bound = bound(K3A, 2 * tensor_bytes(args[4:7]), n[0] * n[1])
        del args
        torch.cuda.empty_cache()
    return worst, ms, plain_ms, *k3a_bound


def hold_k3c(label, grid, p):
    """K3c against its plain version, its outputs allocated over a cache of
    NaNs: the interior bit for bit and every halo point exactly 0; returns
    the largest max|Δ| (of the interiors)."""
    poison_cache(grid.total_shape, grid.dtype)
    got = fused_pressure_gradient(grid, p)
    err = hold(label, {"out": dict(enumerate(got))},
               {"out": dict(enumerate(fused_pressure_gradient_reference(grid, p)))},
               grid.dtype, grid.interior, exact=True)
    for n, g in enumerate(got):
        halo = g.clone()
        halo[grid.interior_slices] = 0
        if halo.isnan().any() or halo.any():
            raise AssertionError(f"{label} [{n}]: a halo point is not exactly 0")
    print(f"{label}: every halo point exactly 0")
    return err


def phase_k3bc():
    """K3b and K3c against their plain versions; returns their
    (max_abs_err, ms, plain_ms, bound_ms, bound_by) at 256³ fp32."""
    out = {}
    for size, dtype in (((N, N, N), torch.float32), ((64, 64, 64), torch.float64),
                        ((100, 77, 45), torch.float32)):
        grid = RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                               topology=(PERIODIC, PERIODIC, BOUNDED),
                               dtype=dtype, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(5)
        u, v, w, p = (torch.randn(grid.total_shape, generator=gen, dtype=dtype,
                                  device=DEVICE) for _ in range(4))
        # zero numerators of gz on the bottom wall face, as a mirrored halo
        # gives them
        p[..., grid.Hz - 1] = p[..., grid.Hz]
        n = size[0]
        label = f"{'x'.join(map(str, size))} {str(dtype)[6:]}"
        for name, fn, ref_fn, args in (
                (K3B, fused_divergence, fused_divergence_reference, (grid, u, v, w)),
                (K3C, fused_pressure_gradient, fused_pressure_gradient_reference,
                 (grid, p))):
            if name == K3B:
                err = hold(f"{name} {label}", {"out": {0: fn(*args)}},
                           {"out": {0: ref_fn(*args)}}, dtype)
            else:
                err = hold_k3c(f"{name} {label}", grid, p)
            if name in out:
                out[name] = (max(out[name][0], err),) + out[name][1:]
            elif n == N:
                ms = cuda_ms(lambda: fn(*args), 20)
                plain_ms = cuda_ms(lambda: ref_fn(*args), 3)
                # K3b: u, v, w in, the interior divergence out;
                # K3c: p in, three with-halo gradients out
                nb = (tensor_bytes([u, v, w]) + n ** 3 * p.element_size()
                      if name == K3B else 4 * tensor_bytes([p]))
                out[name] = (err, ms, plain_ms, *bound(name, nb, n ** 3))
                kernel = ("divergence_kernel" if name == K3B
                          else "pressure_gradient_kernel")
                print(f"{name} {label} time: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms (CUDA events); kernel alone "
                      f"{device_ms(lambda: fn(*args), 20, kernel)} ms "
                      "(torch.profiler)")
        del u, v, w, p
        torch.cuda.empty_cache()
    return out[K3B], out[K3C]


def zero_counts():
    """Every wrapper's launch count set to 0 (T1's Fourier mode and K2's
    stretched-x/y form apart)."""
    torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    fourier_tridiagonal.launches = 0
    WRAPPERS[K2].stretched_launches = 0
    WRAPPERS[K5].cut_launches = 0


#: the launches of a hydrostatic model's ``initial_state`` (its
#: ``update_state``: K4a, and K6 before and after it)
INITIAL_STATE = {K4A: 1, K6: 2}


def launch_counts():
    """Every kernel's launches since ``zero_counts`` (``K2XY`` and
    ``K5CUT`` out of K2's and K5's)."""
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    launches[K2XY] = WRAPPERS[K2].stretched_launches
    launches[K2] -= launches[K2XY]
    launches[K5CUT] = WRAPPERS[K5].cut_launches
    launches[K5] -= launches[K5CUT]
    return launches


def read_counts(path, steps, extra=None, plain=False):
    """The launches since ``zero_counts``, checked against ``PER_STEP[path]``
    (and, of T1's, those of its Fourier mode against
    ``T1_FOURIER_PER_STEP``) times ``steps`` plus ``extra``; none with
    ``plain``. K2's stretched-x/y form and K5's cut form count as kernels
    of their own (``K2XY``, ``K5CUT``), out of K2's and K5's counts."""
    torch.cuda.synchronize()
    launches = launch_counts()
    expected = {k: 0 if plain else PER_STEP[path].get(k, 0) * steps
                + (extra or {}).get(k, 0) for k in launches}
    if launches != expected:
        raise AssertionError(f"{path} path: kernel launches {launches}, "
                             f"expected {expected}")
    # T1's Fourier-mode launches among its own (the pressure solve's)
    launches[T1F] = fourier_tridiagonal.launches
    want = 0 if plain else T1_FOURIER_PER_STEP.get(path, 0) * steps
    if launches[T1F] != want:
        raise AssertionError(f"{path} path: {launches[T1F]} T1 launches in its "
                             f"Fourier mode, expected {want}")
    return launches


def run_steps(path, model, state, step, warmup, steps, plain):
    """The path's warm-up and timed steps; every launch count is set to 0
    just before them and read just after. Returns (state, s per timed
    step, launch counts)."""
    zero_counts()
    for _ in range(warmup):
        state = step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / steps
    return state, per_step, read_counts(path, warmup + steps, plain=plain)


# examples/langmuir_turbulence.py:36-46 and
# examples/ocean_wind_mixing_and_convection.py:50-58
LANGMUIR = dict(Qu=-3.72e-5, Qb=2.307e-8, N2=1.936e-5, amplitude=0.8,
                wavelength=60.0, mld=8.0)
WIND = dict(QT=200.0 / (1026.0 * 3991.0), dTdz=0.01,
            Qu=-1.225 / 1026.0 * 2.5e-3 * 10.0 * abs(10.0),
            evaporation=1e-3 / 3600.0)


def surface_grid(n=None, dtype=torch.float32, stretched=False):
    """The examples' 64 m × 64 m × 32 m (Periodic, Periodic, Bounded) box
    with n³ cells (``N`` by default, or ``n`` = (nx, ny, nz)) on the card;
    with ``stretched``, on the wind-mixing example's stretched z faces."""
    size = (N,) * 3 if n is None else n if isinstance(n, tuple) else (n,) * 3
    z = stretched_faces(size[2]) if stretched else (-32, 0)
    return RectilinearGrid(size=size, x=(0, 64), y=(0, 64), z=z,
                           topology=(PERIODIC, PERIODIC, BOUNDED), dtype=dtype,
                           device=DEVICE)


def stretched_faces(nz, Lz=32.0, refinement=1.2, stretching=12.0):
    """examples/ocean_wind_mixing_and_convection.py:31-38: finer near the
    surface."""
    h = np.arange(nz + 1) / nz
    zeta = 1 + (h - 1) / refinement
    sigma = (1 - np.exp(-stretching * h)) / (1 - np.exp(-stretching))
    return Lz * (zeta * sigma - 1)


def langmuir_model(n=None, closure=None):
    """examples/langmuir_turbulence.py at n³ with the cuts of ``SURFACE``
    (``closure`` replaces the ScalarDiffusivity cut)."""
    c = LANGMUIR
    k = 2 * math.pi / c["wavelength"]
    scale = c["wavelength"] / (4 * math.pi)
    us0 = c["amplitude"] ** 2 * k * math.sqrt(9.80665 * k)
    stokes = UniformStokesDrift(dz_us=lambda z, t: us0 / scale * torch.exp(z / scale))
    return NonhydrostaticModel(
        surface_grid(n), advection=WENO5(), timestepper="RungeKutta3",
        tracers=("b",), buoyancy=BuoyancyTracer(), coriolis=FPlane(f=1e-4),
        closure=closure or ScalarDiffusivity(nu=1e-5, kappa=1e-5),
        stokes_drift=stokes,
        boundary_conditions={"u": FieldBCs(top=FluxBC(c["Qu"])),
                             "b": FieldBCs(top=FluxBC(c["Qb"]),
                                           bottom=GradientBC(c["N2"]))})


def wind_mixing_model(n=None, stretched=False, dtype=torch.float32, eos=None,
                      closure=None):
    """examples/ocean_wind_mixing_and_convection.py at n³ with the cuts of
    ``SURFACE``; S's top flux is the example's discrete-form QS. With
    ``stretched``, uncut: its stretched z and AMD. ``eos`` replaces its
    linear equation of state, ``closure`` its closure."""
    c = WIND

    def QS(grid, t, fields):
        return -c["evaporation"] * fields["S"]
    return NonhydrostaticModel(
        surface_grid(n, dtype, stretched), advection=UpwindBiasedFifthOrder(),
        timestepper="RungeKutta3",
        tracers=("T", "S"), coriolis=FPlane(f=1e-4),
        buoyancy=SeawaterBuoyancy(equation_of_state=eos or LinearEquationOfState(
            thermal_expansion=2e-4, haline_contraction=8e-4)),
        closure=closure or (AnisotropicMinimumDissipation() if stretched
                            else ScalarDiffusivity(nu=1e-5, kappa=1e-5)),
        boundary_conditions={"u": FieldBCs(top=FluxBC(c["Qu"])),
                             "T": FieldBCs(top=FluxBC(c["QT"]),
                                           bottom=GradientBC(c["dTdz"])),
                             "S": FieldBCs(top=FluxBC(QS, discrete=True))})


def surface_state(path, model, seed=0, **extra):
    """The example's initial state on the card, its noise from a seeded
    torch.Generator: langmuir_turbulence.py l.63-76,
    ocean_wind_mixing_and_convection.py l.77-86; ``extra`` values of other
    fields (the wind-mixing model's)."""
    g = model.grid
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    noise = lambda: torch.randn(g.shape, generator=gen, dtype=g.dtype, device=DEVICE)
    zc = g.nodes(CENTER, with_halo=False)[2]
    if path.startswith("langmuir"):
        c = LANGMUIR
        decay = torch.exp(zc / 4.0)
        ustar = math.sqrt(abs(c["Qu"]))
        strat = torch.where(zc < -c["mld"], c["N2"] * zc,
                            torch.full_like(zc, -c["N2"] * c["mld"]))
        return model.initial_state(
            b=strat + 1e-1 * c["N2"] * 32 * decay * noise(),
            u=ustar * 1e-1 * decay * noise(), w=ustar * 1e-1 * decay * noise())
    c = WIND
    prof = zc / 32.0 * (1 + zc / 32.0)
    ustar = math.sqrt(abs(c["Qu"]))
    return model.initial_state(
        T=20.0 + c["dTdz"] * zc + c["dTdz"] * 32.0 * 1e-6 * prof * noise(),
        u=ustar * 1e-3 * prof * noise(), w=ustar * 1e-3 * prof * noise(), S=35.0,
        **extra)


def implicit_model(n=None, dtype=torch.float32):
    """The "AB2 stretched implicit" path's model at n³ (``N`` by default)."""
    return NonhydrostaticModel(surface_grid(n, dtype, stretched=True),
                               advection=WENO5(), buoyancy=BuoyancyTracer(),
                               closure=ScalarDiffusivity(**IMPLICIT))


def les_model(path, n=None):
    """The model of an ``LES`` path at n³ fp32."""
    if path == "langmuir AMD":
        return langmuir_model(n, AnisotropicMinimumDissipation())
    if path == "wind mixing stretched":
        return wind_mixing_model(n, stretched=True)
    return implicit_model(n)


def bench_state(model, seed=0):
    """bench.py's initial fields: random u, v (1e-2) and b (1e-4)."""
    rng = np.random.default_rng(seed)
    shape = model.grid.shape
    return model.initial_state(u=1e-2 * rng.standard_normal(shape),
                               v=1e-2 * rng.standard_normal(shape),
                               b=1e-4 * rng.standard_normal(shape))


def path_model(path):
    """The path's model at 256³ fp32, its initial state and (Δt, warm-up
    steps, timed steps)."""
    if path in SURFACE:
        model = (langmuir_model if path == "langmuir" else wind_mixing_model)()
        return model, surface_state(path, model), SURFACE[path]
    if path in LES:
        model = les_model(path)
        state = (bench_state(model) if path == "AB2 stretched implicit"
                 else surface_state(path, model))
        return model, state, LES[path]
    timestepper, dt, warmup, steps, kw = PATHS[path]
    model = model_for(N, torch.float32, timestepper=timestepper, **kw)
    rng = np.random.default_rng(0)
    shape = model.grid.shape
    state = model.initial_state(u=1e-2 * rng.standard_normal(shape),
                                v=1e-2 * rng.standard_normal(shape),
                                b=1e-4 * rng.standard_normal(shape))
    return model, state, (dt, warmup, steps)


def drive(path, plain):
    """Build the path's model at 256³ fp32 and run it with the kernels or
    (``plain``) their plain versions."""
    model, state, (dt, warmup, steps) = path_model(path)
    if model.kernels["fill"] is not fused_fill_halos:
        raise AssertionError(f"{path}: fills take {model.kernels['fill']}, not K6")
    kernels = nonhydrostatic.PLAIN if plain else None
    state, per_step, launches = run_steps(
        path, model, state, lambda s: model.step(s, dt, kernels), warmup,
        steps, plain)
    return model, state, per_step, launches


def divergence_ratio(model, state, uniform=False):
    """max|∇·u|·Δx / max|u| over the interior of a filled state; with
    ``uniform``, of ∇·u minus its domain mean. On a stretched z, ∂z w takes
    each level's Δzᶜ and Δx is the grid's smallest spacing."""
    g = model.grid
    sol = state["solution"]
    (hx, hy, hz), (nx, ny, nz) = g.halo, g.shape
    cut = lambda a, di=0, dj=0, dk=0: a[hx + di:hx + di + nx,
                                        hy + dj:hy + dj + ny,
                                        hz + dk:hz + dk + nz]
    u, v, w = sol["u"], sol["v"], sol["w"]
    dz, dx = g.Lz / nz, g.Lx / nx
    if not g.z_regular:
        dz, dx = g.dz(CENTER)[:, :, hz:hz + nz], g.min_spacing()
    div = ((cut(u, di=1) - cut(u)) / (g.Lx / nx)
           + (cut(v, dj=1) - cut(v)) / (g.Ly / ny)
           + (cut(w, dk=1) - cut(w)) / dz)
    if uniform:
        div = div - div.double().mean()
    umax = max(float(cut(a).abs().max()) for a in (u, v, w))
    return float(div.abs().max()) * dx / umax


def agreement(path, steps, kernel_fields, model, state):
    """max over fields of max|Δ|/max|field| between the kernel run's
    interiors and ``state``'s (max|Δ| itself for a field that is zero);
    raises above the path's ``AGREE``."""
    def relative(k, a):
        err = float((kernel_fields[k] - model.grid.interior(a)).abs().max())
        scale = float(model.grid.interior(a).abs().max())
        return err / scale if scale else err
    rel = {k: relative(k, a) for k, a in state["solution"].items()}
    name = max(rel, key=rel.get)
    if not rel[name] <= AGREE[path]:
        raise AssertionError(f"{path}: kernel and plain runs differ by "
                             f"{rel[name]:.3e} of max|{name}| after {steps} "
                             f"steps ({rel})")
    return rel[name]


def check_finite(path, model, state, keys=()):
    for name, a in state["solution"].items():
        if tuple(a.shape) != model.grid.total_shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{path} {name}: shape {tuple(a.shape)} or "
                                 "non-finite values")
    for key in keys:
        if not bool(torch.isfinite(state[key]).all()):
            raise AssertionError(f"{path} {key}: non-finite values")


def path_kernel_times(path, model, state):
    """The path's kernel (K1 on AB2, K2 on RK3) held bit for bit and timed
    against its plain version on the path's own fields after its steps
    (smooth, unlike the random inputs of phases 3 and 4); returns (max|Δ|,
    ms, plain_ms)."""
    if path == "AB2":
        err = hold_k1(f"K1 {N}^3 fp32 on the path's fields", model, state)[2]
        call = lambda: fused_ab2_advance(model, state, PATHS[path][1], False)
        plain = lambda: fused_ab2_advance_reference(model, state,
                                                     PATHS[path][1], False)
        name = "K1"
    else:
        sol = state["solution"]
        args = (model.grid, model.advection, model.tracer_advection,
                sol["u"], sol["v"], sol["w"],
                {n: sol[n] for n in model.tracer_names})
        err = hold_k2(f"K2 {N}^3 fp32 on the path's fields", args, torch.float32)
        call = lambda: fused_advective_tendencies(*args)
        plain = lambda: fused_advective_tendencies_reference(*args)
        name = "K2"
    ms, plain_ms = cuda_ms(call, 20), cuda_ms(plain, 3)
    print(f"{name} {N}^3 fp32 on the {path} path's fields time: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events)")
    return err, ms, plain_ms


def surface_response(path, model, state):
    """The surface fluxes acted: both winds (Qu < 0) drive the top layer's
    mean u positive from a start whose mean is ~0, and the wind-mixing
    heat loss (QT > 0) cools the top layer below its initial 20 + 0.01 z."""
    g = model.grid
    top = lambda name: float(g.interior(state["solution"][name])[:, :, -1].double().mean())
    u_top = top("u")
    if not u_top > 0:
        raise AssertionError(f"{path}: the top layer's mean u is {u_top:.3e}, "
                             "not driven by the wind stress")
    line = f"{path}: top layer's mean u {u_top:.6e} m/s"
    if path.startswith("wind mixing"):
        t0 = 20.0 + WIND["dTdz"] * float(g.nodes(CENTER)[2].flatten()[-1])
        t_top = top("T")
        if not t_top < t0:
            raise AssertionError(f"{path}: the top layer's mean T {t_top} is not "
                                 f"below its initial {t0}")
        line += f", mean T {t_top:.9f} K (initially {t0:.9f})"
    print(line)


def phase_path(path):
    """One 256³ path with the kernels, checked, then with the plain
    versions; returns the kernel run's launch counts and, on the AB2 and
    RK3 paths, K1's or K2's (max|Δ|, ms, plain_ms) on the path's fields."""
    model, state, per_step, launches = drive(path, plain=False)
    check_finite(path, model, state, ("pHY", "pNHS"))
    uniform = path == "general projection"
    ratio = divergence_ratio(model, state, uniform)
    what = "max|div u - mean|*dx/max|u|" if uniform else "max|div u|*dx/max|u|"
    if not ratio <= 1e-5:
        raise AssertionError(f"{path}: {what} = {ratio:.3e} > 1e-5")
    warmup, steps = (SURFACE[path] if path in SURFACE else
                     LES[path] if path in LES else PATHS[path][1:4])[1:]
    used = {k: n for k, n in launches.items() if n}
    print(f"{path} path: {N}^3 fp32, {steps} steps: {per_step * 1e3:.3f} ms/step, "
          f"{N ** 3 / per_step:.6e} grid points/s, launches {used} in "
          f"{warmup + steps} steps, {what} {ratio:.3e}")
    if path in SURFACE or path in ("langmuir AMD", "wind mixing stretched"):
        surface_response(path, model, state)
    times = path_kernel_times(path, model, state) if path in ("AB2", "RK3") else None
    kernel_u = {k: model.grid.interior(a) for k, a in state["solution"].items()}
    del state
    model, state, plain_step, _ = drive(path, plain=True)
    worst = agreement(path, warmup + steps, kernel_u, model, state)
    print(f"{path} path: plain versions: {plain_step * 1e3:.3f} ms/step, "
          f"{N ** 3 / plain_step:.6e} grid points/s; kernel and plain runs "
          f"agree to {worst:.3e} of max|field|")
    del model, state, kernel_u
    torch.cuda.empty_cache()
    return launches, times


def drive_shallow_water(plain):
    """The 16384² shallow-water headline, run with K3a or (``plain``) its
    plain version; returns (model, state, s per step, launches, Σh₀)."""
    dt, warmup, steps = SW_PATH
    grid = RectilinearGrid(size=(N_SW, N_SW, 1), x=(0, 2 * math.pi),
                           y=(0, 2 * math.pi), topology=(PERIODIC, PERIODIC, FLAT),
                           dtype=torch.float32, device=DEVICE)
    model = ShallowWaterModel(grid, gravitational_acceleration=10.0,
                              advection=WENO5())
    state = model.initial_state(
        uh=lambda x, y, z: 0.1 * torch.sin(x) * torch.cos(y), h=1.0)
    mass0 = float(model.grid.interior(state["solution"]["h"]).double().sum())
    kernels = shallow_water.PLAIN if plain else None
    state, per_step, launches = run_steps(
        "shallow water", model, state, lambda s: model.step(s, dt, kernels),
        warmup, steps, plain)
    return model, state, per_step, launches, mass0


def phase_shallow_water():
    """The shallow-water path with K3a, checked, then with its plain
    version; returns the kernel run's launch counts and K3a's and its
    plain version's ms on the path's fields."""
    _, warmup, steps = SW_PATH
    model, state, per_step, launches, mass0 = drive_shallow_water(plain=False)
    check_finite("shallow water", model, state)
    mass = float(model.grid.interior(state["solution"]["h"]).double().sum())
    drift = abs(mass - mass0) / abs(mass0)
    if not drift <= 1e-6:
        raise AssertionError(f"shallow water: sum(h) drifted by {drift:.3e}")
    print(f"shallow-water path: {N_SW}^2 fp32, {steps} steps: "
          f"{per_step * 1e3:.3f} ms/step, {N_SW ** 2 / per_step:.6e} grid "
          f"points/s, launches {launches[K3A]} K3a in {warmup + steps} steps "
          f"(no other), sum(h) drift {drift:.3e}")
    # K3a's time on the path's own fields: smooth, with vh ~ 1e-6, where
    # the random inputs of phase 5 are not
    sol = state["solution"]
    args = (model.grid, model.advection, model.tracer_advection, model.g,
            sol["uh"], sol["vh"], sol["h"])
    names = ("uh", "vh", "h")
    hold(f"K3a {N_SW}x{N_SW} float32 on the path's fields",
         {"G": dict(zip(names, fused_shallow_water_tendencies(*args)))},
         {"G": dict(zip(names, fused_shallow_water_tendencies_reference(*args)))},
         torch.float32, model.grid.interior, exact=True)
    ms = cuda_ms(lambda: fused_shallow_water_tendencies(*args), 20)
    plain_ms = cuda_ms(lambda: fused_shallow_water_tendencies_reference(*args), 3)
    print(f"K3a {N_SW}x{N_SW} float32 on the path's fields time: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events)")
    kernel_u = {k: model.grid.interior(a).clone()
                for k, a in state["solution"].items()}
    del state, sol, args
    torch.cuda.empty_cache()
    model, state, plain_step, _, _ = drive_shallow_water(plain=True)
    worst = agreement("shallow water", warmup + steps, kernel_u, model, state)
    print(f"shallow-water path: plain version: {plain_step * 1e3:.3f} ms/step, "
          f"{N_SW ** 2 / plain_step:.6e} grid points/s; kernel and plain runs "
          f"agree to {worst:.3e} of max|field|")
    del model, state, kernel_u
    torch.cuda.empty_cache()
    return launches, ms, plain_ms


# -- the hydrostatic kernels and path ---------------------------------------------

def latlon_grid(dtype=torch.float32, size=None, latitude=(-75, 75)):
    """The flagship's lat-lon grid (benchmark/bench_hydro_flagship.py:24-31):
    (0, 360) periodic × ``latitude`` bounded, z faces −3000(1 − k/Nz)^1.8."""
    size = size or HYDRO["size"]
    k = np.arange(size[2] + 1)
    return LatitudeLongitudeGrid(size=size, longitude=(0, 360), latitude=latitude,
                                 z=-3000.0 * (1.0 - k / size[2]) ** 1.8,
                                 dtype=dtype, device=DEVICE)


def wind_bcs():
    """The near-global run's wind stress (benchmark/bench_near_global.py:35-36)."""
    return {"u": FieldBCs(top=FluxBC(
        lambda lam, phi, t: -1e-4 * torch.cos(3.0 * math.pi * phi / 180.0)))}


def latlon_flagship(dtype=torch.float32, wind=False, grid=None, momentum_advection=None,
                    tracer_advection=None, free_surface=None, **kw):
    """The ¼° flagship of benchmark/bench_hydro_flagship.py through the
    public API; with ``wind``, under the near-global run's wind stress;
    ``grid`` another lat-lon grid, the schemes others than its
    weno_velocity momentum and WENO5 tracers, ``free_surface`` another than
    its split-explicit(30), ``kw`` more model options."""
    return HydrostaticFreeSurfaceModel(
        grid or latlon_grid(dtype),
        momentum_advection=momentum_advection or VectorInvariant(scheme="weno_velocity"),
        tracer_advection=tracer_advection or WENO5(), tracers=("T", "S"),
        free_surface=free_surface or SplitExplicitFreeSurface(substeps=HYDRO["substeps"]),
        coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer(),
        boundary_conditions=wind_bcs() if wind else None, **kw)


def near_global_bathymetry(lam, phi):
    """benchmark/bench_near_global.py:28-31: a sigmoid continent (100 m
    above the sea) in a 3000 m ocean."""
    s = torch.sigmoid
    land = (s((lam - 255.0) / 8.0) * s((300.0 - lam) / 8.0)
            * s((phi + 55.0) / 6.0) * s((70.0 - phi) / 6.0))
    full = lambda v: torch.full((), v, dtype=lam.dtype, device=lam.device)
    return torch.where(land > 0.5, full(100.0), full(-3000.0))


def ocean_closure(kind, grid):
    """The ocean-physics configuration's closure (``OCEAN``) on ``grid``,
    with CATKE (``kind`` "CATKE" or "CATKE Roquet") or a closure of the
    closures hold in its place."""
    horizontal = HorizontalScalarDiffusivity(nu=OCEAN["nu"], kappa=OCEAN["kappa"])
    if kind.startswith("CATKE"):
        phi = grid.coord(1, C, with_halo=True).reshape(1, -1)
        tau = torch.broadcast_to(-1e-4 * torch.cos(3.0 * math.pi * phi / 180.0),
                                 grid.total_shape[:2]).contiguous()
        return horizontal, CATKEVerticalDiffusivity(surface_momentum_flux=(tau, 0.0))
    if kind == "convective adjustment":
        return horizontal, ConvectiveAdjustmentVerticalDiffusivity(
            convective_kappa_z=1.0, background_kappa_z=1e-5)
    if kind == "Ri-based":
        return horizontal, RiBasedVerticalDiffusivity()
    return (horizontal, IsopycnalSkewSymmetricDiffusivity(),
            VerticalScalarDiffusivity(nu=1e-3, kappa=1e-4,
                                      time_discretization="vertically_implicit"))


def ocean_halo():
    """The halo the ocean-physics model takes (its default schemes')."""
    h = max(VectorInvariant().required_halo, CenteredSecondOrder().required_halo, 1)
    return (h, h, h)


def ocean_model(kind="CATKE", size=None, dtype=torch.float32):
    """The ocean-physics configuration (``OCEAN``) at ``size`` (¼° by
    default) through the public API, its grid built with the halo the
    model takes (so that τx's plane has the model's with-halo shape)."""
    grid = latlon_grid(dtype, size).with_halo(ocean_halo())
    eos = (RoquetIdealizedEquationOfState() if kind == "CATKE Roquet"
           else TEOS10EquationOfState())
    return HydrostaticFreeSurfaceModel(
        grid, free_surface=SplitExplicitFreeSurface(substeps=HYDRO["substeps"]),
        coriolis=HydrostaticSphericalCoriolis(),
        buoyancy=SeawaterBuoyancy(equation_of_state=eos), tracers=("T", "S"),
        closure=ocean_closure(kind, grid),
        immersed_boundary=GridFittedBottom(near_global_bathymetry),
        boundary_conditions=wind_bcs())


def ocean_state(model):
    """The ocean-physics configuration's initial state (``OCEAN``)."""
    e = {"e": OCEAN["e"]} if "e" in model.tracer_names else {}
    return model.initial_state(T=lambda lam, phi, z: 2.0 + 18.0 * torch.exp(z / 500.0),
                               S=35.0, **e)


def near_global_model(path, dtype=torch.float32):
    """The model of a ``NEAR_GLOBAL`` path at ¼° through the public API."""
    if path == "near-global CATKE":
        return ocean_model("CATKE", dtype=dtype)
    closure = ScalarDiffusivity(**NEAR_GLOBAL_CLOSURE)
    if path == "1/4 deg diffusive":
        return latlon_flagship(dtype, closure=closure)
    bottom = GridFittedBottom(near_global_bathymetry)
    if path == "near-global WENO":
        return latlon_flagship(dtype, wind=True, closure=closure, immersed_boundary=bottom)
    if path == "near-global UB5":
        return latlon_flagship(dtype, wind=True, closure=closure, immersed_boundary=bottom,
                               momentum_advection=UpwindBiasedFifthOrder(),
                               tracer_advection=BoundsPreservingWENO5())
    return HydrostaticFreeSurfaceModel(
        latlon_grid(dtype), free_surface=SplitExplicitFreeSurface(substeps=HYDRO["substeps"]),
        coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer(),
        closure=closure, immersed_boundary=bottom, boundary_conditions=wind_bcs())


def stretched_latitude(ny, extent=75.0):
    """ny + 1 latitude faces over (−extent, extent), 1.7 times finer at the
    equator than at the edges."""
    s = np.linspace(-1.0, 1.0, ny + 1)
    return extent * (0.6 * s + 0.4 * s ** 3)


def bounded_beta_model(dtype=torch.float64, size=(128, 96, 16), **kw):
    """``size`` (Bounded, Bounded, Bounded) with stretched z, flux-form
    WENO5 momentum, a β-plane and 8 barotropic substeps (1e4 m cells);
    ``kw`` more model options."""
    k = np.arange(size[2] + 1)
    grid = RectilinearGrid(size=size, x=(0, 1e4 * size[0]), y=(0, 1e4 * size[1]),
                           z=-1000.0 * (1.0 - k / size[2]) ** 1.5,
                           topology=(BOUNDED, BOUNDED, BOUNDED), dtype=dtype,
                           device=DEVICE)
    return HydrostaticFreeSurfaceModel(
        grid, momentum_advection=WENO5(), tracer_advection=WENO5(),
        tracers=("T", "S"), free_surface=SplitExplicitFreeSurface(substeps=8),
        coriolis=BetaPlane(f0=1e-4, beta=1e-11), buoyancy=BuoyancyTracer(), **kw)


def ridge(x, y):
    """validation/near_global_lat_lon.py's ridge (1200 m over a 3000 m
    ocean, 12° wide) on the 1000 m β-plane box: 400 m, 1.2e5 m wide, at the
    box's middle in x."""
    return -1000.0 + 400.0 * torch.exp(-((x - 6.4e5) / 1.2e5) ** 2) + 0.0 * y


def hydro_random_state(model, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    g = model.grid
    rand = lambda s, shape: s * torch.randn(shape, generator=gen, dtype=g.dtype,
                                            device=DEVICE)
    state = model.initial_state(u=rand(0.1, g.shape), v=rand(0.1, g.shape),
                                T=rand(1.0, g.shape), S=rand(1.0, g.shape),
                                b=rand(1e-3, g.shape))
    state["G_prev"] = {n: rand(1e-6, g.total_shape)
                       for n in model.prognostic_names()}
    return state


def phase_k4():
    """K4a and K4b against their plain versions; returns their
    (max_abs_err, ms, plain_ms, bound_ms, bound_by) at ¼° fp32, K4b in
    its advance form, the main path's."""
    out = {}
    tile_edges = lambda dtype: bounded_beta_model(dtype, (130, 97, 16))
    for label, build, dtype in (("1/4 deg flagship fp32", latlon_flagship,
                                 torch.float32),
                                ("130x97x16 fp64 flux-form, beta-plane, bounded "
                                 "x and y", tile_edges, torch.float64)):
        model = build(dtype)
        state = hydro_random_state(model, 11)
        g, sol = model.grid, state["solution"]
        print(f"K4a {label} launch: {columns_config(g)}")
        args = (g, sol["u"], sol["v"], sol["b"])
        outputs = lambda ts: {n: t for n, t in zip(("w", "pHY"), ts) if t is not None}
        err_a = 0.0
        for part, a in (("w and pHY'", args), ("w only", args[:3])):
            poison_cache(g.total_shape, dtype)
            got = outputs(hydrostatic_columns(*a))
            ref = outputs(hydrostatic_columns_reference(*a))
            if got.keys() != ref.keys():
                raise AssertionError(f"K4a {label} {part}: outputs {list(got)}, "
                                     f"plain version {list(ref)}")
            err_a = max(err_a, hold(f"K4a {label} {part}", {"out": got},
                                    {"out": ref}, dtype, exact=True))
        err_b = 0.0
        for adv in (None, (HYDRO["dt"], False)):
            got = fused_hydrostatic_tendencies(model, state, adv)
            ref = fused_hydrostatic_tendencies_reference(model, state, adv)
            got, ref = (({"G": got}, {"G": ref}) if adv is None else
                        ({"psi'": got[0], "G": got[1]},
                         {"psi'": ref[0], "G": ref[1]}))
            err_b = max(err_b, hold(f"K4b {label} "
                                    f"{'tendencies' if adv is None else 'advance'}",
                                    got, ref, dtype, g.interior, exact=True))
        del got, ref
        if dtype is torch.float32:
            points = g.Nx * g.Ny * g.Nz
            adv = (HYDRO["dt"], False)
            ms_a = cuda_ms(lambda: hydrostatic_columns(*args), 10)
            plain_a = cuda_ms(lambda: hydrostatic_columns_reference(*args), 2)
            w, ph = hydrostatic_columns(*args)
            out[K4A] = (err_a, ms_a, plain_a, *bound(
                K4A, tensor_bytes(args[1:], [w, ph]), points))
            ms_b = cuda_ms(lambda: fused_hydrostatic_tendencies(model, state, adv), 10)
            plain_b = cuda_ms(lambda: fused_hydrostatic_tendencies_reference(
                model, state, adv), 2)
            psi, G = fused_hydrostatic_tendencies(model, state, adv)
            nb = tensor_bytes(sol.values(), [state["w"], state["pHY"]],
                              state["G_prev"].values(), psi.values(), G.values())
            out[K4B] = (err_b, ms_b, plain_b, *bound(K4B, nb, points))
            print(f"K4a {label} time: kernel {ms_a:.4f} ms, plain {plain_a:.4f} "
                  f"ms; K4b advance: kernel {ms_b:.4f} ms, plain {plain_b:.4f} ms "
                  "(CUDA events)")
            del w, ph, psi, G
        else:
            for k, err in ((K4A, err_a), (K4B, err_b)):
                out[k] = (max(out[k][0], err),) + out[k][1:]
        del model, state, sol, args
        torch.cuda.empty_cache()
    return out


#: operations a point that K4b's newer parts need, counted as ``FLOPS``:
#: the closure adds ~20 a field (four face fluxes of a subtraction, a
#: division and two products, their differences and the division by V),
#: five fields; the clear flags are selects and add none; a stretched
#: latitude's tables make the tracers' y fluxes two-sided (~60 more each)
K4B_FORM_FLOPS = {"closure": 1400, "masks": 1300, "stretched y": 1480}


def k4b_form_cases():
    """(label, part, model builder, dtype, timed) of K4b's newer parts'
    holds: the in-kernel closure, the solid masks (clear flags) and a
    stretched latitude's y tables, each at ¼° fp32 (timed) and on a
    smaller fp64 grid."""
    f32, f64 = torch.float32, torch.float64
    per_tracer = ScalarDiffusivity(nu=2e3, kappa={"T": 1e3, "b": 5e2}, nu_z=1e-3,
                                   kappa_z={"T": 1e-3})
    return (
        ("1/4 deg fp32 (the 1/4 deg diffusive path's model)", "closure",
         lambda: near_global_model("1/4 deg diffusive"), f32, True),
        ("128x96x16 fp64 bounded beta-plane, explicit nu_z, per-tracer kappa", "closure",
         lambda: bounded_beta_model(closure=per_tracer), f64, False),
        ("1/4 deg fp32 near-global bottom, CENTER (the near-global WENO path's model)",
         "masks", lambda: near_global_model("near-global WENO"), f32, True),
        ("128x96x16 fp64 ridge, flux-form WENO5: CENTER and U/V", "masks",
         lambda: bounded_beta_model(immersed_boundary=GridFittedBottom(ridge)), f64, False),
        ("1440x600x24 fp32 stretched latitude (the flagship)", "stretched y",
         lambda: latlon_flagship(grid=latlon_grid(
             latitude=stretched_latitude(HYDRO["size"][1]))),
         f32, True),
        ("67x45x29 fp64 stretched latitude, flux-form WENO5", "stretched y",
         lambda: HydrostaticFreeSurfaceModel(
             latlon_grid(f64, (67, 45, 29), stretched_latitude(45)),
             momentum_advection=WENO5(), tracer_advection=WENO5(), tracers=("T", "S"),
             free_surface=SplitExplicitFreeSurface(substeps=8),
             coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer()),
         f64, False))


def phase_k4_forms():
    """K4b's newer parts against its plain version, both forms, bit for bit
    on the interior over NaN-filled outputs, its halos exactly zero; the
    ¼° cases timed (the form their path runs) against their bounds.
    Returns (the largest max|Δ|, a reading of each timed case: part,
    form, max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    from clima_oceananigans_jl_torch.ops.fused_hydrostatic import kernel_closure
    worst, readings = 0.0, []
    for label, part, build, dtype, timed in k4b_form_cases():
        model = build()
        g = model.grid
        reached = {"closure": kernel_closure(model) is not None,
                   "masks": bool(_mask_locs(model)), "stretched y": not g.y_regular}
        if not reached[part]:
            raise AssertionError(f"K4b {label}: the model does not reach its {part}")
        state = hydro_random_state(model, 13)
        case_err = hold_k4b(f"{part}, {label}", model, state)
        worst = max(worst, case_err)
        if timed:
            adv = (HYDRO["dt"], False) if model.fused_advance else None
            form = "tendencies" if adv is None else "advance"
            ms = cuda_ms(lambda: fused_hydrostatic_tendencies(model, state, adv), 10)
            plain_ms = cuda_ms(lambda: fused_hydrostatic_tendencies_reference(
                model, state, adv), 2)
            out = fused_hydrostatic_tendencies(model, state, adv)
            outs = list(out[0].values()) + list(out[1].values()) if adv else list(out.values())
            extra = [clear_flags(g, loc, 2) for loc in _mask_locs(model)]
            if not g.y_regular:
                extra.append(y_tables(g))
            nb = tensor_bytes(state["solution"].values(), [state["w"], state["pHY"]],
                              state["G_prev"].values() if adv else [], outs, extra)
            b_ms, b_by = bound(K4B, nb, g.Nx * g.Ny * g.Nz, K4B_FORM_FLOPS[part])
            print(f"K4b {part}, {label}, {form} time: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (CUDA events); bound {b_ms:.4f} ms ({b_by})")
            readings.append({"part": part, "form": form, "max_abs_err": case_err,
                             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by})
            del out, outs, extra
        del model, state
        torch.cuda.empty_cache()
    return worst, readings


def phase_k5_planes():
    """K5 over the near-global run's bottom (the column depths as (X, Y)
    planes) against its plain version on every with-halo point at ¼° fp32
    with 30 substeps, over NaN-filled outputs; its time against its bound.
    Returns (max|Δ|, ms, plain_ms, bound_ms, bound_by)."""
    model = near_global_model("near-global")
    g = model.grid
    Hfc = column_depths(g)[0]
    if torch.equal(Hfc, Hfc[g.Hx:g.Hx + 1].expand_as(Hfc)):
        raise AssertionError("K5 planes: the near-global depths do not vary in x")
    shape = g.total_shape[:2] + (1,)
    n = HYDRO["substeps"]
    args = k5_args(model, 14, n)
    eta = args[2]
    label = "1/4 deg fp32 near-global bottom (depth planes), 30 substeps"
    print(f"K5 {label} cooperative grid: {cooperative_grid(g)}")
    err = hold_k5(label, model, args)
    ms = cuda_ms(lambda: fused_substep_eta(*args), 5)
    plain_ms = cuda_ms(lambda: fused_substep_eta_reference(*args), 2)
    # η0, U0, V0, Gᵁ, Gⱽ and the two depth planes in, η̅, U̅, V̅ out
    b_ms, b_by = bound(K5, 10 * tensor_bytes([eta]), shape[0] * shape[1] * n)
    print(f"K5 {label} time: kernel {ms:.4f} ms (one cooperative launch), plain "
          f"{plain_ms:.4f} ms (CUDA events); bound {b_ms:.4f} ms ({b_by})")
    del model, args
    torch.cuda.empty_cache()
    return err, ms, plain_ms, b_ms, b_by


def phase_k5():
    """K5 against its plain version on every with-halo point; returns
    (max_abs_err, ms, plain_ms, bound_ms, bound_by) at ¼° fp32 with 30
    substeps."""
    out = None
    for label, build, dtype, n in (
            ("1/4 deg fp32, 30 substeps", latlon_flagship, torch.float32,
             HYDRO["substeps"]),
            ("128x96 fp64 bounded x and y, 8 substeps", bounded_beta_model,
             torch.float64, 8)):
        model = build(dtype)
        g = model.grid
        shape = g.total_shape[:2] + (1,)
        args = k5_args(model, 12, n)
        eta = args[2]
        print(f"K5 {label} cooperative grid: {cooperative_grid(g)}")
        err = hold_k5(label, model, args)
        if out is None:
            ms = cuda_ms(lambda: fused_substep_eta(*args), 5)
            plain_ms = cuda_ms(lambda: fused_substep_eta_reference(*args), 2)
            # η0, U0, V0, Gᵁ, Gⱽ, Hᶠᶜ, Hᶜᶠ in, η̅, U̅, V̅ out (metric rows and
            # weights are negligible)
            nb = 10 * tensor_bytes([eta])
            out = (err, ms, plain_ms, *bound(K5, nb, shape[0] * shape[1] * n))
            print(f"K5 {label} time: kernel {ms:.4f} ms (one cooperative launch), "
                  f"plain {plain_ms:.4f} ms (CUDA events)")
        else:
            out = (max(out[0], err),) + out[1:]
        del model, args
        torch.cuda.empty_cache()
    return out


def nan_halos(grid, fields, seed):
    """``fields`` [(shape, loc, bcs, axes)] as K6's (data, loc, bcs, axes,
    t) on the card: random on each field's kept interior (``fill_plan``'s),
    NaN on every point a fill writes, so a point K6 leaves unwritten fails
    a bit-for-bit hold."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = []
    for shape, loc, bcs, axes in fields:
        ints, _ = fill_plan(grid, loc, bcs, axes, shape)
        data = torch.full(shape, float("nan"), dtype=grid.dtype, device=DEVICE)
        keep = tuple(slice(lo, hi) for _S, _N, _H, lo, hi, *_r in ints)
        data[keep] = torch.randn(data[keep].shape, generator=gen,
                                 dtype=grid.dtype, device=DEVICE)
        out.append((data, loc, bcs, axes, 0.0))
    return out


def hydro_fill_fields(model):
    """The two groups of (shape, loc, bcs, axes) the hydrostatic step fills
    in ``update_state``: u, v, tracers and η, then w and pHY′."""
    g = model.grid
    first = [(g.total_shape, model._locs()[n], model.bcs[n], (0, 1, 2))
             for n in model.prognostic_names()]
    first.append((g.total_shape[:2] + (1,), ETA_LOC, model.eta_bcs, (0, 1)))
    second = [(g.total_shape, loc, bcs, (0, 1, 2)) for loc, bcs in (
        (W_LOC, model.w_bcs), (CENTER, model.pressure_bcs))]
    return first, second


def nonhydrostatic_fill_fields(model):
    """The two groups the nonhydrostatic step fills in ``update_state``
    (u, v, w and the tracers, then pHY′; the general projection's groups
    have the same shapes and rules: u, v, w, then pNHS)."""
    g = model.grid
    assert model.kernels["fill"] is fused_fill_halos, model._fill_unsupported_reason()
    first = [(g.total_shape, model._locs()[n], model.bcs[n], (0, 1, 2))
             for n in model.prognostic_names()]
    return first, [(g.total_shape, CENTER, model.pressure_bcs, (0, 1, 2))]


def axis_sources(S, N, H, lo, hi, k0, k1, v0, v1):
    """The kept indices along one axis that its written indices read (a
    wall face that takes b reads none), as ``csrc/fill_halos.cu::rule``."""
    out = set()
    for i in list(range(lo)) + list(range(hi, S)):
        side = 0 if i < lo else 1
        kind = (k0, k1)[side]
        if kind == WRAP:
            out.add(i + N if side == 0 else i - N)
        elif kind == MIRROR_C:
            m = 2 * H - 1 - i if side == 0 else 2 * (H + N) - 1 - i
            out.add(min(max(m, H), H + N - 1))
        elif kind == MIRROR_F:
            face = H if side == 0 else H + N
            if i != face:
                out.add(min(max(2 * face - i, H), H + N))
    return sorted(out)


def fill_masks(grid, data, loc, bcs, axes):
    """(written, source) boolean masks of one field on the card: the points
    a fill writes, and the kept points some written point reads."""
    ints, _ = fill_plan(grid, loc, bcs, axes, data.shape)
    kept, src = [], []
    for a, (S, N, H, lo, hi, *rest) in enumerate(ints):
        k = torch.zeros(S, dtype=torch.bool, device=DEVICE)
        k[lo:hi] = True
        m = torch.zeros(S, dtype=torch.bool, device=DEVICE)
        m[axis_sources(S, N, H, lo, hi, *rest)] = True
        shape = [1, 1, 1]
        shape[a] = S
        kept.append(k.view(shape))
        src.append(m.view(shape))
    keep = kept[0] & kept[1] & kept[2]
    return ~keep, keep & (src[0] | src[1] | src[2])


def fill_work(grid, fields):
    """(compulsory bytes, written points) of filling ``fields``: each
    written halo point once and each distinct source point once."""
    nbytes = written = 0
    for data, loc, bcs, axes, _t in fields:
        wmask, smask = fill_masks(grid, data, loc, bcs, axes)
        w, n_src = int(wmask.sum()), int(smask.sum())
        written += w
        nbytes += (w + n_src) * data.element_size()
    return nbytes, written


def fill_sectors(grid, fields, size=32):
    """(blocks of ``size`` bytes holding a source point, blocks holding a
    written point, blocks of the fields) of filling ``fields``: what the
    fill moves at the granularity of the L2 cache's sectors (32 bytes) or
    of a DRAM access (64 bytes), each array taken as aligned to it."""
    read = wrote = total = 0
    for data, loc, bcs, axes, _t in fields:
        es = data.element_size()
        for mask, acc in zip(fill_masks(grid, data, loc, bcs, axes), ("r", "w")):
            n = int(torch.unique(mask.flatten().nonzero().flatten() * es // size).numel())
            if acc == "r":
                read += n
            else:
                wrote += n
        total += -(-data.numel() * es // size)
    return read, wrote, total


def hold_k6(label, grid, fields, seed):
    """K6 against its plain version, bit for bit on every with-halo point,
    from NaN on every written point (``nan_halos``), one launch; returns
    (max|Δ|, the kernel's filled fields)."""
    got = nan_halos(grid, fields, seed)
    ref = [(d.clone(), *rest) for d, *rest in got]
    n0 = fused_fill_halos.launches
    fused_fill_halos(grid, got)
    if fused_fill_halos.launches != n0 + 1:
        raise AssertionError("K6: expected one launch per group")
    fused_fill_halos_reference(grid, ref)
    err = hold(label, {"out": {i: f[0] for i, f in enumerate(got)}},
               {"out": {i: f[0] for i, f in enumerate(ref)}}, grid.dtype,
               exact=True)
    return err, got, ref


def bounded_fill_fields(dtype=torch.float64, size=(67, 45, 29)):
    """A group on (Bounded, Periodic, Bounded) at a size off K6's blocks:
    every location with value, open and flux walls."""
    grid = RectilinearGrid(size=size, extent=(1.0, 2.0, 0.5),
                           topology=(BOUNDED, PERIODIC, BOUNDED), dtype=dtype,
                           device=DEVICE, halo=(3, 3, 3))
    walls = (FieldBCs(west=ValueBC(0.3), east=OpenBC(-0.2), bottom=ValueBC(0.5),
                      top=OpenBC(1.5)),
             FieldBCs(west=OpenBC(0.1), east=FluxBC(), bottom=FluxBC(),
                      top=ValueBC(-1.25)),
             None)
    return grid, [(grid.total_shape, loc, regularize_bcs(grid, loc, bcs), (0, 1, 2))
                  for loc in (CENTER, U_LOC, V_LOC, W_LOC) for bcs in walls]


def k6_value_fields(kind, topology, dtype, size=(67, 45, 29)):
    """A group at a size off K6's blocks, with a stretched z, every
    location, and on every side of its bounded axes: gradient BCs (kind
    "gradient": scalar, plane and callable b in turn), plane-array values
    ("plane": value and open BCs) or callable values ("callable")."""
    k = np.arange(size[2] + 1)
    grid = RectilinearGrid(size=size, x=(0, 1), y=(0, 2),
                           z=-0.5 * (1.0 - k / size[2]) ** 1.5, topology=topology,
                           dtype=dtype, device=DEVICE, halo=(3, 3, 3))
    rng = np.random.default_rng(16)
    plane = lambda a: rng.standard_normal(tuple(n for i, n in enumerate(size) if i != a))

    def bc(i):
        if kind == "gradient":
            return (GradientBC(0.3), GradientBC(plane(i // 2)),
                    GradientBC(lambda p, q, t: p - 2.0 * q + t))[i % 3]
        kind_bc = ValueBC if i % 2 == 0 else OpenBC
        if kind == "plane":
            return kind_bc(plane(i // 2))
        return kind_bc(lambda p, q, t: p * q + 0.5 * p + t)
    sides = ("west", "east", "south", "north", "bottom", "top")
    bcs = FieldBCs(**{s: bc(i) for i, s in enumerate(sides)
                      if grid.topology[i // 2] is BOUNDED})
    return grid, [(grid.total_shape, loc, regularize_bcs(grid, loc, bcs), (0, 1, 2))
                  for loc in (CENTER, U_LOC, V_LOC, W_LOC)]


def phase_k6():
    """K6 against its plain version on every point, from NaN on every
    written point; returns (max_abs_err, ms, plain_ms, bound_ms, bound_by)
    of the ¼° fp32 first group (u, v, T, S, b and η: the hydrostatic
    path's first fill of a step), and prints the times of the 256³
    nonhydrostatic groups."""
    out = None
    for label, build in (("1/4 deg fp32", latlon_flagship),
                         ("128x96x16 fp64 bounded x and y", bounded_beta_model)):
        model = build()
        g = model.grid
        for part, group in zip(("u, v, T, S, b, eta", "w, pHY"),
                               hydro_fill_fields(model)):
            err, got, ref = hold_k6(f"K6 {label} {part}", g, group, 13)
            if out is None:
                ms = cuda_ms(lambda: fused_fill_halos(g, got), 20)
                plain_ms = cuda_ms(lambda: fused_fill_halos_reference(g, ref), 5)
                nbytes, points = fill_work(g, got)
                out = (err, ms, plain_ms, *bound(K6, nbytes, points))
                print(f"K6 {label} {part}: {points} halo points, "
                      f"{nbytes / 1e9:.4f} GB compulsory "
                      f"({nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
                for size in (32, 64):
                    read, wrote, total = fill_sectors(g, got, size)
                    moved = size * (read + wrote)
                    print(f"K6 {label} {part}: {size}-byte blocks {read} read, "
                          f"{wrote} written of {total} ({100 * read / total:.1f}% "
                          f"and {100 * wrote / total:.1f}%), {moved / 1e9:.4f} GB "
                          f"({moved / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s)")
                print(f"K6 {label} {part} time: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms (CUDA events); kernel alone "
                      f"{device_ms(lambda: fused_fill_halos(g, got), 20, 'fill_halos_kernel')}"
                      " ms (torch.profiler)")
            else:
                out = (max(out[0], err),) + out[1:]
            del got, ref
        del model
        torch.cuda.empty_cache()
    model = model_for(N, torch.float32, boundary_conditions=FLUX_WALLS,
                      timestepper="RungeKutta3")
    g = model.grid
    for part, group in zip(("u, v, w, b", "pNHS"), nonhydrostatic_fill_fields(model)):
        label = f"K6 {N}^3 fp32 nonhydrostatic {part}"
        err, got, ref = hold_k6(label, g, group, 14)
        out = (max(out[0], err),) + out[1:]
        ms = cuda_ms(lambda: fused_fill_halos(g, got), 20)
        plain_ms = cuda_ms(lambda: fused_fill_halos_reference(g, ref), 5)
        nbytes, points = fill_work(g, got)
        moved = [size * sum(fill_sectors(g, got, size)[:2]) for size in (32, 64)]
        alone = device_ms(lambda: fused_fill_halos(g, got), 20, "fill_halos_kernel")
        print(f"{label} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA "
              f"events), kernel alone {alone} ms (torch.profiler); {points} halo "
              f"points, bound {bound(K6, nbytes, points)[0]:.4f} ms; 32- and "
              f"64-byte blocks moved {moved[0] / HBM_BYTES_PER_S * 1e3:.4f} and "
              f"{moved[1] / HBM_BYTES_PER_S * 1e3:.4f} ms")
        del got, ref
    del model
    torch.cuda.empty_cache()
    grid, group = bounded_fill_fields()
    err, _, _ = hold_k6(f"K6 {'x'.join(map(str, grid.shape))} fp64 (Bounded, "
                        f"Periodic, Bounded), value, open and flux walls, "
                        f"{len(group)} fields", grid, group, 15)
    out = (max(out[0], err),) + out[1:]
    for kind in ("gradient", "plane", "callable"):
        for topology in ((BOUNDED,) * 3, (PERIODIC, BOUNDED, BOUNDED)):
            for dtype in (torch.float64, torch.float32):
                grid, group = k6_value_fields(kind, topology, dtype)
                err, _, _ = hold_k6(
                    f"K6 {'x'.join(map(str, grid.shape))} {str(dtype)[6:]} "
                    f"{tuple(t.value for t in topology)}, stretched z, {kind} "
                    f"{'BCs' if kind == 'gradient' else 'values'} on every side, "
                    f"{len(group)} fields", grid, group, 17)
                out = (max(out[0], err),) + out[1:]
    # the langmuir path's groups: u, v, w, b with b's gradient wall (the
    # side table), then pHY'
    model = langmuir_model()
    g = model.grid
    for part, group in zip(("u, v, w, b (gradient bottom)", "pHY'"),
                           nonhydrostatic_fill_fields(model)):
        label = f"K6 {N}^3 fp32 langmuir {part}"
        err, got, ref = hold_k6(label, g, group, 18)
        out = (max(out[0], err),) + out[1:]
        ms = cuda_ms(lambda: fused_fill_halos(g, got), 20)
        alone = device_ms(lambda: fused_fill_halos(g, got), 20, "fill_halos_kernel")
        print(f"{label} time: kernel {ms:.4f} ms (CUDA events), kernel alone "
              f"{alone} ms (torch.profiler)")
        del got, ref
    del model
    torch.cuda.empty_cache()
    return out


def hydro_path_model(path):
    """The model and initial state of a ¼° path: the flagship (``path``
    "hydrostatic"), the flagship under wind ("hydrostatic wind"), a
    ``NEAR_GLOBAL`` or a ``SCHEME_PATHS`` path."""
    if path in NEAR_GLOBAL or path == "near-global UB5":
        model = near_global_model(path)
    elif path == "hydrostatic positive":
        model = latlon_flagship(tracer_advection=PositiveWENO5())
    else:
        model = latlon_flagship(wind=path == "hydrostatic wind")
    if model.fused_advance != FUSED_ADVANCE[path]:
        raise AssertionError(f"{path}: fused_advance is {model.fused_advance}")
    b = lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0
    if path == "near-global CATKE":
        state = ocean_state(model)
    elif path in ("near-global", "near-global WENO", "near-global UB5"):
        state = model.initial_state(b=b)  # bench_near_global.py's state
    elif path == "hydrostatic positive":
        rng = np.random.default_rng(0)
        gen = torch.Generator(device=DEVICE).manual_seed(18)
        g = model.grid
        noise = lambda: 1e-2 * torch.randn(g.shape, generator=gen, device=DEVICE)
        z = g.nodes(CENTER)[2]
        T = torch.broadcast_to(2.0 + 18.0 * torch.exp(z / 500.0), g.shape) + noise()
        state = model.initial_state(u=0.1 * rng.standard_normal(g.shape), b=b, T=T,
                                    S=35.0 + noise())
    else:
        rng = np.random.default_rng(0)
        state = model.initial_state(u=0.1 * rng.standard_normal(model.grid.shape), b=b)
    return model, state


def drive_hydrostatic(path, plain):
    """A ¼° path run (``hydro_path_model``) with K4a, K4b, K5, K6 (and T1)
    or (``plain``) their plain versions; returns (model, state, s per
    step, launches)."""
    model, state = hydro_path_model(path)
    kernels = hydrostatic.PLAIN if plain else None
    state, per_step, launches = run_steps(
        path, model, state,
        lambda s: model.step(s, HYDRO["dt"], kernels), HYDRO["warmup"],
        HYDRO["steps"], plain)
    return model, state, per_step, launches


def zero_at_solid_faces(path, model, state):
    """validation/near_global_lat_lon.py's check: u and v exactly zero at
    every solid face; returns the count of solid u and v faces."""
    imm = model.grid.immersed
    sol = state["solution"]
    for name, loc in (("u", U_LOC), ("v", V_LOC)):
        worst = float((sol[name] * imm.mask_for(loc)).abs().max())
        if worst != 0.0:
            raise AssertionError(f"{path}: max|{name}| at solid faces {worst:.3e}")
    return int(imm.solid_fcc.sum()) + int(imm.solid_cfc.sum())


def wind_tke(path, model, state):
    """The wind's TKE input: over the wet cells of the top layer, e under a
    wind stress |τx| > 1e-5 is above e where |τx| ≤ 1e-5 on average (the
    columns share T, S and so N²; only the surface TKE flux differs). The
    mean under the wind is printed beside its initial 1e-7: the JAX
    package's CATKE takes −Kᶜ N² explicitly and has no floor on e, so under
    this stratification at Δt = 600 s e falls below 0 in both packages."""
    g = model.grid
    tau = model.closure[1].surface_momentum_flux[0]
    k = g.Hz + g.Nz - 1
    top = state["solution"]["e"][:, :, k].double()
    wet = ~g.immersed.mask_for(CENTER)[:, :, k]
    wet[:g.Hx], wet[g.Hx + g.Nx:], wet[:, :g.Hy], wet[:, g.Hy + g.Ny:] = (
        False, False, False, False)
    windy, calm = wet & (tau.abs() > 1e-5), wet & (tau.abs() <= 1e-5)
    e_windy, e_calm = float(top[windy].mean()), float(top[calm].mean())
    if not e_windy > e_calm:
        raise AssertionError(f"{path}: the top layer's mean e under the wind "
                             f"{e_windy:.6e} is not above the calm cells' {e_calm:.6e}")
    print(f"{path}: the top layer's mean e over {int(windy.sum())} wet cells under "
          f"|tau_x| > 1e-5 is {e_windy:.6e} m^2/s^2 (initially {OCEAN['e']}), "
          f"above the {int(calm.sum())} calm cells' {e_calm:.6e}")


def eta_balance(path, model, state):
    """The free surface's volume check: |Σ η Az| ≤ 1e-5 Σ |η| Az over the
    interior columns; returns (Σ η Az, Σ |η| Az)."""
    g = model.grid
    cut = lambda a: a[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny, 0].double()
    eta, az = cut(state["eta"]), cut(torch.broadcast_to(g.Az(ETA_LOC), state["eta"].shape))
    net, gross = float((eta * az).sum()), float((eta.abs() * az).sum())
    if not abs(net) <= 1e-5 * gross:
        raise AssertionError(f"{path}: |sum(eta Az)| {abs(net):.3e} > "
                             f"1e-5 sum(|eta| Az) = {1e-5 * gross:.3e}")
    return net, gross


def phase_hydrostatic(path="hydrostatic"):
    """A ¼° hydrostatic path (``path`` "hydrostatic", "hydrostatic wind", a
    ``NEAR_GLOBAL`` or a ``SCHEME_PATHS`` one) with the kernels, checked,
    then with their plain versions; returns the kernel run's launch
    counts, K4b's and its plain version's ms on the path's fields (ms None
    where K4b runs in its tendency form) and K4b's reading there (a form
    record: its hold, times, bound and launches on the path)."""
    model, state, per_step, launches = drive_hydrostatic(path, plain=False)
    check_finite(path, model, state, ("w", "pHY", "eta"))
    g = model.grid
    if model.immersed_boundary is not None:
        faces = zero_at_solid_faces(path, model, state)
        print(f"{path} path: u and v exactly 0 at all {faces} solid faces")
    cut = lambda a: a[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny, 0].double()
    net, gross = eta_balance(path, model, state)
    points = g.Nx * g.Ny * g.Nz
    used = {k: n for k, n in launches.items() if n}
    steps = HYDRO["warmup"] + HYDRO["steps"]
    print(f"{path} path: 1/4 deg {g.Nx}x{g.Ny}x{g.Nz} fp32, "
          f"{HYDRO['steps']} steps: {per_step * 1e3:.3f} ms/step, "
          f"{points / per_step:.6e} grid points/s, launches {used} in {steps} "
          f"steps, |sum(eta Az)|/sum(|eta| Az) {abs(net) / gross:.3e}")
    if path == "near-global CATKE":
        wind_tke(path, model, state)
        print(f"{path} path: {per_step * 1e3:.3f} ms/step, "
              f"{points / per_step / 1e6:.3f} M points/s on {card_line()}")
    if path == "hydrostatic positive":
        sol = state["solution"]
        mins = {n: float(g.interior(sol[n]).min()) for n in ("T", "S", "b")}
        # a reading, not a gate: the limiter bounds each flux, but
        # quasi-AB2 is not strong-stability-preserving
        print(f"{path} path: after {steps} steps min T {mins['T']:.6e}, min S "
              f"{mins['S']:.6e}, min b {mins['b']:.6e}")
    if path in SCHEME_PATHS:
        print(f"{path} path: {per_step * 1e3:.3f} ms/step, "
              f"{points / per_step / 1e6:.3f} M points/s, launches a step "
              f"{ {k: n // steps for k, n in used.items()} } on {card_line()}")
    # K4b on the path's own fields (T = S = 0, b linear in z), where the
    # random fields of phase 11 are not: the form the path runs
    adv = (HYDRO["dt"], False) if FUSED_ADVANCE[path] else None
    form = "tendencies" if adv is None else "advance"
    got = fused_hydrostatic_tendencies(model, state, adv)
    ref = fused_hydrostatic_tendencies_reference(model, state, adv)
    got, ref = (({"G": got}, {"G": ref}) if adv is None else
                ({"psi'": got[0], "G": got[1]}, {"psi'": ref[0], "G": ref[1]}))
    err = hold(f"K4b 1/4 deg fp32 {form} on the {path} path's fields", got, ref,
               torch.float32, g.interior, exact=True)
    b_ms, b_by = k4b_bound(model, state, [t for o in got.values() for t in o.values()],
                           adv is not None)
    del got, ref
    ms = cuda_ms(lambda: fused_hydrostatic_tendencies(model, state, adv), 10)
    plain_ms = cuda_ms(lambda: fused_hydrostatic_tendencies_reference(
        model, state, adv), 2)
    print(f"K4b 1/4 deg fp32 {form} on the {path} path's fields time: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events), bound {b_ms:.4f} ms "
          f"({b_by})")
    reading = form_record(path, f"1/4 deg fp32 {form}, {PATH_SCHEMES.get(path, '')}"
                          .rstrip(", "), err, ms, plain_ms, b_ms, b_by,
                          launches[K4B])
    kernel_u = {k: g.interior(a).clone() for k, a in state["solution"].items()}
    kernel_eta = cut(state["eta"]).clone()
    del state
    torch.cuda.empty_cache()
    model, state, plain_step, _ = drive_hydrostatic(path, plain=True)
    worst = agreement(path, steps, kernel_u, model, state)
    eta_rel = (float((kernel_eta - cut(state["eta"])).abs().max())
               / float(cut(state["eta"]).abs().max()))
    if not eta_rel <= AGREE[path]:
        raise AssertionError(f"{path}: kernel and plain runs differ by "
                             f"{eta_rel:.3e} of max|eta|")
    print(f"{path} path: plain versions: {plain_step * 1e3:.3f} ms/step, "
          f"{points / plain_step:.6e} grid points/s; kernel and plain runs "
          f"agree to {max(worst, eta_rel):.3e} of max|field| (eta included)")
    del model, state, kernel_u
    torch.cuda.empty_cache()
    return launches, (None if adv is None else ms), plain_ms, reading


#: the forced hold: RK3 at 64³ fp32 on the examples' box, (Δt, steps)
FORCED = (1.0, 3)


def forced_model(n=64, background=False):
    """The forced hold's RK3 model on the examples' box at n³ fp32: a
    sponge Relaxation(1/60 s, GaussianMask(z = −28 m, 3 m), LinearTarget(N²
    z)) on b, a Forcing with a field dependency on u (a linear drag of
    1e-3/s) and tilted gravity ĝ = (sin 3°, 0, −cos 3°), as in
    examples/tilted_bottom_boundary_layer.py but on a (Periodic, Periodic,
    Bounded) grid (Flat axes are not ported). With ``background``,
    background fields of u (a shear) and b (N² z) instead: the JAX package
    runs their cross terms outside its kernels, and so does the port (its
    plain versions)."""
    N2, theta = LANGMUIR["N2"], math.radians(3.0)
    kw = (dict(background_fields={
              "u": BackgroundField(lambda x, y, z, t, s: s * (z + 16.0),
                                   parameters=1e-3),
              "b": lambda x, y, z, t: N2 * z + 0.0 * x * y})
          if background else
          dict(forcing={"b": Relaxation(rate=1 / 60, mask=GaussianMask(
                            center=-28.0, width=3.0), target=LinearTarget(gradient=N2)),
                        "u": Forcing(lambda x, y, z, t, u, r: -r * u,
                                     parameters=1e-3, field_dependencies="u")}))
    gravity = (0.0, 0.0, -1.0) if background else (math.sin(theta), 0.0,
                                                   -math.cos(theta))
    return NonhydrostaticModel(
        surface_grid(n), advection=WENO5(), timestepper="RungeKutta3",
        buoyancy=BuoyancyTracer(gravity_unit_vector=gravity),
        coriolis=FPlane(f=1e-4), closure=ScalarDiffusivity(nu=1e-5, kappa=1e-5),
        **kw)


def phase_forced():
    """The forced hold: its steps with K2 and K6 and with their plain
    versions, every field and pHY′, pNHS held bit for bit (these launches
    are a comparison's and go into no record); then the background-field
    model's steps the same way (the JAX package's branch, the cross terms
    as PyTorch ops, the kernels for the rest), finite."""
    dt, steps = FORCED
    out = {}
    for plain in (False, True):
        model = forced_model()
        if model.fused_advection is not True or model.fused_step:
            raise AssertionError("forced: the model should run K2 and K6, RK3")
        g = model.grid
        gen = torch.Generator(device=DEVICE).manual_seed(19)
        noise = lambda s: s * torch.randn(g.shape, generator=gen, dtype=g.dtype,
                                          device=DEVICE)
        zc = g.nodes(CENTER, with_halo=False)[2]
        state = model.initial_state(b=LANGMUIR["N2"] * zc + noise(1e-6),
                                    u=noise(1e-2), w=noise(1e-3))
        state, _, counts = run_steps(
            "forced", model, state,
            lambda s: model.step(s, dt, nonhydrostatic.PLAIN if plain else None),
            0, steps, plain)
        out[plain] = state
        launches = counts if not plain else launches
    got, ref = out[False], out[True]
    hold(f"forced hold 64^3 fp32, {steps} RK3 steps (sponge, drag, tilted gravity)",
         {"solution": got["solution"], "p": {"pHY": got["pHY"], "pNHS": got["pNHS"]}},
         {"solution": ref["solution"], "p": {"pHY": ref["pHY"], "pNHS": ref["pNHS"]}},
         torch.float32, exact=True)
    check_finite("forced", model, got, ("pHY", "pNHS"))
    used = {k: n for k, n in launches.items() if n}
    print(f"forced hold: kernel launches {used} in {steps} steps (the kernel run)")
    out = {}
    for plain in (False, True):
        model = forced_model(background=True)
        if model.fused_advection or model.kernels["advect"] is not fused_advective_tendencies:
            raise AssertionError("background fields: the model should take the JAX "
                                 "branch with the kernels")
        gen = torch.Generator(device=DEVICE).manual_seed(20)
        state = model.initial_state(u=1e-2 * torch.randn(
            model.grid.shape, generator=gen, device=DEVICE))
        out[plain], _, _ = run_steps(
            "background", model, state,
            lambda s: model.step(s, dt, nonhydrostatic.PLAIN if plain else None),
            0, steps, plain)
    got, ref = out[False], out[True]
    hold(f"background fields 64^3 fp32, {steps} RK3 steps",
         {"solution": got["solution"]}, {"solution": ref["solution"]}, torch.float32,
         exact=True)
    check_finite("background fields", model, got, ("pHY", "pNHS"))
    print(f"background fields: {steps} RK3 steps at 64^3 fp32, every field finite")
    del out, got, ref, model, state
    torch.cuda.empty_cache()


#: K1's and K2's holds on the wind-mixing example's stretched z (their
#: stretched and general instantiations): (size, dtype, momentum, tracer
#: scheme, tracers, closure, w walls, z); sizes off the 8×12×32 tiles,
#: WENO5 and centred tracers, horizontal-only diffusion (a vertically
#: implicit closure), w's top wall face (FluxBC w walls), the general
#: instantiation on a regular z, and the wind-mixing path's
#: UpwindBiasedFifthOrder with two tracers at 256³
STRETCHED_CASES = (
    ((N, N, N), torch.float32, WENO5, WENO5, 0, "implicit", None, "stretched"),
    ((64, 64, 64), torch.float64, WENO5, CenteredSecondOrder, 1, "implicit", None,
     "stretched"),
    ((100, 77, 45), torch.float32, WENO5, WENO5, 1, "explicit", "flux", "stretched"),
    ((72, 40, 36), torch.float64, CenteredSecondOrder, WENO5, 2, None, "flux",
     "stretched"),
    ((64, 64, 64), torch.float32, WENO5, WENO5, 0, "implicit", None, "regular"),
    ((N, N, N), torch.float32, UpwindBiasedFifthOrder, UpwindBiasedFifthOrder, 2,
     "explicit", None, "stretched"),
)


def stretched_case_model(size, dtype, momentum, tracer_scheme, ntracers, closure,
                         walls, z):
    closure = {"implicit": ScalarDiffusivity(**IMPLICIT),
               "explicit": ScalarDiffusivity(nu=1e-5, kappa=1e-5), None: None}[closure]
    bcs = {"w": FieldBCs(bottom=FluxBC(), top=FluxBC())} if walls else None
    return NonhydrostaticModel(
        surface_grid(size, dtype, stretched=z == "stretched"), advection=momentum(),
        tracer_advection=tracer_scheme(), buoyancy=BuoyancyTracer(),
        tracers=tuple(f"c{i}" for i in range(ntracers)), closure=closure,
        boundary_conditions=bcs)


def phase_stretched():
    """K1 and K2 on a stretched z (and K1's general instantiation on a
    regular one) against their plain versions, bit for bit over NaN-filled
    outputs; their times at 256³ fp32 beside the regular ones of phases 3
    and 4. Returns (max_abs_err of K1, of K2)."""
    w1 = w2 = 0.0
    for case in STRETCHED_CASES:
        size, dtype, momentum, tracer_scheme, nt, closure, walls, z = case
        model = stretched_case_model(*case)
        if not (model.fused_step and general_route(model)):
            raise AssertionError(f"stretched case {case}: the model does not take "
                                 "K1's general route")
        label = (f"{'x'.join(map(str, size))} {str(dtype)[6:]} {z} z, "
                 f"{momentum.__name__}/{tracer_scheme.__name__}, closure {closure}"
                 + (", w's top face" if w_top(model) else ""))
        state = random_state(model, 11)
        poison_cache(model.grid.total_shape, dtype, 12)
        w1 = max(w1, hold_k1(f"K1 {label}", model, state, dt=0.5)[2])
        sol = state["solution"]
        args = (model.grid, model.advection, model.tracer_advection, sol["u"],
                sol["v"], sol["w"], {n: sol[n] for n in model.tracer_names})
        poison_cache(model.grid.total_shape, dtype, 12)
        w2 = max(w2, hold_k2(f"K2 {label}", args, dtype))
        if size == (N, N, N) and momentum is WENO5:
            k1 = lambda: fused_ab2_advance(model, state, 0.5, False)
            k1_plain = lambda: fused_ab2_advance_reference(model, state, 0.5, False)
            k2 = lambda: fused_advective_tendencies(*args)
            k2_plain = lambda: fused_advective_tendencies_reference(*args)
            print(f"K1 stretched {N}^3 fp32 ab2 time (general instantiation, "
                  f"horizontal-only diffusion): kernel {cuda_ms(k1, 20):.4f} ms, plain "
                  f"{cuda_ms(k1_plain, 3):.4f} ms (CUDA events); kernel alone "
                  f"{device_ms(k1, 20, 'fused_ab2_advance')} ms (torch.profiler)")
            print(f"K2 stretched {N}^3 fp32 WENO5/WENO5 time: kernel "
                  f"{cuda_ms(k2, 20):.4f} ms, plain {cuda_ms(k2_plain, 3):.4f} ms "
                  f"(CUDA events); kernel alone "
                  f"{device_ms(k2, 20, 'fused_advective_tendencies')} ms (torch.profiler)")
        del model, state, sol, args
        torch.cuda.empty_cache()
    return w1, w2


def hold_t1(label, call, plain, dtype):
    """T1 against its plain version, bit for bit over NaN-filled outputs;
    returns max|Δ|."""
    ref = plain()
    poison_cache(ref.shape, ref.dtype, 8)
    got = call()
    torch.cuda.synchronize()
    part = (lambda x: torch.view_as_real(x)) if got.is_complex() else (lambda x: x)
    return hold(label, {"phi": {"phi": part(got)}}, {"phi": {"phi": part(ref)}},
                dtype, exact=True)


def fourier_args(grid, seed, m=0.0):
    """T1's Fourier-mode arguments for ``grid``'s Fourier-tridiagonal solve:
    the solver's eigenvalues (x the real-FFT axis) and bands, a random
    complex spectrum of the shape the solve hands over."""
    solver = FourierTridiagonalSolver.build(grid)
    nxr = grid.Nx // 2 + 1
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ctype = torch.complex64 if grid.dtype == torch.float32 else torch.complex128
    b = torch.randn((nxr, grid.Ny, grid.Nz), generator=gen, dtype=ctype, device=DEVICE)
    return (solver.lam_x[:nxr].contiguous(), solver.lam_y, m, solver.lower,
            solver.upper, solver.dzc, b, m == 0.0)


def t1_forms():
    """T1's forms at the shapes its paths give it, built one at a time:
    dicts of part, shape, the kernel's call, its plain version's, the
    compulsory bytes (d read and φ written once, 3D bands read once) and
    points. "Fourier": the 256³ wind-mixing grid's pressure solve
    (129×256×256 complex64, the pin); "implicit 1D" and "implicit 3D": the
    implicit step's solve on that grid, 262×262×256 fp32, with 1D bands (a
    scalar κ) or 3D ones; "1/4 deg implicit 1D": the ¼° grid's,
    1446×606×24 fp32. The implicit forms read d as a view of a with-halo
    field's interior levels and write a view of a NaN-filled with-halo
    field (``view`` holds it), as the implicit step does; "1/4 deg implicit
    3D": the near-global CATKE path's solves, its ¼° grid (at the halo its
    model takes) with CATKE's 3D bands. Also the launcher's ``plan`` of the
    form."""
    from clima_oceananigans_jl_torch.solvers import tridiagonal as tt

    grid = surface_grid(N, torch.float32, stretched=True)
    args = fourier_args(grid, 21)
    b = args[6]
    yield dict(part="Fourier", shape="x".join(map(str, b.shape)) + " complex64",
               call=lambda: fourier_tridiagonal(*args),
               plain=lambda: fourier_tridiagonal_reference(*args), view=None,
               nbytes=2 * tensor_bytes([b]), points=2 * b.numel(),
               plan=lambda: tt.plan(b.shape[2], 2, torch.float32, False, True))
    del args, b
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    quarter = latlon_grid()
    for part, g, bands3d in (("implicit 1D", grid, False), ("implicit 3D", grid, True),
                             ("1/4 deg implicit 1D", quarter, False),
                             ("1/4 deg implicit 3D", quarter.with_halo(ocean_halo()), True)):
        total, h, nz = g.total_shape, g.Hz, g.Nz
        cols = tuple(total[:2])
        data = torch.randn(total, generator=gen, device=DEVICE)
        lo = -0.5 * torch.rand(cols + (nz,) if bands3d else (nz,), generator=gen,
                               device=DEVICE)
        up = -0.5 * torch.rand(lo.shape, generator=gen, device=DEVICE)
        bands = (lo, 1.0 - lo - up, up)
        d = data[:, :, h:h + nz]
        full = torch.full(total, float("nan"), device=DEVICE)
        out = full[:, :, h:h + nz]
        yield dict(part=part, shape=f"{total[0]}x{total[1]}x{nz} fp32",
                   call=lambda bands=bands, d=d, out=out:
                   solve_batched_tridiagonal(*bands, d, out=out),
                   plain=lambda bands=bands, d=d: solve_batched_tridiagonal_reference(*bands, d),
                   view=(full, h, nz), points=d.numel(),
                   nbytes=2 * tensor_bytes([d]) + (tensor_bytes(bands) if bands3d else 0),
                   plan=lambda nz=nz, bands3d=bands3d: tt.plan(nz, 1, torch.float32, bands3d))
        del data, lo, up, bands, d, full, out


def phase_t1():
    """T1 against its plain version bit for bit: every form of
    ``t1_forms`` (the implicit forms through views, the halos of the
    output's with-halo field still NaN after the call), 67×45×29 fp64 in
    the Fourier mode (with and without the pin), and the implicit step at
    256³ fp32 (a scalar κ: 1D bands; AMD's 3D κ with Value and Gradient
    walls on a centred field, and on w), which hands T1 views. Each form
    timed (CUDA events, and alone by torch.profiler) against its bound.
    Returns ((max_abs_err, ms, plain_ms, bound_ms, bound_by) of the
    Fourier form, a reading of each form: part, shape, max_abs_err, ms,
    plain_ms, bound_ms, bound_by)."""
    worst, readings = 0.0, []
    for f in t1_forms():
        err = hold_t1(f"T1 {f['part']} {f['shape']}", f["call"], f["plain"],
                      torch.float32)
        if f["view"] is not None:
            full, h, nz = f["view"]
            if not (full[:, :, :h].isnan().all() and full[:, :, h + nz:].isnan().all()):
                raise AssertionError(f"T1 {f['part']}: a halo point of out was written")
        worst = max(worst, err)
        ms = cuda_ms(f["call"], 20)
        plain_ms = cuda_ms(f["plain"], 2)
        alone = device_ms(f["call"], 20, "tridiagonal")
        b_ms, b_by = bound(T1, f["nbytes"], f["points"])
        print(f"T1 {f['part']} {f['shape']} time: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (CUDA events); kernel alone {alone} ms "
              f"(torch.profiler); bound {b_ms:.4f} ms ({b_by})")
        readings.append({"part": f["part"], "shape": f["shape"], "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by})
        del f
        torch.cuda.empty_cache()
    small = surface_grid((67, 45, 29), torch.float64, stretched=True)
    for m in (0.0, -0.5):
        a = fourier_args(small, 22, m)
        worst = max(worst, hold_t1(f"T1 Fourier 67x45x29 fp64, m = {m}",
                                   lambda: fourier_tridiagonal(*a),
                                   lambda: fourier_tridiagonal_reference(*a),
                                   torch.float64))
    # the implicit step's bands at 256³ fp32, AMD's κ from random velocities
    model = wind_mixing_model(stretched=True)
    state = random_state(model, 24)
    g = model.grid
    nu = state["diffusivities"]["nu_e"]
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    data = torch.randn(g.total_shape, generator=gen, dtype=g.dtype, device=DEVICE)
    for what, loc, kappa, bot, top in (
            ("scalar kappa (1D bands), centred", CENTER, 1e-5, None, None),
            ("AMD kappa (3D bands), centred, Value/Gradient walls", CENTER, nu,
             ValueBC(20.0), GradientBC(0.01)),
            ("AMD kappa (3D bands), w", W_LOC, nu, None, None)):
        step = lambda solve: implicit_vertical_diffusion_step(
            data, g, loc, kappa, 0.5, bc_bottom=bot, bc_top=top, solve=solve)
        worst = max(worst, hold_t1(f"T1 implicit step {N}^3 fp32, {what}",
                                   lambda: step(solve_batched_tridiagonal),
                                   lambda: step(solve_batched_tridiagonal_reference),
                                   torch.float32))
    step_ms = cuda_ms(lambda: implicit_vertical_diffusion_step(data, g, CENTER, 1e-5, 0.5), 10)
    print(f"T1 implicit step {N}^3 fp32, scalar kappa: the whole step (bands, the "
          f"field's copy, T1 on views) {step_ms:.4f} ms (CUDA events)")
    del model, state, nu, data
    torch.cuda.empty_cache()
    first = readings[0]
    return ((worst, first["ms"], first["plain_ms"], first["bound_ms"], first["bound_by"]),
            readings)


# -- walls and Flat axes ----------------------------------------------------------

#: the Flat and bounded holds: topology and size, off the kernels' tiles
FLAT_BOUNDED = {
    "P,F,B": ((PERIODIC, FLAT, BOUNDED), (1000, 1, 333)),
    "B,F,B": ((BOUNDED, FLAT, BOUNDED), (777, 1, 129)),
    "P,P,F": ((PERIODIC, PERIODIC, FLAT), (1024, 1000, 1)),
    "F,F,B": ((FLAT, FLAT, BOUNDED), (1, 1, 1000)),
    "F,P,B": ((FLAT, PERIODIC, BOUNDED), (1, 1000, 333)),
    "P,B,B": ((PERIODIC, BOUNDED, BOUNDED), (100, 77, 45)),
    "B,B,B": ((BOUNDED, BOUNDED, BOUNDED), (67, 45, 29)),
}
#: the topologies K1 takes among them (a Flat z, a Flat x: the JAX gate
#: sends a bounded x or y and a Flat y to the general branch)
K1_FLAT = ("P,P,F", "F,P,B")
SCHEMES = (WENO5, UpwindBiasedFifthOrder, CenteredSecondOrder)
#: the walls-and-Flat paths: (warm-up steps, timed steps); Δt is set from
#: the initial state (``wall_path_model``)
WALLS = {"horizontal convection": (2, 5), "2D turbulence": (2, 3)}
#: the geometry and schemes of each path whose K2, K3b and K3c readings go
#: into the records' ``forms``
PATH_FORMS = {"horizontal convection": "B,F,B 4096x1x2048 fp32, WENO5",
              "2D turbulence": "P,P,F 8192x8192x1 fp32, UB5",
              "seamount": "P,F,B 4096x1x2048 fp64, immersed bottom, WENO5 / "
                          "PositiveWENO5 b, c",
              "internal wave": "P,F,P 4096x1x4096 fp64, C4"}
HC = dict(size=(4096, 1, 2048), Lx=2.0, H=1.0, b_star=1.0, Ra=1e8, Pr=1.0)
#: each wall path's bare ``model.step`` ms/step with the kernels, from its run
BARE_STEP_MS = {}
TURBULENCE = dict(size=(8192, 8192, 1), nu=1e-5, kmin=2, kmax=6, speed=0.5,
                  seed=7)


def flat_grid(topology, size, dtype):
    return RectilinearGrid(size=size, x=(0.0, 1.3), y=(0.0, 0.7), z=(-0.9, 0.0),
                           topology=topology, dtype=dtype, device=DEVICE)


def hold_k3bc(label, grid, u, v, w, p):
    """K3b bit for bit, K3c on the interior with its halos exactly 0 (over
    NaN-filled memory); returns (K3b's, K3c's) max|Δ|."""
    poison_cache(grid.shape, grid.dtype, 2)
    e_b = hold(f"{K3B} {label}", {"out": {0: fused_divergence(grid, u, v, w)}},
               {"out": {0: fused_divergence_reference(grid, u, v, w)}}, grid.dtype,
               exact=True)
    return e_b, hold_k3c(f"{K3C} {label}", grid, p)


def phase_flat_bounded():
    """K2, K3b and K3c on every topology of ``FLAT_BOUNDED`` and K1 on
    ``K1_FLAT``, bit for bit against their plain versions over NaN-filled
    outputs; returns the largest max|Δ| of each kernel and K1's Flat-z
    (max|Δ|, ms, plain_ms, bound_ms, bound_by) at 1024×1000×1 fp32."""
    worst = {K1: 0.0, K2: 0.0, K3B: 0.0, K3C: 0.0}
    k1_form = None
    for name, (topology, size) in FLAT_BOUNDED.items():
        for dtype in (torch.float32, torch.float64):
            grid = flat_grid(topology, size, dtype)
            tag = f"{name} {'x'.join(map(str, size))} {str(dtype)[6:]}"
            for scheme in SCHEMES:
                for kind in ("random", "zero"):
                    grid_s = grid.with_halo((1 if scheme is CenteredSecondOrder
                                             else 3,) * 3)
                    args = k2_args(grid_s, scheme, scheme, 1, kind)
                    poison_cache(grid_s.total_shape, dtype, 6)
                    worst[K2] = max(worst[K2], hold_k2(
                        f"K2 {scheme.__name__} {tag} {kind}", args, dtype))
                    del args
            gen = torch.Generator(device=DEVICE).manual_seed(5)
            u, v, w, p = (torch.randn(grid.total_shape, generator=gen, dtype=dtype,
                                      device=DEVICE) for _ in range(4))
            e_b, e_c = hold_k3bc(tag, grid, u, v, w, p)
            worst[K3B], worst[K3C] = max(worst[K3B], e_b), max(worst[K3C], e_c)
            del u, v, w, p
            if name in K1_FLAT:
                for scheme in SCHEMES:
                    kw = (dict(tracers=("c",)) if name == "P,P,F"
                          else dict(buoyancy=BuoyancyTracer()))
                    model = NonhydrostaticModel(
                        grid, advection=scheme(), coriolis=FPlane(f=0.3),
                        closure=ScalarDiffusivity(nu=1e-3, kappa=2e-3), **kw)
                    if not (model.fused_step and general_route(model)):
                        raise AssertionError(f"K1 {tag}: the model does not take K1")
                    state = random_state(model, 1)
                    poison_cache(model.grid.total_shape, dtype, 8)
                    psi_k, g_k, err = hold_k1(f"K1 {scheme.__name__} {tag}", model, state)
                    worst[K1] = max(worst[K1], err)
                    if (name == "P,P,F" and dtype == torch.float32
                            and scheme is UpwindBiasedFifthOrder):
                        ms = cuda_ms(lambda: fused_ab2_advance(model, state, 1e-4, False), 20)
                        plain_ms = cuda_ms(lambda: fused_ab2_advance_reference(
                            model, state, 1e-4, False), 3)
                        nb = tensor_bytes(state["solution"].values(),
                                          state["G_prev"].values(), psi_k.values(),
                                          g_k.values())
                        k1_form = (err, ms, plain_ms,
                                   *bound(K1, nb, math.prod(size), flops=2 * 820 // 3))
                        print(f"K1 UB5 {tag} ab2 time: kernel {ms:.4f} ms, plain "
                              f"{plain_ms:.4f} ms (CUDA events)")
                    del model, state, psi_k, g_k
            del grid
            torch.cuda.empty_cache()
    return worst, k1_form


def hc_model():
    """examples/horizontal_convection.py at ``HC["size"]`` fp32."""
    c = HC
    nu = math.sqrt(c["Pr"] * c["b_star"] * c["Lx"] ** 3 / c["Ra"])
    grid = RectilinearGrid(size=c["size"], x=(-c["Lx"] / 2, c["Lx"] / 2), y=(0, 1),
                           z=(-c["H"], 0), topology=(BOUNDED, FLAT, BOUNDED),
                           dtype=torch.float32, device=DEVICE)
    b_top = ValueBC(lambda x, y, t: -c["b_star"] * torch.cos(2 * math.pi * x / c["Lx"]))
    return NonhydrostaticModel(grid, advection=WENO5(), timestepper="RungeKutta3",
                               buoyancy=BuoyancyTracer(),
                               closure=ScalarDiffusivity(nu=nu, kappa=nu / c["Pr"]),
                               boundary_conditions={"b": FieldBCs(top=b_top)})


def turbulence_model():
    """examples/two_dimensional_turbulence.py at ``TURBULENCE["size"]`` fp32."""
    grid = RectilinearGrid(size=TURBULENCE["size"], x=(0, 2 * math.pi),
                           y=(0, 2 * math.pi), topology=(PERIODIC, PERIODIC, FLAT),
                           dtype=torch.float32, device=DEVICE)
    return NonhydrostaticModel(grid, timestepper="RungeKutta3",
                               advection=UpwindBiasedFifthOrder(),
                               closure=ScalarDiffusivity(nu=TURBULENCE["nu"]))


def turbulence_state(model):
    """The example's band-limited flow: ψ = Σ cos(k·x + φ)/|k|² over
    2 ≤ |k| ≤ 6 with phases from a seeded numpy generator, u = −∂ψ/∂y and
    v = ∂ψ/∂x (the example's np.gradient, taken exactly), scaled to
    max(|u|, |v|) = 0.5; summed on the card in fp64."""
    c = TURBULENCE
    rng = np.random.default_rng(c["seed"])
    x, y, _ = model.grid.nodes(CENTER)
    x, y = x.double(), y.double()
    u = torch.zeros(model.grid.shape[:2], dtype=torch.float64, device=DEVICE)
    v = torch.zeros_like(u)
    for kx in range(-c["kmax"], c["kmax"] + 1):
        for ky in range(-c["kmax"], c["kmax"] + 1):
            kk = math.hypot(kx, ky)
            if not c["kmin"] <= kk <= c["kmax"]:
                continue
            phase = rng.uniform(0, 2 * math.pi)
            s = torch.sin(kx * x[:, :, 0] + ky * y[:, :, 0] + phase) / kk ** 2
            u += ky * s
            v -= kx * s
    scale = c["speed"] / max(float(u.abs().max()), float(v.abs().max()))
    return model.initial_state(u=(scale * u)[:, :, None], v=(scale * v)[:, :, None])


def wall_path_model(path):
    """The path's model, initial state and Δt: CFL 0.5 on the initial
    velocities, and half the explicit diffusive limit Δ²/(2dκ) (d the
    axes that are not Flat; at 4096×1×2048 it sets horizontal
    convection's Δt)."""
    if path == "horizontal convection":
        model = hc_model()
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        noise = lambda: 1e-3 * torch.randn(model.grid.shape, generator=gen,
                                           dtype=model.grid.dtype, device=DEVICE)
        state = model.initial_state(u=noise(), w=noise(), b=noise())
    else:
        model = turbulence_model()
        state = turbulence_state(model)
    g = model.grid
    umax = max(float(g.interior(state["solution"][n]).abs().max()) for n in "uvw")
    d = sum(t is not FLAT for t in g.topology)
    dt = min(0.5 * g.min_spacing() / umax,
             0.5 * model.cell_diffusion_timescale(state) / (2 * d))
    return model, state, dt


def drive_wall_path(path, plain):
    model, state, dt = wall_path_model(path)
    if model.kernels["fill"] is not fused_fill_halos:
        raise AssertionError(f"{path}: fills take {model.kernels['fill']}, not K6")
    warmup, steps = WALLS[path]
    state, per_step, launches = run_steps(
        path, model, state, lambda s: model.step(s, dt, nonhydrostatic.PLAIN if plain else None),
        warmup, steps, plain)
    return model, state, dt, per_step, launches


def flat_divergence_ratio(model, state):
    """max|∇·u|·Δx_min/max|u| over the interior (div_ccc of the filled
    velocities: a Flat axis adds +0)."""
    g = model.grid
    sol = state["solution"]
    div = fused_divergence_reference(g, sol["u"], sol["v"], sol["w"])
    umax = max(float(g.interior(sol[n]).abs().max()) for n in "uvw")
    return float(div.abs().max()) * g.min_spacing() / umax


#: K2's operations a transport by scheme: WENO5's stream ~64 (``FLOPS[K2]``
#: counts four fields of it on three axes), BoundsPreservingWENO5's with its
#: clip ~68, UB5's two-sided form ~40, UB3's ~20 (two 3-point sides with
#: their divisions, the upwind product), UB1's product ~8, C4's 4-point
#: interpolation ~8, the centred mean ~4, PositiveWENO5's ~150 (L and R at
#: the face with shared differences ~110, theta of a cell ~20, the limited
#: pair and the product); an immersed grid adds its flag's test and select
#: (~2)
K2_TRANSPORT = {WENO5: 64, UpwindBiasedFifthOrder: 40, CenteredSecondOrder: 4,
                PositiveWENO5: 150, BoundsPreservingWENO5: 68,
                UpwindBiasedThirdOrder: 20, UpwindBiasedFirstOrder: 8,
                CenteredFourthOrder: 8}
#: the WENO5 family's reconstruction under each bf16 option (``bf16_mode``:
#: 2 fast_bf16, 1 bf16_smoothness) as (operations in T, operations in
#: bf16), each bf16 operation and each cast counted once: under fast_bf16
#: the stream's ~64 and its six casts (five in, one back) are all bf16;
#: under bf16_smoothness the first differences, the candidates, num, den
#: and their quotient stay in T (~25), the four casts in, the second
#: differences, s, the βs, the weights' products and the three casts back
#: are bf16 (~42); PositiveWENO5's L and R at a face twice as many
BF16_SPLIT = {2: ((0, 70), (0, 140)), 1: ((25, 42), (50, 84))}
#: the operations of that reconstruction in ``K2_TRANSPORT`` (WENO5's
#: stream; PositiveWENO5's L and R)
BF16_REPLACES = (64, 110)
#: the card's bf16 rate outside the tensor cores over its fp32 rate (packed
#: bf16x2 instructions: 133.8 against 66.9 TFLOP/s in NVIDIA's H100 SXM
#: white paper)
BF16_SPEEDUP = 2


def transport_ops(scheme, dtype):
    """``K2_TRANSPORT`` of the scheme in fp32-rate operations: under a bf16
    option its reconstruction's bf16 operations count at the bf16 rate
    (``BF16_SPLIT``; bf16_smoothness does nothing to fp64 data)."""
    mode = bf16_mode(scheme)
    if mode == 1 and dtype != torch.float32:
        mode = 0
    ops = K2_TRANSPORT[type(scheme)]
    if mode:
        pw = isinstance(scheme, PositiveWENO5)
        in_t, in_bf16 = BF16_SPLIT[mode][pw]
        ops += in_t + in_bf16 / BF16_SPEEDUP - BF16_REPLACES[pw]
    return ops


def k2_flops(grid, scheme, tracer_scheme, ntracers):
    """K2's operations a point: each field's transports on the axes that
    are not Flat, by scheme (``transport_ops``; +2 each over an immersed
    bottom), and ~8 for each field's divergence."""
    imm = 2 if getattr(grid, "immersed", None) is not None else 0
    axes = sum(t is not FLAT for t in grid.topology)
    nf = 3 + ntracers
    ops = lambda s: transport_ops(s, grid.dtype) + imm
    return (3 * ops(scheme) + ntracers * ops(tracer_scheme)) * axes + 8 * nf


def k2_bound(args):
    """K2's bound on its arguments: each field read once and its tendency
    written once, and the clear flags it reads over an immersed bottom."""
    grid, scheme, tracer_scheme, u, v, w, tracers = args
    flags = k2_clear_flags(grid, scheme, tracer_scheme, len(tracers)) or []
    nbytes = (2 * tensor_bytes([u, v, w], tracers.values())
              + tensor_bytes([f for f in flags if f is not None]))
    return bound(K2, nbytes, math.prod(grid.shape),
                 flops=k2_flops(grid, scheme, tracer_scheme, len(tracers)))


def wall_path_kernels(path, model, state):
    """K2 on the path's fields, K3b and K3c on its velocities and pNHS,
    held bit for bit and timed; returns {kernel: (max|Δ|, ms, plain_ms,
    bound_ms, bound_by)}."""
    g, sol = model.grid, state["solution"]
    tracers = {n: sol[n] for n in model.tracer_names}
    args = (g, model.advection, model.tracer_advection, sol["u"], sol["v"],
            sol["w"], tracers)
    poison_cache(g.total_shape, g.dtype, 6)
    err = hold_k2(f"K2 on the {path} path's fields", args, g.dtype)
    ms = cuda_ms(lambda: fused_advective_tendencies(*args), 10)
    plain_ms = cuda_ms(lambda: fused_advective_tendencies_reference(*args), 2)
    out = {K2: (err, ms, plain_ms, *k2_bound(args))}
    u, v, w, p = sol["u"], sol["v"], sol["w"], state["pNHS"]
    e_b, e_c = hold_k3bc(f"on the {path} path's fields", g, u, v, w, p)
    for name, fn, ref, a, nb, e in (
            (K3B, fused_divergence, fused_divergence_reference, (g, u, v, w),
             tensor_bytes([u, v, w]) + math.prod(g.shape) * u.element_size(), e_b),
            (K3C, fused_pressure_gradient, fused_pressure_gradient_reference, (g, p),
             4 * tensor_bytes([p]), e_c)):
        kms, kplain = cuda_ms(lambda: fn(*a), 10), cuda_ms(lambda: ref(*a), 2)
        out[name] = (e, kms, kplain, *bound(name, nb, math.prod(g.shape)))
    for name, (e, kms, kplain, b_ms, by) in out.items():
        print(f"{name} on the {path} path's fields time: kernel {kms:.4f} ms, plain "
              f"{kplain:.4f} ms (CUDA events), bound {b_ms:.4f} ms ({by})")
    return out


def phase_wall_path(path):
    """One walls-and-Flat path with the kernels, checked, then with the
    plain versions; returns the kernel run's launch counts, its kernels'
    readings on the path's fields and K6's max|Δ| on its fill groups."""
    model, state, dt, per_step, launches = drive_wall_path(path, plain=False)
    check_finite(path, model, state, ("pNHS",) + (("pHY",) if model.buoyancy else ()))
    ratio = flat_divergence_ratio(model, state)
    if not ratio <= 1e-5:
        raise AssertionError(f"{path}: max|div u|*dx/max|u| = {ratio:.3e} > 1e-5")
    warmup, steps = WALLS[path]
    BARE_STEP_MS[path] = per_step * 1e3
    points = math.prod(model.grid.shape)
    used = {k: n for k, n in launches.items() if n}
    print(f"{path} path: {'x'.join(map(str, model.grid.shape))} fp32, {steps} steps "
          f"at dt {dt:.6e}: {per_step * 1e3:.3f} ms/step, {points / per_step:.6e} grid "
          f"points/s on {card_line()}; launches {used} in {warmup + steps} steps, "
          f"max|div u|*dx/max|u| {ratio:.3e}")
    if path == "horizontal convection":
        b = model.grid.interior(state["solution"]["b"])
        lo, hi = float(b.min()), float(b.max())
        if not (lo >= -1.001 * HC["b_star"] and hi <= 1.001 * HC["b_star"]):
            raise AssertionError(f"{path}: b in [{lo}, {hi}], outside ±1.001 b*")
        print(f"{path}: b in [{lo:.6f}, {hi:.6f}] (the maximum principle: ±1.001 b*)")
    readings = wall_path_kernels(path, model, state)
    # K6 on the path's two fill groups (horizontal convection's b with its
    # callable top value), from NaN on every point it writes
    k6_err = max(hold_k6(f"K6 {path} group {i + 1}", model.grid, group, 8 + i)[0]
                 for i, group in enumerate(nonhydrostatic_fill_fields(model)))
    kernel_u = {k: model.grid.interior(a) for k, a in state["solution"].items()}
    del state
    torch.cuda.empty_cache()
    model, state, _, plain_step, _ = drive_wall_path(path, plain=True)
    worst = agreement(path, warmup + steps, kernel_u, model, state)
    print(f"{path} path: plain versions: {plain_step * 1e3:.3f} ms/step, "
          f"{points / plain_step:.6e} grid points/s; kernel and plain runs agree "
          f"to {worst:.3e} of max|field|")
    del model, state, kernel_u
    torch.cuda.empty_cache()
    return launches, readings, k6_err


# -- immersed boundaries and PositiveWENO5 -------------------------------------------

#: validation/seamount.py at full width: stratified flow over a Gaussian
#: seamount with an immersed bottom and a PositiveWENO5 tracer, 4096×1×2048
#: fp64 (the validation's dtype; 43× its 96×48 in each direction, the grid
#: of a high-resolution lee-wave study: Δx = 2.44 m, Δz = 0.49 m), Δt =
#: min(60, 0.25 Lx/N) = 0.61 s, the validation's rule. The one cut is the
#: step count: 2 warm-up and 5 timed steps, and 200 more for its checks
#: (the validation runs 1200 at 96×48).
SEAMOUNT = dict(size=(4096, 1, 2048), Lx=10_000.0, Lz=1_000.0, U0=0.1, N2=1e-5,
                warmup=2, steps=5, more=200)
#: K2's immersed and PositiveWENO5 holds (beyond the path's own fields):
#: (label, topology, size, dtype, momentum, tracer scheme, tracers,
#: immersed); the bottom is tests/test_immersed.py's seamount scaled to the
#: unit box
K2_IMMERSED_CASES = (
    ("P,P,B 256x256x128 fp32, WENO5 / PositiveWENO5 b, c, immersed",
     (PERIODIC, PERIODIC, BOUNDED), (256, 256, 128), torch.float32, WENO5,
     PositiveWENO5, ("b", "c"), True),
    ("P,P,B 100x77x45 fp64, centred / WENO5, immersed",
     (PERIODIC, PERIODIC, BOUNDED), (100, 77, 45), torch.float64,
     CenteredSecondOrder, WENO5, ("b", "c"), True),
    ("P,F,B 1000x1x333 fp64, WENO5 / PositiveWENO5 b, c, immersed",
     (PERIODIC, FLAT, BOUNDED), (1000, 1, 333), torch.float64, WENO5,
     PositiveWENO5, ("b", "c"), True),
    ("P,P,B 100x77x45 fp32, UB5 / PositiveWENO5 c, no bottom",
     (PERIODIC, PERIODIC, BOUNDED), (100, 77, 45), torch.float32,
     UpwindBiasedFifthOrder, PositiveWENO5, ("c",), False),
)


def unit_seamount(x, y):
    """tests/test_immersed.py's seamount on the unit box."""
    return -1.0 + 0.6 * torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02)


def phase_k2_immersed():
    """K2 over an immersed bottom and with PositiveWENO5 tracers against its
    plain version bit for bit over NaN-filled outputs (``K2_IMMERSED_CASES``:
    masked random velocities, tracers in [−0.1, 1.1] so the limiter acts
    both ways), each timed against its bound; returns the records' forms."""
    forms = []
    for label, topology, size, dtype, momentum, tracer, names, immersed in K2_IMMERSED_CASES:
        grid = RectilinearGrid(size=size, x=(0.0, 1.0), y=(0.0, 1.0), z=(-1.0, 0.0),
                               topology=topology, dtype=dtype, device=DEVICE)
        model = NonhydrostaticModel(
            grid, advection=momentum(),
            tracer_advection=(tracer(bounds=(0.0, 1.0)) if tracer is PositiveWENO5
                              else tracer()), tracers=names,
            immersed_boundary=GridFittedBottom(unit_seamount) if immersed else None)
        g = model.grid
        gen = torch.Generator(device=DEVICE).manual_seed(9)
        sol = {n: torch.randn(g.total_shape, generator=gen, dtype=dtype, device=DEVICE)
               for n in "uvw"}
        sol.update({n: 1.2 * torch.rand(g.total_shape, generator=gen, dtype=dtype,
                                        device=DEVICE) - 0.1 for n in names})
        if immersed:
            sol = model.immersed_boundary.mask_state(model, {"solution": sol})["solution"]
        args = (g, model.advection, model.tracer_advection, sol["u"], sol["v"], sol["w"],
                {n: sol[n] for n in names})
        poison_cache(g.total_shape, dtype, 3 + len(names) + 2)
        err = hold_k2(f"K2 {label}", args, dtype)
        ms = cuda_ms(lambda: fused_advective_tendencies(*args), 10)
        plain_ms = cuda_ms(lambda: fused_advective_tendencies_reference(*args), 2)
        b_ms, by = k2_bound(args)
        print(f"K2 {label} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA "
              f"events), bound {b_ms:.4f} ms ({by}) on {card_line()}")
        forms.append({"part": "immersed" if immersed else "PositiveWENO5", "form": label,
                      "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": by, "library_ms": None})
        del model, g, sol, args
        torch.cuda.empty_cache()
    return forms


def seamount_model():
    """validation/seamount.py at ``SEAMOUNT["size"]`` fp64, through the
    public constructors."""
    c = SEAMOUNT
    grid = RectilinearGrid(size=c["size"], x=(0.0, c["Lx"]), y=(0.0, 1.0),
                           z=(-c["Lz"], 0.0), topology=(PERIODIC, FLAT, BOUNDED),
                           dtype=torch.float64, device=DEVICE)
    bottom = lambda x, y: -c["Lz"] + 500.0 * torch.exp(-((x - 0.5 * c["Lx"]) / 2000.0) ** 2)
    return NonhydrostaticModel(grid, advection=WENO5(),
                               tracer_advection=PositiveWENO5(bounds=(0.0, 1.0)),
                               tracers=("c",), buoyancy=BuoyancyTracer(),
                               closure=ScalarDiffusivity(nu=1e-3, kappa=1e-4),
                               immersed_boundary=GridFittedBottom(bottom))


def seamount_state(model):
    """The validation's initial state: u = U0, b = N²(z + Lz), the Gaussian c."""
    c = SEAMOUNT
    return model.initial_state(
        u=c["U0"], b=lambda x, y, z: c["N2"] * (z + c["Lz"]),
        c=lambda x, y, z: torch.exp(-((x - 2500.0) / 800.0) ** 2 - ((z + 500.0) / 150.0) ** 2))


def seamount_totals(model, state):
    """The validation's numbers on the interior: Σc·V over the fluid (fp64),
    max|c| in the solid, min c, max c."""
    g = model.grid
    c = g.interior(state["solution"]["c"])
    fluid = ~g.interior(g.immersed.solid_ccc)
    vol = g.interior(torch.broadcast_to(g.V(CENTER), g.total_shape))
    return (float((c * vol * fluid).sum()), float((c * ~fluid).abs().max()),
            float(c.min()), float(c.max()))


def immersed_divergence_ratio(model, state):
    """max|∇·u|·Δx_min/max|u| over the fluid cells none of whose faces is
    solid, and over every fluid cell. The pressure solve is the parent
    grid's (the JAX package's): it makes the velocities divergence-free
    before ``update_state`` masks the solid faces to 0, so the cells that
    touch a solid face carry the masking's divergence."""
    g = model.grid
    sol = state["solution"]
    div = fused_divergence_reference(g, sol["u"], sol["v"], sol["w"])
    imm = g.immersed
    near = imm.solid_ccc.clone()
    for a in range(3):
        if g.topology[a] is not FLAT:
            near |= torch.roll(imm.solid_ccc, 1, a) | torch.roll(imm.solid_ccc, -1, a)
    umax = max(float(g.interior(sol[n]).abs().max()) for n in "uvw")
    scale = g.min_spacing() / umax
    fluid = ~g.interior(imm.solid_ccc)
    return (float(div[~g.interior(near)].abs().max()) * scale,
            float(div[fluid].abs().max()) * scale)


def drive_seamount(plain):
    """The seamount path with the kernels or their plain versions: its
    warm-up and timed steps (``run_steps``); returns (model, state, Δt, Σc
    of the initial state, s per timed step, launches)."""
    c = SEAMOUNT
    model = seamount_model()
    if model.kernels["fill"] is not fused_fill_halos:
        raise AssertionError(f"seamount: fills take {model.kernels['fill']}, not K6")
    if model.fused_step or model._fast_projection_ok():
        raise AssertionError("seamount: the immersed model must take the general "
                             "AB2 branch and the general projection")
    state = seamount_state(model)
    tot0 = seamount_totals(model, state)[0]
    dt = min(60.0, 0.25 * c["Lx"] / c["size"][0])
    kernels = nonhydrostatic.PLAIN if plain else None
    state, per_step, launches = run_steps(
        "seamount", model, state, lambda s: model.step(s, dt, kernels), c["warmup"],
        c["steps"], plain)
    return model, state, dt, tot0, per_step, launches


def phase_seamount():
    """The seamount path (``SEAMOUNT``) with the kernels, checked, then with
    the plain versions; returns the kernel run's launch counts, K2's, K3b's
    and K3c's readings on the path's fields and K6's max|Δ| on its fill
    groups."""
    path, c = "seamount", SEAMOUNT
    model, state, dt, tot0, per_step, launches = drive_seamount(plain=False)
    check_finite(path, model, state, ("pHY", "pNHS"))
    away, every = immersed_divergence_ratio(model, state)
    if not away <= 1e-5:
        raise AssertionError(f"{path}: max|div u|*dx/max|u| = {away:.3e} > 1e-5 "
                             "away from the solid")
    imm = model.grid.immersed
    for name, loc in (("u", U_LOC), ("v", V_LOC), ("w", W_LOC)):
        worst = float((state["solution"][name] * imm.mask_for(loc)).abs().max())
        if worst != 0.0:
            raise AssertionError(f"{path}: max|{name}| at solid faces {worst:.3e}")
    points = math.prod(model.grid.shape)
    used = {k: n for k, n in launches.items() if n}
    print(f"{path} path: {'x'.join(map(str, model.grid.shape))} fp64, {c['steps']} steps "
          f"at dt {dt:.6e}: {per_step * 1e3:.3f} ms/step, {points / per_step:.6e} grid "
          f"points/s on {card_line()}; launches {used} in {c['warmup'] + c['steps']} "
          f"steps; max|div u|*dx/max|u| {away:.3e} away from the solid ({every:.3e} "
          f"over every fluid cell, the masking's); u, v, w exactly 0 at "
          f"{int(imm.solid_fcc.sum()) + int(imm.solid_ccf.sum())} solid u and w faces")
    readings = wall_path_kernels(path, model, state)
    k6_err = max(hold_k6(f"K6 {path} group {i + 1}", model.grid, group, 10 + i)[0]
                 for i, group in enumerate(nonhydrostatic_fill_fields(model)))
    kernel_u = {k: model.grid.interior(a).clone() for k, a in state["solution"].items()}
    # the validation's checks after more steps with the kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(c["more"]):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    more_s = time.perf_counter() - t0
    check_finite(path, model, state, ("pHY", "pNHS"))
    tot, solid, cmin, cmax = seamount_totals(model, state)
    drift = abs(tot / tot0 - 1)
    print(f"{path}: after {c['warmup'] + c['steps'] + c['more']} steps "
          f"({more_s / c['more'] * 1e3:.3f} ms/step over the last {c['more']}): Σc/Σc0 − 1 "
          f"= {tot / tot0 - 1:+.3e}, max|c| in the solid {solid:.3e}, c in "
          f"[{cmin:+.6e}, {cmax:.9f}] (the validation's bounds: drift < 1e-3, "
          f"solid ≤ 1e-10, c in [−1e-9, 1 + 1e-9])")
    if not (drift < 1e-3 and solid <= 1e-10 and cmin >= -1e-9 and cmax <= 1.0 + 1e-9):
        raise AssertionError(f"{path}: the validation's checks fail: drift {drift:.3e}, "
                             f"solid {solid:.3e}, c in [{cmin}, {cmax}]")
    del state
    torch.cuda.empty_cache()
    model, state, _, _, plain_step, _ = drive_seamount(plain=True)
    worst = agreement(path, c["warmup"] + c["steps"], kernel_u, model, state)
    print(f"{path} path: plain versions: {plain_step * 1e3:.3f} ms/step, "
          f"{points / plain_step:.6e} grid points/s; kernel and plain runs agree to "
          f"{worst:.3e} of max|field|")
    del model, state, kernel_u
    torch.cuda.empty_cache()
    return launches, readings, k6_err


# -- the remaining schemes: C4, UB1, UB3, BoundsPreservingWENO5 -------------------------

#: the four schemes that came last, by short name
NEW_SCHEMES = {"C4": CenteredFourthOrder, "UB1": UpwindBiasedFirstOrder,
               "UB3": UpwindBiasedThirdOrder, "BP": BoundsPreservingWENO5}
#: K2's holds beyond each scheme alone at 256³ fp32: (label, topology,
#: momentum, tracer scheme, z, immersed), all at 256³ fp32 but the immersed
#: one (256×256×128): a WENO5 momentum with UB3 tracers needs two sets of
#: near-wall bounds on a bounded axis
K2_SCHEME_CASES = (
    ("P,P,B 256^3 fp32, WENO5 / UB3", (PERIODIC, PERIODIC, BOUNDED), WENO5,
     UpwindBiasedThirdOrder, "regular", False),
    ("B,B,B 256^3 fp32, WENO5 / UB3", (BOUNDED, BOUNDED, BOUNDED), WENO5,
     UpwindBiasedThirdOrder, "regular", False),
    ("P,P,B 256^3 fp32 stretched z, BP / BP", (PERIODIC, PERIODIC, BOUNDED),
     BoundsPreservingWENO5, BoundsPreservingWENO5, "stretched", False),
    ("P,P,B 256x256x128 fp32, C4 / UB3, immersed", (PERIODIC, PERIODIC, BOUNDED),
     CenteredFourthOrder, UpwindBiasedThirdOrder, "regular", True),
)
#: K3a's holds at the shallow-water headline's 16384² fp32, with one tracer
K3A_SCHEMES = {"UB3": UpwindBiasedThirdOrder, "C4": CenteredFourthOrder,
               "UB5": UpwindBiasedFifthOrder, "BP": BoundsPreservingWENO5}


def form_record(part, label, err, ms, plain_ms, bound_ms, by, launches=0):
    return {"part": part, "form": label, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None}


def time_form(kernel, label, call, plain, b, reps=10):
    """The kernel's and its plain version's times by CUDA events, printed
    beside the bound ``b`` (bound_ms, bound_by); returns (ms, plain_ms)."""
    ms, plain_ms = cuda_ms(call, reps), cuda_ms(plain, 2)
    print(f"{kernel} {label} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA "
          f"events), bound {b[0]:.4f} ms ({b[1]}) on {card_line()}")
    return ms, plain_ms


def scheme_k2_args(label, topology, momentum, tracer, z, immersed, seed=13):
    """K2's arguments on a case of ``K2_SCHEME_CASES`` (or a scheme alone):
    random velocities, tracers b and c in [−0.1, 1.1], masked over the
    immersed bottom."""
    size = (N, N, N // 2) if immersed else (N, N, N)
    grid = (surface_grid(size, stretched=True) if z == "stretched" else
            RectilinearGrid(size=size, x=(0.0, 1.0), y=(0.0, 1.0), z=(-1.0, 0.0),
                            topology=topology, device=DEVICE))
    model = NonhydrostaticModel(
        grid, advection=momentum(), tracer_advection=tracer(), tracers=("b", "c"),
        immersed_boundary=GridFittedBottom(unit_seamount) if immersed else None)
    g = model.grid
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sol = {n: torch.randn(g.total_shape, generator=gen, device=DEVICE) for n in "uvw"}
    sol.update({n: 1.2 * torch.rand(g.total_shape, generator=gen, device=DEVICE) - 0.1
                for n in "bc"})
    if immersed:
        sol = model.immersed_boundary.mask_state(model, {"solution": sol})["solution"]
    return (g, model.advection, model.tracer_advection, sol["u"], sol["v"], sol["w"],
            {n: sol[n] for n in "bc"})


def phase_schemes():
    """The new schemes in K1, K2 and K3a, bit for bit against the plain
    versions over NaN-filled outputs, each form timed against its bound:
    K1 and K2 at 256³ fp32 with each of C4, UB1, UB3 and BP as the
    momentum and the tracer scheme (the bench configuration's fields for
    K1), ``K2_SCHEME_CASES``, and K3a at 16384² fp32 with ``K3A_SCHEMES``.
    Returns ({kernel: largest max|Δ|}, {kernel: the records' forms})."""
    worst = {K1: 0.0, K2: 0.0, K3A: 0.0}
    forms = {K1: [], K2: [], K3A: []}
    for short, scheme in NEW_SCHEMES.items():
        grid = RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                               topology=(PERIODIC, PERIODIC, BOUNDED), device=DEVICE)
        model = NonhydrostaticModel(grid, advection=scheme(), buoyancy=BuoyancyTracer())
        if not (model.fused_step and model.g_interior):
            raise AssertionError(f"K1 {short}: the model does not take K1's fused branch")
        state = random_state(model, 1)
        poison_cache(model.grid.total_shape, torch.float32, 10)
        psi_k, g_k, err = hold_k1(f"K1 {short} {N}^3 fp32", model, state)
        nb = tensor_bytes(state["solution"].values(), state["G_prev"].values(),
                          [state["pHY"]], psi_k.values(), g_k.values())
        b = bound(K1, nb, N ** 3, flops=k2_flops(model.grid, scheme(), scheme(), 1) + 20)
        label = f"P,P,B {N}^3 fp32, {short} / {short}, bench"
        ms, plain_ms = time_form(K1, label, lambda: fused_ab2_advance(
            model, state, 1e-4, False), lambda: fused_ab2_advance_reference(
            model, state, 1e-4, False), b)
        worst[K1] = max(worst[K1], err)
        forms[K1].append(form_record(short, label, err, ms, plain_ms, *b))
        sol = state["solution"]
        args = (model.grid, model.advection, model.tracer_advection, sol["u"], sol["v"],
                sol["w"], {"b": sol["b"]})
        poison_cache(model.grid.total_shape, torch.float32, 6)
        err = hold_k2(f"K2 {short} {N}^3 fp32", args, torch.float32)
        b = k2_bound(args)
        label = f"P,P,B {N}^3 fp32, {short} / {short}"
        ms, plain_ms = time_form(K2, label, lambda: fused_advective_tendencies(*args),
                                 lambda: fused_advective_tendencies_reference(*args), b)
        worst[K2] = max(worst[K2], err)
        forms[K2].append(form_record(short, label, err, ms, plain_ms, *b))
        del model, state, psi_k, g_k, sol, args
        torch.cuda.empty_cache()
    for case in K2_SCHEME_CASES:
        label = case[0]
        args = scheme_k2_args(*case)
        poison_cache(args[0].total_shape, torch.float32, 7)
        err = hold_k2(f"K2 {label}", args, torch.float32)
        b = k2_bound(args)
        ms, plain_ms = time_form(K2, label, lambda: fused_advective_tendencies(*args),
                                 lambda: fused_advective_tendencies_reference(*args), b)
        worst[K2] = max(worst[K2], err)
        forms[K2].append(form_record("schemes", label, err, ms, plain_ms, *b))
        if label.startswith("P,P,B 256^3 fp32, WENO5 / UB3"):
            # K1 with the same schemes on the bench configuration
            grid = RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                                   topology=(PERIODIC, PERIODIC, BOUNDED), device=DEVICE)
            model = NonhydrostaticModel(grid, advection=WENO5(),
                                        tracer_advection=UpwindBiasedThirdOrder(),
                                        buoyancy=BuoyancyTracer(), tracers=("c",))
            state = random_state(model, 2)
            poison_cache(model.grid.total_shape, torch.float32, 10)
            worst[K1] = max(worst[K1], hold_k1(f"K1 {label}", model, state)[2])
            del model, state
        del args
        torch.cuda.empty_cache()
    for short, scheme in K3A_SCHEMES.items():
        grid = RectilinearGrid(size=(N_SW, N_SW, 1), x=(0, 2 * math.pi),
                               y=(0, 2 * math.pi), topology=(PERIODIC, PERIODIC, FLAT),
                               halo=(3, 3, 0), device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(4)
        rand = lambda s, o=0.0: o + s * torch.randn(grid.total_shape, generator=gen,
                                                    device=DEVICE)
        args = (grid, scheme(), scheme(), 10.0, rand(0.1), rand(0.1), rand(0.05, 1.0),
                [rand(1.0)], None)
        label = f"{N_SW}x{N_SW} fp32, {short} / {short}, 1 tracer"
        names = ["uh", "vh", "h", "c"]
        poison_cache(grid.total_shape, torch.float32, 4)
        got = dict(zip(names, fused_shallow_water_tendencies(*args)))
        ref = dict(zip(names, fused_shallow_water_tendencies_reference(*args)))
        err = hold(f"K3a {label}", {"G": got}, {"G": ref}, torch.float32, grid.interior,
                   exact=True)
        del got, ref
        per_transport = K2_TRANSPORT[scheme]
        b = bound(K3A, 2 * tensor_bytes(args[4:7], args[7]), N_SW ** 2,
                  flops=4 * per_transport + 44 + 2 * per_transport + 10)
        ms, plain_ms = time_form(K3A, label,
                                 lambda: fused_shallow_water_tendencies(*args),
                                 lambda: fused_shallow_water_tendencies_reference(*args), b)
        worst[K3A] = max(worst[K3A], err)
        forms[K3A].append(form_record(short, label, err, ms, plain_ms, *b))
        del args
        torch.cuda.empty_cache()
    return worst, forms


#: the schemes slice's paths' schemes, in their K4b records
PATH_SCHEMES = {"hydrostatic positive": "weno_velocity / PositiveWENO5",
                "near-global UB5": "UB5 / BoundsPreservingWENO5, immersed"}
#: the six schemes K4b takes beyond WENO5 and the centred one
K4B_SCHEMES = {"UB5": UpwindBiasedFifthOrder, "PW": PositiveWENO5,
               "C4": CenteredFourthOrder, "UB1": UpwindBiasedFirstOrder,
               "UB3": UpwindBiasedThirdOrder, "BP": BoundsPreservingWENO5}
#: the K4b holds at 1° (360×150×24 fp32: the flagship's grid at 1°), 3
#: steps of each fields' run through the model first; the stretched-latitude
#: grid's (PW and BP: K4b's y tables)
SCHEMES_HOLD = dict(size=(360, 150, 24), steps=3, stretched=("PW", "BP"))


def k4b_flops(model):
    """K4b's operations a point with the model's schemes, counted as
    ``FLOPS``: the vector-invariant flagship's momentum (~400) or two
    velocities' three flux-form transports by scheme (``transport_ops``),
    each tracer's three transports (a WENO5 or BoundsPreservingWENO5 z flux
    two-sided on a stretched z: one transport more; PositiveWENO5's count
    has both sides), ~8 a field for the divergences and ~50 for Coriolis,
    −∂pHY′ and the epilogue."""
    sch, ts = model.momentum_advection, model.tracer_advection
    ops = lambda s: transport_ops(s, model.grid.dtype)
    mom = 400 if isinstance(sch, VectorInvariant) else 6 * ops(sch)
    per = 3 * ops(ts)
    if not model.grid.z_regular and type(ts) in (WENO5, BoundsPreservingWENO5):
        per += ops(ts)
    nf = 2 + len(model.tracer_names)
    return mom + len(model.tracer_names) * per + 8 * nf + 50


def k4b_bound(model, state, outs, advance):
    """K4b's bound on a call's inputs and its output tensors ``outs`` (G,
    or ψ′ and G with ``advance``): each field, w, pHY′ (and G_prev in the
    advance) read once, the clear flags and y tables it reads, each output
    written once."""
    from clima_oceananigans_jl_torch.ops.fused_hydrostatic import _mask_locs, clear_flags
    from clima_oceananigans_jl_torch.ops.metric_rows import dz3_pack, y_tables
    g = model.grid
    extra = [clear_flags(g, loc, (model.tracer_advection if loc == CENTER
                                  else model.momentum_advection).buffer)
             for loc in _mask_locs(model)]
    if not g.y_regular:
        extra.append(y_tables(g))
    if getattr(g, "partial_cells", False):  # the 3D Δz at centres and faces
        extra.append(dz3_pack(g))
    gp = state["G_prev"].values() if advance else []
    nb = tensor_bytes(state["solution"].values(), [state["w"], state["pHY"]], gp, outs,
                      extra)
    return bound(K4B, nb, g.Nx * g.Ny * g.Nz, k4b_flops(model))


def scheme_hold_model(short, bottom, stretched=False):
    """The flagship at 1° (``SCHEMES_HOLD``) with the scheme ``short`` as
    flux-form momentum and tracer scheme; over the near-global bottom with
    ``bottom``, on stretched latitudes with ``stretched``."""
    size = SCHEMES_HOLD["size"]
    lat = stretched_latitude(size[1]) if stretched else (-75, 75)
    kw = dict(immersed_boundary=GridFittedBottom(near_global_bathymetry)) if bottom else {}
    scheme = K4B_SCHEMES[short]
    return latlon_flagship(grid=latlon_grid(size=size, latitude=lat),
                           momentum_advection=scheme(), tracer_advection=scheme(), **kw)


def phase_hydro_schemes():
    """The schemes slice's holds, each kernel form bit for bit against its
    plain version over NaN-filled outputs and (all but K4b's immersed and
    stretched forms) timed against its bound:
    - K4b at 1° with each of ``K4B_SCHEMES`` as flux-form momentum and
      tracer scheme, on the flagship's flat bottom and over the near-global
      one, in the fused advance and the tendency form (after 3 steps of the
      model with the kernels), halos exactly 0; on stretched latitudes with
      PW and BP (the y tables);
    - K1 and K2 at 256³ fp32 with PositiveWENO5 as the momentum and the
      tracer scheme (the bench configuration's fields for K1), K2 with
      PositiveWENO5 tracers on the wind-mixing stretched z, K3a at 16384²
      fp32 with PositiveWENO5 for uh, vh and a tracer.
    Returns ({kernel: largest max|Δ|}, {kernel: the records' forms})."""
    worst = {K1: 0.0, K2: 0.0, K3A: 0.0, K4B: 0.0}
    forms = {K1: [], K2: [], K3A: [], K4B: []}
    steps = SCHEMES_HOLD["steps"]
    cases = [(short, bottom, False) for short in K4B_SCHEMES for bottom in (False, True)]
    cases += [(short, False, True) for short in SCHEMES_HOLD["stretched"]]
    for short, bottom, stretched in cases:
        model = scheme_hold_model(short, bottom, stretched)
        g = model.grid
        gen = torch.Generator(device=DEVICE).manual_seed(19)
        rand = lambda sc, o=0.0: o + sc * torch.randn(g.shape, generator=gen, device=DEVICE)
        state = model.initial_state(u=rand(0.1), v=rand(0.1), T=rand(1.0, 10.0),
                                    S=rand(1e-2, 35.0), b=lambda lam, phi, z: 2e-5 * (
                                        z + 3000.0) / 3000.0)
        for _ in range(steps):
            state = model.step(state, HYDRO["dt"])
        where = ("near-global bottom" if bottom else "stretched latitude" if stretched
                 else "flat")
        label = f"1 deg fp32 {where}, {short} / {short}"
        case_err = 0.0
        for adv in ((HYDRO["dt"], False), None):
            poison_cache(g.total_shape, torch.float32, 12)
            got = fused_hydrostatic_tendencies(model, state, adv)
            ref = fused_hydrostatic_tendencies_reference(model, state, adv)
            form = "tendencies" if adv is None else "advance"
            pairs = (({"G": got}, {"G": ref}) if adv is None else
                     ({"psi'": got[0], "G": got[1]}, {"psi'": ref[0], "G": ref[1]}))
            case_err = max(case_err, hold(f"K4b {label}, {form}", *pairs, torch.float32,
                                          g.interior, exact=True))
            for kind in pairs[0].values():  # the kernel writes its halos zero
                for name, t in kind.items():
                    halo = t.clone()
                    halo[g.interior_slices] = 0
                    if halo.isnan().any() or halo.any():
                        raise AssertionError(f"K4b {label}, {form} {name}: a halo "
                                             "point is not zero")
            if adv is not None and not bottom and not stretched:
                b = k4b_bound(model, state, [t for o in got for t in o.values()], True)
                del got, ref
                ms, plain_ms = time_form(K4B, f"{label}, advance",
                                         lambda: fused_hydrostatic_tendencies(model, state, adv),
                                         lambda: fused_hydrostatic_tendencies_reference(
                                             model, state, adv), b)
                forms[K4B].append(form_record(short, f"{label}, advance", case_err, ms,
                                              plain_ms, *b))
            else:
                del got, ref
        worst[K4B] = max(worst[K4B], case_err)
        del model, state
        torch.cuda.empty_cache()
    # K1 and K2 with PositiveWENO5 momentum and tracers at 256³ fp32
    grid = RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED), device=DEVICE)
    model = NonhydrostaticModel(grid, advection=PositiveWENO5(), buoyancy=BuoyancyTracer(),
                                tracer_advection=PositiveWENO5())
    if not (model.fused_step and model.g_interior):
        raise AssertionError("K1 PW: the model does not take K1's fused branch")
    state = random_state(model, 1)
    poison_cache(model.grid.total_shape, torch.float32, 10)
    psi_k, g_k, err = hold_k1(f"K1 PW {N}^3 fp32", model, state)
    nb = tensor_bytes(state["solution"].values(), state["G_prev"].values(),
                      [state["pHY"]], psi_k.values(), g_k.values())
    b = bound(K1, nb, N ** 3, flops=k2_flops(model.grid, PositiveWENO5(),
                                             PositiveWENO5(), 1) + 20)
    label = f"P,P,B {N}^3 fp32, PW / PW, bench"
    ms, plain_ms = time_form(K1, label, lambda: fused_ab2_advance(model, state, 1e-4, False),
                             lambda: fused_ab2_advance_reference(model, state, 1e-4, False), b)
    worst[K1] = max(worst[K1], err)
    forms[K1].append(form_record("PW", label, err, ms, plain_ms, *b))
    sol = state["solution"]
    args = (model.grid, model.advection, model.tracer_advection, sol["u"], sol["v"],
            sol["w"], {"b": sol["b"]})
    poison_cache(model.grid.total_shape, torch.float32, 6)
    err = hold_k2(f"K2 PW {N}^3 fp32", args, torch.float32)
    label = f"P,P,B {N}^3 fp32, PW / PW"
    ms, plain_ms = time_form(K2, label, lambda: fused_advective_tendencies(*args),
                             lambda: fused_advective_tendencies_reference(*args),
                             k2_bound(args))
    worst[K2] = max(worst[K2], err)
    forms[K2].append(form_record("PW momentum", label, err, ms, plain_ms, *k2_bound(args)))
    del model, state, psi_k, g_k, sol, args
    torch.cuda.empty_cache()
    # K2 with PositiveWENO5 tracers on the wind-mixing stretched z
    label = f"P,P,B {N}^3 fp32 stretched z, WENO5 / PW"
    args = scheme_k2_args(label, (PERIODIC, PERIODIC, BOUNDED), WENO5, PositiveWENO5,
                          "stretched", False)
    poison_cache(args[0].total_shape, torch.float32, 7)
    err = hold_k2(f"K2 {label}", args, torch.float32)
    ms, plain_ms = time_form(K2, label, lambda: fused_advective_tendencies(*args),
                             lambda: fused_advective_tendencies_reference(*args),
                             k2_bound(args))
    worst[K2] = max(worst[K2], err)
    forms[K2].append(form_record("PW stretched", label, err, ms, plain_ms, *k2_bound(args)))
    del args
    torch.cuda.empty_cache()
    # K3a with PositiveWENO5 at the shallow-water headline's 16384²
    grid = RectilinearGrid(size=(N_SW, N_SW, 1), x=(0, 2 * math.pi), y=(0, 2 * math.pi),
                           topology=(PERIODIC, PERIODIC, FLAT), halo=(3, 3, 0),
                           device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rand = lambda sc, o=0.0: o + sc * torch.randn(grid.total_shape, generator=gen,
                                                  device=DEVICE)
    c = 1.2 * torch.rand(grid.total_shape, generator=gen, device=DEVICE) - 0.1
    args = (grid, PositiveWENO5(), PositiveWENO5(), 10.0, rand(0.1), rand(0.1),
            rand(0.05, 1.0), [c], None)
    label = f"{N_SW}x{N_SW} fp32, PW / PW, 1 tracer"
    poison_cache(grid.total_shape, torch.float32, 4)
    names = ["uh", "vh", "h", "c"]
    got = dict(zip(names, fused_shallow_water_tendencies(*args)))
    ref = dict(zip(names, fused_shallow_water_tendencies_reference(*args)))
    err = hold(f"K3a {label}", {"G": got}, {"G": ref}, torch.float32, grid.interior,
               exact=True)
    del got, ref
    # uh along y and vh along x limited, their own axes WENO5's stream
    per = K2_TRANSPORT[PositiveWENO5]
    b = bound(K3A, 2 * tensor_bytes(args[4:7], args[7]), N_SW ** 2,
              flops=2 * per + 2 * K2_TRANSPORT[WENO5] + 44 + 2 * per + 10)
    ms, plain_ms = time_form(K3A, label, lambda: fused_shallow_water_tendencies(*args),
                             lambda: fused_shallow_water_tendencies_reference(*args), b)
    worst[K3A] = max(worst[K3A], err)
    forms[K3A].append(form_record("PW", label, err, ms, plain_ms, *b))
    del args
    torch.cuda.empty_cache()
    return worst, forms


#: WENO5's bf16 options (the bf16 forms of ``csrc/weno5_advection.cuh`` in
#: the ANY instantiations of K1, K2, K3a and K4b), by name as the holds'
#: labels give them
BF16_OPTIONS = {"smoothness": dict(bf16_smoothness=True), "fast": dict(fast_bf16=True)}
#: the WENO5 family under each option
BF16_SCHEMES = {"WENO5": WENO5, "BP": BoundsPreservingWENO5, "PW": PositiveWENO5}
#: the two 256³ fp32 AB2 paths of the options (Δt = 1e-4, 2 warm-up and 5
#: timed steps; 1 K1 and 2 K6 a step):
#: - "AB2 bf16 smoothness": bench.py:55-76 with CLIMA_BF16S set,
#:   WENO5(bf16_smoothness=True), the AB2 path's u, v (1e-2) and b (1e-4)
#:   from a numpy seed;
#: - "AB2 fast bf16": benchmark/bench_bf16.py:9-25, WENO5(fast_bf16=True),
#:   u = 1e-2·N(0,1) from a seeded torch.Generator, v = b = 0.
#: Each is held bit for bit against its plain run and, after the same steps
#: from the same state, within ``BF16_GATE`` of each field's scale of the
#: fp32 run (the gate of tests/test_bf16_smoothness.py:68).
BF16_PATHS = {"AB2 bf16 smoothness": "smoothness", "AB2 fast bf16": "fast"}
BF16_PATH_STEPS = (1e-4, 2, 5)
BF16_GATE = 5e-3
#: the fp64 holds of fast_bf16 (K1 and K2 at 128³, K3a at 4096²) and the ¼°
#: advance with bf16_smoothness tracers
BF16_HOLD = dict(n64=128, n_sw64=4096, quarter_steps=2)


def bf16_path_model(path, option):
    """The 256³ fp32 AB2 model with WENO5 under ``option`` (None: WENO5()
    in fp32) and the path's initial state."""
    grid = RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED), device=DEVICE)
    model = NonhydrostaticModel(grid, advection=WENO5(**BF16_OPTIONS.get(option, {})),
                                buoyancy=BuoyancyTracer(),
                                timestepper="QuasiAdamsBashforth2")
    if not (model.fused_step and model.g_interior):
        raise AssertionError(f"{path}: the model does not take K1's fused branch")
    if path == "AB2 fast bf16":
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        return model, model.initial_state(
            u=1e-2 * torch.randn(grid.shape, generator=gen, device=DEVICE))
    return model, bench_state(model)


def phase_bf16_path(path):
    """One of ``BF16_PATHS`` with the kernels (checked: finite, the AB2
    path's divergence bound, K1 bit for bit and timed on the path's
    fields), then the fp32 run from the same state (the kernels), then the
    plain versions; returns the kernel run's launch counts and K1's reading
    on the path's fields (a form record with the path's launches)."""
    dt, warmup, steps = BF16_PATH_STEPS
    option = BF16_PATHS[path]
    model, state = bf16_path_model(path, option)
    state, per_step, launches = run_steps(path, model, state, lambda s: model.step(s, dt),
                                          warmup, steps, False)
    check_finite(path, model, state, ("pHY", "pNHS"))
    ratio = divergence_ratio(model, state)
    if not ratio <= 1e-5:
        raise AssertionError(f"{path}: max|div u|*dx/max|u| = {ratio:.3e} > 1e-5")
    err = hold_k1(f"K1 {N}^3 fp32 on the {path} path's fields", model, state, dt)[2]
    psi_k, g_k = fused_ab2_advance(model, state, dt, False)
    nb = tensor_bytes(state["solution"].values(), state["G_prev"].values(),
                      [state["pHY"]], psi_k.values(), g_k.values())
    del psi_k, g_k
    scheme = model.advection
    b = bound(K1, nb, N ** 3, flops=k2_flops(model.grid, scheme, scheme, 1) + 20)
    label = f"P,P,B {N}^3 fp32, WENO5 {option} / WENO5 {option}, the {path} path's fields"
    ms, plain_ms = time_form(K1, label, lambda: fused_ab2_advance(model, state, dt, False),
                             lambda: fused_ab2_advance_reference(model, state, dt, False), b)
    reading = form_record(path, label, err, ms, plain_ms, *b, launches[K1])
    kernel_u = {k: model.grid.interior(a).clone() for k, a in state["solution"].items()}
    del model, state
    torch.cuda.empty_cache()
    model, state = bf16_path_model(path, None)
    state, fp32_step, _ = run_steps("AB2", model, state, lambda s: model.step(s, dt),
                                    warmup, steps, False)
    gap = {}
    for k, a in state["solution"].items():
        ref = model.grid.interior(a)
        scale = float(ref.abs().max()) + 1e-12
        gap[k] = float((kernel_u[k] - ref).abs().max()) / scale
        if not gap[k] < BF16_GATE:
            raise AssertionError(f"{path}: {k} differs from the fp32 run by {gap[k]:.3e} "
                                 f"of its scale (gate {BF16_GATE})")
    used = {k: n for k, n in launches.items() if n}
    print(f"{path} path: {N}^3 fp32, {steps} steps: {per_step * 1e3:.3f} ms/step beside "
          f"the fp32 AB2 run's {fp32_step * 1e3:.3f} ms/step in this call, "
          f"{N ** 3 / per_step:.6e} grid points/s, launches {used} in {warmup + steps} "
          f"steps, max|div u|*dx/max|u| {ratio:.3e}, from the fp32 run "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in gap.items()})} of each "
          f"field's scale, on {card_line()}")
    del model, state
    torch.cuda.empty_cache()
    model, state = bf16_path_model(path, option)
    state, plain_step, _ = run_steps(path, model, state,
                                     lambda s: model.step(s, dt, nonhydrostatic.PLAIN),
                                     warmup, steps, True)
    worst = agreement(path, warmup + steps, kernel_u, model, state)
    print(f"{path} path: plain versions: {plain_step * 1e3:.3f} ms/step; kernel and "
          f"plain runs agree to {worst:.3e} of max|field|")
    del model, state, kernel_u
    torch.cuda.empty_cache()
    return launches, reading


def bf16_scheme(short, option):
    return BF16_SCHEMES[short](**BF16_OPTIONS[option])


def bf16_k2_args(size, dtype, momentum, tracer, stretched=False, seed=13):
    """K2's arguments as ``scheme_k2_args`` makes them (random velocities,
    tracers b and c in [−0.1, 1.1]), on the examples' box with ``size``
    cells of ``dtype``, on the wind-mixing stretched z with ``stretched``."""
    grid = surface_grid(size, dtype, stretched)
    model = NonhydrostaticModel(grid, advection=momentum, tracer_advection=tracer,
                                tracers=("b", "c"))
    g = model.grid
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rand = lambda: torch.randn(g.total_shape, generator=gen, dtype=dtype, device=DEVICE)
    sol = {n: rand() for n in "uvw"}
    sol.update({n: 1.2 * torch.rand(g.total_shape, generator=gen, dtype=dtype,
                                    device=DEVICE) - 0.1 for n in "bc"})
    return (g, model.advection, model.tracer_advection, sol["u"], sol["v"], sol["w"],
            {n: sol[n] for n in "bc"})


def bf16_k1(label, n, dtype, scheme):
    """K1 with ``scheme`` as momentum and tracer scheme on the bench
    configuration's random fields, bit for bit and timed; returns (its
    record, the model and state)."""
    grid = RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED), dtype=dtype,
                           device=DEVICE)
    model = NonhydrostaticModel(grid, advection=scheme, tracer_advection=scheme,
                                buoyancy=BuoyancyTracer())
    if not (model.fused_step and model.g_interior):
        raise AssertionError(f"K1 {label}: the model does not take K1's fused branch")
    state = random_state(model, 1)
    poison_cache(model.grid.total_shape, dtype, 10)
    psi_k, g_k, err = hold_k1(f"K1 {label}", model, state)
    nb = tensor_bytes(state["solution"].values(), state["G_prev"].values(),
                      [state["pHY"]], psi_k.values(), g_k.values())
    del psi_k, g_k
    b = bound(K1, nb, n ** 3, flops=k2_flops(model.grid, scheme, scheme, 1) + 20)
    ms, plain_ms = time_form(K1, label, lambda: fused_ab2_advance(model, state, 1e-4, False),
                             lambda: fused_ab2_advance_reference(model, state, 1e-4, False), b)
    return form_record("bf16", label, err, ms, plain_ms, *b), model, state


def bf16_k2(label, args):
    """K2 on ``args``, bit for bit over NaN-filled outputs and timed."""
    poison_cache(args[0].total_shape, args[0].dtype, 7)
    err = hold_k2(f"K2 {label}", args, args[0].dtype)
    b = k2_bound(args)
    ms, plain_ms = time_form(K2, label, lambda: fused_advective_tendencies(*args),
                             lambda: fused_advective_tendencies_reference(*args), b)
    return form_record("bf16", label, err, ms, plain_ms, *b)


def bf16_k3a(label, n, dtype, momentum, tracer):
    """K3a at n² with ``momentum`` for uh and vh and one ``tracer`` tracer
    (as phase_schemes' holds), bit for bit over NaN-filled outputs and
    timed."""
    grid = RectilinearGrid(size=(n, n, 1), x=(0, 2 * math.pi), y=(0, 2 * math.pi),
                           topology=(PERIODIC, PERIODIC, FLAT), halo=(3, 3, 0),
                           dtype=dtype, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rand = lambda sc, o=0.0: o + sc * torch.randn(grid.total_shape, generator=gen,
                                                  dtype=dtype, device=DEVICE)
    c = 1.2 * torch.rand(grid.total_shape, generator=gen, dtype=dtype, device=DEVICE) - 0.1
    args = (grid, momentum, tracer, 10.0, rand(0.1), rand(0.1), rand(0.05, 1.0), [c], None)
    poison_cache(grid.total_shape, dtype, 4)
    names = ["uh", "vh", "h", "c"]
    got = dict(zip(names, fused_shallow_water_tendencies(*args)))
    ref = dict(zip(names, fused_shallow_water_tendencies_reference(*args)))
    err = hold(f"K3a {label}", {"G": got}, {"G": ref}, dtype, grid.interior, exact=True)
    del got, ref
    # uh and vh: two transports each; the tracer's two with its velocities
    flops = (4 * transport_ops(momentum, dtype) + 44
             + 2 * transport_ops(tracer, dtype) + 10)
    b = bound(K3A, 2 * tensor_bytes(args[4:7], args[7]), n ** 2, flops=flops)
    ms, plain_ms = time_form(K3A, label, lambda: fused_shallow_water_tendencies(*args),
                             lambda: fused_shallow_water_tendencies_reference(*args), b)
    return form_record("bf16", label, err, ms, plain_ms, *b)


def bf16_k4b(label, model, state, timed):
    """K4b's fused advance and tendency form on the model's state, bit for
    bit over NaN-filled outputs with zero halos; with ``timed``, the
    advance timed against its bound. Returns (max|Δ|, its record or None)."""
    g = model.grid
    err, record = 0.0, None
    for adv in ((HYDRO["dt"], False), None):
        poison_cache(g.total_shape, g.dtype, 12)
        got = fused_hydrostatic_tendencies(model, state, adv)
        ref = fused_hydrostatic_tendencies_reference(model, state, adv)
        form = "tendencies" if adv is None else "advance"
        pairs = (({"G": got}, {"G": ref}) if adv is None else
                 ({"psi'": got[0], "G": got[1]}, {"psi'": ref[0], "G": ref[1]}))
        err = max(err, hold(f"K4b {label}, {form}", *pairs, g.dtype, g.interior,
                            exact=True))
        for kind in pairs[0].values():  # the kernel writes its halos zero
            for name, t in kind.items():
                halo = t.clone()
                halo[g.interior_slices] = 0
                if halo.isnan().any() or halo.any():
                    raise AssertionError(f"K4b {label}, {form} {name}: a halo point "
                                         "is not zero")
        if adv is not None and timed:
            b = k4b_bound(model, state, [t for o in got for t in o.values()], True)
            del got, ref
            ms, plain_ms = time_form(K4B, f"{label}, advance",
                                     lambda: fused_hydrostatic_tendencies(model, state, adv),
                                     lambda: fused_hydrostatic_tendencies_reference(
                                         model, state, adv), b)
            record = form_record("bf16", f"{label}, advance", err, ms, plain_ms, *b)
        else:
            del got, ref
    return err, record


#: the bf16 forms on walls, an immersed bottom and a Flat x: K2 on
#: (B, B, B) and on (P, P, B) over ``unit_seamount``, K1 on (F, P, B)
BF16_WALLS = {"B,B,B": (67, 45, 29), "P,P,B immersed": (100, 77, 45),
              "F,P,B": (1, 1000, 333)}


def bf16_wall_args(where, size, dtype, option):
    """K2's arguments on ``BF16_WALLS[where]`` with WENO5 momentum and a
    PositiveWENO5 tracer under ``option``: random velocities (masked over
    the bottom), the tracer in [−0.1, 1.1]."""
    topology = ((BOUNDED,) * 3 if where == "B,B,B" else (PERIODIC, PERIODIC, BOUNDED))
    immersed = "immersed" in where
    grid = RectilinearGrid(size=size, x=(0.0, 1.0), y=(0.0, 1.0), z=(-1.0, 0.0),
                           topology=topology, dtype=dtype, device=DEVICE)
    model = NonhydrostaticModel(
        grid, advection=bf16_scheme("WENO5", option),
        tracer_advection=bf16_scheme("PW", option), tracers=("c",),
        immersed_boundary=GridFittedBottom(unit_seamount) if immersed else None)
    g = model.grid
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    sol = {n: torch.randn(g.total_shape, generator=gen, dtype=dtype, device=DEVICE)
           for n in "uvw"}
    sol["c"] = 1.2 * torch.rand(g.total_shape, generator=gen, dtype=dtype, device=DEVICE) - 0.1
    if immersed:
        sol = model.immersed_boundary.mask_state(model, {"solution": sol})["solution"]
    return (g, model.advection, model.tracer_advection, sol["u"], sol["v"], sol["w"],
            {"c": sol["c"]})


def bf16_k1_flat(label, size, dtype, option):
    """K1 on (F, P, B) with WENO5 momentum and PositiveWENO5 tracers under
    ``option`` on random fields, bit for bit (``hold_k1``) and timed."""
    grid = RectilinearGrid(size=size, x=(0.0, 1.0), y=(0.0, 1.0), z=(-1.0, 0.0),
                           topology=(FLAT, PERIODIC, BOUNDED), dtype=dtype, device=DEVICE)
    scheme, tracer = bf16_scheme("WENO5", option), bf16_scheme("PW", option)
    model = NonhydrostaticModel(grid, advection=scheme, tracer_advection=tracer,
                                buoyancy=BuoyancyTracer())
    if not model.fused_step:
        raise AssertionError(f"K1 {label}: the model does not take K1's fused branch")
    state = random_state(model, 2)
    poison_cache(model.grid.total_shape, dtype, 10)
    psi_k, g_k, err = hold_k1(f"K1 {label}", model, state)
    nb = tensor_bytes(state["solution"].values(), state["G_prev"].values(),
                      [state["pHY"]], psi_k.values(), g_k.values())
    del psi_k, g_k
    b = bound(K1, nb, math.prod(size), flops=k2_flops(model.grid, scheme, tracer, 1) + 20)
    ms, plain_ms = time_form(K1, label, lambda: fused_ab2_advance(model, state, 1e-4, False),
                             lambda: fused_ab2_advance_reference(model, state, 1e-4, False), b)
    del model, state
    return form_record("bf16", label, err, ms, plain_ms, *b)


def phase_bf16_holds():
    """The bf16 forms of K1, K2, K3a and K4b bit for bit against their
    plain versions over NaN-filled outputs, each timed against its bound
    (``transport_ops``) but K4b's forms over the bottom and on stretched
    latitudes:
    - K1 and K2 at 256³ fp32 with WENO5, BoundsPreservingWENO5 and
      PositiveWENO5 under each option as the momentum and the tracer
      scheme (the bench configuration's fields), and at 128³ fp64 with
      WENO5 (K2: PositiveWENO5 tracers) under fast_bf16;
    - K2 with WENO5 momentum and PositiveWENO5 tracers on the wind-mixing
      stretched z (the table form) under each option in fp32 and under
      fast_bf16 at 128³ fp64;
    - K2 on (B, B, B) and over ``unit_seamount`` (bounded x and y: the
      near-wall bounds read at run time and the velocities' wall faces;
      the clear flags) and K1 on (F, P, B), under each option in fp32 and
      under fast_bf16 in fp64 (``BF16_WALLS``);
    - K3a at 16384² fp32 under each option (WENO5 for uh and vh,
      PositiveWENO5 for a tracer) and at 4096² fp64 under fast_bf16;
    - K4b at 1° (``SCHEMES_HOLD``) with each of the three as flux-form
      momentum and tracers under each option on the flat bottom, WENO5
      under each over the near-global bottom, PositiveWENO5 under each on
      stretched latitudes, WENO5 under fast_bf16 in fp64, both forms after
      3 steps; and the ¼° flagship's fused advance with
      WENO5(bf16_smoothness=True) tracers on its fields.
    Returns ({kernel: largest max|Δ|}, {kernel: the records' forms})."""
    worst = {K1: 0.0, K2: 0.0, K3A: 0.0, K4B: 0.0}
    forms = {K1: [], K2: [], K3A: [], K4B: []}

    def keep(name, record):
        worst[name] = max(worst[name], record["max_abs_err"])
        forms[name].append(record)

    for short in BF16_SCHEMES:
        for option in BF16_OPTIONS:
            scheme = bf16_scheme(short, option)
            label = f"P,P,B {N}^3 fp32, {short} {option} / {short} {option}"
            record, model, state = bf16_k1(f"{label}, bench", N, torch.float32, scheme)
            keep(K1, record)
            sol = state["solution"]
            keep(K2, bf16_k2(label, (model.grid, scheme, scheme, sol["u"], sol["v"],
                                     sol["w"], {"b": sol["b"]})))
            del model, state, sol
            torch.cuda.empty_cache()
    n64 = BF16_HOLD["n64"]
    record, model, state = bf16_k1(f"P,P,B {n64}^3 fp64, WENO5 fast / WENO5 fast, bench",
                                   n64, torch.float64, bf16_scheme("WENO5", "fast"))
    keep(K1, record)
    del model, state
    cases = [(f"P,P,B {N}^3 fp32 stretched z, WENO5 {o} / PW {o}", N, torch.float32, o, True)
             for o in BF16_OPTIONS]
    cases += [(f"P,P,B {n64}^3 fp64{z}, WENO5 fast / PW fast", n64, torch.float64, "fast",
               z != "") for z in ("", " stretched z")]
    for label, n, dtype, option, stretched in cases:
        args = bf16_k2_args(n, dtype, bf16_scheme("WENO5", option),
                            bf16_scheme("PW", option), stretched)
        keep(K2, bf16_k2(label, args))
        del args
        torch.cuda.empty_cache()
    for where, size in BF16_WALLS.items():
        for dtype, option in ((torch.float32, "smoothness"), (torch.float32, "fast"),
                              (torch.float64, "fast")):
            label = (f"{where} {'x'.join(map(str, size))} {str(dtype)[6:]}, "
                     f"WENO5 {option} / PW {option}")
            if where == "F,P,B":
                keep(K1, bf16_k1_flat(label, size, dtype, option))
            else:
                keep(K2, bf16_k2(label, bf16_wall_args(where, size, dtype, option)))
            torch.cuda.empty_cache()
    for n, dtype, options in ((N_SW, torch.float32, tuple(BF16_OPTIONS)),
                              (BF16_HOLD["n_sw64"], torch.float64, ("fast",))):
        for option in options:
            keep(K3A, bf16_k3a(f"{n}x{n} {str(dtype)[6:]}, WENO5 {option} / PW {option}, "
                               "1 tracer", n, dtype, bf16_scheme("WENO5", option),
                               bf16_scheme("PW", option)))
            torch.cuda.empty_cache()
    size = SCHEMES_HOLD["size"]
    k4b = [(short, option, "flat", torch.float32) for short in BF16_SCHEMES
           for option in BF16_OPTIONS]
    k4b += [("WENO5", option, "near-global bottom", torch.float32) for option in BF16_OPTIONS]
    k4b += [("PW", option, "stretched latitude", torch.float32) for option in BF16_OPTIONS]
    k4b += [("WENO5", "fast", "flat", torch.float64)]
    for short, option, where, dtype in k4b:
        lat = stretched_latitude(size[1]) if where == "stretched latitude" else (-75, 75)
        kw = (dict(immersed_boundary=GridFittedBottom(near_global_bathymetry))
              if where == "near-global bottom" else {})
        model = latlon_flagship(grid=latlon_grid(dtype, size=size, latitude=lat),
                                momentum_advection=bf16_scheme(short, option),
                                tracer_advection=bf16_scheme(short, option), **kw)
        g = model.grid
        gen = torch.Generator(device=DEVICE).manual_seed(19)
        rand = lambda sc, o=0.0: o + sc * torch.randn(g.shape, generator=gen, dtype=dtype,
                                                      device=DEVICE)
        state = model.initial_state(u=rand(0.1), v=rand(0.1), T=rand(1.0, 10.0),
                                    S=rand(1e-2, 35.0), b=lambda lam, phi, z: 2e-5 * (
                                        z + 3000.0) / 3000.0)
        for _ in range(SCHEMES_HOLD["steps"]):
            state = model.step(state, HYDRO["dt"])
        label = (f"1 deg {str(dtype)[6:]} {where}, {short} {option} / {short} {option}")
        err, record = bf16_k4b(label, model, state, where == "flat")
        worst[K4B] = max(worst[K4B], err)
        if record is not None:
            forms[K4B].append(record)
        del model, state
        torch.cuda.empty_cache()
    # the ¼° flagship's advance with bf16_smoothness tracers on its fields
    model = latlon_flagship(tracer_advection=WENO5(bf16_smoothness=True))
    rng = np.random.default_rng(0)
    state = model.initial_state(u=0.1 * rng.standard_normal(model.grid.shape),
                                b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    for _ in range(BF16_HOLD["quarter_steps"]):
        state = model.step(state, HYDRO["dt"])
    err, record = bf16_k4b("1/4 deg fp32 flagship, weno_velocity / WENO5 smoothness",
                           model, state, True)
    worst[K4B] = max(worst[K4B], err)
    forms[K4B].append(record)
    del model, state
    torch.cuda.empty_cache()
    return worst, forms


#: examples/internal_wave.py at 32× its 128² on each axis, 4096×1×4096 fp64
#: (the example's dtype), its Δt = 0.02·2π/ω and its 100 iterations through
#: ``Simulation``: the first ``warmup`` untimed; ``hold``: steps of the
#: kernels against the plain versions from the initial state first
INTERNAL_WAVE = dict(N=4096, warmup=2, iterations=100, hold=2)


def phase_internal_wave():
    """The internal-wave path: the kernels against their plain versions
    over the first steps (exact), then the example's 100 iterations
    through ``Simulation`` with its launches counted, the example's two
    checks, K2/K3b/K3c held and timed on its fields and K6 on its fill
    groups; returns (launches, readings, K6's max|Δ|, the hold's max|Δ|)."""
    c, path = INTERNAL_WAVE, "internal wave"
    model = internal_wave.build(c["N"], DEVICE)
    if model.fused_advection or model.kernels["advect"] is not fused_advective_tendencies:
        raise AssertionError(f"{path}: the model should take the JAX branch with the kernels")
    state0 = internal_wave.initial_state(model)
    runs = {}
    for plain in (False, True):
        s = state0
        for _ in range(c["hold"]):
            s = model.step(s, internal_wave.DT, nonhydrostatic.PLAIN if plain else None)
        runs[plain] = s
    err = hold(f"{path} {c['hold']} RK3 steps, kernels against plain versions",
               {"solution": runs[False]["solution"], "p": {"pNHS": runs[False]["pNHS"]}},
               {"solution": runs[True]["solution"], "p": {"pNHS": runs[True]["pNHS"]}},
               torch.float64, exact=True)
    del runs, s
    torch.cuda.empty_cache()
    E0, x0 = internal_wave.energy(model, state0), internal_wave.centroid_x(model, state0)
    sim = Simulation(model, state=state0, dt=internal_wave.DT,
                     stop_iteration=c["iterations"])
    del state0
    _, per_step, launches = run_steps(
        path, model, None, lambda _: sim.time_step(), c["warmup"],
        c["iterations"] - c["warmup"], plain=False)
    state = sim.state
    if sim.model_iteration() != c["iterations"]:
        raise AssertionError(f"{path}: {sim.model_iteration()} iterations")
    check_finite(path, model, state, ("pHY", "pNHS"))
    t = sim.model_time()
    result = dict(drift=abs(internal_wave.energy(model, state) - E0) / E0,
                  moved=internal_wave.centroid_x(model, state) - x0,
                  expected=internal_wave.CG_X * t, time=t)
    ratio = flat_divergence_ratio(model, state)
    points = math.prod(model.grid.shape)
    used = {k: n for k, n in launches.items() if n}
    print(f"{path} path: {'x'.join(map(str, model.grid.shape))} fp64 through Simulation, "
          f"{c['iterations'] - c['warmup']} timed iterations after {c['warmup']} at dt "
          f"{internal_wave.DT:.6e}: {per_step * 1e3:.3f} ms/step, {points / per_step:.6e} "
          f"grid points/s on {card_line()}; launches {used}; t = {t:.4f}, energy drift "
          f"{result['drift']:.3e} (< 3e-2), centroid moved {result['moved']:.4f} "
          f"(analytic {result['expected']:.4f}, within 25%), max|div u|*dx/max|u| "
          f"{ratio:.3e}; kernels against plain versions over {c['hold']} steps: max|Δ| "
          f"{err:.3e}")
    internal_wave.check(result)
    if not ratio <= 1e-5:
        raise AssertionError(f"{path}: max|div u|*dx/max|u| = {ratio:.3e} > 1e-5")
    readings = wall_path_kernels(path, model, state)
    k6_err = max(hold_k6(f"K6 {path} group {i + 1}", model.grid, group, 12 + i)[0]
                 for i, group in enumerate(nonhydrostatic_fill_fields(model)))
    del sim, state, model
    torch.cuda.empty_cache()
    return launches, readings, k6_err, err


#: validation/periodic_advection.py as written: N = 128, one period of 640
#: RK3 steps for each of its 7 schemes and 2 profiles; the first ``hold``
#: steps of each run also with the plain versions, held exactly
PERIODIC_ADVECTION = dict(N=128, hold=3)


def phase_periodic_advection():
    """The validation's sweep on the card with its eight assertions; the
    kernel runs' launches counted over the whole sweep; returns (launches,
    the holds' max|Δ|)."""
    c, path = PERIODIC_ADVECTION, "periodic advection"
    results, worst, total = {}, 0.0, 0
    launches = {k: 0 for k in WRAPPERS}
    t0 = time.perf_counter()
    for profile in periodic_advection.PROFILES:
        for name, scheme in periodic_advection.SCHEMES:
            model, state, dt, steps = periodic_advection.setup(profile, scheme, c["N"],
                                                               DEVICE)
            # each run's steps counted from 0 (its initial state's fill apart)
            torch.cuda.synchronize()
            for w in WRAPPERS.values():
                w.launches = 0
            plain = state
            for i in range(steps):
                state = model.step(state, dt)
                if i < c["hold"]:
                    plain = model.step(plain, dt, nonhydrostatic.PLAIN)
                    if i == c["hold"] - 1:
                        worst = max(worst, hold(
                            f"{path} {profile} {name}: {c['hold']} steps, kernels "
                            "against plain versions", {"solution": state["solution"]},
                            {"solution": plain["solution"]}, torch.float64, exact=True))
            results[(profile, name)] = periodic_advection.score(model, state, profile)
            total += steps
            for k, w in WRAPPERS.items():
                launches[k] += w.launches
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    expected = {k: PER_STEP[path].get(k, 0) * total for k in WRAPPERS}
    if launches != expected:
        raise AssertionError(f"{path}: kernel launches {launches}, expected {expected}")
    line = ", ".join(f"{p[:5]} {n} L1 {l1:.3e} over {over:+.3e}"
                     for (p, n), (l1, over) in results.items())
    print(f"{path}: N = {c['N']} fp64, {total} RK3 steps in {elapsed:.2f} s "
          f"({elapsed / total * 1e3:.3f} ms/step with the holds) on {card_line()}; {line}")
    periodic_advection.check(results)
    print(f"{path}: the validation's eight assertions pass")
    return launches, worst


# -- the user surface: Simulation, schedules, writers, checkpoints ----------------------

#: the simulation path: examples/horizontal_convection.py:46-58 as written,
#: through ``Simulation``, on the horizontal-convection path's model and
#: seeded state (``HC``, 4096×1×2048 fp32): the example's
#: ``TimeStepWizard(cfl=0.7, max_change=1.2, max_dt=0.1)`` every 50
#: iterations with one cut, ``diffusive_cfl=0.125`` (at this size the
#: explicit diffusive limit binds, and 0.125 Δ²/κ is the path's Δt, half of
#: Δ²/(2dκ) with d = 2); the automatic NaN checker; a classic NetCDF writer
#: of b (whole) and w's top ``w_levels`` levels every ``writer_every``
#: iterations; a classic NetCDF writer of b averaged over the last half of
#: every ``checkpoint_every`` iterations' model time; a ``Checkpointer``
#: every ``checkpoint_every`` iterations; ``warmup`` and then ``iterations``
#: timed iterations. ``continuation``: (checkpoint iteration, stop
#: iteration) of the pickup hold at this size (Δt fixed, iteration
#: schedules only), ``ab2``: the same on the 256³ AB2 bench path;
#: ``average``: (iterations of the averaging interval, iterations run) of the
#: device average's hold against a host numpy accumulation.
SIMULATION = dict(warmup=2, iterations=100, writer_every=25, checkpoint_every=50,
                  w_levels=64, continuation=(30, 40), ab2=(10, 20), average=(8, 12))


def fp32_ticks(dt, n):
    """The model time after ``n`` ticks of Δt on an fp32 clock: an
    ``AveragedTimeInterval`` of that length fires on an iteration."""
    t = np.float32(0.0)
    for _ in range(n):
        t = t + np.float32(dt)
    return float(t)


def timed_firings(obj, times):
    """Wraps ``obj.write`` so that each firing appends (iteration, its host
    time in s between synchronizations of the card)."""
    write = obj.write

    def timed(sim):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write(sim)
        torch.cuda.synchronize()
        times.append((sim.model_iteration(), time.perf_counter() - t0))

    obj.write = timed
    return obj


def state_difference(a, b, prefix=""):
    """{key: max|Δ|} over every tensor of two states (and 0 or inf for the
    host leaves, by equality)."""
    out = {}
    for k, x in a.items():
        y, key = b[k], f"{prefix}{k}"
        if isinstance(x, dict):
            out.update(state_difference(x, y, f"{key}/"))
        elif isinstance(x, torch.Tensor):
            out[key] = float((x - y).abs().max())
        elif k == "clock":
            same = (x.time == y.time and x.iteration == y.iteration
                    and np.asarray(x.time).dtype == np.asarray(y.time).dtype)
            out[key] = 0.0 if same else math.inf
        else:
            same = x == y and np.asarray(x).dtype == np.asarray(y).dtype
            out[key] = 0.0 if same else math.inf
    return out


def pickup_hold(label, model, make_state, dt, every, stop, pickup, tmp):
    """Run A to ``stop`` with a ``Checkpointer`` every ``every`` iterations;
    run B, a new Simulation, picks up A's iteration-``every`` file
    (``pickup``: True for the latest, or the iteration) and runs to
    ``stop``: B's state must be A's, every tensor max|Δ| = 0; prints the
    file's MB and A's checkpoint writes in ms."""
    writes, runs, first = [], [], []
    prefix = label.replace(" ", "_").replace("^", "")
    for picks in (False, pickup):
        sim = Simulation(model, state=make_state(), dt=dt, stop_iteration=stop)
        sim.output_writers["checkpointer"] = timed_firings(
            Checkpointer(IterationInterval(every), dir=tmp, prefix=prefix),
            [] if picks else writes)
        if picks:
            sim.callbacks["first"] = Callback(lambda q: first.append(q.model_iteration()))
        sim.run(pickup=picks)
        if sim.model_iteration() != stop:
            raise AssertionError(f"{label}: stopped at {sim.model_iteration()}, not {stop}")
        runs.append(sim.state)
        del sim
    if first[0] != every:
        raise AssertionError(f"{label}: picked up iteration {first[0]}, not {every}")
    diff = state_difference(*runs)
    worst = max(diff.values())
    if worst != 0.0:
        raise AssertionError(f"{label}: the picked-up run differs: {diff}")
    mb = os.path.getsize(os.path.join(tmp, f"{prefix}_iteration{every}.npz")) / 1e6
    print(f"{label} pickup of iteration {every} (a {mb:.1f} MB checkpoint), run to {stop}: "
          f"max|Δ| {worst} over {len(diff)} leaves ({', '.join(sorted(diff))}); A's "
          f"checkpoint writes {[round(1e3 * t, 3) for _, t in writes]} ms")


def average_hold(model, make_state, dt, tmp):
    """An ``AveragedTimeInterval`` writer of b (auto-wrapped: the sum on the
    card) beside a ``WindowedTimeAverage`` of host copies of b (numpy sums)
    on the same schedule: their records must be equal bit for bit."""
    n, stop = SIMULATION["average"]
    interval = fp32_ticks(dt, n)
    sched = AveragedTimeInterval(interval, window=interval / 2)
    g = model.grid
    samples = []

    def host_b(sim):
        samples.append(sim.model_iteration())
        return g.interior(sim.state["solution"]["b"]).cpu().numpy()

    sim = Simulation(model, state=make_state(), dt=dt, stop_iteration=stop)
    host = WindowedTimeAverage(host_b, schedule=sched)
    sim.diagnostics["b on the host"] = host
    path = os.path.join(tmp, "b_average.nc")
    writer = NetCDFOutputWriter(dict(b_avg="b", b_host=host), path, schedule=sched,
                                format="classic")
    sim.output_writers["average"] = writer
    sim.run()
    writer.close()
    if not isinstance(writer.outputs["b_avg"], WindowedTimeAverage):
        raise AssertionError("the averaged writer's output was not wrapped")
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        dev, hst = f.variables["b_avg"][:], f.variables["b_host"][:]
    err = float(np.abs(dev - hst).max())
    if dev.shape[0] != 2 or err != 0.0 or len(samples) < 3:
        raise AssertionError(f"device average: {dev.shape[0]} records, max|Δ| {err} "
                             f"against the host accumulation, samples {samples}")
    print(f"simulation device average of b over iterations {samples[1:]} "
          f"(interval {interval!r} s, window half): max|Δ| {err} against a host numpy "
          "accumulation of the same samples")
    return err


def simulation_path(model, state, dt, tmp):
    """The simulation path's ``Simulation`` (``SIMULATION``) of ``model``
    from ``state``, its files in ``tmp``: the wizard, a callback keeping a
    copy of b's interior (and its iteration) at each firing of the fields
    writer, the fields writer, the averaged writer and the checkpointer.
    Returns (sim, that copy's dict)."""
    c = SIMULATION
    g = model.grid
    nz, levels = g.Nz, c["w_levels"]
    last_b = {}
    sim = Simulation(model, state=state, dt=dt)
    sim.callbacks["wizard"] = Callback(
        TimeStepWizard(cfl=0.7, max_change=1.2, max_dt=0.1, diffusive_cfl=0.125),
        IterationInterval(c["checkpoint_every"]))
    sim.callbacks["last b"] = Callback(
        lambda s: last_b.update(b=g.interior(s.state["solution"]["b"]).clone(),
                                iteration=s.model_iteration()),
        IterationInterval(c["writer_every"]))
    top_w = lambda s: windowed(s.model.fields(s.state)["w"], g,
                               (None, None, (nz - levels, nz))).data
    sim.output_writers["fields"] = NetCDFOutputWriter(
        dict(b="b", w_top=top_w), os.path.join(tmp, "fields.nc"),
        schedule=IterationInterval(c["writer_every"]), format="classic")
    interval = fp32_ticks(dt, c["checkpoint_every"])
    sim.output_writers["averages"] = NetCDFOutputWriter(
        dict(b_avg="b"), os.path.join(tmp, "averages.nc"),
        schedule=AveragedTimeInterval(interval, window=interval / 2), format="classic")
    sim.output_writers["checkpointer"] = Checkpointer(
        IterationInterval(c["checkpoint_every"]), dir=tmp, keep=1)
    return sim, last_b


def phase_simulation():
    """The simulation path (``SIMULATION``): the timed run with its
    launches counted, its checks and readings, the NetCDF read-back, the
    device average's hold and the two pickup holds; returns the timed
    run's launch counts."""
    c = SIMULATION
    model, state, dt = wall_path_model("horizontal convection")
    g = model.grid
    with tempfile.TemporaryDirectory() as tmp:
        sim, last_b = simulation_path(model, state, dt, tmp)
        del state
        firings = {name: [] for name in sim.output_writers}
        for name, w in sim.output_writers.items():
            timed_firings(w, firings[name])
        fields_path = sim.output_writers["fields"].filepath
        # one iteration a step of run_steps, which counts and times them
        _, per_it, launches = run_steps(
            "simulation", model, None, lambda _: sim.time_step(), c["warmup"],
            c["iterations"], plain=False)
        iterations = sim.model_iteration()
        if iterations != c["warmup"] + c["iterations"] or sim.dt != dt:
            raise AssertionError(f"simulation path: {iterations} iterations, Δt {sim.dt!r} "
                                 f"(the path's {dt!r})")
        # the path's checks (PERF.md §2)
        state = sim.state
        check_finite("simulation", model, state, ("pNHS", "pHY"))
        ratio = flat_divergence_ratio(model, state)
        b = g.interior(state["solution"]["b"])
        lo, hi = float(b.min()), float(b.max())
        if not (ratio <= 1e-5 and lo >= -1.001 * HC["b_star"] and hi <= 1.001 * HC["b_star"]):
            raise AssertionError(f"simulation: max|div u|*dx/max|u| {ratio:.3e}, b in "
                                 f"[{lo}, {hi}]")
        for w in sim.output_writers.values():
            if isinstance(w, NetCDFOutputWriter):
                w.close()
        from scipy.io import netcdf_file
        with netcdf_file(fields_path, "r", mmap=False) as f:
            records, b_last = f.variables["b"].shape[0], f.variables["b"][-1]
            w_shape = f.variables["w_top"].shape
        readback = float(np.abs(b_last - last_b["b"].cpu().numpy()).max())
        if (readback != 0.0 or records != iterations // c["writer_every"] + 1
                or last_b["iteration"] != iterations // c["writer_every"] * c["writer_every"]):
            raise AssertionError(f"simulation: the last b record differs by {readback} from "
                                 f"the state at iteration {last_b['iteration']}")
        used = {k: n for k, n in launches.items() if n}
        # the timed iterations' firings (the warm-up's, at initialize, apart)
        ms = {k: [1e3 * t for it, t in v if it > c["warmup"]] for k, v in firings.items()}
        loop = per_it * 1e3 - sum(map(sum, ms.values())) / c["iterations"]
        bare = BARE_STEP_MS["horizontal convection"]
        print(f"simulation: {'x'.join(map(str, g.shape))} fp32 through Simulation, "
              f"{c['iterations']} timed iterations at dt {dt:.6e}: "
              f"{per_it * 1e3:.3f} ms/iteration, {loop:.3f} "
              f"ms/iteration excluding firings, bare model.step {bare:.3f} ms/step "
              f"(ratio {loop / bare:.4f}); "
              f"ms per firing: fields writer {ms['fields']}, averaged writer "
              f"{ms['averages']}, checkpointer {ms['checkpointer']}; "
              f"{records} b records of {tuple(b_last.shape)} and w_top {w_shape}; last b record "
              f"max|Δ| {readback} against the state; max|div u|*dx/max|u| {ratio:.3e}; b in "
              f"[{lo:.6f}, {hi:.6f}]; launches {used} on {card_line()}")
        del sim, state, b, last_b
        torch.cuda.empty_cache()
        make_state = lambda: wall_path_model("horizontal convection")[1]
        average_hold(model, make_state, dt, tmp)
        every, stop = c["continuation"]
        pickup_hold("simulation", model, make_state, dt, every, stop, True, tmp)
        del model
        torch.cuda.empty_cache()
        ab2 = model_for(N, torch.float32)
        if not (ab2.fused_step and ab2.g_interior):
            raise AssertionError("the AB2 bench path does not take K1's fused branch")
        every, stop = c["ab2"]
        # A checkpoints at its stop too: B picks up the iteration by number
        pickup_hold(f"AB2 {N}^3", ab2, lambda: bench_state(ab2), PATHS["AB2"][1], every,
                    stop, every, tmp)
        del ab2
        torch.cuda.empty_cache()
    return launches


# -- ocean physics: CATKE, convective adjustment, Ri-based mixing, GM/Redi ------

def phase_closures_hold():
    """The closures hold (``CLOSURES_HOLD``): the ocean-physics configuration
    at 1° with each closure in CATKE's place, and with CATKE under Roquet's
    equation of state, its steps with the kernels and with their plain
    versions held bit for bit (max|Δ| = 0) and finite; each run's launches
    checked against ``PER_STEP`` (a comparison: no record)."""
    c = CLOSURES_HOLD
    for kind in c["kinds"]:
        path = f"closures hold: {kind}"
        out, ms, counts = {}, {}, {}
        for plain in (False, True):
            model = ocean_model(kind, c["size"])
            if model.fused_advance:
                raise AssertionError(f"{path}: the two-stage route was expected")
            kernels = hydrostatic.PLAIN if plain else None
            out[plain], ms[plain], counts[plain] = run_steps(
                path, model, ocean_state(model),
                lambda s: model.step(s, HYDRO["dt"], kernels), 0, c["steps"], plain)
        got, ref = out[False], out[True]
        hold(f"{path}, 1 deg {'x'.join(map(str, c['size']))} fp32, {c['steps']} steps",
             {"solution": got["solution"], "p": {"eta": got["eta"], "pHY": got["pHY"]}},
             {"solution": ref["solution"], "p": {"eta": ref["eta"], "pHY": ref["pHY"]}},
             torch.float32, exact=True)
        check_finite(path, model, got, ("w", "pHY", "eta"))
        print(f"{path}: tracers {model.tracer_names}, launches "
              f"{ {k: n for k, n in counts[False].items() if n} } in {c['steps']} "
              f"steps, {ms[False] * 1e3:.3f} ms/step (plain {ms[True] * 1e3:.3f}), "
              "every field finite")
        del out, got, ref, model
        torch.cuda.empty_cache()


def free_convection_model(kind):
    """validation/vertical_mixing_closures.py's column model with closure
    ``kind``, on ``FREE_CONVECTION``'s periodic grid."""
    c = FREE_CONVECTION
    grid = RectilinearGrid(size=c["size"], x=(0.0, float(c["size"][0])),
                           y=(0.0, float(c["size"][1])), z=(-c["H"], 0.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED),
                           dtype=torch.float64, device=DEVICE)
    closure = {"CATKE": CATKEVerticalDiffusivity(),
               "convective adjustment": ConvectiveAdjustmentVerticalDiffusivity(
                   convective_kappa_z=1.0, background_kappa_z=1e-5),
               "Ri-based": RiBasedVerticalDiffusivity()}[kind]
    return HydrostaticFreeSurfaceModel(
        grid, buoyancy=BuoyancyTracer(), momentum_advection=None,
        tracer_advection=None, closure=closure,
        free_surface=ImplicitFreeSurface(solver_method="pcg"),
        boundary_conditions={"b": FieldBCs(top=FluxBC(c["B0"]))})


def phase_nonhydrostatic_closures():
    """The nonhydrostatic closures hold (``NONHYDROSTATIC_HOLD``): the
    wind-mixing configuration at 128³ fp32 under TEOS-10, under Roquet and
    with CATKE beside its ScalarDiffusivity, its RK3 steps with the kernels
    and with their plain versions held bit for bit and finite."""
    c = NONHYDROSTATIC_HOLD
    for kind in c["kinds"]:
        path = f"nonhydrostatic closures hold: {kind}"
        out, counts = {}, {}
        for plain in (False, True):
            kw = ({"eos": TEOS10EquationOfState()} if kind == "TEOS-10" else
                  {"eos": RoquetIdealizedEquationOfState()} if kind == "Roquet" else
                  {"closure": (ScalarDiffusivity(nu=1e-5, kappa=1e-5),
                               CATKEVerticalDiffusivity())})
            model = wind_mixing_model(c["n"], **kw)
            extra = {"e": OCEAN["e"]} if "e" in model.tracer_names else {}
            state = surface_state("wind mixing", model, **extra)
            kernels = nonhydrostatic.PLAIN if plain else None
            out[plain], _, counts[plain] = run_steps(
                path, model, state, lambda s: model.step(s, SURFACE["wind mixing"][0],
                                                         kernels),
                0, c["steps"], plain)
        got, ref = out[False], out[True]
        hold(f"{path}, {c['n']}^3 fp32, {c['steps']} RK3 steps",
             {"solution": got["solution"], "p": {"pHY": got["pHY"], "pNHS": got["pNHS"]}},
             {"solution": ref["solution"], "p": {"pHY": ref["pHY"], "pNHS": ref["pNHS"]}},
             torch.float32, exact=True)
        check_finite(path, model, got, ("pHY", "pNHS"))
        print(f"{path}: tracers {model.tracer_names}, launches "
              f"{ {k: n for k, n in counts[False].items() if n} } in {c['steps']} "
              "steps, every field finite")
        del out, got, ref, model
        torch.cuda.empty_cache()


# -- the Flat slice: K4a, K4b and K5 on Flat axes, K4b's Cartesian Coriolis ---

#: the Flat topologies K4a, K4b and K5 take, with the sizes of their holds
FLAT_HYDRO = (("F,P,B", (FLAT, PERIODIC, BOUNDED), (1, 256, 32)),
              ("F,B,B", (FLAT, BOUNDED, BOUNDED), (1, 256, 32)),
              ("P,F,B", (PERIODIC, FLAT, BOUNDED), (256, 1, 32)),
              ("B,F,B", (BOUNDED, FLAT, BOUNDED), (256, 1, 32)),
              ("F,F,B", (FLAT, FLAT, BOUNDED), (1, 1, 64)))
#: K4b's Cartesian Coriolis forms, held on a (Periodic, Bounded, Bounded) box
CARTESIAN = {"ConstantCartesianCoriolis": lambda: ConstantCartesianCoriolis(
                 fx=2e-5, fy=5e-5, fz=1e-4),
             "NonTraditionalBetaPlane": lambda: NonTraditionalBetaPlane(
                 fz0=1e-4, fy0=5e-5, beta=1.6e-11, gamma=-1e-11)}
CARTESIAN_HOLD = dict(size=(256, 128, 32), steps=3)
#: the paths that run each Flat topology's forms (their launches go into
#: the forms' records)
FLAT_FORM_PATHS = {"F,B,B": ("front slice",),
                   "F,F,B": ("column closures", "wind mixing column", "ensemble columns")}


def flat_hydro_model(topology, size, dtype, momentum=None, coriolis=None,
                     free_surface=None):
    """A hydrostatic model of the Flat holds: WENO5 tracers T, S and b, a
    β-plane, an explicit constant-coefficient closure (K4b's in-kernel
    closure) and a split-explicit free surface unless given otherwise."""
    grid = RectilinearGrid(size=size, x=(0, 2e6), y=(0, 1e6), z=(-1000, 0),
                           topology=topology, dtype=dtype, device=DEVICE)
    return HydrostaticFreeSurfaceModel(
        grid, momentum_advection=momentum or WENO5(), tracer_advection=WENO5(),
        tracers=("T", "S"), buoyancy=BuoyancyTracer(),
        coriolis=coriolis or BetaPlane(f0=1e-4, beta=1.6e-11),
        closure=ScalarDiffusivity(nu=1e2, kappa=1e1, nu_z=1e-3, kappa_z=1e-4),
        free_surface=free_surface or SplitExplicitFreeSurface(substeps=8))


def hold_k4b(label, model, state):
    """K4b against its plain version in both forms, bit for bit on the
    interior over NaN-filled outputs, its halos exactly zero; max|Δ|."""
    g, dtype = model.grid, model.grid.dtype
    err = 0.0
    for adv in (None, (HYDRO["dt"], False)):
        poison_cache(g.total_shape, dtype)
        got = fused_hydrostatic_tendencies(model, state, adv)
        ref = fused_hydrostatic_tendencies_reference(model, state, adv)
        got, ref = (({"G": got}, {"G": ref}) if adv is None else
                    ({"psi'": got[0], "G": got[1]}, {"psi'": ref[0], "G": ref[1]}))
        form = "tendencies" if adv is None else "advance"
        err = max(err, hold(f"K4b {label}, {form}", got, ref, dtype, g.interior,
                            exact=True))
        for kind in got.values():  # the kernel writes its halos zero
            for name, t in kind.items():
                if t.device.type != "cuda":
                    continue
                halo = t.clone()
                halo[g.interior_slices] = 0
                if halo.isnan().any() or halo.any():
                    raise AssertionError(f"K4b {label}, {form} {name}: a halo point "
                                         "is not zero")
        del got, ref
    return err


def hold_k4a(label, g, sol):
    """K4a against its plain version on every with-halo point, with b and
    w only, over NaN-filled outputs; max|Δ|."""
    args = (g, sol["u"], sol["v"], sol["b"])
    outputs = lambda ts: {n: t for n, t in zip(("w", "pHY"), ts) if t is not None}
    err = 0.0
    for part, a in (("w and pHY'", args), ("w only", args[:3])):
        poison_cache(g.total_shape, g.dtype)
        err = max(err, hold(f"K4a {label} {part}", {"out": outputs(hydrostatic_columns(*a))},
                            {"out": outputs(hydrostatic_columns_reference(*a))}, g.dtype,
                            exact=True))
    return err


def k5_args(model, seed, n):
    """Random arguments of K5 on the model's grid (η filled)."""
    g = model.grid
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    shape = g.total_shape[:2] + (1,)
    rand = lambda s: s * torch.randn(shape, generator=gen, dtype=g.dtype, device=DEVICE)
    eta = fill2d(rand(0.1), g, ETA_LOC, model.eta_bcs)
    wv = model.free_surface._weight_vec(None, eta)
    return (g, model.eta_bcs, eta, rand(10.0), rand(10.0), rand(1e-3), rand(1e-3),
            *column_depths(g), 9.80665, 40.0, wv, wv, n)


def hold_k5(label, model, args):
    """K5 against its plain version on every with-halo point over
    NaN-filled outputs; max|Δ|."""
    g = model.grid
    names = ("eta_av", "U_av", "V_av")
    poison_cache(g.total_shape[:2] + (1,), g.dtype, 20)
    return hold(f"K5 {label}", {"out": dict(zip(names, fused_substep_eta(*args)))},
                {"out": dict(zip(names, fused_substep_eta_reference(*args)))},
                g.dtype, exact=True)


def steps_agree(label, model, state, steps, dt=60.0):
    """``steps`` model steps with the kernels and with their plain versions,
    every solution field and η bit for bit."""
    runs = []
    for kernels in (None, hydrostatic.PLAIN):
        s = state
        for _ in range(steps):
            s = model.step(s, dt, kernels=kernels)
        runs.append(s)
    got = dict(runs[0]["solution"], eta=runs[0]["eta"])
    ref = dict(runs[1]["solution"], eta=runs[1]["eta"])
    return hold(f"{label}, {steps} steps kernels against plain", {"s": got}, {"s": ref},
                model.grid.dtype, exact=True)


def phase_flat_holds():
    """K4a, K4b (both forms, both momentum forms) and K5 on the five Flat
    topologies in fp32 and fp64, and K4b's Cartesian Coriolis forms on a
    (Periodic, Bounded, Bounded) box, each bit for bit its plain version;
    3 model steps with the kernels against 3 with the plain versions on
    each. Returns ({kernel: largest max|Δ|}, {kernel: the fp32 forms'
    readings, timed by CUDA events})."""
    worst = {K4A: 0.0, K4B: 0.0, K5: 0.0}
    forms = {K4A: [], K4B: [], K5: []}
    for short, topology, size in FLAT_HYDRO:
        for dtype in (torch.float32, torch.float64):
            tag = f"{short} {'x'.join(map(str, size))} {str(dtype)[6:]}"
            for momentum in (WENO5(), VectorInvariant()):
                model = flat_hydro_model(topology, size, dtype, momentum)
                state = hydro_random_state(model, 21)
                label = f"Flat {tag} {type(momentum).__name__}"
                # the last (VectorInvariant) model's is the timed form's reading
                err_b = hold_k4b(label, model, state)
                worst[K4B] = max(worst[K4B], err_b)
            g, sol = model.grid, state["solution"]
            err_a = hold_k4a(f"Flat {tag}", g, sol)
            args = k5_args(model, 22, 8)
            err_5 = hold_k5(f"Flat {tag}, 8 substeps", model, args)
            worst[K4A], worst[K5] = max(worst[K4A], err_a), max(worst[K5], err_5)
            if dtype is torch.float64:
                worst[K4B] = max(worst[K4B], steps_agree(f"Flat {tag}", model, state, 3))
                continue
            points = g.Nx * g.Ny * g.Nz
            a = (g, sol["u"], sol["v"], sol["b"])
            w, ph = hydrostatic_columns(*a)
            forms[K4A].append(form_record(
                short, f"{tag}, w and pHY'", err_a, cuda_ms(lambda: hydrostatic_columns(*a), 20),
                cuda_ms(lambda: hydrostatic_columns_reference(*a), 3),
                *bound(K4A, tensor_bytes(a[1:], [w, ph]), points)))
            adv = (HYDRO["dt"], False)
            psi, G = fused_hydrostatic_tendencies(model, state, adv)
            nb = tensor_bytes(sol.values(), [state["w"], state["pHY"]],
                              state["G_prev"].values(), psi.values(), G.values())
            forms[K4B].append(form_record(
                short, f"{tag}, VectorInvariant, advance", err_b,
                cuda_ms(lambda: fused_hydrostatic_tendencies(model, state, adv), 20),
                cuda_ms(lambda: fused_hydrostatic_tendencies_reference(model, state, adv), 3),
                *bound(K4B, nb, points, K4B_FORM_FLOPS["closure"])))
            forms[K5].append(form_record(
                short, f"{tag}, 8 substeps", err_5, cuda_ms(lambda: fused_substep_eta(*args), 20),
                cuda_ms(lambda: fused_substep_eta_reference(*args), 3),
                *bound(K5, 10 * tensor_bytes([args[2]]),
                       g.total_shape[0] * g.total_shape[1] * 8)))
            print(f"Flat {tag} times (CUDA events): K4a {forms[K4A][-1]['ms']:.4f} ms, "
                  f"K4b advance {forms[K4B][-1]['ms']:.4f} ms, K5 {forms[K5][-1]['ms']:.4f} ms")
            del w, ph, psi, G
        del model, state, args
        torch.cuda.empty_cache()
    size = CARTESIAN_HOLD["size"]
    for name, make in CARTESIAN.items():
        for dtype in (torch.float32, torch.float64):
            tag = f"P,B,B {'x'.join(map(str, size))} {str(dtype)[6:]}"
            for momentum in (WENO5(), VectorInvariant()):
                model = flat_hydro_model((PERIODIC, BOUNDED, BOUNDED), size, dtype,
                                         momentum, make())
                state = hydro_random_state(model, 23)
                label = f"{name} {tag} {type(momentum).__name__}"
                err = hold_k4b(label, model, state)
                err = max(err, steps_agree(label, model, state, CARTESIAN_HOLD["steps"]))
                worst[K4B] = max(worst[K4B], err)
                if dtype is torch.float32 and isinstance(momentum, VectorInvariant):
                    adv = (HYDRO["dt"], False)
                    g, sol = model.grid, state["solution"]
                    psi, G = fused_hydrostatic_tendencies(model, state, adv)
                    nb = tensor_bytes(sol.values(), [state["w"], state["pHY"]],
                                      state["G_prev"].values(), psi.values(), G.values())
                    forms[K4B].append(form_record(
                        name, f"{tag}, VectorInvariant, advance", err,
                        cuda_ms(lambda: fused_hydrostatic_tendencies(model, state, adv), 20),
                        cuda_ms(lambda: fused_hydrostatic_tendencies_reference(
                            model, state, adv), 3),
                        *bound(K4B, nb, g.Nx * g.Ny * g.Nz, K4B_FORM_FLOPS["closure"])))
                    print(f"{label} K4b advance time: {forms[K4B][-1]['ms']:.4f} ms "
                          "(CUDA events)")
                    del psi, G
                del model, state
                torch.cuda.empty_cache()
    return worst, forms


#: the model steps of each column's hold, kernels against plain versions
COLUMN_HOLD_STEPS = 4


def column_steps_agree(path, fresh, end, dt):
    """A column path's configuration held bit for bit: ``COLUMN_HOLD_STEPS``
    steps with the kernels against as many with their plain versions (K4a,
    K4b's tendency form, T1 and K6), from ``fresh`` (the path's model and
    initial state built again: an Euler first step) and from ``end`` (the
    path's model and end state); max|Δ|. Run after the path's counts were
    read, so these launches count on no path."""
    return max(steps_agree(f"{path}, from {start}", model, state, COLUMN_HOLD_STEPS, dt)
               for start, (model, state) in (("its initial state", fresh),
                                              ("the run's end", end)))


def phase_column_closures():
    """validation/vertical_mixing_closures.py as written, through the port's
    copy: the (Flat, Flat, Bounded) 1×1×64 fp64 column under each closure,
    720 steps of 60 s, with the kernels (K4a, K4b's tendency form, T1, K6;
    the counts include the initial state's K4a and two K6);
    the validation's assertions (budget within 2%, the mixed layer's
    gradient, the depth ratio); then each column's configuration held bit
    for bit (``column_steps_agree``). Returns (the launch counts by path,
    the holds' largest max|Δ|)."""
    vmc = vertical_mixing_closures
    steps = int(vmc.T_END / vmc.DT)
    by_path, results, err = {}, {}, 0.0
    for name, make in vmc.CLOSURES:
        path = f"column closures: {name}"
        zero_counts()
        t0 = time.perf_counter()
        h, budget, grad, model, state = vmc.run_closure(name, make(), device=DEVICE)
        torch.cuda.synchronize()
        per_step = (time.perf_counter() - t0) / steps
        # the copy builds its model and initial state inside the count
        by_path[path] = read_counts(path, steps, INITIAL_STATE)
        check_finite(path, model, state, ("w", "pHY", "eta"))
        results[name] = (h, budget, grad)
        print(f"{path}: (Flat, Flat, Bounded) 1x1x{model.grid.Nz} fp64, {steps} steps "
              f"{per_step * 1e3:.3f} ms/step, h = {h:.1f} m (h/h_exp = "
              f"{h / vmc.expected_depth():.3f}), budget {budget:.5f}, mixed-layer "
              f"max|db/dz| {grad}; launches "
              f"{ {k: n for k, n in by_path[path].items() if n} } on {card_line()}")
        fresh = vmc.model_for(make(), device=DEVICE)
        err = max(err, column_steps_agree(path, (fresh, vmc.initial_state(fresh)),
                                          (model, state), vmc.DT))
        del model, state, fresh
    vmc.check(results)
    print("column closures: the validation's assertions pass")
    return by_path, err


def phase_wind_mixing_column():
    """validation/wind_mixing_column.py as written, through the port's copy:
    the stretched-z (Flat, Flat, Bounded) 1×1×48 fp64 CATKE column under
    its wind, 240 ``Simulation`` iterations with the kernels; its final TKE
    profile; every field finite, e > 0 in the top five cells, the top
    layer's u along the wind (against the sign of the kinematic stress,
    an upward flux); then the column's configuration held bit for bit
    (``column_steps_agree``). Returns (the launch counts by path, the
    hold's max|Δ|)."""
    wmc, path = wind_mixing_column, "wind mixing column"
    sim = wmc.simulation(device=DEVICE)
    zero_counts()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    per_it = (time.perf_counter() - t0) / wmc.STOP_ITERATION
    launches = read_counts(path, wmc.STOP_ITERATION)
    model, state = sim.model, sim.state
    check_finite(path, model, state, ("w", "pHY", "eta"))
    e = wmc.tke_profile(sim)
    u_top = float(model.grid.interior(state["solution"]["u"])[0, 0, -1])
    print(f"{path}: final TKE profile (top 5): {e}")
    if not (e > 0).all():
        raise AssertionError(f"{path}: e <= 0 near the surface: {e}")
    if not u_top * wmc.WIND_STRESS < 0:
        raise AssertionError(f"{path}: the top layer's u {u_top:.6e} does not follow "
                             f"the wind (kinematic stress {wmc.WIND_STRESS})")
    print(f"{path}: 1x1x{model.grid.Nz} fp64 stretched z, {wmc.STOP_ITERATION} "
          f"iterations {per_it * 1e3:.3f} ms/iteration, top-layer u {u_top:.6e} m/s, "
          f"launches { {k: n for k, n in launches.items() if n} } on {card_line()}")
    fresh = wmc.model_for(device=DEVICE)
    err = column_steps_agree(path, (fresh, wmc.initial_state(fresh)), (model, state),
                             wmc.DT)
    return {path: launches}, err


#: the Stommel gyre's timed reading: N, warm-up and timed steps
GYRE_TIMED = dict(N=1024, warmup=2, steps=5)


def phase_gyre():
    """validation/barotropic_gyre.py's model, through the port's copy, at
    its timed reading's N = 1024 fp64 (2 warm-up, 5 timed steps): ms a
    step, the two forcing callables' share of it (three stages a step, CUDA
    events), and 3 steps with K3a against 3 with its plain version, bit for
    bit. (The validation's own ~10⁴ RK3 steps at N = 64 are not run here
    since the decomposed near-global path came; its scores and three
    assertions are checked on the CPU on the analytic Stommel state, by
    tests/test_torch_flat_hydrostatic.py::test_gyre_copy_checks_its_scores.)
    Returns the launch counts by path."""
    bg = barotropic_gyre
    by_path = {}
    c, path = GYRE_TIMED, "Stommel gyre 1024"
    model = bg.model_for(c["N"], DEVICE)
    dt = bg.time_step(c["N"])[0]
    state = model.initial_state(h=bg.H)
    plain = state
    state, per_step, by_path[path] = run_steps(
        path, model, state, lambda s: model.step(s, dt), c["warmup"], c["steps"], False)
    for _ in range(c["warmup"] + c["steps"]):
        plain = model.step(plain, dt, shallow_water.PLAIN)
    hold(f"{path}: {c['warmup'] + c['steps']} steps, K3a against its plain version",
         {"solution": state["solution"]}, {"solution": plain["solution"]},
         torch.float64, model.grid.interior, exact=True)
    g, sol, clock = model.grid, state["solution"], state["clock"]
    forcing_ms = cuda_ms(lambda: [model.forcing[n](g, clock, sol) for n in model.forcing],
                         20)
    step_ms = cuda_ms(lambda: model.step(state, dt), 5)
    share = 3 * forcing_ms / step_ms
    print(f"{path}: {c['N']}x{c['N']} fp64, {per_step * 1e3:.3f} ms/step (wall), "
          f"{step_ms:.4f} ms/step (CUDA events); the two forcing callables "
          f"{forcing_ms:.4f} ms a stage, {share:.4f} of the step on {card_line()}")
    del model, state, plain
    torch.cuda.empty_cache()
    return by_path


#: the front slice: examples/baroclinic_adjustment.py:29-61's physics on a
#: zonally symmetric y-z slice, (Flat, Bounded, Bounded) 1×8192×128 fp32
#: over its 1000 km × 1 km channel (Δy ≈ 122 m, Δz ≈ 7.8 m): its β-plane at
#: 45°S, WENO5 momentum and tracers, its ScalarDiffusivity(kh = 0.1) with
#: the vertical part scaled by the slice's aspect ratio Δz/Δy, its front
#: b = N²z + Δb ramp(y) plus noise from numpy seed 1, with
#: SplitExplicitFreeSurface(substeps=30) in place of its implicit free
#: surface (K5's Flat-x form). Δt = 10 s: the advective limit Δy/U is
#: ~150 s at the front's thermal wind M²H/f ≈ 0.8 m/s, the first internal
#: mode's NH/π ≈ 0.64 m/s gives Δy/c ≈ 190 s, and the substeps (Δτ =
#: 2Δt/30) keep the barotropic wave √(gH) ≈ 99 m/s at cΔτ/Δy ≈ 0.54,
#: which binds (it passes 1 at Δt ≈ 18 s). Users: studies of front
#: adjustment in a zonally averaged channel, where the 3D example's
#: baroclinic instability is excluded by construction.
FRONT = dict(size=(1, 8192, 128), Ly=1000e3, Lz=1e3, dt=10.0, warmup=2, steps=5,
             N2=4e-6, M2=8e-8, dy_front=50e3, kh=0.1)


def front_model_state():
    c = FRONT
    grid = RectilinearGrid(size=c["size"], x=(0.0, 1.0), y=(-c["Ly"] / 2, c["Ly"] / 2),
                           z=(-c["Lz"], 0.0), topology=(FLAT, BOUNDED, BOUNDED),
                           dtype=torch.float32, device=DEVICE)
    omega, radius = 7.292115e-5, 6.371e6
    coriolis = BetaPlane(f0=2 * omega * math.sin(math.radians(-45.0)),
                         beta=2 * omega * math.cos(math.radians(-45.0)) / radius)
    aspect = (c["Lz"] / c["size"][2]) / (c["Ly"] / c["size"][1])
    closure = ScalarDiffusivity(nu=c["kh"], kappa=c["kh"], nu_z=aspect * c["kh"],
                                kappa_z=aspect * c["kh"])
    model = HydrostaticFreeSurfaceModel(
        grid, coriolis=coriolis, buoyancy=BuoyancyTracer(), closure=closure,
        momentum_advection=WENO5(), tracer_advection=WENO5(),
        free_surface=SplitExplicitFreeSurface(substeps=30))
    db = c["dy_front"] * c["M2"]
    g = model.grid
    noise = 1e-2 * db * np.random.default_rng(1).standard_normal(g.shape)
    y = g.nodes(CENTER)[1].double().cpu().numpy()
    z = g.nodes(CENTER)[2].double().cpu().numpy()
    b0 = c["N2"] * z + db * np.clip(y / c["dy_front"] + 0.5, 0.0, 1.0) + noise
    return model, model.initial_state(b=b0)


def phase_front_slice():
    """The front slice (``FRONT``) with the kernels, then with their plain
    versions: 2 warm-up and 5 timed steps, 1 K4a, 1 K4b (its fused advance
    with the in-kernel closure, the Flat-x layout), 1 K5 and 2 K6 a step;
    every field finite, |Σ η·Az| ≤ 1e-5·Σ|η|·Az, the two runs bit for bit;
    K4b held and timed on the path's fields. Returns (launches, K4b's
    reading on the path)."""
    c, path = FRONT, "front slice"
    model, state = front_model_state()
    if not model.fused_advance:
        raise AssertionError(f"{path}: the model does not take K4b's fused advance")
    state, per_step, launches = run_steps(
        path, model, state, lambda s: model.step(s, c["dt"]), c["warmup"], c["steps"],
        False)
    check_finite(path, model, state, ("w", "pHY", "eta"))
    g = model.grid
    cut = lambda a: a[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny, 0].double()
    az = cut(torch.broadcast_to(g.Az(ETA_LOC), state["eta"].shape))
    net, gross = (float((cut(state["eta"]) * az).sum()),
                  float((cut(state["eta"]).abs() * az).sum()))
    if not abs(net) <= 1e-5 * gross:
        raise AssertionError(f"{path}: |sum(eta Az)| {abs(net):.3e} > 1e-5 "
                             f"sum(|eta| Az) = {1e-5 * gross:.3e}")
    adv = (c["dt"], False)
    got = fused_hydrostatic_tendencies(model, state, adv)
    ref = fused_hydrostatic_tendencies_reference(model, state, adv)
    err = hold(f"K4b {path} advance on the path's fields",
               {"psi'": got[0], "G": got[1]}, {"psi'": ref[0], "G": ref[1]},
               torch.float32, g.interior, exact=True)
    b_ms, b_by = k4b_bound(model, state, [t for o in got for t in o.values()], True)
    del got, ref
    ms = cuda_ms(lambda: fused_hydrostatic_tendencies(model, state, adv), 10)
    plain_ms = cuda_ms(lambda: fused_hydrostatic_tendencies_reference(model, state, adv), 2)
    points = g.Nx * g.Ny * g.Nz
    steps = c["warmup"] + c["steps"]
    print(f"{path} path: (Flat, Bounded, Bounded) {g.Nx}x{g.Ny}x{g.Nz} fp32, dt "
          f"{c['dt']} s, {c['steps']} steps: {per_step * 1e3:.3f} ms/step, "
          f"{points / per_step:.6e} grid points/s, launches "
          f"{ {k: n for k, n in launches.items() if n} } in {steps} steps, "
          f"|sum(eta Az)|/sum(|eta| Az) {abs(net) / gross:.3e}; K4b advance on its "
          f"fields {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
          f"on {card_line()}")
    reading = form_record(path, f"F,B,B {g.Nx}x{g.Ny}x{g.Nz} fp32 advance, WENO5, "
                          "in-kernel closure, Flat-x layout", err, ms, plain_ms, b_ms,
                          b_by, launches[K4B])
    kernel_run = dict(state["solution"], eta=state["eta"])
    model, state = front_model_state()
    state, plain_step, _ = run_steps(
        path, model, state, lambda s: model.step(s, c["dt"], hydrostatic.PLAIN),
        c["warmup"], c["steps"], True)
    hold(f"{path}: {steps} steps with the kernels against the plain versions",
         {"s": kernel_run}, {"s": dict(state["solution"], eta=state["eta"])},
         torch.float32, exact=True)
    print(f"{path} path: plain versions {plain_step * 1e3:.3f} ms/step")
    del model, state, kernel_run
    torch.cuda.empty_cache()
    return launches, reading


# -- the stencil-matrix slice: a stretched x or y, the matrix and multigrid free
# -- surfaces, Lagrangian particles ---------------------------------------------

#: the stretched channel (the JAX suite's fully stretched configuration,
#: tests/test_matrix_solvers.py:147-173, at full width): (Bounded, Periodic,
#: Bounded) on [−1, 1] × [0, 1] × [−1, 0], x faces tanh(linspace(−1.2, 1.2))
#: / tanh(1.2), z faces −cos(linspace(0, π/2)), fp64 (the model's
#: multigrid tolerance of 1e-9 is below fp32's resolution), WENO5 momentum
#: and tracer c, quasi-AB2 at Δt = 1e-3, u, v ~ 1e-2 N(0, 1) and 2²⁰
#: particles uniform in the domain from numpy seed 9, tracking c; 1 warm-up
#: and 1 timed step (each ~5–8 s of host-bound multigrid CG), cut from 2
#: and 5, then (for the decomposed near-global path) from 1 and 2, to keep
#: the whole run well inside its limit
CHANNEL = dict(size=(256, 256, 128), dt=1e-3, warmup=1, steps=1, particles=2 ** 20,
               seed=9)
#: the ¼° flagship with ImplicitFreeSurface(solver_method=m, maxiter=50) in
#: place of split-explicit(30), as __graft_entry__.py:128 builds the
#: flagship's implicit free surface; 1 warm-up and 2 timed steps (the
#: multigrid one ~1 s a step), cut from 2 and 5 as the channel's
IMPLICIT_FS = dict(methods=("matrix", "multigrid"), maxiter=50, warmup=1, steps=2)
#: validation/implicit_free_surface.py as written: N
IFS_VALIDATION = dict(N=64)
#: the particle holds: the shallow-water headline at 1024² with a tracer,
#: and the ¼° flagship, each with 2¹⁶ particles, 3 steps
PARTICLES_HOLD = dict(n_sw=1024, particles=2 ** 16, steps=3)
#: K2's stretched-x/y form's holds: (label, stretched axes, topology, size,
#: dtype, momentum, tracer scheme, immersed); each scheme a class or a
#: partial that makes it
PW01 = functools.partial(PositiveWENO5, bounds=(0.0, 1.0))
K2XY_CASES = (
    ("x P,P,B 100x77x45 fp32 WENO5/WENO5", "x", (PERIODIC, PERIODIC, BOUNDED),
     (100, 77, 45), torch.float32, WENO5, WENO5, False),
    ("x B,P,B 100x77x45 fp64 WENO5/UB3", "x", (BOUNDED, PERIODIC, BOUNDED),
     (100, 77, 45), torch.float64, WENO5, UpwindBiasedThirdOrder, False),
    ("y P,B,B 96x130x40 fp32 UB3/PositiveWENO5", "y", (PERIODIC, BOUNDED, BOUNDED),
     (96, 130, 40), torch.float32, UpwindBiasedThirdOrder, PW01, False),
    ("x+y B,B,B 90x90x36 fp64 C4/WENO5", "xy", (BOUNDED, BOUNDED, BOUNDED),
     (90, 90, 36), torch.float64, CenteredFourthOrder, WENO5, False),
    ("x+z B,P,B 96x64x48 fp32 WENO5/PositiveWENO5", "xz", (BOUNDED, PERIODIC, BOUNDED),
     (96, 64, 48), torch.float32, WENO5, PW01, False),
    ("x B,F,B 512x1x256 fp64 WENO5/WENO5", "x", (BOUNDED, FLAT, BOUNDED),
     (512, 1, 256), torch.float64, WENO5, WENO5, False),
    ("x B,P,B 128x96x48 fp32 immersed WENO5/WENO5", "x", (BOUNDED, PERIODIC, BOUNDED),
     (128, 96, 48), torch.float32, WENO5, WENO5, True),
    ("x B,P,B 128x96x48 fp64 immersed WENO5/PositiveWENO5", "x",
     (BOUNDED, PERIODIC, BOUNDED), (128, 96, 48), torch.float64, WENO5, PW01, True),
    ("x+y B,B,B 90x90x36 fp32 UB1/UB1", "xy", (BOUNDED, BOUNDED, BOUNDED),
     (90, 90, 36), torch.float32, UpwindBiasedFirstOrder, UpwindBiasedFirstOrder, False),
    ("x+z B,P,B 96x64x48 fp64 UB5/UB5", "xz", (BOUNDED, PERIODIC, BOUNDED),
     (96, 64, 48), torch.float64, UpwindBiasedFifthOrder, UpwindBiasedFifthOrder, False),
    ("y P,B,B 96x130x40 fp64 BP/BP", "y", (PERIODIC, BOUNDED, BOUNDED),
     (96, 130, 40), torch.float64, BoundsPreservingWENO5, BoundsPreservingWENO5, False),
    ("x+z B,P,B 96x64x48 fp32 WENO5 fast_bf16", "xz", (BOUNDED, PERIODIC, BOUNDED),
     (96, 64, 48), torch.float32, functools.partial(WENO5, fast_bf16=True),
     functools.partial(WENO5, fast_bf16=True), False),
    ("x B,B,B 100x77x45 fp32 WENO5 bf16_smoothness", "x", (BOUNDED, BOUNDED, BOUNDED),
     (100, 77, 45), torch.float32, functools.partial(WENO5, bf16_smoothness=True),
     functools.partial(WENO5, bf16_smoothness=True), False),
    ("x+y+z B,B,B 37x29x11 fp64 WENO5/UB3 (partial tiles, one chunk)", "xyz",
     (BOUNDED, BOUNDED, BOUNDED), (37, 29, 11), torch.float64, WENO5,
     UpwindBiasedThirdOrder, False),
)


def channel_faces(n, kind):
    """The channel's x faces (tanh-refined at both walls), y faces (refined
    at y = 0; the holds' stretched y) or z faces (−cos)."""
    if kind == "x":
        return np.tanh(np.linspace(-1.2, 1.2, n + 1)) / np.tanh(1.2)
    if kind == "y":
        return np.linspace(0.0, 1.0, n + 1) ** 1.3
    return -np.cos(np.linspace(0, np.pi / 2, n + 1))


def stretched_grid(stretch, topology, size, dtype):
    """A grid on [−1, 1] × [0, 1] × [−1, 0] stretched along the axes named
    in ``stretch`` (``channel_faces``)."""
    return RectilinearGrid(
        size=size, x=channel_faces(size[0], "x") if "x" in stretch else (-1.0, 1.0),
        y=channel_faces(size[1], "y") if "y" in stretch else (0.0, 1.0),
        z=channel_faces(size[2], "z") if "z" in stretch else (-1.0, 0.0),
        topology=topology, dtype=dtype, device=DEVICE)


def uniform_particles(grid, n, seed, tracked):
    """``n`` particles uniform in the grid's domain (numpy seed ``seed``; a
    Flat axis' coordinate its one centre), tracking ``tracked``."""
    rng = np.random.default_rng(seed)
    xyz = []
    for a in range(3):
        ax = grid._axes[a]
        lo = float(ax.cf[ax.h])
        q = (np.full(n, float(ax.cc[0])) if ax.topo is FLAT
             else rng.uniform(lo, lo + ax.extent, n))
        xyz.append(torch.as_tensor(q, dtype=grid.dtype, device=DEVICE))
    return LagrangianParticles(*xyz, {}, 1.0, tracked)


def particles_inside(label, grid, p):
    """Raises unless every particle lies in the grid's domain."""
    for a, q in enumerate((p.x, p.y, p.z)):
        ax = grid._axes[a]
        if ax.topo is FLAT:
            continue
        lo = float(ax.cf[ax.h])
        qmin, qmax = float(q.min()), float(q.max())
        if not (lo <= qmin and qmax <= lo + ax.extent and bool(torch.isfinite(q).all())):
            raise AssertionError(f"{label}: particles outside the domain along axis {a}: "
                                 f"[{qmin}, {qmax}] against [{lo}, {lo + ax.extent}]")


def particles_equal(label, got, ref):
    """Two particle sets' positions and properties held bit for bit."""
    pairs = {a: (getattr(got, a), getattr(ref, a)) for a in ("x", "y", "z")}
    pairs.update({f"properties[{k}]": (v, ref.properties[k])
                  for k, v in got.properties.items()})
    for name, (g, r) in pairs.items():
        if not torch.equal(g, r):
            raise AssertionError(f"{label}: particles' {name} differ by "
                                 f"{float((g - r).abs().max()):.3e}")
    print(f"{label}: {len(got)} particles' positions and {sorted(got.properties)} "
          f"bit for bit")


def channel_model(size=CHANNEL["size"], particles=True):
    """The stretched channel's model and initial state (``CHANNEL``; at
    another ``size``, and without its particles, for ``chip_breakdown.py``)."""
    c = CHANNEL
    grid = stretched_grid("xz", (BOUNDED, PERIODIC, BOUNDED), size, torch.float64)
    p = uniform_particles(grid, c["particles"], c["seed"], ("c",)) if particles else None
    model = NonhydrostaticModel(grid, advection=WENO5(), tracers=("c",), particles=p)
    rng = np.random.default_rng(c["seed"])
    state = model.initial_state(
        u=1e-2 * rng.standard_normal(size), v=1e-2 * rng.standard_normal(size),
        c=lambda x, y, z: torch.exp(-(x ** 2 + (z + 0.5) ** 2) / 0.1))
    return model, state


def drive_channel(plain):
    """The stretched channel with the kernels or their plain versions; returns
    (model, state, s per timed step, launches, (CG iterations a solve, the
    largest final relative residual))."""
    c = CHANNEL
    model, state = channel_model()
    if model.fused_step or model.projection_kernels or model.kernels["fill"] is not \
            fused_fill_halos:
        raise AssertionError("stretched channel: the general AB2 branch, the whole-array "
                             "projection operators and K6's fills were expected")
    if not isinstance(model.pressure_solver, MultigridPoissonSolver):
        raise AssertionError(f"stretched channel: solve {model.pressure_solver}")
    kernels = nonhydrostatic.PLAIN if plain else None
    SOLVES.update(solves=0, iterations=0, residual=0.0)
    state, per_step, launches = run_steps(
        "stretched channel", model, state, lambda s: model.step(s, c["dt"], kernels),
        c["warmup"], c["steps"], plain)
    if SOLVES["solves"] != c["warmup"] + c["steps"]:
        raise AssertionError(f"stretched channel: {SOLVES['solves']} solves")
    return (model, state, per_step, launches,
            (SOLVES["iterations"] / SOLVES["solves"], SOLVES["residual"]))


def stretched_divergence_ratio(model, state):
    """max|∇·u|·Δx_min/max|u| over the interior, ∇·u with the grid's
    per-index metrics (the whole-array operator)."""
    g, sol = model.grid, state["solution"]
    div = fused_divergence_reference(g, sol["u"], sol["v"], sol["w"])
    umax = max(float(g.interior(sol[n]).abs().max()) for n in "uvw")
    return float(div.abs().max()) * g.min_spacing() / umax


def k2xy_reading(label, args, dtype, reps=10):
    """K2's stretched-x/y form held bit for bit on ``args`` (over NaN-filled
    outputs, one launch) and timed against its plain version and its bound
    (as ``k2_bound``, with the rows' bytes); returns (max|Δ|, ms, plain_ms,
    bound_ms, bound_by)."""
    grid = args[0]
    poison_cache(grid.total_shape, dtype, len(args[6]) + 5)
    before = WRAPPERS[K2].stretched_launches
    err = hold_k2(f"K2 stretched-x/y {label}", args, dtype)
    if WRAPPERS[K2].stretched_launches != before + 1:
        raise AssertionError(f"{label}: K2's stretched-x/y form was not launched")
    grid, scheme, tracer_scheme, u, v, w, tracers = args
    rows, _ = stretched_rows_arg(grid, scheme, tracer_scheme)
    flags = k2_clear_flags(grid, scheme, tracer_scheme, len(tracers)) or []
    nbytes = (2 * tensor_bytes([u, v, w], tracers.values()) + tensor_bytes(rows)
              + tensor_bytes([f for f in flags if f is not None]))
    b_ms, by = bound(K2, nbytes, math.prod(grid.shape),
                     flops=k2_flops(grid, scheme, tracer_scheme, len(tracers)))
    ms, plain_ms = time_form("K2 stretched-x/y", label,
                             lambda: fused_advective_tendencies(*args),
                             lambda: fused_advective_tendencies_reference(*args),
                             (b_ms, by), reps)
    return err, ms, plain_ms, b_ms, by


def phase_stretched_channel():
    """The stretched channel (``CHANNEL``) with the kernels, checked (finite,
    max|∇·u|·Δx_min/max|u| ≤ 1e-5, every particle in the domain), K2's
    stretched-x/y form held and timed on its fields, then with the plain
    versions, every field and every particle bit for bit; returns (the
    kernel run's launches, the form's reading)."""
    path, c = "stretched channel", CHANNEL
    model, state, per_step, launches, iters = drive_channel(plain=False)
    check_finite(path, model, state, ("pNHS",))
    ratio = stretched_divergence_ratio(model, state)
    if not ratio <= 1e-5:
        raise AssertionError(f"{path}: max|div u|*dx_min/max|u| = {ratio:.3e} > 1e-5")
    g = model.grid
    particles_inside(path, g, state["particles"])
    points = math.prod(g.shape)
    steps = c["warmup"] + c["steps"]
    print(f"{path} path: {'x'.join(map(str, g.shape))} fp64 stretched x and z, "
          f"{c['steps']} steps at dt {c['dt']}: {per_step * 1e3:.3f} ms/step, "
          f"{points / per_step:.6e} grid points/s on {card_line()}; launches "
          f"{ {k: n for k, n in launches.items() if n} } in {steps} steps; "
          f"{iters[0]:.1f} multigrid-CG iterations a solve (maxiter "
          f"{model.pressure_solver.mg.maxiter}, tolerance "
          f"{model.pressure_solver.mg.tolerance:g}), final relative residual at most "
          f"{iters[1]:.3e}; max|div u|*dx_min/max|u| "
          f"{ratio:.3e}; {len(state['particles'])} particles in the domain")
    sol = state["solution"]
    args = (g, model.advection, model.tracer_advection, sol["u"], sol["v"], sol["w"],
            {"c": sol["c"]})
    reading = k2xy_reading("on the stretched channel's fields", args, torch.float64, 5)
    kernel_u = {k: g.interior(a).clone() for k, a in sol.items()}
    kernel_p = state["particles"]
    del state, args, sol
    torch.cuda.empty_cache()
    model, state, plain_step, _, plain_iters = drive_channel(plain=True)
    worst = agreement(path, steps, kernel_u, model, state)
    particles_equal(f"{path}: kernel and plain runs", kernel_p, state["particles"])
    print(f"{path} path: plain versions: {plain_step * 1e3:.3f} ms/step "
          f"({plain_iters[0]:.1f} iterations a solve, final relative residual at most "
          f"{plain_iters[1]:.3e}); kernel and plain runs agree to "
          f"{worst:.3e} of max|field|")
    del model, state, kernel_u, kernel_p
    torch.cuda.empty_cache()
    return launches, reading


def k2xy_args(stretch, topology, size, dtype, momentum, tracer, immersed):
    """K2's arguments on a case of ``K2XY_CASES``: random velocities, tracers
    c0 and c1 in [−0.1, 1.1], masked over a bottom where ``immersed``."""
    grid = stretched_grid(stretch, topology, size, dtype)
    model = NonhydrostaticModel(
        grid, advection=momentum(), tracers=("c0", "c1"), tracer_advection=tracer(),
        immersed_boundary=(GridFittedBottom(lambda x, y: -0.8 + 0.3 * torch.exp(
            -x ** 2 / 0.1)) if immersed else None))
    g = model.grid
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    sol = {n: torch.randn(g.total_shape, generator=gen, dtype=dtype, device=DEVICE)
           for n in "uvw"}
    sol.update({n: 1.2 * torch.rand(g.total_shape, generator=gen, dtype=dtype,
                                    device=DEVICE) - 0.1 for n in ("c0", "c1")})
    if immersed:
        sol = model.immersed_boundary.mask_state(model, {"solution": sol})["solution"]
    return (g, model.advection, model.tracer_advection, sol["u"], sol["v"], sol["w"],
            {n: sol[n] for n in ("c0", "c1")})


def phase_k2xy_holds():
    """K2's stretched-x/y form against its plain version (``K2XY_CASES``):
    a stretched x, y, x and y, x and z, on Periodic and Bounded x, a Flat y,
    every scheme and WENO5's bf16 options, immersed, partial tiles, fp32 and
    fp64, random fields (tracers in [−0.1, 1.1], masked over a bottom), bit
    for bit over NaN-filled outputs, each timed; returns the forms'
    records."""
    forms = []
    for label, *case in K2XY_CASES:
        args = k2xy_args(*case)
        forms.append(form_record("hold", label, *k2xy_reading(label, args, case[3])))
        del args
        torch.cuda.empty_cache()
    return forms


def flagship_implicit(method, particles=None):
    """The ¼° flagship under ImplicitFreeSurface(``method``, maxiter 50) and
    the flagship path's initial state."""
    model = latlon_flagship(free_surface=ImplicitFreeSurface(
        solver_method=method, maxiter=IMPLICIT_FS["maxiter"]), particles=particles)
    rng = np.random.default_rng(0)
    state = model.initial_state(u=0.1 * rng.standard_normal(model.grid.shape),
                                b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    return model, state


def phase_implicit_free_surface():
    """validation/implicit_free_surface.py as written through the port's copy
    (N = 64: fft, pcg, matrix and multigrid, 50 steps each, its assertion
    that each is within 1e-6 of fft), then the ¼° flagship under the matrix
    and the multigrid implicit free surface (``IMPLICIT_FS``), 1 + 2 steps
    with the kernels and then the plain versions, bit for bit, with the CG
    iterations a step; returns the launch counts by path."""
    by_path = {}
    path = "implicit free surface validation"
    steps = implicit_free_surface.N_STEPS * len(implicit_free_surface.METHODS)
    zero_counts()
    SOLVES.update(solves=0, iterations=0, residual=0.0)
    t0 = time.perf_counter()
    implicit_free_surface.main(IFS_VALIDATION["N"], DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # each method's model builds its initial state inside the count
    by_path[path] = read_counts(path, steps, {k: 4 * n for k, n in INITIAL_STATE.items()})
    print(f"{path}: N = {IFS_VALIDATION['N']} fp64, {steps} steps in {seconds:.3f} s, "
          f"{SOLVES['iterations'] / SOLVES['solves']:.1f} CG iterations a matrix or "
          f"multigrid solve; launches { {k: n for k, n in by_path[path].items() if n} } "
          f"on {card_line()}")
    for method in IMPLICIT_FS["methods"]:
        path = f"implicit free surface: {method}"
        out, ms, iters = {}, {}, {}
        for plain in (False, True):
            model, state = flagship_implicit(method)
            SOLVES.update(solves=0, iterations=0, residual=0.0)
            kernels = hydrostatic.PLAIN if plain else None
            out[plain], ms[plain], counts = run_steps(
                path, model, state, lambda s: model.step(s, HYDRO["dt"], kernels),
                IMPLICIT_FS["warmup"], IMPLICIT_FS["steps"], plain)
            iters[plain] = (SOLVES["iterations"] / SOLVES["solves"], SOLVES["residual"])
            if not plain:
                by_path[path] = counts
                check_finite(path, model, out[plain], ("w", "pHY", "eta"))
                del state
        got, ref = out[False], out[True]
        hold(f"{path}, 1/4 deg fp32, {IMPLICIT_FS['warmup'] + IMPLICIT_FS['steps']} steps",
             {"solution": got["solution"], "p": {"eta": got["eta"], "w": got["w"]}},
             {"solution": ref["solution"], "p": {"eta": ref["eta"], "w": ref["w"]}},
             torch.float32, exact=True)
        g = model.grid
        print(f"{path} path: 1/4 deg {g.Nx}x{g.Ny}x{g.Nz} fp32, {IMPLICIT_FS['steps']} steps: "
              f"{ms[False] * 1e3:.3f} ms/step (plain {ms[True] * 1e3:.3f}), "
              f"{math.prod(g.shape) / ms[False]:.6e} grid points/s, {iters[False][0]:.1f} CG "
              f"iterations a step (maxiter {IMPLICIT_FS['maxiter']}, final relative "
              f"residual at most {iters[False][1]:.3e}); launches a step "
              f"{ {k: n // (IMPLICIT_FS['warmup'] + IMPLICIT_FS['steps']) for k, n in by_path[path].items() if n} } "
              f"on {card_line()}")
        del out, got, ref, model
        torch.cuda.empty_cache()
    return by_path


def phase_particle_holds():
    """Particles in the shallow-water model (the headline at 1024² with a
    tracer c) and in the ¼° flagship (split-explicit, tracking T and b),
    ``PARTICLES_HOLD["particles"]`` each: 3 steps with the kernels against 3
    with the plain versions, fields and particles bit for bit, every
    particle in the domain."""
    c = PARTICLES_HOLD
    n = c["n_sw"]
    grid = RectilinearGrid(size=(n, n, 1), x=(0, 2 * math.pi), y=(0, 2 * math.pi),
                           topology=(PERIODIC, PERIODIC, FLAT), dtype=torch.float32,
                           device=DEVICE)
    runs = []
    for kernels in (None, shallow_water.PLAIN):
        p = uniform_particles(grid, c["particles"], 11, ("c",))
        model = ShallowWaterModel(grid, gravitational_acceleration=10.0, advection=WENO5(),
                                  tracers=("c",), particles=p)
        s = model.initial_state(uh=lambda x, y, z: 0.1 * torch.sin(x) * torch.cos(y),
                                h=1.0, c=lambda x, y, z: torch.cos(x) * torch.sin(y))
        for _ in range(c["steps"]):
            s = model.step(s, 1e-3, kernels)
        runs.append(s)
    label = f"particles hold: shallow water {n}^2 fp32"
    hold(label, {"s": runs[0]["solution"]}, {"s": runs[1]["solution"]}, torch.float32,
         exact=True)
    particles_equal(label, runs[0]["particles"], runs[1]["particles"])
    particles_inside(label, model.grid, runs[0]["particles"])
    del runs, model
    runs = []
    for kernels in (None, hydrostatic.PLAIN):
        model = latlon_flagship()
        p = uniform_particles(model.grid, c["particles"], 12, ("T", "b"))
        model.particles = p
        rng = np.random.default_rng(0)
        s = model.initial_state(u=0.1 * rng.standard_normal(model.grid.shape),
                                b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
        for _ in range(c["steps"]):
            s = model.step(s, HYDRO["dt"], kernels)
        runs.append(s)
    label = "particles hold: 1/4 deg flagship fp32"
    hold(label, {"s": dict(runs[0]["solution"], eta=runs[0]["eta"])},
         {"s": dict(runs[1]["solution"], eta=runs[1]["eta"])}, torch.float32, exact=True)
    particles_equal(label, runs[0]["particles"], runs[1]["particles"])
    particles_inside(label, model.grid, runs[0]["particles"])
    del runs, model
    torch.cuda.empty_cache()


def phase_free_convection():
    """validation/vertical_mixing_closures.py's physics on the (Periodic,
    Periodic, Bounded) 32×32×64 fp64 grid of ``FREE_CONVECTION`` (K4b's
    regular layout with no advection, which the column path's Flat layout
    does not run): ``COLUMN_HOLD_STEPS`` steps under each closure with the
    kernels, their launches counted, against as many with their plain
    versions, bit for bit; returns the launch counts by path."""
    c = FREE_CONVECTION
    by_path = {}
    for kind in c["kinds"]:
        path = f"free convection: {kind}"
        model = free_convection_model(kind)
        init = {"b": lambda x, y, z: c["N2"] * z}
        if "e" in model.tracer_names:
            init["e"] = 1e-7
        state = model.initial_state(**init)
        runs = []
        for kernels in (None, hydrostatic.PLAIN):
            zero_counts()
            s = state
            for _ in range(COLUMN_HOLD_STEPS):
                s = model.step(s, c["dt"], kernels=kernels)
            counts = read_counts(path, COLUMN_HOLD_STEPS, plain=kernels is not None)
            if kernels is None:
                by_path[path] = counts
            runs.append(s)
        check_finite(path, model, runs[0], ("w", "pHY", "eta"))
        hold(f"{path}, {'x'.join(map(str, c['size']))} fp64, {COLUMN_HOLD_STEPS} steps "
             "kernels against plain", {"s": dict(runs[0]["solution"], eta=runs[0]["eta"])},
             {"s": dict(runs[1]["solution"], eta=runs[1]["eta"])}, torch.float64,
             exact=True)
        print(f"{path}: launches { {k: n for k, n in by_path[path].items() if n} } in "
              f"{COLUMN_HOLD_STEPS} steps")
        del model, state, runs
    torch.cuda.empty_cache()
    return by_path

#: the cubed-sphere slice: the four cubed-sphere validations at N, as
#: written (their own step counts); Galewsky's test at C256 (the
#: validation eddying_aquaplanet.py's configuration at N = 256 fp64, about
#: 0.35°, the resolution of Galewsky et al. (2004)'s T341 reference) at
#: the script's CFL 0.45 on the grid's own smallest spacing
#: (``grid_time_step``, ~7.2 s): the script's rule (Δt ≈ 31 s) takes that
#: spacing as 0.7 of the mean, but the conformal C256 grid's is 0.16 of
#: it, CFL 1.95 at the corners, and the fields went non-finite within 22
#: steps on the card; the JAX suite's multilevel configuration at full
#: width (tests/test_cubed_sphere_model.py:87-104 at 256×256×32, z ∈
#: [−4000, 0], fp32, tracer c, solid-body u, Gaussian c) at CFL 0.5 on the
#: grid's smallest spacing (``cs3d_time_step``, ~1.4 s): the reference's η
#: equation takes Ay·U = Δx·Δz·Σu Δz, so its free-surface wave runs at
#: √(g H Δz) ≈ 2214 m/s here (not √(gH)), and the conformal C256 grid's
#: smallest spacing is ~6.3 km; RK3 held that wave at CFL 0.94 and not
#: 1.57 at 32×32×4 on the CPU, and Δt = 50 s and 5 s (CFL 17 and 1.75)
#: went non-finite on the card; the
#: column closures' CATKE column (1×1×64 fp64, Δt = 60 s) as an ensemble of
#: 32 members whose initial N² runs from 1e-6 to 1e-5, as users run such
#: ensembles to calibrate column closures
CUBED_SPHERE = dict(N=32)
GALEWSKY = dict(N=256, warmup=2, steps=20, profiled=2)
CS3D = dict(size=(256, 256, 32), z=(-4000.0, 0.0), cfl=0.5, warmup=2, steps=10,
            profiled=2)
ENSEMBLE = dict(members=32, steps=10, N2=(1e-6, 1e-5), nz=64, hold=(0, 31))


def cs3d_time_step(grid, model, cfl):
    """Δt at ``cfl`` for the cubed-sphere model's free-surface wave on a
    multilevel grid, √(g H Δz) (the reference's η equation), on the
    grid's smallest spacing."""
    depth = grid._zaxis.extent
    dz = float(grid._zaxis.dc[grid.Hz])
    return cfl * eddying_aquaplanet.min_spacing(grid) / math.sqrt(model.g * depth * dz)


class _Prefetch(threading.Thread):
    """The host geometry of Galewsky C256's grid (the conformal map at its
    corners, centres, nodes and tangents, numpy on the host's cores),
    computed while the kernels build and the earlier phases run; the
    phases that need it ``wait`` for it."""

    def __init__(self):
        super().__init__(daemon=True)
        self.error = None

    def run(self):
        from clima_oceananigans_jl_torch.grids.cubed_sphere import _geometry
        from clima_oceananigans_jl_torch.utils.location import F
        try:
            geo = _geometry(GALEWSKY["N"], 3, "conformal")
            geo.corners, geo.centers
            for loc in ((F, F), (F, C), (C, F), (C, C)):
                geo.nodes(loc)
            geo.tangents((F, C), 0), geo.tangents((C, F), 1)
        except BaseException as e:  # raised again by wait()
            self.error = e

    def wait(self):
        t0 = time.perf_counter()
        self.join()
        if self.error is not None:
            raise self.error
        return time.perf_counter() - t0


def profiled_steps(step, state, n):
    """``n`` more steps under torch.profiler: (state, device launches a
    step (kernels, copies and fills), the device's idle share, ms a step on
    the host clock); the idle share None when the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    idle = 1 - busy / elapsed if busy > 0 else None
    return state, sum(e.count for e in events) / n, idle, elapsed / n


def phase_cubed_sphere_validations():
    """validation/solid_body_rotation.py, rossby_haurwitz.py,
    cubed_sphere_gravity_waves.py and eddying_aquaplanet.py as written,
    through the port's copies, at N = ``CUBED_SPHERE["N"]`` fp64 with their
    own step counts (~160, 864, 384 and 2070 RK3 steps) and assertions; the
    cubed-sphere model launches no kernel of the port (checked). Returns the
    launch counts by path."""
    N, by_path = CUBED_SPHERE["N"], {}
    quiet = lambda *a: None
    runs = (
        ("solid body rotation", solid_body_rotation,
         lambda: solid_body_rotation.run(N, DEVICE, log=quiet),
         lambda r: solid_body_rotation.check(r, N), solid_body_rotation.steps_and_dt(N)[0]),
        ("Rossby-Haurwitz", rossby_haurwitz, lambda: rossby_haurwitz.run(N, DEVICE, log=quiet),
         rossby_haurwitz.check, int(rossby_haurwitz.DAY / rossby_haurwitz.DT)),
        ("cubed sphere gravity waves", cubed_sphere_gravity_waves,
         lambda: cubed_sphere_gravity_waves.run(N, DEVICE, log=quiet),
         cubed_sphere_gravity_waves.check,
         math.ceil(cubed_sphere_gravity_waves.T2 / cubed_sphere_gravity_waves.DT - 1e-9)),
        ("eddying aquaplanet", eddying_aquaplanet,
         lambda: eddying_aquaplanet.run(N, DEVICE, log=quiet),
         eddying_aquaplanet.check,
         math.ceil(6 * eddying_aquaplanet.DAY / eddying_aquaplanet.time_step(N) - 1e-9)))
    for path, module, run, check, steps in runs:
        zero_counts()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        by_path[path] = read_counts(path, steps)
        check(result)
        print(f"{path}: {module.__name__.rsplit('.', 1)[-1]}.py at N = {N} fp64, "
              f"{steps} RK3 steps in {seconds:.1f} s ({seconds / steps * 1e3:.3f} ms a "
              f"step with the grid, the model and the diagnostics); its assertions pass: "
              f"{result if not isinstance(result, dict) else {k: v for k, v in result.items() if k != 'dt'}} "
              f"on {card_line()}")
    return by_path


def phase_biogeochemistry():
    """validation/biogeochemistry.py as written, through the port's copy:
    the reacting column (PrescribedVelocityModel, 400 steps) and the
    sinking slice (NonhydrostaticModel with fused_advection=False, 400
    steps), its eight checks. Returns the launch counts by path."""
    path = "biogeochemistry"
    zero_counts()
    t0 = time.perf_counter()
    r1 = biogeochemistry.run_reacting(DEVICE)
    r2 = biogeochemistry.run_sinking(DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(path, biogeochemistry.STEPS1 + biogeochemistry.STEPS2)
    biogeochemistry.check(r1, r2)
    print(f"{path}: the reacting column and the sinking slice, "
          f"{biogeochemistry.STEPS1} + {biogeochemistry.STEPS2} steps in {seconds:.1f} s; "
          f"the eight checks pass on {card_line()}")
    return {path: launches}


def cubed_sphere_reading(path, model, state, dt, c):
    """The reading of a C256 path (the model's step replayed from its CUDA
    graph, ``cuda_graphs``): ``c["warmup"]`` + ``c["steps"]`` steps
    (counts set to 0 before, read after: the model launches no kernel of
    the port), ms a step by CUDA events over the timed ones, then
    ``c["profiled"]`` steps under the profiler (launches a step, idle
    share), and the peak memory. Returns (state, launches, a dict of the
    numbers)."""
    step = lambda s: model.step(s, dt)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for _ in range(c["warmup"]):
        state = step(state)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(c["steps"]):
        state = step(state)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / c["steps"] * 1e3
    launches = read_counts(path, c["warmup"] + c["steps"])
    state, per_step, idle, prof_ms = profiled_steps(step, state, c["profiled"])
    out = dict(ms=start.elapsed_time(end) / c["steps"], wall_ms=wall,
               launches_per_step=per_step, idle=idle, profiled_ms=prof_ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    idle_s = "not measured" if idle is None else f"{100 * idle:.1f}%"
    print(f"{path}: {c['steps']} timed steps after {c['warmup']}: {out['ms']:.4f} ms/step "
          f"(CUDA events; {wall:.4f} wall), {per_step:.0f} device launches a step, "
          f"device idle {idle_s} (torch.profiler, {c['profiled']} steps, "
          f"{prof_ms:.4f} ms/step there), peak memory {out['peak_gb']:.3f} GB "
          f"on {card_line()}")
    return state, launches, out


def check_cubed_sphere(path, model, state):
    g = model.grid
    for name, a in list(state["solution"].items()) + [("eta", state["eta"])]:
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{path} {name}: non-finite values")
    if tuple(state["solution"]["u"].shape) != g.total_shape:
        raise AssertionError(f"{path}: u of shape {tuple(state['solution']['u'].shape)}")


def phase_galewsky(prefetch=None):
    """``Galewsky C256``: eddying_aquaplanet.py's configuration at N = 256
    fp64 (6 × 256² columns), its grid built on the host (the time printed;
    its geometry from ``prefetch``, a started ``_Prefetch``, if given),
    its Δt, ``cubed_sphere_reading``; finite fields and the script's mass
    check (|Δ∬η dA| ≤ 1e-9 ∬H₀ dA). Returns (the launch counts by path, the
    reading)."""
    ea, c, path = eddying_aquaplanet, GALEWSKY, "Galewsky C256"
    if prefetch is not None:
        print(f"{path}: waited {prefetch.wait():.1f} s for its host geometry, computed "
              "beside the build and the earlier phases")
    t0 = time.perf_counter()
    grid = CubedSphereGrid(size=(c["N"], c["N"], 1), radius=ea.A, dtype=torch.float64,
                           halo=3, device=DEVICE)
    build_s = time.perf_counter() - t0
    model = ea.model_for(c["N"], DEVICE, grid=grid)
    state = ea.initial_state(model)
    init_s = time.perf_counter() - t0 - build_s
    eddies = ea.Eddies(grid)
    mass0 = eddies.mass(state)
    dt = ea.grid_time_step(grid)
    print(f"{path}: 6 x {c['N']}^2 x 1 fp64 ({6 * c['N'] ** 2} columns), the grid built "
          f"in {build_s:.1f} s on the host, the model and its initial state in "
          f"{init_s:.1f} s; dt {dt:.3f} s")
    state, launches, reading = cubed_sphere_reading(path, model, state, dt, c)
    check_cubed_sphere(path, model, state)
    model.cuda_graphs = False
    reading["eager_ms"] = cuda_ms(lambda: model.step(state, dt), 5)
    model.cuda_graphs = True
    print(f"{path}: the step without its CUDA graph {reading['eager_ms']:.4f} ms "
          f"(CUDA events, 5 steps; with it {reading['ms']:.4f})")
    drift = abs(eddies.mass(state) - mass0) / (eddies.area.sum() * ea.H0)
    if not drift < 1e-9:
        raise AssertionError(f"{path}: mass drift {drift:.3e} over 1e-9")
    print(f"{path}: finite, mass drift {drift:.3e} (the script's gate 1e-9)")
    reading.update(build_s=build_s, init_s=init_s, mass_drift=drift)
    del model, state, grid
    torch.cuda.empty_cache()
    return {path: launches}, reading


def phase_cubed_sphere_3d():
    """``cubed sphere 3D C256x32`` (``CS3D``): the JAX suite's multilevel
    configuration at full width, ``cubed_sphere_reading``; finite fields
    and |Σ η·Az| ≤ 1e-5·Σ|η|·Az over the interior (fp64 sums), the
    hydrostatic gate. Returns (the launch counts by path, the reading)."""
    c, path = CS3D, "cubed sphere 3D C256x32"
    t0 = time.perf_counter()
    grid = CubedSphereGrid(size=c["size"], z=c["z"], radius=6.371e6, dtype=torch.float32,
                           halo=3, device=DEVICE)
    build_s = time.perf_counter() - t0
    model = CubedSphereHydrostaticModel(grid, tracers=("c",))

    def c0(p):
        n = p / np.linalg.norm(p, axis=-1, keepdims=True)
        return np.exp(-((n[..., 0] - 1.0) ** 2) / 0.1)

    def vel(p):
        n = p / np.linalg.norm(p, axis=-1, keepdims=True)
        return np.cross([0.0, 0.0, 1.0], n)

    state = model.initial_state(u=vel, c=c0)
    dt = cs3d_time_step(grid, model, c["cfl"])
    print(f"{path}: 6 x {c['size'][0]}^2 x {c['size'][2]} fp32, the grid in "
          f"{build_s:.1f} s (the host geometry of C256 shared with Galewsky C256's); "
          f"dt {dt:.4f} s")
    state, launches, reading = cubed_sphere_reading(path, model, state, dt, c)
    check_cubed_sphere(path, model, state)
    H, N = grid.H, grid.N
    eta = state["eta"][:, H:H + N, H:H + N].double()
    az = grid.face_grids().Az(CENTER)[:, H:H + N, H:H + N].double()
    net, gross = float((eta * az).sum()), float((eta.abs() * az).sum())
    if not abs(net) <= 1e-5 * gross:
        raise AssertionError(f"{path}: |sum eta Az| {abs(net):.3e} over 1e-5 x {gross:.3e}")
    print(f"{path}: finite, |sum eta Az| = {abs(net):.3e} <= 1e-5 x {gross:.3e}")
    reading.update(build_s=build_s, volume=abs(net) / gross if gross else 0.0)
    del model, state, grid
    torch.cuda.empty_cache()
    return {path: launches}, reading


def phase_ensemble_columns():
    """``ensemble columns`` (``ENSEMBLE``): the column closures' CATKE
    column as 32 members (initial N² from 1e-6 to 1e-5), 10 ensemble steps
    (the members one by one through ``model.step``: 1 K4a, 1 K4b, 3 K6 and
    4 T1 a member-step), ms an ensemble step; members 0 and 31 held bit
    for bit against the same member stepped alone (launches counted on no
    path). Returns the launch counts by path."""
    vmc, c, path = vertical_mixing_closures, ENSEMBLE, "ensemble columns"
    model = vmc.model_for(CATKEVerticalDiffusivity(), c["nz"], DEVICE)
    inits = [dict(b=lambda x, y, z, n2=n2: n2 * z, e=1e-7)
             for n2 in np.linspace(*c["N2"], c["members"])]
    batched = ensemble_initial_state(model, inits)
    step = ensemble_step(model)
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        batched = step(batched, vmc.DT)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / c["steps"]
    launches = read_counts(path, c["members"] * c["steps"])
    for name, a in batched["solution"].items():
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{path} {name}: non-finite values")
    for i in c["hold"]:
        alone = model.initial_state(**inits[i])
        for _ in range(c["steps"]):
            alone = model.step(alone, vmc.DT)
        hold(f"{path}: member {i} against the member stepped alone",
             {"solution": member(batched, i)["solution"]}, {"solution": alone["solution"]},
             torch.float64, exact=True)
    print(f"{path}: {c['members']} members of the 1x1x{c['nz']} fp64 CATKE column, "
          f"{c['steps']} ensemble steps of {vmc.DT:g} s, {per_step * 1e3:.3f} ms an "
          f"ensemble step ({per_step * 1e3 / c['members']:.3f} ms a member-step), "
          f"launches { {k: n for k, n in launches.items() if n} } on {card_line()}")
    return {path: launches}, per_step * 1e3

#: the partial-cell slice's ¼° path, "near-global partial cells":
#: validation/near_global_lat_lon.py at deg = 0.25 (its grid and z faces,
#: SplitExplicitFreeSurface(substeps=50), the spherical Coriolis,
#: BuoyancyTracer, its vertically implicit ScalarDiffusivity, the zonal wind
#: and the quadratic bottom drag, its b), with PartialCellBottom of its
#: bathymetry in place of GridFittedBottom: 1440×600×24 fp32, the two-stage
#: route (K4b's 3D-Δz tendency form, K4a's 3D-Δz form, K5 on the fluid
#: depths, T1 on u, v and b). Its Δt is benchmark/bench_near_global.py's
#: 600 s at ¼°, not the script's 1200 s, which it chose at 3°: at ¼° and
#: 1200 s the fields go non-finite within a few steps over partial cells
#: (PERF.md §6, the partial-cell entry); its 3 days are then 432
#: iterations. ``warmup`` + ``steps`` timed steps, ``profiled`` more under
#: the profiler (the idle share), ``agree`` steps with the kernels against as
#: many with their plain versions, then the ``iterations`` through
#: ``Simulation`` and the validation's checks
NEAR_GLOBAL_PARTIAL = dict(deg=0.25, dt=600.0, warmup=2, steps=5, profiled=2, agree=3,
                           iterations=432)
#: the partial-cell holds at 1° over the same bathymetry (360×150×24), fp32 and
#: fp64: K4a's 3D-Δz form, and K4b's under each scheme pair (momentum,
#: tracers, tracer names), after ``steps`` steps from a random state
PARTIAL_HOLD = dict(deg=1.0, steps=2, schemes={
    "default": (VectorInvariant, CenteredSecondOrder, ()),
    "WENO5": (lambda: VectorInvariant(scheme="weno_velocity"), WENO5, ("T", "S")),
    "UB5 / BP": (UpwindBiasedFifthOrder, BoundsPreservingWENO5, ("T", "S"))})


def partial_cells_census(model):
    """(columns with a cut cell, cut cells, the smallest fraction) over the
    interior of a partial-cell model's grid."""
    g = model.grid
    inner = (slice(g.Hx, g.Hx + g.Nx), slice(g.Hy, g.Hy + g.Ny), slice(g.Hz, g.Hz + g.Nz))
    frac = g.dz(CENTER)[inner] / g._axes[2].dc[inner[2]]
    cut = (frac < 1) & ~g.immersed.solid_ccc[inner]
    return int(cut.any(-1).sum()), int(cut.sum()), float(frac[cut].min())


def k4a_bound(g, sol, outs):
    """K4a's bound: u, v, b and (partial cells) the two 3D Δz arrays read
    once, w and pHY′ written once."""
    from clima_oceananigans_jl_torch.ops.metric_rows import dz3_pack
    extra = [dz3_pack(g)] if getattr(g, "partial_cells", False) else []
    return bound(K4A, tensor_bytes([sol["u"], sol["v"], sol["b"]], outs, extra),
                 g.Nx * g.Ny * g.Nz)


def k4_readings(label, model, state, launches=None):
    """K4a (w and pHY′) and K4b's tendency form on ``state``: held bit for
    bit against their plain versions over NaN-filled outputs (K4b both
    forms, its halos zero) and timed against their bounds; returns
    (max|Δ| by kernel, {kernel: form record}), with ``launches`` (a path's
    counts) in the records."""
    g, sol, dtype = model.grid, state["solution"], model.grid.dtype
    err = {K4A: hold_k4a(label, g, sol), K4B: hold_k4b(label, model, state)}
    args = (g, sol["u"], sol["v"], sol["b"])
    b_a = k4a_bound(g, sol, [t for t in hydrostatic_columns(*args)])
    ms_a, plain_a = time_form(K4A, f"{label}, w and pHY'",
                              lambda: hydrostatic_columns(*args),
                              lambda: hydrostatic_columns_reference(*args), b_a)
    b_b = k4b_bound(model, state, list(fused_hydrostatic_tendencies(model, state).values()),
                    False)
    ms_b, plain_b = time_form(K4B, f"{label}, tendencies",
                              lambda: fused_hydrostatic_tendencies(model, state),
                              lambda: fused_hydrostatic_tendencies_reference(model, state),
                              b_b)
    n = launches or {}
    records = {K4A: form_record("partial cells", f"{label}, w and pHY'", err[K4A], ms_a,
                                plain_a, *b_a, n.get(K4A, 0)),
               K4B: form_record("partial cells", f"{label}, tendencies", err[K4B], ms_b,
                                plain_b, *b_b, n.get(K4B, 0))}
    torch.cuda.empty_cache()
    return err, records


def phase_partial_holds():
    """K4a's and K4b's 3D-Δz forms at 1° (``PARTIAL_HOLD``) over the
    near-global validation's bathymetry with PartialCellBottom, fp32 and
    fp64: K4a on the default schemes' state, K4b under each scheme pair,
    each bit for bit its plain version and timed against its bound.
    Returns ({kernel: largest max|Δ|}, {kernel: form records})."""
    c = PARTIAL_HOLD
    worst, forms = {K4A: 0.0, K4B: 0.0}, {K4A: [], K4B: []}
    for dtype in (torch.float32, torch.float64):
        for short, (mom, tr, tracers) in c["schemes"].items():
            model = near_global_lat_lon.model_for(
                c["deg"], dtype, DEVICE, partial_cells=True, momentum_advection=mom(),
                tracer_advection=tr(), tracers=tracers)
            if not model.grid.partial_cells:
                raise AssertionError(f"partial-cell hold {short}: no partial cells")
            g = model.grid
            gen = torch.Generator(device=DEVICE).manual_seed(24)
            rand = lambda sc, o=0.0: o + sc * torch.randn(g.shape, generator=gen,
                                                          device=DEVICE)
            extra = {"T": rand(1.0, 10.0), "S": rand(1e-2, 35.0)} if tracers else {}
            state = model.initial_state(u=rand(0.1), v=rand(0.1),
                                        b=near_global_lat_lon.initial_b, **extra)
            for _ in range(c["steps"]):
                state = model.step(state, near_global_lat_lon.DT)
            name = "fp32" if dtype is torch.float32 else "fp64"
            label = (f"1 deg {name} partial cells, "
                     f"{type(model.momentum_advection).__name__} / "
                     f"{type(model.tracer_advection).__name__}")
            err, records = k4_readings(label, model, state)
            for k in (K4A, K4B):
                worst[k] = max(worst[k], err[k])
            # K4a's form does not depend on the schemes: one record a dtype
            forms[K4B].append(records[K4B])
            if short == "default":
                forms[K4A].append(records[K4A])
            del model, state
            torch.cuda.empty_cache()
    return worst, forms


def phase_near_global_partial():
    """``near-global partial cells`` (``NEAR_GLOBAL_PARTIAL``): the census of
    cut cells, the timed steps and their launches, the idle share, K4a and
    K4b read on the path's fields, the kernels' steps against the plain
    versions' from one state (bit for bit over NaN-filled outputs), then 3
    days through ``Simulation`` and the validation's checks, with the free
    surface's volume check. Returns (the launches, {kernel: form record},
    largest max|Δ| by kernel)."""
    c, path = NEAR_GLOBAL_PARTIAL, "near-global partial cells"
    ng = near_global_lat_lon
    model = ng.model_for(c["deg"], torch.float32, DEVICE, partial_cells=True)
    g = model.grid
    if not g.partial_cells or model.fused_advance:
        raise AssertionError(f"{path}: not the partial-cell two-stage route")
    columns, cells, smallest = partial_cells_census(model)
    print(f"{path}: {g.Nx}x{g.Ny}x{g.Nz} fp32, {columns} columns with a partial "
          f"bottom cell ({cells} cut cells), the smallest fraction {smallest:.6f}")
    step = lambda s: model.step(s, c["dt"])
    state, per_step, launches = run_steps(path, model, ng.initial_state(model), step,
                                          c["warmup"], c["steps"], plain=False)
    state, _, idle, prof_ms = profiled_steps(step, state, c["profiled"])
    check_finite(path, model, state, ("w", "pHY", "eta"))
    idle_s = "not measured" if idle is None else f"{100 * idle:.1f}%"
    print(f"{path}: {per_step * 1e3:.3f} ms/step ({c['steps']} steps after {c['warmup']}), "
          f"{g.Nx * g.Ny * g.Nz / per_step / 1e6:.3f} M points/s, device idle {idle_s} "
          f"(torch.profiler, {c['profiled']} steps, {prof_ms:.3f} ms/step), launches a step "
          f"{ {k: n // (c['warmup'] + c['steps']) for k, n in launches.items() if n} } "
          f"on {card_line()}")
    err, records = k4_readings(f"1/4 deg fp32 on the {path} path's fields", model, state,
                               launches)
    poison_cache(g.total_shape, torch.float32, 12)
    err_steps = steps_agree(path, model, state, c["agree"], c["dt"])
    for k in (K4A, K4B):
        err[k] = max(err[k], err_steps)
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sim = ng.run(model, ng.initial_state(model), c["iterations"], c["dt"],
                 log=lambda line: print(f"{path}: {line}"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    umax = ng.check(model, sim.state, log=lambda line: print(f"{path}: {line}"))
    net, gross = eta_balance(path, model, sim.state)
    print(f"{path}: {c['iterations']} iterations of {c['dt']:g} s in {seconds:.1f} s "
          f"({seconds / c['iterations'] * 1e3:.3f} ms an iteration through Simulation); "
          f"u, v exactly 0 at solid faces, finite, max|u| {umax:.6f} in (1e-3, 3); "
          f"|sum(eta Az)|/sum(|eta| Az) {abs(net) / gross:.3e}")
    del model, sim
    torch.cuda.empty_cache()
    return launches, records, err


# -- the distributed slice: the models decomposed over a mesh of shards ----------

#: the decomposed RK3 flagship: the RK3 path's model (256³ fp32, WENO5,
#: BuoyancyTracer, FPlane(1e-4), ScalarDiffusivity(1e-5, 1e-5), Δt = 1e-3,
#: __graft_entry__.py:26-38) at full width, wrapped in DistributedModel over a
#: (2, 2) mesh of four shards on one card (Oceananigans' MultiRegion on one
#: GPU); the general projection with the pencil FFT solve. ``hold`` steps
#: from the initial state held, then ``steps`` more timed
DISTRIBUTED = dict(mesh=(2, 2), hold=3, steps=5)
PER_STEP["distributed RK3"] = {K2: 12, K3B: 12, K3C: 12, K6: 48}
#: the decomposed run against the single-device one, of max|field|: the CPU
#: tests' ``PENCIL_RTOL`` (1e-12 in fp64, tests/test_torch_distributed_*.py)
#: taken as ~4096 units of the type's eps, here of fp32 (4.9e-4): the pencil
#: solve's complex FFTs round otherwise than the single-device real FFT
PENCIL_EPS = 4096
#: the small holds: 64³ fp32 unless said, one step each (three RK3
#: stages; the decomposed steps are host-bound, ~0.15–0.3 s a step at any
#: size, and the holds had 43 s at two steps on a slow host)
DIST_HOLD = dict(n=64, steps=1, n_sw=1024, n_hy=32, steps_hy=2)


def pencil_tolerance(dtype):
    return PENCIL_EPS * torch.finfo(dtype).eps


def dist_devices(n):
    """n shards on the card (cuda:0 for each)."""
    return [torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(DEVICE)] * n


def dist_gathered(dm, states):
    """The decomposed states gathered, interiors of the solution (and of η,
    where the state has one)."""
    g = dm.grid
    s = dm.gather_state(states)
    fields = {k: g.interior(a) for k, a in s["solution"].items()}
    if "eta" in s:
        fields["eta"] = s["eta"][g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    return s, fields


def dist_relative(label, got, ref, tol):
    """max over fields of max|Δ|/max|ref|; raises above ``tol`` (exact
    with 0)."""
    rel = {}
    for k, r in ref.items():
        err = float((got[k].double() - r.double()).abs().max())
        scale = float(r.abs().max())
        rel[k] = err / scale if scale else err
    worst = max(rel.values())
    if not worst <= tol:
        raise AssertionError(f"{label}: {worst:.3e} of max|field| > {tol:.3e} ({rel})")
    return worst


def dist_steps(dm, states, dt, n, kernels=None):
    for _ in range(n):
        states = dm.step(states, dt, kernels=kernels)
    return states


def phase_distributed():
    """The decomposed RK3 flagship at 256³ fp32 on a (2, 2) mesh of four
    shards on one card: the kernel run (its launches read), held bit for
    bit against the decomposed plain run after ``hold`` steps, against the
    single-device run within ``pencil_tolerance``, and to the ∇·u gate of
    PERF.md §2; then ``steps`` timed steps beside the single-device RK3
    step's, the exchange's and the transposes' copies and bytes per step.
    Returns the kernel run's launch counts."""
    from clima_oceananigans_jl_torch import DistributedModel, make_mesh
    c = DISTRIBUTED
    path = "distributed RK3"
    timestepper, dt, _, _, kw = PATHS["RK3"]
    model = model_for(N, torch.float32, timestepper=timestepper, **kw)
    rng = np.random.default_rng(0)
    shape = model.grid.shape
    state0 = model.initial_state(u=1e-2 * rng.standard_normal(shape),
                                 v=1e-2 * rng.standard_normal(shape),
                                 b=1e-4 * rng.standard_normal(shape))
    mesh = make_mesh(c["mesh"], dist_devices(4))
    dm = DistributedModel(model, mesh)
    # the single-device step: hold steps, then the timed ones
    single = state0
    for _ in range(c["hold"]):
        single = model.step(single, dt)
    single_hold = {k: model.grid.interior(a).clone() for k, a in single["solution"].items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        single = model.step(single, dt)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) / c["steps"] * 1e3
    del single
    # the decomposed kernel run: every count set to 0 just before, read after
    states = dm.scatter_state(state0)
    zero_counts()
    mesh.reset_counts()
    states = dist_steps(dm, states, dt, c["hold"])
    torch.cuda.synchronize()
    held, kernel_u = dist_gathered(dm, states)
    ratio = divergence_ratio(model, held)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = dist_steps(dm, states, dt, c["steps"])
    torch.cuda.synchronize()
    dist_ms = (time.perf_counter() - t0) / c["steps"] * 1e3
    n = c["hold"] + c["steps"]
    launches = read_counts(path, n)
    per_step = {what: {k: v / n for k, v in d.items()} for what, d in
                (("counts", mesh.counts), ("copies", mesh.copies), ("bytes", mesh.bytes))}
    per = lambda what: per_step[what]
    check_finite(path, model, dm.gather_state(states), ("pHY", "pNHS"))
    if not ratio <= 1e-5:
        raise AssertionError(f"{path}: max|div u|*dx/max|u| = {ratio:.3e} > 1e-5")
    del states
    # the holds: the decomposed plain run, the single-device run
    plain = dist_steps(dm, dm.scatter_state(state0), dt, c["hold"],
                       nonhydrostatic.PLAIN)
    _, plain_u = dist_gathered(dm, plain)
    del plain
    dist_relative(f"{path}: kernel against plain runs", kernel_u, plain_u, 0.0)
    tol = pencil_tolerance(torch.float32)
    worst = dist_relative(f"{path}: against the single-device run", kernel_u,
                          single_hold, tol)
    used = {k: v / n for k, v in launches.items() if v}
    print(f"{path} path: {N}^3 fp32 on a {c['mesh']} mesh of 4 shards on one card, "
          f"{c['steps']} steps: {dist_ms:.3f} ms/step ({N ** 3 / dist_ms * 1e3:.6e} "
          f"grid points/s), single-device RK3 {single_ms:.3f} ms/step in the same "
          f"call; launches per step {used}; {card_line()}")
    print(f"{path} path: per step: exchanges {per('counts').get('exchange', 0):g}, "
          f"exchange copies {per('copies').get('exchange', 0):g}, exchange bytes "
          f"{per('bytes').get('exchange', 0):.6e}, transposes "
          f"{per('counts').get('all_to_all', 0):g} ({per('copies').get('all_to_all', 0):g} "
          f"copies, {per('bytes').get('all_to_all', 0):.6e} bytes), sums "
          f"{per('counts').get('sum', 0):g}")
    print(f"{path} path: after {c['hold']} steps the kernel and plain decomposed runs "
          f"agree exactly; against the single-device run {worst:.3e} of max|field| "
          f"(<= {tol:.3e}, {PENCIL_EPS} fp32 eps); max|div u|*dx/max|u| {ratio:.3e}")
    del dm, model, state0, kernel_u, plain_u, single_hold
    torch.cuda.empty_cache()
    return launches


#: the decomposed near-global ocean: benchmark/bench_near_global.py at
#: deg = 0.25 (1440×600×24 fp32), built as the "near-global" path builds it
#: (``hydro_path_model``: its sigmoid continent, wind, closure and state),
#: wrapped in DistributedModel over a (2, 2) mesh of four 720×300×24 shards
#: on one card (Oceananigans' MultiRegion on one GPU); the shards take the
#: two-stage route with K5's cut form. ``hold`` steps held from the initial
#: state, then ``steps`` timed and ``profiled`` under the profiler
DIST_NEAR_GLOBAL = dict(mesh=(2, 2), hold=3, steps=5, profiled=2)
#: the four shards' launches a step: each 1 K4a, 1 K4b, 2 × 30 K5 (its cut
#: form), 2 × 30 + 1 K6 in the barotropic substeps and 2 in update_state,
#: 3 T1
PER_STEP["distributed near-global"] = {K4A: 4, K4B: 4, K5CUT: 240, K6: 252, T1: 12}


def shard_inputs(label, model, dm):
    """What K4b and K5 read on each shard of ``dm``, confirmed: a cut axis
    has no near-wall bounds (``axis_bounds`` of the model's flux-form and
    tracer schemes and of WENO5, where the global grid's bounded axis has
    them); K4b's y rows (and a stretched y's tables, and the clear flags
    of the model's schemes, and over partial cells the 3D-Δz pack) and K5's
    metric rows and depth planes are built on the shard's grid (its own
    ``_cache``, its shape), the rows, the pack and the planes equal to the
    global grid's at the shard's window. Returns a summary."""
    g = model.grid
    Hfc, Hcf = column_depths(g)
    k5_rows = depth_inputs(g, Hfc, Hcf)[0]
    ys_global = kernel_y_rows(g, model.coriolis)
    schemes = [s for s in (model.momentum_advection, model.tracer_advection)
               if hasattr(s, "is_upwind")] + [WENO5()]
    flags = 0
    for r, lm in enumerate(dm.local_models):
        lg = lm.grid
        sx, sy = _windows(g, dm.mesh_shape, *dm.mesh.coords(r))
        for axis in (0, 1):
            if lg.dist[axis] is None:
                continue
            for sch in schemes:
                if axis_bounds(lg, axis, sch) != (0, 0, -1, 0, -1):
                    raise AssertionError(f"{label}: shard {r} has near-wall bounds "
                                         f"on its cut axis {axis}")
        ys = kernel_y_rows(lg, lm.coriolis)
        if ys.shape[1] != lg.total_shape[1] or not torch.equal(ys, ys_global[:, sy]):
            raise AssertionError(f"{label}: shard {r}'s K4b y rows")
        table = any(type(sch) in TABLE_SCHEMES for sch in schemes[:-1])
        if table and not lg.y_regular and y_tables(lg).shape[1] != lg.total_shape[1]:
            raise AssertionError(f"{label}: shard {r}'s y tables")
        for loc in _mask_locs(lm):
            sch = lm.tracer_advection if loc == CENTER else lm.momentum_advection
            f = clear_flags(lg, loc, sch.buffer)
            if tuple(f.shape) != lg.total_shape or f is g._cache.get(
                    ("clear_flags", tuple(loc), sch.buffer)):
                raise AssertionError(f"{label}: shard {r}'s clear flags")
            flags += 1
        if getattr(lg, "partial_cells", False) and not torch.equal(
                dz3_pack(lg), dz3_pack(g)[:, sx, sy]):
            raise AssertionError(f"{label}: shard {r}'s 3D-Δz pack")
        rows, (hfc, hcf) = depth_inputs(lg, *column_depths(lg))
        if not (torch.equal(rows, k5_rows[:, sy]) and torch.equal(hfc, Hfc[sx, sy, 0])
                and torch.equal(hcf, Hcf[sx, sy, 0])):
            raise AssertionError(f"{label}: shard {r}'s K5 rows or depth planes")
    bounded = [a for a in (0, 1) if g.topology[a] is BOUNDED]
    return (f"no near-wall bounds on the cut axes (WENO5's on the global bounded "
            f"axes {bounded}: {[axis_bounds(g, a, WENO5()) for a in bounded]}); K4b's y "
            f"rows and K5's rows and depth planes the shards' own, equal to the global "
            f"grid's at each window; {flags} clear-flag tensors built on the shards")


def k5_cut_inputs(dm, model, seed):
    """Per shard K5's arguments from seeded global fields on the card (η
    ~ 0.1, U, V ~ 10, Gᵁ, Gⱽ ~ 1e-3 N(0, 1) on the interior, NaN halos:
    neither the cut form nor its plain version reads them), cut at the
    shards' windows, with the model's Δτ at Δt = 600 s and its weights."""
    g, fs = model.grid, model.free_surface
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    shape = g.total_shape[:2] + (1,)
    fields = []
    for scale in (0.1, 10.0, 10.0, 1e-3, 1e-3):
        a = torch.full(shape, float("nan"), dtype=g.dtype, device=DEVICE)
        a[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny] = scale * torch.randn(
            (g.Nx, g.Ny, 1), generator=gen, dtype=g.dtype, device=DEVICE)
        fields.append(scatter_array(a, g, dm.mesh_shape, dm.mesh.devices))
    n = fs.substeps
    wv = fs._weight_vec(None, fields[0][0])
    return [(lm.grid, lm.eta_bcs, *(f[r] for f in fields), *column_depths(lm.grid),
             fs.gravitational_acceleration, 2.0 * HYDRO["dt"] / n, wv, wv, n)
            for r, lm in enumerate(dm.local_models)]


def cut_mirrors(*args):
    """K5's cut form's plain version: its halves' plain mirrors between the
    plain fills (``fused_fill_halos_reference``)."""
    return cut_sequence(*args, half_uv=substep_uv_interior_reference,
                        half_eta=substep_eta_interior_reference,
                        fill=fused_fill_halos_reference)


def hold_k5_cut(label, dm, model, seed):
    """K5's cut form (its 2n launches between K6's fills and the exchange)
    against its plain version on every shard's every with-halo point of
    η̅, U̅, V̅, bit for bit over NaN-filled work arrays; max|Δ|."""
    inputs = k5_cut_inputs(dm, model, seed)
    names = ("eta_av", "U_av", "V_av")
    shape = dm.local_grid.total_shape[:2] + (1,)

    def shard(r):
        poison_cache(shape, model.grid.dtype, 12)
        got = fused_substep_eta(*inputs[r])
        poison_cache(shape, model.grid.dtype, 12)
        return got, cut_mirrors(*inputs[r])

    before = WRAPPERS[K5].cut_launches
    out = dm.mesh.run(shard)
    n = model.free_surface.substeps
    if WRAPPERS[K5].cut_launches - before != 2 * n * dm.mesh.size:
        raise AssertionError(f"{label}: {WRAPPERS[K5].cut_launches - before} cut-form "
                             f"launches, expected {2 * n * dm.mesh.size}")
    got = {f"shard {r}": dict(zip(names, o[0])) for r, o in enumerate(out)}
    ref = {f"shard {r}": dict(zip(names, o[1])) for r, o in enumerate(out)}
    return hold(f"K5 cut form {label}", got, ref, model.grid.dtype, exact=True)


def k5_cut_reading(label, dm, model):
    """K5's cut form held (``hold_k5_cut``) on the shards of ``dm``, then
    timed on one shard: its 2n launches a call with the fills left out (no
    exchange runs outside the mesh), by the profiler's device time and by
    CUDA events, against its halves' plain mirrors and its bound (K5's:
    η0, U0, V0, Gᵁ, Gⱽ and the two depth planes in, η̅, U̅, V̅ out, 32
    operations a point and substep). Returns (max|Δ|, ms, plain_ms,
    bound_ms, bound_by)."""
    err = hold_k5_cut(label, dm, model, 15)
    args = k5_cut_inputs(dm, model, 16)[0]
    g, n = args[0], args[-1]
    no_fill = lambda grid, fields: None
    kernel_halves = lambda: cut_sequence(*args, *cut_kernel_halves(g, *args[7:9]),
                                         fill=no_fill)
    plain_halves = lambda: cut_sequence(*args, half_uv=substep_uv_interior_reference,
                                        half_eta=substep_eta_interior_reference,
                                        fill=no_fill)
    before = WRAPPERS[K5].cut_launches
    ms = device_ms(kernel_halves, 5, "substep_")
    wall_ms = cuda_ms(kernel_halves, 5)
    if WRAPPERS[K5].cut_launches - before != 2 * n * 12:
        raise AssertionError(f"{label}: the timed calls launched "
                             f"{WRAPPERS[K5].cut_launches - before} times")
    plain_ms = cuda_ms(plain_halves, 2)
    shape = g.total_shape[:2] + (1,)
    b_ms, b_by = bound(K5CUT, 10 * math.prod(shape) * torch.finfo(g.dtype).bits // 8,
                       shape[0] * shape[1] * n)
    if ms is None:
        ms = wall_ms
    print(f"K5 cut form {label} time, one {g.Nx}x{g.Ny} shard, {n} substeps ({2 * n} "
          f"launches, fills left out): kernels {ms:.4f} ms of device time (profiler), "
          f"{wall_ms:.4f} ms by CUDA events (host-bound launches); plain halves "
          f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
    return err, ms, plain_ms, b_ms, b_by


def phase_distributed_near_global():
    """``distributed near-global`` (``DIST_NEAR_GLOBAL``): the ¼° near-global
    ocean decomposed on a (2, 2) mesh of one card. What the shards' kernels
    read is confirmed (``shard_inputs``); ``hold`` steps with the kernels
    (their launches read with the timed steps') are checked (finite, u and
    v exactly 0 at solid faces, |Σ η·Az| ≤ 1e-5·Σ|η|·Az), held bit for
    bit against the decomposed plain run and the overlap_halo run, and
    within ``pencil_tolerance`` of the single-device kernel run; ``steps``
    timed beside the single-device near-global step, then ``profiled`` for
    the idle share; K4a and K4b held on each shard's fields, K5's cut form
    held and timed on the shards. Returns (the kernel run's launches, K5's
    cut form's reading, K4a's and K4b's largest max|Δ|)."""
    from clima_oceananigans_jl_torch import DistributedModel, make_mesh
    c, path = DIST_NEAR_GLOBAL, "distributed near-global"
    dt = HYDRO["dt"]
    model, state0 = hydro_path_model("near-global")
    g = model.grid
    mesh = make_mesh(c["mesh"], dist_devices(4))
    dm = DistributedModel(model, mesh)
    if any(lm.fused_advance for lm in dm.local_models):
        raise AssertionError(f"{path}: a shard on the fused advance")
    print(f"{path}: {shard_inputs(path, model, dm)}")
    single = state0
    for _ in range(c["hold"]):
        single = model.step(single, dt)
    single_hold = {k: g.interior(a).clone() for k, a in single["solution"].items()}
    single_hold["eta"] = single["eta"][g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny].clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        single = model.step(single, dt)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) / c["steps"] * 1e3
    del single
    # the decomposed kernel run: every count set to 0 just before, read after
    states = dm.scatter_state(state0)
    zero_counts()
    mesh.reset_counts()
    states = dist_steps(dm, states, dt, c["hold"])
    held, kernel_u = dist_gathered(dm, states)
    check_finite(path, model, held, ("w", "pHY", "eta"))
    faces = zero_at_solid_faces(path, model, held)
    net, gross = eta_balance(path, model, held)
    del held
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = dist_steps(dm, states, dt, c["steps"])
    torch.cuda.synchronize()
    dist_ms = (time.perf_counter() - t0) / c["steps"] * 1e3
    n = c["hold"] + c["steps"]
    launches = read_counts(path, n)
    exchanges = mesh.counts.get("exchange", 0) / n
    states, _, idle, prof_ms = profiled_steps(lambda s: dm.step(s, dt), states,
                                              c["profiled"])
    check_finite(path, model, dm.gather_state(states), ("w", "pHY", "eta"))
    # K4a and K4b on each shard's fields, bit for bit over NaN-filled outputs
    k4_err = max(max(hold_k4a(f"1/4 deg fp32 on the {path} path's shard {r}", lm.grid,
                              st["solution"]),
                     hold_k4b(f"1/4 deg fp32 on the {path} path's shard {r}", lm, st))
                 for r, (lm, st) in enumerate(zip(dm.local_models, states)))
    del states
    torch.cuda.empty_cache()
    # the holds: the decomposed plain run, overlap_halo, the single-device run
    plain = dist_steps(dm, dm.scatter_state(state0), dt, c["hold"], hydrostatic.PLAIN)
    _, plain_u = dist_gathered(dm, plain)
    del plain
    dist_relative(f"{path}: kernel against plain runs", kernel_u, plain_u, 0.0)
    del plain_u
    dmo = DistributedModel(model, mesh, overlap_halo=True)
    _, ovl = dist_gathered(dmo, dist_steps(dmo, dmo.scatter_state(state0), dt, c["hold"]))
    dist_relative(f"{path}: overlap_halo against no overlap", ovl, kernel_u, 0.0)
    del dmo, ovl
    tol = pencil_tolerance(torch.float32)
    worst = dist_relative(f"{path}: against the single-device run", kernel_u,
                          single_hold, tol)
    torch.cuda.empty_cache()
    reading = k5_cut_reading(f"1/4 deg fp32 on the {path} path's shards", dm, model)
    shards = mesh.size
    per_shard = {k: v / n / shards for k, v in launches.items() if v}
    idle_s = "not measured" if idle is None else f"{100 * idle:.1f}%"
    points = g.Nx * g.Ny * g.Nz
    print(f"{path} path: 1/4 deg {g.Nx}x{g.Ny}x{g.Nz} fp32 on a {c['mesh']} mesh of "
          f"{shards} shards of {g.Nx // c['mesh'][0]}x{g.Ny // c['mesh'][1]}x{g.Nz} "
          f"on one "
          f"card, {c['steps']} steps: {dist_ms:.3f} ms/step ({points / dist_ms * 1e3:.6e} "
          f"grid points/s), single-device near-global {single_ms:.3f} ms/step in the "
          f"same call; device idle {idle_s} (torch.profiler, {c['profiled']} steps, "
          f"{prof_ms:.3f} ms/step); launches per shard per step {per_shard}; "
          f"exchanges a step {exchanges:g}; {card_line()}")
    print(f"{path} path: after {c['hold']} steps the kernel run is bit for bit the "
          f"decomposed plain run and the overlap_halo run; against the single-device "
          f"run {worst:.3e} of max|field| (<= {tol:.3e}, {PENCIL_EPS} fp32 eps); u and v "
          f"exactly 0 at all {faces} solid faces; |sum(eta Az)|/sum(|eta| Az) "
          f"{abs(net) / gross:.3e}")
    del dm, model, state0, kernel_u, single_hold
    torch.cuda.empty_cache()
    return launches, reading, k4_err


def dist_case(label, make, init, mesh_shape, dt, kernels, plain_kernels,
              single=True, exact_plain=True, overlap=False, tol=None, steps=None,
              check=None):
    """One small hold: ``make()``'s model decomposed on ``mesh_shape`` (all
    shards on one card), its kernel run against its plain run after
    ``steps`` steps (``DIST_HOLD["steps"]`` by default; bit for bit, or
    within the shallow-water path's ``AGREE``), and against the
    single-device kernel run within ``tol`` (the pencil tolerance; 0 where
    no FFT runs). ``kernels``: the kernels that must have launched
    (``launch_counts``' names). With ``overlap``, the halo-overlap step is
    held bit for bit against the plain decomposed step instead. ``check``,
    given, is called with (model, dm) before the steps and returns a note
    for the printed line."""
    from clima_oceananigans_jl_torch import DistributedModel, make_mesh
    steps = steps or DIST_HOLD["steps"]
    model = make()
    s0 = init(model)
    nshards = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, dist_devices(nshards))
    dm = DistributedModel(model, mesh)
    note = check(model, dm) if check is not None else None
    zero_counts()
    _, got = dist_gathered(dm, dist_steps(dm, dm.scatter_state(s0), dt, steps))
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if k in kernels}
    if not all(counts.values()):
        raise AssertionError(f"{label}: a kernel did not launch: {counts}")
    line = f"distributed hold {label}: {mesh_shape} mesh, launches {counts}"
    if note:
        line += f"; {note}"
    if overlap:
        dmo = DistributedModel(model, mesh, overlap_halo=True)
        _, ovl = dist_gathered(dmo, dist_steps(dmo, dmo.scatter_state(s0), dt, steps))
        dist_relative(f"{label}: overlap against no overlap", ovl, got, 0.0)
        line += "; overlap_halo=True bit for bit the plain decomposed step"
    else:
        _, plain = dist_gathered(dm, dist_steps(dm, dm.scatter_state(s0), dt, steps,
                                                plain_kernels))
        err = dist_relative(f"{label}: kernel against plain runs", got, plain,
                            0.0 if exact_plain else AGREE["shallow water"])
        line += f"; kernel and plain decomposed runs agree to {err:.3e}"
    if single:
        ref = s0
        for _ in range(steps):
            ref = model.step(ref, dt)
        ref = {k: model.grid.interior(a) for k, a in ref["solution"].items()}
        tol = pencil_tolerance(model.grid.dtype) if tol is None else tol
        err = dist_relative(f"{label}: against the single-device run", got, ref, tol)
        line += f"; single-device run within {err:.3e} (<= {tol:.3e})"
    print(line)
    del dm, model, s0, got
    torch.cuda.empty_cache()


def phase_distributed_holds():
    """The small holds of the decomposed models on one card: meshes (4, 1),
    (1, 4) and (2, 4); a bounded global x (the end shards' walls,
    ``select_edge``); a stretched z (T1's Fourier form per shard);
    overlap_halo; a GridFittedBottom; shallow water at 1024² on (2, 4) with
    K3a per shard; the hydrostatic model: a (P, B, B) 32×32×8
    split-explicit(10) box on (2, 2), and the JAX suite's near-global stack
    at 48×24×8 (``near_global_stack``) on (2, 2) and (4, 1) in fp32 and
    fp64 and with WENO5 flux-form momentum and tracer (the shards' clear
    flags), each with what the shards' kernels read confirmed
    (``shard_inputs``), 2 steps, K4a, K4b, K5's cut form and K6 (and T1)
    launched, bit for bit the decomposed plain run."""
    from clima_oceananigans_jl_torch import DistributedModel, make_mesh
    n = DIST_HOLD["n"]
    timestepper, dt, _, _, kw = PATHS["RK3"]
    nh = (K2, K3B, K3C, K6)
    flagship = lambda: model_for(n, torch.float32, timestepper=timestepper, **kw)

    def random_uvb(model, seed=0):
        rng = np.random.default_rng(seed)
        shape = model.grid.shape
        return model.initial_state(u=1e-2 * rng.standard_normal(shape),
                                   v=1e-2 * rng.standard_normal(shape),
                                   b=1e-4 * rng.standard_normal(shape))

    P = nonhydrostatic.PLAIN
    for shape in ((4, 1), (1, 4), (2, 4)):
        dist_case(f"RK3 {n}^3 fp32", flagship, random_uvb, shape, dt, nh, P)

    def bounded_x():
        grid = RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                               topology=(BOUNDED, PERIODIC, BOUNDED),
                               dtype=torch.float32, device=DEVICE)
        return NonhydrostaticModel(grid, buoyancy=BuoyancyTracer(),
                                   timestepper=timestepper, **kw)

    dist_case(f"bounded x (B,P,B) RK3 {n}^3 fp32, centred", bounded_x, random_uvb,
              (2, 2), dt, nh, P)

    def stretched():
        grid = RectilinearGrid(size=(n, n, n), x=(0.0, 1.0), y=(0.0, 1.0),
                               z=stretched_faces(n, Lz=1.0),
                               topology=(PERIODIC, PERIODIC, BOUNDED),
                               dtype=torch.float32, device=DEVICE)
        return NonhydrostaticModel(grid, advection=WENO5(), buoyancy=BuoyancyTracer(),
                                   timestepper=timestepper, **kw)

    dist_case(f"stretched z RK3 {n}^3 fp32", stretched, random_uvb, (2, 2), dt,
              (K2, K6, T1), P)
    dist_case(f"overlap_halo RK3 {n}^3 fp32", flagship, random_uvb, (2, 2), dt, nh, P,
              overlap=True)

    def immersed():
        grid = RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                               topology=(PERIODIC, PERIODIC, BOUNDED),
                               dtype=torch.float32, device=DEVICE)
        bump = lambda x, y: -1.0 + 0.4 * torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2)
                                                   / 0.02)
        return NonhydrostaticModel(grid, tracers=("c",),
                                   immersed_boundary=GridFittedBottom(bump))

    dist_case(f"GridFittedBottom AB2 {n}^3 fp32", immersed,
              lambda m: m.initial_state(u=1e-2, c=lambda x, y, z: torch.exp(
                  -((x - 0.3) ** 2 + (z + 0.5) ** 2) / 0.05)),
              (2, 2), 1e-3, nh, P)

    def sw():
        n_sw = DIST_HOLD["n_sw"]
        grid = RectilinearGrid(size=(n_sw, n_sw, 1), x=(0, 2 * math.pi),
                               y=(0, 2 * math.pi), topology=(PERIODIC, PERIODIC, FLAT),
                               dtype=torch.float32, device=DEVICE)
        return ShallowWaterModel(grid, gravitational_acceleration=10.0,
                                 advection=WENO5(), coriolis=FPlane(f=1.0))

    dist_case(f"shallow water {DIST_HOLD['n_sw']}^2 fp32", sw,
              lambda m: m.initial_state(uh=lambda x, y, z: 0.1 * torch.sin(x)
                                        * torch.cos(y), h=1.0),
              (2, 4), SW_PATH[0], (K3A,), shallow_water.PLAIN, exact_plain=False,
              tol=0.0)
    hydrostatic_holds()


def hydrostatic_holds():
    """The hydrostatic model decomposed on one card: K4a, K4b, K5's cut
    form, K6 (and T1) on every shard, each case's kernel run bit for bit
    its plain decomposed run (``phase_distributed_holds``' last cases)."""
    hy, c = hydrostatic.PLAIN, DIST_HOLD

    def split_box():
        grid = RectilinearGrid(size=(c["n_hy"], c["n_hy"], 8), x=(0, 1e5), y=(0, 1e5),
                               z=(-100.0, 0), topology=(PERIODIC, BOUNDED, BOUNDED),
                               device=DEVICE)
        return HydrostaticFreeSurfaceModel(grid, free_surface=SplitExplicitFreeSurface(
            substeps=10))

    def split_init(model):
        return model.initial_state(
            eta=lambda x, y: 0.01 * torch.sin(2 * math.pi * x / 1e5)
            * torch.cos(math.pi * y / 1e5),
            u=lambda x, y, z: 0.01 * torch.cos(2 * math.pi * y / 1e5))

    hk = (K4A, K4B, K5CUT, K6)
    stack_init = lambda m: m.initial_state(b=lambda lam, phi, z: 2e-5 * (z + 3000.0)
                                           / 3000.0)
    dist_case(f"hydrostatic (P,B,B) {c['n_hy']}x{c['n_hy']}x8 fp32 split-explicit(10)",
              split_box, split_init, (2, 2), 300.0, hk, hy, steps=c["steps_hy"],
              check=lambda m, dm: shard_inputs("hydrostatic hold", m, dm))
    for dtype in (torch.float32, torch.float64):
        for shape in ((2, 2), (4, 1)):
            dist_case(f"near-global stack 48x24x8 {str(dtype)[6:]}",
                      functools.partial(near_global_stack, dtype),
                      stack_init, shape, 600.0, hk + (T1,), hy, steps=c["steps_hy"],
                      check=lambda m, dm: shard_inputs("near-global stack", m, dm))
    # the near-global stack with WENO schemes: K4b reads the shards' clear
    # flags over the ridge and bump
    dist_case("near-global stack 48x24x8 float32, WENO5 flux-form momentum and tracer",
              functools.partial(near_global_stack, torch.float32, WENO5()),
              stack_init, (2, 2), 600.0, hk + (T1,), hy, steps=c["steps_hy"],
              check=lambda m, dm: shard_inputs("near-global stack WENO5", m, dm))
    # and over partial bottom cells: K4a's and K4b's 3D-Δz forms read the
    # shards' Δz
    dist_case("near-global stack 48x24x8 float32, PartialCellBottom",
              functools.partial(near_global_stack, torch.float32, partial=True),
              stack_init, (2, 2), 600.0, hk + (T1,), hy, steps=c["steps_hy"],
              check=lambda m, dm: shard_inputs("near-global stack partial cells", m, dm))


def near_global_stack(dtype, scheme=None, partial=False):
    """The JAX suite's decomposed near-global stack
    (tests/test_distributed.py:502-553) at 48×24×8: a lat-lon grid (0–360,
    −60–60), the GridFittedBottom of its ridge and bump, split-explicit(12),
    HydrostaticSphericalCoriolis, BuoyancyTracer, the vertically implicit
    ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4) and its
    wind FluxBC on u; ``scheme`` the momentum (flux form) and tracer
    scheme in place of the defaults; with ``partial``, its bottom as a
    PartialCellBottom (K4a's and K4b's 3D-Δz forms)."""
    grid = LatitudeLongitudeGrid(size=(48, 24, 8), longitude=(0, 360), latitude=(-60, 60),
                                 z=(-3000.0, 0.0), dtype=dtype, device=DEVICE)
    full = lambda v, like: torch.full((), v, dtype=like.dtype, device=like.device)
    bathy = lambda lam, phi: torch.where(
        (lam > 170) & (lam < 190), full(100.0, lam),
        -3000.0 + 800.0 * torch.exp(-((lam - 60) / 15.0) ** 2))
    wind = lambda lam, phi, t: -1e-4 * torch.cos(3.0 * math.pi * phi / 180.0)
    kw = {} if scheme is None else dict(momentum_advection=scheme, tracer_advection=scheme)
    return HydrostaticFreeSurfaceModel(
        grid, free_surface=SplitExplicitFreeSurface(substeps=12),
        coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer(),
        closure=ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
                                  time_discretization="vertically_implicit"),
        immersed_boundary=(PartialCellBottom if partial else GridFittedBottom)(bathy),
        boundary_conditions={"u": FieldBCs(top=FluxBC(wind))}, **kw)


def _timed_phase(fn):
    """``fn`` with its seconds printed after it ("phase <name>: s")."""
    def run(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out
    return run


# every phase prints its seconds, so that a run's time can be read phase by phase
for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = _timed_phase(globals()[_name])


def main():
    t0 = time.perf_counter()
    phase_device()
    prefetch = _Prefetch()
    prefetch.start()
    phase_build()
    measured = {K1: phase_k1(), K2: phase_k2(), K3A: phase_k3a()}
    measured[K3B], measured[K3C] = phase_k3bc()
    measured.update(phase_k4())
    k4b_err, k4b_forms = phase_k4_forms()
    measured[K5] = phase_k5()
    k5_planes = phase_k5_planes()
    k5_err = k5_planes[0]
    # the Flat slice's holds: K4a, K4b and K5 on Flat axes, K4b's Cartesian
    # Coriolis forms
    flat_hold_worst, flat_hold_forms = phase_flat_holds()
    measured[K6] = phase_k6()
    phase_forced()
    k1_err, k2_err = phase_stretched()
    measured[T1], t1_readings = phase_t1()
    # each path's launches, read just after its kernel run; a kernel's
    # record counts its launches on every path
    by_path = {}
    for path, name in (("AB2", K1), ("RK3", K2)):
        by_path[path], (err, ms, plain_ms) = phase_path(path)
        # K1's and K2's times on their paths' fields
        measured[name] = (max(measured[name][0], err), ms, plain_ms,
                          *measured[name][3:])
    by_path["shallow water"], ms, plain_ms = phase_shallow_water()
    # K3a's times on the path's fields
    measured[K3A] = (measured[K3A][0], ms, plain_ms, *measured[K3A][3:])
    by_path["general projection"], _ = phase_path("general projection")
    by_path["hydrostatic"], ms, plain_ms, _ = phase_hydrostatic()
    # K4b's times on the path's fields (its advance form)
    measured[K4B] = (measured[K4B][0], ms, plain_ms, *measured[K4B][3:])
    for path in SURFACE:
        by_path[path], _ = phase_path(path)
    by_path["hydrostatic wind"], _, _, _ = phase_hydrostatic("hydrostatic wind")
    for path in LES:
        by_path[path], _ = phase_path(path)
    for path in NEAR_GLOBAL:
        by_path[path], _, _, _ = phase_hydrostatic(path)
    # the schemes slice's ¼° paths, K4b's readings on their fields
    k4b_path_forms = []
    for path in SCHEME_PATHS:
        by_path[path], _, _, reading = phase_hydrostatic(path)
        k4b_path_forms.append(reading)
    flat_worst, k1_flat = phase_flat_bounded()
    wall_readings = {}
    for path in WALLS:
        by_path[path], wall_readings[path], k6_err = phase_wall_path(path)
        flat_worst[K6] = max(flat_worst.get(K6, 0.0), k6_err)
    k2_immersed = phase_k2_immersed()
    by_path["simulation"] = phase_simulation()
    by_path["seamount"], wall_readings["seamount"], k6_err = phase_seamount()
    flat_worst[K6] = max(flat_worst[K6], k6_err)
    flat_worst[K2] = max(flat_worst[K2], *(f["max_abs_err"] for f in k2_immersed))
    scheme_worst, scheme_forms = phase_schemes()
    hydro_worst, hydro_forms = phase_hydro_schemes()
    for name, err in hydro_worst.items():
        scheme_worst[name] = max(scheme_worst.get(name, 0.0), err)
    bf16_worst, bf16_forms = phase_bf16_holds()
    for name, err in bf16_worst.items():
        scheme_worst[name] = max(scheme_worst.get(name, 0.0), err)
    bf16_readings = []
    for path in BF16_PATHS:
        by_path[path], reading = phase_bf16_path(path)
        bf16_readings.append(reading)
    (by_path["internal wave"], wall_readings["internal wave"], k6_err,
     iw_err) = phase_internal_wave()
    by_path["periodic advection"], pa_err = phase_periodic_advection()
    phase_closures_hold()
    by_path.update(phase_free_convection())
    phase_nonhydrostatic_closures()
    # the Flat slice's paths: the two columns, the gyre, the front slice
    # (each column's holds run K4a, K4b, T1 and K6)
    columns, column_err = phase_column_closures()
    by_path.update(columns)
    columns, err = phase_wind_mixing_column()
    by_path.update(columns)
    column_err = max(column_err, err)
    by_path.update(phase_gyre())
    by_path["front slice"], front_reading = phase_front_slice()
    # the stencil-matrix slice: K2's stretched-x/y form (its holds and the
    # stretched channel), the implicit free surface's matrix and multigrid
    # methods, particles
    k2xy_forms = phase_k2xy_holds()
    by_path["stretched channel"], k2xy_reading_ = phase_stretched_channel()
    by_path.update(phase_implicit_free_surface())
    phase_particle_holds()
    measured[K2XY] = (max(k2xy_reading_[0], *(f["max_abs_err"] for f in k2xy_forms)),
                      *k2xy_reading_[1:])
    # the cubed-sphere slice: the four cubed-sphere validations and the
    # biogeochemistry copy as written, the two C256 readings, the ensemble
    by_path.update(phase_cubed_sphere_validations())
    by_path.update(phase_biogeochemistry())
    counts, _ = phase_galewsky(prefetch)
    by_path.update(counts)
    counts, _ = phase_cubed_sphere_3d()
    by_path.update(counts)
    counts, _ = phase_ensemble_columns()
    by_path.update(counts)
    # the partial-cell slice: K4a's and K4b's 3D-Δz forms at 1° and the ¼° path
    partial_worst, partial_forms = phase_partial_holds()
    by_path["near-global partial cells"], partial_readings, err = phase_near_global_partial()
    # the distributed slice: the RK3 flagship decomposed on a (2, 2) mesh,
    # then the small holds
    by_path["distributed RK3"] = phase_distributed()
    # the decomposed slice of the hydrostatic model: the ¼° near-global ocean
    # on a (2, 2) mesh, K5's cut form held and timed on its shards
    by_path["distributed near-global"], k5_cut, k4_err = phase_distributed_near_global()
    measured[K5CUT] = k5_cut
    for name in (K4A, K4B):
        measured[name] = (max(measured[name][0], k4_err), *measured[name][1:])
    phase_distributed_holds()
    for name in (K4A, K4B):
        flat_worst[name] = max(flat_worst.get(name, 0.0), partial_worst[name], err[name])
    for name, err in flat_hold_worst.items():
        flat_worst[name] = max(flat_worst.get(name, 0.0), err)
    for name in (K4A, K4B, T1, K6):
        flat_worst[name] = max(flat_worst.get(name, 0.0), column_err)
    flat_worst[K6] = max(flat_worst[K6], k6_err)
    for name, err in scheme_worst.items():
        flat_worst[name] = max(flat_worst.get(name, 0.0), err)
    flat_worst[K2] = max(flat_worst[K2], iw_err, pa_err)
    # every hold's max|Δ| in its kernel's record
    for name, err in flat_worst.items():
        measured[name] = (max(measured[name][0], err), *measured[name][1:])
    # K1's and K2's holds on a stretched z, K4b's newer parts, K5 on planes
    for name, err in ((K1, k1_err), (K2, k2_err), (K4B, k4b_err), (K5, k5_err)):
        measured[name] = (max(measured[name][0], err), *measured[name][1:])
    launches = {k: sum(counts.get(k, 0) for counts in by_path.values())
                for k in (*WRAPPERS, K2XY, K5CUT)}
    print("launches by path: " + json.dumps(
        {path: {k: n for k, n in counts.items() if n} for path, counts in by_path.items()}))
    records = []
    for name, (err, ms, plain_ms, bound_ms, bound_by) in measured.items():
        records.append({
            "name": name, "route": "cuda",
            "source": f"clima_oceananigans_jl_torch/csrc/{SOURCES[name]}.cu",
            **({"sources": [f"clima_oceananigans_jl_torch/csrc/{k}.cu"
                            for k in K2_SOURCES]} if name == K2 else {}),
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    if not all(r["launches"] > 0 for r in records):
        raise AssertionError(f"a kernel was never launched on its path: {records}")
    # K4b's newer parts and K5 over a bottom: their own readings beside the
    # kernel's, with the launches of the path that runs each (none runs a
    # stretched latitude: its hold only)
    form_path = {"closure": "1/4 deg diffusive", "masks": "near-global WENO"}
    by_name = {r["name"]: r for r in records}
    by_name[K4B]["forms"] = [
        dict(r, launches=by_path[form_path[r["part"]]][K4B] if r["part"] in form_path
             else 0, library_ms=None) for r in k4b_forms]
    err, ms, plain_ms, bound_ms, bound_by = k5_planes
    by_name[K5]["forms"] = [{
        "part": "near-global bottom", "form": "depth planes varying in x",
        "launches": by_path["near-global"][K5] + by_path["near-global WENO"][K5],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]
    # T1's forms, with the launches of each path whose T1 calls take it
    def form_launches(path, kind):
        counts = by_path[path]
        return counts[T1F] if kind == "fourier" else counts[T1] - counts[T1F]

    by_name[T1]["forms"] = []
    for r in t1_readings:
        per_path = {p: form_launches(p, kind) for p, kind in T1_FORM_PATHS[r["part"]].items()}
        by_name[T1]["forms"].append(dict(r, launches=sum(per_path.values()),
                                         launches_by_path=per_path, library_ms=None))
    # K1's, K2's, K3b's and K3c's Flat and bounded geometries, with the
    # launches of the path that runs each (no path runs K1 on a Flat axis)
    err, ms, plain_ms, bound_ms, bound_by = k1_flat
    by_name[K1]["forms"] = [{
        "part": "Flat z", "form": "P,P,F 1024x1000x1 fp32, UB5, general instantiation",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]
    for name in (K2, K3B, K3C):
        by_name[name]["forms"] = [{
            "part": path, "form": PATH_FORMS[path],
            "launches": by_path[path][name], "max_abs_err": r[name][0], "ms": r[name][1],
            "plain_ms": r[name][2], "bound_ms": r[name][3], "bound_by": r[name][4],
            "library_ms": None} for path, r in wall_readings.items()]
    by_name[K2]["forms"] += k2_immersed
    # the new schemes' forms: each a hold of its own, no launches but on the
    # paths (the internal wave's C4 in K2's path forms above)
    by_name[K1]["forms"] += scheme_forms[K1] + hydro_forms[K1]
    by_name[K2]["forms"] += scheme_forms[K2] + hydro_forms[K2]
    by_name[K3A]["forms"] = scheme_forms[K3A] + hydro_forms[K3A]
    # K4b with each scheme (holds at 1°) and on the schemes slice's paths,
    # there with the path's launches
    by_name[K4B]["forms"] += hydro_forms[K4B] + k4b_path_forms
    # WENO5's bf16 options: the holds' forms and K1's on the two AB2 paths,
    # there with the path's launches
    by_name[K1]["forms"] += bf16_forms[K1] + bf16_readings
    for name in (K2, K3A, K4B):
        by_name[name]["forms"] += bf16_forms[name]
    # the Flat slice's forms: K4a, K4b and K5 on each Flat topology and
    # K4b's Cartesian Coriolis forms (holds), with the launches of the
    # paths that run each topology; K4b on the front slice's own fields
    def flat_launches(part, name):
        return sum(n[name] for path, n in by_path.items()
                   if any(path.startswith(p) for p in FLAT_FORM_PATHS.get(part, ())))

    for name in (K4A, K4B, K5):
        by_name[name].setdefault("forms", []).extend(
            dict(r, launches=flat_launches(r["part"], name))
            for r in flat_hold_forms[name])
    by_name[K4B]["forms"].append(front_reading)
    # K2's stretched-x/y form: its holds (no launches of their own)
    by_name[K2XY]["forms"] = k2xy_forms
    # K4a's and K4b's 3D-Δz forms: the 1° holds and the ¼° path's readings,
    # there with the path's launches
    for name in (K4A, K4B):
        by_name[name].setdefault("forms", []).extend(partial_forms[name]
                                                     + [partial_readings[name]])
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s on "
          f"{card_line()}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
