"""PyTorch/CUDA port of ``clima_oceananigans_jl_tpu``.

The JAX package beside this one is the reference; this package keeps its
module paths, constructor API and ``state`` layout. So far it runs the
nonhydrostatic model on periodic, bounded and Flat axes (the JAX
package's eight advection schemes for momentum and tracers, grid-fitted immersed boundaries with their bottom fluxes, buoyancy tracer or
seawater buoyancy with a linear or nonlinear equation of state (TEOS-10,
Roquet's idealized one, polynomials), tilted gravity,
f/β-plane, constant Cartesian and non-traditional β-plane Coriolis,
scalar and biharmonic diffusivities with scalar, array or callable
coefficients, vertically implicit diffusion, the LES
closures (Smagorinsky-Lilly, AMD, 2D Leith), the vertical-mixing closures
(CATKE, convective adjustment, Ri-based), GM/Redi and closure tuples, Stokes
drift, forcing, background fields, flux BCs with scalar, plane, callable
and discrete values, every axis stretched or regular (the FFT, the
Fourier-tridiagonal or the multigrid pressure solve), the roll-based and the general projection) with its
quasi-AB2 and RK3 steps, the shallow-water model in its conservative and
vector-invariant forms, and the hydrostatic free-surface model on
rectilinear and lat-lon grids with stretched axes (vector-invariant or
flux-form momentum, each of the eight schemes as the flux form and for
the tracers, spherical Coriolis, forcing and flux BCs, closures
(CATKE, convective adjustment, Ri-based mixing and GM/Redi among them),
seawater buoyancy with any of those equations of state, tilted gravity,
grid-fitted immersed boundaries with their bottom fluxes, explicit,
split-explicit and implicit free surfaces, the implicit one by FFT,
matrix-free CG or CG on the assembled heptadiagonal couplings with a
Jacobi or multigrid preconditioner), Lagrangian particles in all three
models, the hydrostatic model on the conformal cubed sphere, prescribed
velocities and ensembles (members stepped one by one), the three models
decomposed over a mesh of shards (``DistributedModel``, ``make_mesh``,
``MultiRegionGrid``: one thread a shard, the halo exchange, the pencil
Poisson solves; the hydrostatic one on the CPU only), with hand-written CUDA
kernels for Hopper in ``csrc/``: the fused AB2 advance (K1), the fused
advective tendencies (K2), the shallow-water core (K3a), the general
projection's divergence and gradient (K3b, K3c), the hydrostatic w/pHY′
columns (K4a) and tendencies (K4b), the barotropic substeps (K5), the
halo fills (K6) and the batched tridiagonal solve (T1). Around the models
stand the JAX package's user surface: ``Simulation`` with its schedules,
callbacks, ``TimeStepWizard`` and NaN checker, the CFL diagnostics, fields
and abstract operations, the output writers, checkpoints and pickup, and
the readers. Importing it needs no GPU: a kernel is compiled at its
first launch on a CUDA tensor, and h5py is imported only by the writers
and readers that use it. Grids live on the card unless the caller passes
``device="cpu"``.
"""

from .grids.topology import BOUNDED, FLAT, FULLY_CONNECTED, PERIODIC, Topology
from .grids.rectilinear import RectilinearGrid
from .grids.latlon import LatitudeLongitudeGrid
from .grids.cubed_sphere import CubedSphereGrid, cubed_sphere_tracer_step
from .utils.location import C, CENTER, F, U_LOC, V_LOC, W_LOC
from .boundary_conditions.bcs import (
    BC, FieldBCs, FluxBC, GradientBC, OpenBC, Periodic, ValueBC,
    apply_flux_bcs, default_bcs, fill_halos, regularize_bcs,
)
from .fields.field import (
    CenterField, Field, FunctionField, TracerFields, VelocityFields, XFaceField,
    YFaceField, ZFaceField, average, field_norm, integral, interpolate,
    new_field, regrid, set_field, windowed,
)
from .fields.model_fields import BuoyancyField, PressureField
from .advection.schemes import (BoundsPreservingWENO5, CenteredFourthOrder,
                                CenteredSecondOrder, PositiveWENO5,
                                UpwindBiasedFifthOrder, UpwindBiasedFirstOrder,
                                UpwindBiasedThirdOrder, WENO5)
from .advection.vector_invariant import VectorInvariant
from .buoyancy.buoyancy import (BuoyancyTracer, LinearEquationOfState,
                                SeawaterBuoyancy)
from .buoyancy.nonlinear_eos import (PolynomialEquationOfState,
                                     RoquetIdealizedEquationOfState,
                                     TEOS10EquationOfState)
from .fields.background import BackgroundField
from .forcings.forcing import (AdvectiveForcing, Forcing, GaussianMask,
                               LinearTarget, Relaxation)
from .stokes_drift import UniformStokesDrift
from .coriolis.coriolis import (BetaPlane, ConstantCartesianCoriolis, FPlane,
                                HydrostaticSphericalCoriolis,
                                NonTraditionalBetaPlane)
from .closures.scalar_diffusivity import (HorizontalScalarDiffusivity,
                                          ScalarBiharmonicDiffusivity,
                                          ScalarDiffusivity,
                                          VerticalScalarDiffusivity)
from .closures.eddy_viscosity import (AnisotropicMinimumDissipation,
                                      SmagorinskyLilly, TwoDimensionalLeith)
from .closures.vertical_mixing import (CATKEVerticalDiffusivity,
                                       ConvectiveAdjustmentVerticalDiffusivity,
                                       MixingLength, RiBasedVerticalDiffusivity,
                                       SurfaceTKEFlux)
from .closures.isopycnal import FluxTapering, IsopycnalSkewSymmetricDiffusivity
from .timesteppers.steppers import Clock
from .models.nonhydrostatic import NonhydrostaticModel
from .models.shallow_water import ShallowWaterModel
from .models.free_surface import (ExplicitFreeSurface, ImplicitFreeSurface,
                                  SplitExplicitFreeSurface)
from .models.hydrostatic import HydrostaticFreeSurfaceModel
from .models.cubed_sphere_hydrostatic import CubedSphereHydrostaticModel
from .models.prescribed import PrescribedVelocityFields, PrescribedVelocityModel
from .models.ensemble import (ensemble_initial_state, ensemble_step, member,
                              stack_states)
from .immersed.immersed import (GridFittedBottom, GridFittedBoundary,
                                ImmersedBoundary, PartialCellBottom)
from .simulation.simulation import Callback, NaNChecker, Simulation, TimeStepWizard
from .utils.schedules import (
    AndSchedule, AveragedTimeInterval, IterationInterval, OrSchedule,
    SpecifiedTimes, TimeInterval, WallTimeInterval,
)
from .abstract_operations import (
    Average, GridMetric, Integral, KernelFunctionOperation,
    MultiaryOperation, at, compute, partial_x, partial_y, partial_z,
)
from .output.writers import HDF5OutputWriter, NetCDFOutputWriter, WindowedTimeAverage
from .output.checkpointer import Checkpointer
from .output.readers import FieldDataset, FieldTimeSeries
from .diagnostics.diagnostics import AdvectiveCFL, CFL, DiffusiveCFL, StateChecker
from .solvers.stencil_matrix import (HeptadiagonalIterativeSolver, MultigridPoissonSolver,
                                     MultigridSolver, StencilMatrix)
from .particles.lagrangian import LagrangianParticles
from .parallel.distributed import DistributedModel, make_mesh
from .parallel.multi_region import MultiRegionGrid, XPartition, YPartition
