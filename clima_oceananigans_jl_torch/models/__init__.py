"""Models: nonhydrostatic, shallow-water, hydrostatic free-surface (on
rectilinear, lat-lon and cubed-sphere grids), prescribed velocities and
ensembles."""
from .cubed_sphere_hydrostatic import CubedSphereHydrostaticModel
from .ensemble import ensemble_initial_state, ensemble_step, member, stack_states
from .prescribed import PrescribedVelocityFields, PrescribedVelocityModel
