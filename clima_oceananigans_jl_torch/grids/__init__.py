"""Grids: rectilinear, latitude-longitude and the conformal cubed sphere."""
from .cubed_sphere import CubedSphereGrid
from .latlon import LatitudeLongitudeGrid
from .rectilinear import RectilinearGrid
