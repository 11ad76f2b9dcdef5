"""Immersed boundaries: solid masks on any grid.

Counterpart of ``clima_oceananigans_jl_tpu/immersed/immersed.py``
(Oceananigans' ImmersedBoundaries: grid-fitted boundaries, the
peripheral-node rule, ``mask_immersed_field!``). The solid geometry is a
set of boolean masks, one per staggered location, on the grid's device;
masking is a ``torch.where`` on fields and tendencies after each update.
A velocity face is solid when either cell centre beside it is solid, so
advective and diffusive transport through the boundary vanishes.

``ImmersedGrid`` wraps the model's grid (after its halos are set) and
forwards every attribute it lacks to it, but keeps a ``_cache`` of its
own: the column depths, K5's depth planes and every other entry cached
per grid are built again for the immersed grid, so none of the parent's
flat-bottom values leaks into the immersed model. ``PartialCellBottom``
builds a ``PartialCellBoundary``: the masks and two 3D with-halo Δz
arrays (at z-centres and z-faces), which ``ImmersedGrid`` returns from
``spacing``/``dz``/``Ax``/``Ay``/``V`` in place of the parent's z row, as
the JAX ``ImmersedGrid`` does. The hydrostatic model takes it; the
nonhydrostatic model refuses it by name (ROADMAP Queue 1 item 7).

``clear_flags`` turns the conditional fluxes into the kernels' input: one
uint8 tensor a location, cached on the immersed grid, which K2
(``ops/fused_tendencies.py``) and K4b (``ops/fused_hydrostatic.py``)
read.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..advection.schemes import _immersed_clear
from ..utils.location import C, CENTER, F, U_LOC, V_LOC, W_LOC

#: the flux direction of each axis' transports of a field at a location
#: (to faces True, to centres False), as ``advection/fluxes.py`` has them
_FLUX_TO_F = {CENTER: (True, True, True), U_LOC: (False, True, True),
              V_LOC: (True, False, True), W_LOC: (True, True, False)}


def clear_flags(grid, loc, buffer):
    """The kernels' conditional-flux input for the field at ``loc`` on an
    immersed grid: a with-halo uint8 tensor whose bit a (a grid axis) is
    set where the transport along axis a at that flux location reads no
    solid cell (``_immersed_clear`` of the plain version, its rolls
    wrapping at the array edges and reading the cell itself along a Flat
    axis, as they do there); built once per grid and kept in its
    ``_cache`` (the bottom is static)."""
    key = ("clear_flags", tuple(loc), buffer)
    if key not in grid._cache:
        imm = grid.immersed
        flags = torch.zeros(grid.total_shape, dtype=torch.uint8, device=grid.device)
        for axis, to_f in enumerate(_FLUX_TO_F[tuple(loc)]):
            clear = _immersed_clear(imm, loc, axis, to_f, buffer)
            flags |= clear.to(torch.uint8) << axis
        grid._cache[key] = flags.contiguous()
    return grid._cache[key]


def _face_mask(solid_c, axis):
    """A face is solid if either centre beside it is; with-halo roll."""
    return solid_c | torch.roll(solid_c, 1, axis)


@dataclasses.dataclass
class ImmersedBoundary:
    """Solid masks (``torch.bool``, True = solid) at the four canonical
    locations."""

    solid_ccc: torch.Tensor
    solid_fcc: torch.Tensor
    solid_cfc: torch.Tensor
    solid_ccf: torch.Tensor

    @classmethod
    def _from_solid(cls, solid):
        return cls(solid, _face_mask(solid, 0), _face_mask(solid, 1),
                   _face_mask(solid, 2))

    @classmethod
    def from_mask(cls, grid, mask_fn):
        """Solid where ``mask_fn(x, y, z)`` (Oceananigans'
        GridFittedBoundary)."""
        x, y, z = grid.nodes(CENTER, with_halo=True)
        solid = torch.as_tensor(mask_fn(x, y, z), device=grid.device)
        return cls._from_solid(torch.broadcast_to(
            solid.to(torch.bool), grid.total_shape).contiguous())

    @classmethod
    def from_bottom_height(cls, grid, bottom):
        """Solid where z < h(x, y) (Oceananigans' GridFittedBottom); h a
        callable of the horizontal nodes, a constant or an array."""
        x, y, z = grid.nodes(CENTER, with_halo=True)
        h = bottom(x, y) if callable(bottom) else bottom
        if not isinstance(h, torch.Tensor):
            h = torch.as_tensor(h, dtype=grid.dtype, device=grid.device)
        return cls._from_solid(torch.broadcast_to(z < h, grid.total_shape)
                               .contiguous())

    def mask_for(self, loc):
        """The solid mask at any location triple: a node is solid when any
        cell centre beside it is (the peripheral-node rule, corner
        locations such as (F, F, C) included)."""
        loc = tuple(loc)
        if loc == U_LOC:
            return self.solid_fcc
        if loc == V_LOC:
            return self.solid_cfc
        if loc == W_LOC:
            return self.solid_ccf
        if loc == CENTER:
            return self.solid_ccc
        m = self.solid_ccc
        for a in range(3):
            if loc[a] == F:
                m = m | torch.roll(m, 1, a)
        return m

    def mask_field(self, data, loc, value=0.0):
        """The field with ``value`` in the solid (``mask_immersed_field!``)."""
        return torch.where(self.mask_for(loc),
                           torch.full((), value, dtype=data.dtype,
                                      device=data.device), data)

    def mask_state(self, model, state):
        locs = model._locs()
        sol = {name: self.mask_field(arr, locs[name])
               for name, arr in state["solution"].items()}
        return dict(state, solution=sol)

    def mask_tendency(self, model, name, G):
        return self.mask_field(G, model._locs().get(name, CENTER))


class ImmersedGrid:
    """The model's grid with an immersed boundary (Oceananigans'
    ImmersedBoundaryGrid): ``.immersed`` gives the masks, which
    ``advection/schemes.py::transport`` (the conditional fluxes), the
    diffusive fluxes, the column depths and the model's masking read;
    every other attribute is the parent's, but ``_cache`` is its own.

    With partial cells (``dz_ccc``/``dz_ccf``, 3D with-halo tensors) the
    vertical metrics are overridden: ``dz`` at any location is ``dz_ccc``
    where its z location is a centre and ``dz_ccf`` where it is a face, and
    ``Ax``, ``Ay`` and ``V`` multiply the parent's horizontal metric by it.
    Each is defined here, not forwarded: the parent's own ``Ax`` would read
    the parent's z row."""

    def __init__(self, parent, boundary, dz_ccc=None, dz_ccf=None):
        self.parent = parent
        self.boundary = boundary
        self._dz_ccc = dz_ccc
        self._dz_ccf = dz_ccf
        self._cache = {}

    @classmethod
    def wrap(cls, parent, boundary):
        """``parent`` with ``boundary``, whose ``dz_ccc``/``dz_ccf`` (a
        ``PartialCellBoundary``'s) become the grid's vertical metrics."""
        return cls(parent, boundary, getattr(boundary, "dz_ccc", None),
                   getattr(boundary, "dz_ccf", None))

    @property
    def partial_cells(self):
        """Whether the vertical metrics are 3D (partial bottom cells)."""
        return self._dz_ccc is not None

    @property
    def immersed(self):
        return self.boundary

    def __getattr__(self, name):
        if name.startswith("__") or "parent" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.parent, name)

    def __repr__(self):
        return f"ImmersedGrid({self.parent!r})"

    def subgrid_along(self, axis, start, n_new):
        """The parent's strip (``RectilinearGrid.subgrid_along``) with the
        boundary's masks and partial-cell Δz sliced by the same with-halo
        window, so an edge strip sees the shard's own masks."""
        parent_sub = self.parent.subgrid_along(axis, start, n_new)
        sl = [slice(None)] * 3
        sl[axis] = slice(start, start + n_new + 2 * self.parent.halo[axis])
        sl = tuple(sl)
        cut = {f.name: (v[sl] if isinstance(v, torch.Tensor) and v.ndim == 3
                        and v.shape[axis] > 1 else v)
               for f in dataclasses.fields(self.boundary)
               for v in (getattr(self.boundary, f.name),)}
        boundary = dataclasses.replace(self.boundary, **cut)
        return ImmersedGrid.wrap(parent_sub, boundary)

    # -- partial-cell vertical metrics --------------------------------------
    def spacing(self, axis, loc):
        if axis == 2 and self._dz_ccc is not None:
            return self._dz_ccc if loc[2] == C else self._dz_ccf
        return self.parent.spacing(axis, loc)

    def dz(self, loc):
        return self.spacing(2, loc)

    def Ax(self, loc):
        return self.parent.dy(loc) * self.dz(loc)

    def Ay(self, loc):
        return self.parent.dx(loc) * self.dz(loc)

    def V(self, loc):
        return self.parent.Az(loc) * self.dz(loc)


@dataclasses.dataclass(frozen=True)
class GridFittedBoundary:
    """Solid where ``mask(x, y, z)``; built by the model on its final grid
    through ``build``."""

    mask: Any

    def build(self, grid):
        return ImmersedBoundary.from_mask(grid, self.mask)


@dataclasses.dataclass(frozen=True)
class GridFittedBottom:
    """Solid where z < ``bottom_height(x, y)`` (or a constant or array)."""

    bottom_height: Any

    def build(self, grid):
        return ImmersedBoundary.from_bottom_height(grid, self.bottom_height)


@dataclasses.dataclass
class PartialCellBoundary(ImmersedBoundary):
    """A bottom with fractional (partial) bottom cells (Oceananigans'
    partial_cell_immersed_boundaries.jl): the lowest fluid cell of each
    column is shortened to the water depth above the bottom, at least
    ``minimum_fraction`` of the full cell. ``dz_ccc`` and ``dz_ccf`` are
    the 3D with-halo Δz at z-centres and z-faces that ``ImmersedGrid``
    returns as its vertical metrics."""

    dz_ccc: torch.Tensor = None
    dz_ccf: torch.Tensor = None

    @classmethod
    def from_bottom(cls, grid, bottom, minimum_fraction=0.2):
        """The JAX ``PartialCellBoundary.from_bottom``, in its order: h (a
        callable of the horizontal nodes, a constant or an array) and the
        cells from the z axis' rows in the grid's dtype; a cell is solid
        where its top face is at or below h, and the cell h cuts keeps
        max(z_top − h, minimum_fraction Δz); the face spacing is the
        distance between the effective cell centres, its first entry the
        axis' own."""
        x, y, _ = grid.nodes(CENTER, with_halo=True)
        h = bottom(x, y) if callable(bottom) else bottom
        h = torch.as_tensor(h, dtype=grid.dtype, device=grid.device)
        ax = grid._axes[2]
        z_bot = ax.cf.reshape(1, 1, -1)
        dz = ax.dc.reshape(1, 1, -1)
        z_top = z_bot + dz
        solid = torch.broadcast_to(z_top <= h, grid.total_shape).contiguous()
        partial = (z_bot < h) & (z_top > h)
        dz_eff = torch.where(partial, torch.maximum(z_top - h, minimum_fraction * dz), dz)
        dz_ccc = torch.broadcast_to(dz_eff, grid.total_shape).to(grid.dtype).contiguous()
        zc_eff = z_top - 0.5 * dz_eff
        dz_f = zc_eff - torch.roll(zc_eff, 1, 2)
        dz_f[:, :, :1] = torch.broadcast_to(ax.df.reshape(1, 1, -1), dz_f.shape)[:, :, :1]
        dz_ccf = torch.broadcast_to(dz_f, grid.total_shape).to(grid.dtype).contiguous()
        return cls(solid, _face_mask(solid, 0), _face_mask(solid, 1),
                   _face_mask(solid, 2), dz_ccc, dz_ccf)


@dataclasses.dataclass(frozen=True)
class PartialCellBottom:
    """GridFittedBottom with fractional bottom cells (Oceananigans'
    PartialCellBottom): solid where a cell's top face is at or below
    ``bottom_height(x, y)`` (or a constant or array), the cut cell kept
    at ``minimum_fraction`` of its height or more. The hydrostatic model
    takes it; the nonhydrostatic model refuses it (ROADMAP Queue 1 item 7)."""

    bottom_height: Any
    minimum_fraction: float = 0.2

    def build(self, grid):
        return PartialCellBoundary.from_bottom(grid, self.bottom_height,
                                               self.minimum_fraction)
