"""Metric rows: the grid metrics the hydrostatic kernels read, as 1D rows.

The port's counterpart of ``clima_oceananigans_jl_tpu/ops/kernel_grid.py``
(the TPU kernels' stacked metric pack), much smaller: on a grid whose x
axis is regular every metric is constant along x (a lat-lon grid's
Δx = R cos φ Δλ varies with latitude only), so each one is a row over the
with-halo y axis or the with-halo z axis. Every row is sliced at x = Hx
from the very tensor the plain version multiplies by, so a kernel that
forms its products from the rows in the plain version's order rounds as
the plain version does. The rows are built once per grid and options
and kept in the grid's cache.

- ``y_rows``: Δx[(lx, ly)] for the four (lx, ly), Az[(lx, ly)] likewise,
  Δy[C], Δy[F], and four Coriolis rows: f at U_LOC and V_LOC for an f- or
  β-plane, f at (F, F) for the spherical Coriolis in the slot of the
  first, fz at U_LOC and V_LOC for the two Cartesian forms, whose
  horizontal components fill the last two (fy at U_LOC, and fx at V_LOC
  for ``ConstantCartesianCoriolis``); zeros where a form has no row.
  ``Y_ROWS`` gives their order.
- ``z_rows``: Δz[C], Δz[F], then on a stretched z axis the 24 rows of
  WENO5's to-faces tables (``advection/reconstruction_tables.py``): for
  the left then the right side, for each stencil r, its optimal weight and
  its three coefficients; with ``to_centres``, the 24 rows of the
  to-centres tables after them, in the same order (the nonhydrostatic
  kernels K1 and K2 reconstruct w at centres for its own z flux).
- ``axis_rows``: any axis' rows as ``z_rows`` lays out z's (Δᶜ and Δᶠ per
  index, then, with ``tables``, its to-faces and to-centres WENO5 tables),
  which K2's stretched-x/y form reads for each of its three axes (a
  regular axis holds its one spacing in every entry, a Flat one its single
  1);
- ``y_tables``: a stretched y axis' WENO5 tables over with-halo y, laid
  out as ``z_rows`` lays out z's, without the spacing rows: the 24 rows of
  the to-faces tables, then the 24 of the to-centres tables (K4b's
  ``div_vv`` reconstructs v at centres for its own y flux).
- ``dz3_pack``: on partial bottom cells (``ImmersedGrid.partial_cells``)
  Δz is no row but two 3D with-halo tensors, Δz at z-centres and at
  z-faces, stacked in the fields' layout; ``z_rows`` refuses such a grid
  (its Δz rows would be column (0, 0)'s), and ``partial_cell_z_rows`` gives
  K4b the layout of ``z_rows`` with NaN in its two Δz rows (read from the
  pack instead) and the z axis' tables after them.
"""
from __future__ import annotations

import torch

from ..advection.reconstruction_tables import weno5_tables
from ..coriolis.coriolis import (BetaPlane, ConstantCartesianCoriolis, FPlane,
                                 HydrostaticSphericalCoriolis,
                                 NonTraditionalBetaPlane)
from ..utils.location import C, F, U_LOC, V_LOC

_LOC2 = ((C, C), (C, F), (F, C), (F, F))
#: the rows of ``y_rows``, in order
Y_ROWS = (tuple(f"dx_{lx.value}{ly.value}" for lx, ly in _LOC2)
          + tuple(f"az_{lx.value}{ly.value}" for lx, ly in _LOC2)
          + ("dy_c", "dy_f", "f_u", "f_v", "f2_u", "f2_v"))
#: the first rows of ``z_rows``; the table rows follow on a stretched z
Z_ROWS = ("dz_c", "dz_f")
#: rows of one set of WENO5 tables in ``z_rows`` (2 sides x 3 stencils x
#: the optimal weight and three coefficients)
TABLE_ROWS = 24


def y_row(grid, metric):
    """A metric tensor of shape (X|1, Y|1, ·) as a row over with-halo y,
    taken at x = Hx (or its only x entry) and its first z entry."""
    i = min(grid.Hx, metric.shape[0] - 1)
    row = metric[i, :, 0]
    return torch.broadcast_to(row, (grid.total_shape[1],)).contiguous()


def z_row(grid, metric):
    """A z-only metric tensor (1, 1, Z) as a row over with-halo z."""
    return metric.reshape(-1).contiguous()


def coriolis_rows(grid, coriolis):
    """The two Coriolis rows of ``y_rows``, each built by the plain
    version's own expression."""
    zeros = lambda: torch.zeros(grid.total_shape[1], dtype=grid.dtype,
                                device=grid.device)
    if coriolis is None:
        return zeros(), zeros()
    if isinstance(coriolis, HydrostaticSphericalCoriolis):
        return y_row(grid, coriolis.f_ff(grid)), zeros()
    if isinstance(coriolis, BetaPlane):
        return tuple(y_row(grid, coriolis._f(grid, loc)) for loc in (U_LOC, V_LOC))
    if isinstance(coriolis, FPlane):
        full = torch.full((grid.total_shape[1],), coriolis.f, dtype=grid.dtype,
                          device=grid.device)
        return full, full.clone()
    raise ValueError(f"no Coriolis rows for {type(coriolis).__name__}")


def cartesian_rows(grid, coriolis):
    """The four Coriolis rows of ``y_rows`` of a Cartesian form, each the
    plain version's own factor: fz at U_LOC and V_LOC, fy at U_LOC, and fx
    at V_LOC (zeros for the non-traditional β-plane, which has no fx)."""
    full = lambda v: torch.full((grid.total_shape[1],), v, dtype=grid.dtype,
                                device=grid.device)
    if isinstance(coriolis, ConstantCartesianCoriolis):
        return [full(coriolis.fz), full(coriolis.fz), full(coriolis.fy),
                full(coriolis.fx)]
    return [y_row(grid, coriolis._fz(grid, U_LOC)),
            y_row(grid, coriolis._fz(grid, V_LOC)),
            y_row(grid, coriolis._fy(grid, U_LOC)), full(0.0)]


def y_rows(grid, coriolis=None):
    """(len(Y_ROWS), Yt) tensor of the y rows."""
    key = ("y_rows", coriolis)
    if key not in grid._cache:
        rows = [y_row(grid, grid.dx((lx, ly, C))) for lx, ly in _LOC2]
        rows += [y_row(grid, grid.Az((lx, ly, C))) for lx, ly in _LOC2]
        rows += [y_row(grid, grid.dy((C, ly, C))) for ly in (C, F)]
        if isinstance(coriolis, (ConstantCartesianCoriolis,
                                 NonTraditionalBetaPlane)):
            rows += cartesian_rows(grid, coriolis)
        else:
            rows += list(coriolis_rows(grid, coriolis))
            rows += [torch.zeros_like(rows[-1]) for _ in range(2)]
        grid._cache[key] = torch.stack(rows).contiguous()
    return grid._cache[key]


def _table_rows(grid, axis, to_f):
    """The 24 rows of one set of ``axis``' WENO5 tables: for the left then
    the right side, for each stencil r, its optimal weight and three
    coefficients."""
    rows = []
    t = weno5_tables(grid, axis, to_f)
    for side in ("left", "right"):
        for d, cj, _voff, _kind in t[side]:
            rows += [d] + list(cj)
    return rows


def y_tables(grid):
    """(48, Yt) tensor of a stretched y axis' WENO5 tables: to faces, then
    to centres."""
    key = "y_tables"
    if key not in grid._cache:
        rows = _table_rows(grid, 1, True) + _table_rows(grid, 1, False)
        grid._cache[key] = torch.stack(rows).contiguous()
    return grid._cache[key]


def z_rows(grid, tables=False, to_centres=False):
    """(2, 26 or 50, Zt) tensor of the z rows; ``tables`` adds the
    stretched z axis' WENO5 to-faces tables (it must be stretched) and
    ``to_centres`` its to-centres tables after them. A grid with 3D Δz
    (partial cells) has no z rows: ``dz3_pack``."""
    if getattr(grid, "partial_cells", False):
        raise ValueError("z_rows: the grid's Δz is 3D (partial bottom cells); "
                         "the kernels read dz3_pack")
    key = ("z_rows", bool(tables), bool(tables and to_centres))
    if key not in grid._cache:
        rows = [z_row(grid, grid.dz((C, C, loc))) for loc in (C, F)]
        for to_f in ((True, False) if to_centres else (True,)) if tables else ():
            rows += _table_rows(grid, 2, to_f)
        grid._cache[key] = torch.stack(rows).contiguous()
    return grid._cache[key]


def axis_rows(grid, axis, tables=False):
    """(2 or 50, with-halo extent) tensor of ``axis``' rows: Δᶜ and Δᶠ, then
    with ``tables`` (a stretched axis) its WENO5 to-faces and to-centres
    tables; on z the rows of ``z_rows(grid, tables, tables)``."""
    key = ("axis_rows", axis, bool(tables))
    if key not in grid._cache:
        a = grid._axes[axis]
        rows = [a.dc, a.df]
        for to_f in (True, False) if tables else ():
            rows += _table_rows(grid, axis, to_f)
        grid._cache[key] = torch.stack(rows).contiguous()
    return grid._cache[key]


def dz3_pack(grid):
    """(2, X, Y, Z) tensor of a partial-cell grid's Δz at z-centres, then at
    z-faces (``grid.dz`` at (·, ·, C) and (·, ·, F)), with-halo."""
    key = "dz3_pack"
    if key not in grid._cache:
        grid._cache[key] = torch.stack([
            torch.broadcast_to(grid.dz((C, C, loc)), grid.total_shape)
            for loc in (C, F)]).contiguous()
    return grid._cache[key]


def partial_cell_z_rows(grid, tables=False):
    """``z_rows``' layout for a partial-cell grid: its two Δz rows NaN
    (K4b's 3D-Δz form reads ``dz3_pack``), then with ``tables`` the
    stretched z axis' WENO5 to-faces tables."""
    key = ("partial_cell_z_rows", bool(tables))
    if key not in grid._cache:
        nan = torch.full((grid.total_shape[2],), float("nan"), dtype=grid.dtype,
                         device=grid.device)
        rows = [nan, nan.clone()] + (_table_rows(grid, 2, True) if tables else [])
        grid._cache[key] = torch.stack(rows).contiguous()
    return grid._cache[key]
