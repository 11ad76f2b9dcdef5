"""Boundary conditions and halo filling.

Counterpart of ``clima_oceananigans_jl_tpu/boundary_conditions/bcs.py``
(Oceananigans' ``fill_halo_regions!``). ``BC(kind, value)`` covers
Flux / Value / Gradient / Open / Periodic; ``value`` may be a scalar, a
boundary-plane array, or a callable of the boundary nodes and time, and a
flux BC with ``discrete=True`` takes ``value(grid, t, fields)``, a
full-shape flux array (a field-dependent flux such as a drag or an
evaporation rate).

``fill_halos`` writes the halo slabs of a tensor in place (and returns
it): periodic sides are wrap copies, bounded sides use the mirror
ghost-cell formulas of the JAX package, so a fill gives bitwise the same
halos. Flux BCs fill by zero-gradient mirror; their values enter the
tendency through ``apply_flux_bcs`` (positive flux on a left boundary
increases the adjacent cell's G, on a right boundary decreases it).

A ``FULLY_CONNECTED`` axis of a grid cut over a mesh of shards
(``grid.dist``) fills by the neighbour exchange of
``parallel/halo_exchange.py``; where the axis is not periodic globally,
the end shards then write the physical BC of the global grid, as the JAX
package's ``select_edge`` does. Its defaults follow the global topology.
A ``FULLY_CONNECTED`` axis without ``dist`` (a cubed-sphere face's) is
left to its own exchange.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..grids.topology import BOUNDED, FLAT, FULLY_CONNECTED, PERIODIC
from ..ops.operators import flip_loc
from ..utils.location import F


@dataclasses.dataclass
class BC:
    """One side's boundary condition. ``discrete=True`` marks a
    field-dependent flux: ``value(grid, t, fields)`` returns a full-shape
    flux array."""

    kind: str  # periodic | value | gradient | flux | open
    value: Any = None
    discrete: bool = False


def Periodic():
    return BC("periodic")


def ValueBC(v):
    return BC("value", v)


def GradientBC(g):
    return BC("gradient", g)


def FluxBC(q=None, discrete=False):
    return BC("flux", q, discrete)


def OpenBC(v=0.0):
    return BC("open", v)


@dataclasses.dataclass
class FieldBCs:
    """Per-side BCs for one field: (west, east, south, north, bottom, top)."""

    west: Optional[BC] = None
    east: Optional[BC] = None
    south: Optional[BC] = None
    north: Optional[BC] = None
    bottom: Optional[BC] = None
    top: Optional[BC] = None
    #: a flux through the immersed boundary (``apply_immersed_flux_bcs``)
    immersed: Optional[BC] = None

    def sides(self):
        return ((0, 0, self.west), (0, 1, self.east),
                (1, 0, self.south), (1, 1, self.north),
                (2, 0, self.bottom), (2, 1, self.top))


_SIDE_NAMES = (("west", "east"), ("south", "north"), ("bottom", "top"))


def default_bcs(grid, loc):
    """Periodic on periodic axes; zero flux for fields centred on a
    bounded axis; impenetrable (open, 0) for the wall-normal component."""
    sides = {}
    for axis in range(3):
        topo = grid.topology[axis]
        dist = grid.dist[axis] if hasattr(grid, "dist") else None
        if topo is FULLY_CONNECTED and dist is not None:
            topo = dist[2]  # the global topology, for the end shards
        for s in range(2):
            if topo is FLAT:
                bc = None
            elif topo is PERIODIC:
                bc = Periodic()
            elif loc[axis] == F:
                bc = OpenBC(0.0)
            else:
                bc = FluxBC()
            sides[_SIDE_NAMES[axis][s]] = bc
    return FieldBCs(**sides)


def regularize_bcs(grid, loc, bcs=None):
    """Merge user BCs over the defaults."""
    out = default_bcs(grid, loc)
    if bcs is None:
        return out
    for name in [n for pair in _SIDE_NAMES for n in pair] + ["immersed"]:
        user = getattr(bcs, name, None)
        if user is not None:
            setattr(out, name, user)
    return out


def _bvalue(bc, grid, axis, side, loc, t):
    """A BC's value on the boundary plane, as a broadcastable tensor."""
    v = bc.value
    if v is None:
        return torch.zeros((), dtype=grid.dtype, device=grid.device)
    if callable(v):
        nodes = list(grid.nodes(loc, with_halo=True))
        a = grid._axes[axis]
        # boundary position: left face (index h) or right face (index h+n)
        nodes[axis] = a.cf[a.h] if side == 0 else a.cf[a.h + a.n]
        coords = [nodes[i] for i in range(3) if i != axis]
        return torch.as_tensor(v(*coords, t), dtype=grid.dtype,
                               device=grid.device)
    v = torch.as_tensor(v, dtype=grid.dtype, device=grid.device)
    if v.ndim == 2:  # boundary-plane array on interior points → halo shape
        full = list(grid.total_shape)
        plane_axes = [i for i in range(3) if i != axis]
        out = torch.zeros([full[a] for a in plane_axes], dtype=grid.dtype,
                          device=grid.device)
        h0, h1 = (grid.halo[a] for a in plane_axes)
        out[h0:h0 + v.shape[0], h1:h1 + v.shape[1]] = v
        return out.unsqueeze(axis)
    return v


def _axslice(axis, idx):
    sl = [slice(None)] * 3
    sl[axis] = idx
    return tuple(sl)


def _mirror_slab(data, axis, interior_idx):
    """The layers ``interior_idx`` of ``data`` along ``axis``, in order
    (a copy, so later in-place writes do not alias it)."""
    idx = torch.as_tensor(interior_idx, dtype=torch.long, device=data.device)
    return torch.index_select(data, axis, idx)


def _bounded_slab(data, grid, loc, axis, side, bc, t=0.0):
    """(slab, cut) for one bounded side: ``slab`` replaces array indices
    [0:cut) (side 0) or [cut:end) (side 1); slab=None → nothing to write."""
    N = grid.shape[axis]
    H = grid.halo[axis]
    face_loc = loc[axis] == F
    if bc is None or bc.kind in ("periodic", "communication"):
        return None, (H if side == 0 else H + N + (1 if face_loc else 0))
    kind = bc.kind
    # flux BCs fill by zero-gradient mirror and never evaluate their value
    b = None if kind == "flux" else _bvalue(bc, grid, axis, side, loc, t)
    clampc = lambda i: min(max(i, H), H + N - 1)

    if not face_loc:
        if side == 0:
            ghosts = list(range(0, H))
            mirrors = [clampc(2 * H - 1 - g) for g in ghosts]
            cut = H
        else:
            ghosts = list(range(H + N, H + N + H))
            mirrors = [clampc(2 * (H + N) - 1 - g) for g in ghosts]
            cut = H + N
        slab = _mirror_slab(data, axis, mirrors)
        if kind == "value":
            slab = 2.0 * b - slab
        elif kind == "gradient":
            cc = grid._axes[axis].cc
            # ghost = mirror − b·(c_mirror − c_ghost)
            dist = torch.stack([cc[m] - cc[g] for g, m in zip(ghosts, mirrors)])
            shape = [1, 1, 1]
            shape[axis] = H
            slab = slab - b * dist.reshape(shape)
        # flux/default: zero-gradient mirror (slab as is)
        return slab, cut

    # face-located: boundary face at H (left) / H+N (right)
    bidx = H if side == 0 else H + N
    lo, hi = H, H + N
    ghosts = list(range(0, H)) if side == 0 else list(range(bidx + 1, bidx + H))
    mirrors = [min(max(2 * bidx - g, lo), hi) for g in ghosts]
    if kind in ("open", "value"):
        layer = list(data.shape)
        layer[axis] = 1
        bf = torch.broadcast_to(b, layer)
        parts = [bf]
        if ghosts:
            ghost = 2.0 * b - _mirror_slab(data, axis, mirrors)
            gshape = list(data.shape)
            gshape[axis] = len(ghosts)
            ghost = torch.broadcast_to(ghost, gshape)
            parts = [ghost, bf] if side == 0 else [bf, ghost]
        slab = torch.cat(parts, axis)
        return slab, (H + 1 if side == 0 else H + N)
    # flux/default: zero-gradient mirror about the (untouched) boundary face
    cut = H if side == 0 else H + N + 1
    if not ghosts:
        return None, cut
    return _mirror_slab(data, axis, mirrors), cut


def fill_halos_axis(data, grid, loc, axis, bc_left, bc_right, t=0.0):
    """Fill the halos of one axis of ``data`` in place; returns ``data``."""
    topo = grid.topology[axis]
    if topo is FLAT:
        return data
    N = grid.shape[axis]
    H = grid.halo[axis]
    if topo is PERIODIC:
        data[_axslice(axis, slice(0, H))] = data[_axslice(axis, slice(N, N + H))]
        data[_axslice(axis, slice(N + H, N + 2 * H))] = \
            data[_axslice(axis, slice(H, 2 * H))]
        return data
    if topo is FULLY_CONNECTED:
        dist = grid.dist[axis] if hasattr(grid, "dist") else None
        if dist is not None:
            from ..parallel.halo_exchange import exchange_axis
            mesh_axis, n_shards, global_topo = dist
            exchange_axis([data], axis, H, mesh_axis, n_shards,
                          global_topo is PERIODIC)
            fill_cut_edges(data, grid, loc, axis, bc_left, bc_right, t)
        return data
    if topo is not BOUNDED:
        raise NotImplementedError(f"{topo!r} axes are not ported yet")
    # both slabs are computed from the pre-update data, then written
    left, cut0 = _bounded_slab(data, grid, loc, axis, 0, bc_left, t)
    right, cut1 = _bounded_slab(data, grid, loc, axis, 1, bc_right, t)
    if left is not None:
        data[_axslice(axis, slice(0, cut0))] = left
    if right is not None:
        data[_axslice(axis, slice(cut1, data.shape[axis]))] = right
    return data


def fill_cut_edges(data, grid, loc, axis, bc_left, bc_right, t=0.0):
    """After the exchange of a cut axis that is not periodic globally: the
    physical BC's side fill on the end shards (the first shard's left,
    then the last shard's right side, the second read after the first is
    written, as in the JAX package), in place."""
    from ..parallel.halo_exchange import is_edge
    mesh_axis, n_shards, global_topo = grid.dist[axis]
    if global_topo is PERIODIC:
        return data
    for side, bc in ((0, bc_left), (1, bc_right)):
        if not is_edge(mesh_axis, n_shards, side):
            continue
        slab, cut = _bounded_slab(data, grid, loc, axis, side, bc, t)
        if slab is not None:
            data[_axslice(axis, slice(0, cut) if side == 0
                          else slice(cut, data.shape[axis]))] = slab
    return data


def impose_cut_wall_faces(data, grid, loc, bcs=None, t=0.0):
    """The exchange-free part of a cut axis' fill that shows in the
    interior: on the end shards of a cut axis that is bounded globally,
    the open or value wall face of a field located on that axis' faces
    (side 0's face is interior index H). The halo-overlap step's deferred
    ``update_state`` writes just this, in place."""
    from ..parallel.halo_exchange import is_edge
    if bcs is None:
        bcs = default_bcs(grid, loc)
    pairs = ((bcs.west, bcs.east), (bcs.south, bcs.north), (bcs.bottom, bcs.top))
    for axis in (0, 1, 2):
        dist = grid.dist[axis]
        if (grid.topology[axis] is not FULLY_CONNECTED or loc[axis] != F
                or dist is None or dist[2] is PERIODIC):
            continue
        mesh_axis, n_shards, _ = dist
        N, H = grid.shape[axis], grid.halo[axis]
        for side, bc in ((0, pairs[axis][0]), (1, pairs[axis][1])):
            if bc is None or bc.kind not in ("open", "value"):
                continue
            if not is_edge(mesh_axis, n_shards, side):
                continue
            k = H if side == 0 else H + N
            face = data[_axslice(axis, slice(k, k + 1))]
            face.copy_(torch.broadcast_to(
                _bvalue(bc, grid, axis, side, loc, t).to(data.dtype), face.shape))
    return data


def fill_halos(data, grid, loc, bcs=None, t=0.0, axes=(0, 1, 2)):
    """Fill the halo regions of ``data`` in place (and return it).
    Periodic axes first, so corner halos end up consistent."""
    if bcs is None:
        bcs = default_bcs(grid, loc)
    order = sorted(axes, key=lambda a: grid.topology[a] is not PERIODIC)
    pairs = ((bcs.west, bcs.east), (bcs.south, bcs.north),
             (bcs.bottom, bcs.top))
    for axis in order:
        fill_halos_axis(data, grid, loc, axis, *pairs[axis], t=t)
    return data


def _boundary_metrics(grid, loc, axis, side):
    """(A, V): the boundary face's area and the boundary cell's volume of
    one side, as slices of ``grid.Ax/Ay/Az`` and ``grid.V`` (the same
    values); computed once per grid."""
    key = ("flux_bc_metrics", tuple(loc), axis, side)
    if key not in grid._cache:
        N, H = grid.shape[axis], grid.halo[axis]
        i = H if side == 0 else H + N - 1
        A = (grid.Ax, grid.Ay, grid.Az)[axis](flip_loc(loc, axis))
        Vol = grid.V(loc)
        bf = H if side == 0 else H + N
        grid._cache[key] = (A[_axslice(axis, min(bf, A.shape[axis] - 1))],
                            Vol[_axslice(axis, i if Vol.shape[axis] > 1 else 0)])
    return grid._cache[key]


def apply_flux_bcs(G, grid, loc, bcs, t=0.0, fields=None):
    """Add boundary-flux divergences into the tendency G: on each bounded
    side with a flux value q, ±q·A/V at the boundary cell (A the boundary
    face's area, V the cell's volume). q is a scalar, a boundary-plane
    array, a callable of the boundary nodes and t, or with ``discrete`` a
    callable of (grid, t, fields) returning a full-shape array whose
    boundary cell is taken. Returns a new tensor."""
    if bcs is None:
        return G
    out = G
    for axis, side, bc in bcs.sides():
        if bc is None or bc.kind != "flux" or bc.value is None:
            continue
        if grid.topology[axis] is not BOUNDED:
            continue
        N, H = grid.shape[axis], grid.halo[axis]
        i = H if side == 0 else H + N - 1
        if bc.discrete and callable(bc.value):
            qf = torch.as_tensor(bc.value(grid, t, fields or {}),
                                 dtype=G.dtype, device=G.device)
            q = qf[_axslice(axis, i)]
        else:
            q = _bvalue(bc, grid, axis, side, loc, t)
        Ab, Vb = _boundary_metrics(grid, loc, axis, side)
        if q.ndim == 3:
            q = q[_axslice(axis, 0)]
        contrib = q * Ab / Vb
        sgn = 1.0 if side == 0 else -1.0
        if out is G:
            out = G.clone()
        out[_axslice(axis, i)] += sgn * contrib
    return out


def apply_immersed_flux_bcs(G, grid, loc, bcs, t=0.0, fields=None):
    """Add the flux of ``bcs.immersed`` through the immersed bottom into
    the tendency: at every fluid cell whose neighbour below is solid,
    G + q·Az/V (the sign of a bottom FluxBC: a positive flux adds to the
    field). q is a constant, a callable ``q(x, y, z, t)`` of the nodes at
    ``loc``, or with ``discrete`` a callable of (grid, t, fields) giving
    a full-shape array (a bottom drag). Returns G itself when there is no
    such flux or no immersed boundary."""
    bc = getattr(bcs, "immersed", None)
    imm = getattr(grid, "immersed", None)
    if bc is None or imm is None:
        return G
    if bc.kind != "flux":
        raise ValueError("an immersed boundary condition must be a flux")
    solid = imm.mask_for(loc)
    at_bottom = ~solid & torch.roll(solid, 1, 2)
    if bc.discrete and callable(bc.value):
        q = bc.value(grid, t, fields or {})
    elif callable(bc.value):
        x, y, z = grid.nodes(loc, with_halo=True)
        q = bc.value(x, y, z, t)
    else:
        q = bc.value
    q = torch.as_tensor(q, dtype=G.dtype, device=G.device)
    contrib = q * grid.Az(loc) / grid.V(loc)
    return torch.where(at_bottom, G + contrib, G)
