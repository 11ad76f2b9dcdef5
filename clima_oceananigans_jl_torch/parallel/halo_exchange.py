"""Halo exchange along a cut axis of a mesh of shards.

Counterpart of ``clima_oceananigans_jl_tpu/parallel/halo_exchange.py``
(Oceananigans' tagged MPI sends and receives): the left halo [0, H) of a
shard takes its left neighbour's last H interior layers, its right halo
[N+H, N+2H) its right neighbour's first H, in one collective for every
array given (``ppermute`` of each slab in JAX). On an axis that is not
periodic globally, the outer halos of the end shards get zeros, as the
JAX ``ppermute`` leaves them; the caller then writes the physical
boundary condition there (``select_edge`` in JAX, ``is_edge`` here).
"""
from __future__ import annotations

from .mesh import axis_index, current


def _slab(data, axis, lo, hi):
    sl = [slice(None)] * data.ndim
    sl[axis] = slice(lo, hi)
    return data[tuple(sl)]


def exchange_axis(arrays, axis, H, mesh_axis, n_shards, periodic):
    """Fill array axis ``axis`` of each tensor of ``arrays`` (in place)
    from the neighbours along ``mesh_axis``; returns the list. With one
    shard along the mesh axis a periodic axis wraps locally."""
    arrays = list(arrays)
    if n_shards == 1:
        if periodic:
            for d in arrays:
                N = d.shape[axis] - 2 * H
                _slab(d, axis, 0, H).copy_(_slab(d, axis, N, N + H))
                _slab(d, axis, N + H, N + 2 * H).copy_(_slab(d, axis, H, 2 * H))
        return arrays
    mesh, rank = current()
    members = mesh.group(rank, mesh_axis)
    k = members.index(rank)
    left = members[k - 1] if (k > 0 or periodic) else None
    right = members[(k + 1) % n_shards] if (k < n_shards - 1 or periodic) else None
    # my last and first H interior layers, as views: the neighbours copy
    # from them in the collective's round of takes, before any shard runs on
    posted = [(_slab(d, axis, d.shape[axis] - 2 * H, d.shape[axis] - H),
               _slab(d, axis, H, 2 * H)) for d in arrays]

    def take(all_posted):
        for n, d in enumerate(arrays):
            N = d.shape[axis] - 2 * H
            lo, hi = _slab(d, axis, 0, H), _slab(d, axis, N + H, N + 2 * H)
            if left is None:
                lo.zero_()
            else:
                lo.copy_(all_posted[left][n][0])
            if right is None:
                hi.zero_()
            else:
                hi.copy_(all_posted[right][n][1])
        return arrays

    nbytes = sum(2 * t.numel() * t.element_size() for t, _ in posted)
    return mesh.collective(rank, posted, take, "exchange", nbytes, 2 * len(arrays))


def is_edge(mesh_axis, n_shards, side):
    """Whether this shard is the first (side 0) or last (side 1) along
    ``mesh_axis``: where ``select_edge`` of the JAX package takes the
    physical fill."""
    idx = axis_index(mesh_axis)
    return idx == 0 if side == 0 else idx == n_shards - 1
