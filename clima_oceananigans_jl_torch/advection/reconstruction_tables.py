"""Stretched-axis WENO5 reconstruction tables.

Counterpart of ``clima_oceananigans_jl_tpu/advection/reconstruction_tables.py``
(Oceananigans' stretched coefficient tuples, weno_fifth_order.jl:21-60).
On a non-uniform axis the stencil coefficients and the optimal weights
come from the node positions by closed-form Lagrange algebra: the point
value at X of the reconstruction from cell averages v̄_j over
[y_j, y_{j+1}] is Σ_j c_j v̄_j with c_j = (y_{j+1} − y_j) Σ_{m>j} L'_m(X).
The smoothness indicators keep the uniform Jiang–Shu formulas.

The arithmetic is the JAX module's, term by term, on the grid's own
coordinate tensors, so the tables hold the same values in the grid's
type. A grid computes each axis' tables once and keeps them
(``weno5_tables``); the hydrostatic kernel reads them as metric rows
(``ops/metric_rows.py``).
"""
from __future__ import annotations

import torch

from ..grids.topology import FLAT


def _recon_coeffs(X, nodes):
    """Coefficients c_j of the cell averages for the point value at X.
    ``nodes``: k+1 tensors of stencil node positions; cell j spans
    [nodes[j], nodes[j+1]]."""
    k = len(nodes) - 1
    dL = []
    for m in range(k + 1):
        num = 0.0
        for l in range(k + 1):
            if l == m:
                continue
            prod = 1.0
            for q in range(k + 1):
                if q == m or q == l:
                    continue
                prod = prod * (X - nodes[q])
            num = num + prod
        den = 1.0
        for l in range(k + 1):
            if l != m:
                den = den * (nodes[m] - nodes[l])
        dL.append(num / den)
    sufs = [0.0] * (k + 2)
    for m in range(k, -1, -1):
        sufs[m] = sufs[m + 1] + dL[m]
    return [(nodes[j + 1] - nodes[j]) * sufs[j + 1] for j in range(k)]


def _build_tables(P, to_f):
    """WENO5 tables from the 1D node positions ``P`` (face coordinates for
    a cell→face reconstruction, ``to_f``; centre coordinates for the dual
    face→centre one). Returns {"left": [...], "right": [...]}; each side
    lists per stencil r ``(d_r, [c_r0, c_r1, c_r2], [o0, o1, o2], kind)``:
    the optimal-weight row, the three coefficient rows, the value offsets
    (result[i] uses data[i+o]) and the smoothness formula's kind (0:
    w0−4w1+3w2, 1: w0−w2, 2: 3w0−4w1+w2). Entries whose stencil crosses
    the array ends wrap and are never read by an interior flux."""
    roll = lambda o: torch.roll(P, -o, 0) if o else P
    vshift = 0 if to_f else 1
    out = {}
    for side in ("left", "right"):
        per_r = []
        for r in range(3):
            if side == "left":
                noff = [-3 + r, -2 + r, -1 + r, r]
                kind = r
            else:
                noff = [-r, 1 - r, 2 - r, 3 - r]
                kind = 2 - r
            cj = _recon_coeffs(P, [roll(o) for o in noff])
            voff = [o + vshift for o in noff[:3]]
            per_r.append((cj, voff, kind))
        noff5 = [-3, -2, -1, 0, 1, 2] if side == "left" else [-2, -1, 0, 1, 2, 3]
        q = _recon_coeffs(P, [roll(o) for o in noff5])
        if side == "left":
            d0 = q[0] / per_r[0][0][0]
            d2 = q[4] / per_r[2][0][2]
        else:
            d0 = q[4] / per_r[0][0][2]
            d2 = q[0] / per_r[2][0][0]
        d1 = 1.0 - d0 - d2
        out[side] = [(d,) + per_r[r] for r, d in enumerate((d0, d1, d2))]
    return out


def weno5_tables(grid, axis, to_f):
    """The WENO5 tables of ``grid``'s ``axis``, computed at the first call
    and kept on the grid; None on a regular or flat axis, and on a grid
    without 1D coordinate axes (the cubed sphere's face grids), as in the
    JAX package."""
    axes = getattr(grid, "_axes", None)
    if axes is None:
        return None
    a = axes[axis]
    if a.topo is FLAT or a.regular:
        return None
    key = (axis, bool(to_f))
    if key not in grid._cache:
        grid._cache[key] = _build_tables(a.cf if to_f else a.cc, to_f)
    return grid._cache[key]
