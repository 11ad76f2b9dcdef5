"""Cubed-sphere grids: 6 conformal (or gnomonic) faces batched on a
leading axis.

Counterpart of ``clima_oceananigans_jl_tpu/grids/cubed_sphere.py``
(Oceananigans' ConformalCubedSphereGrid and its halo filling): the faces
live on a leading batch axis, (6, Nx, Ny, Nz); per-face stencils run as
one ``torch.func.vmap`` over stacked face-grid metrics, and the
inter-face halo exchange is one gather through precomputed index maps.

Geometry: the exact **conformal** (Rančić et al. 1996) map
(``grids/conformal_map.py``) by default, or ``map_kind="gnomonic"``. Edge
nodes of adjacent faces coincide, so the exchange is exact where nodes
match: per-location (centres, x-faces, y-faces) maps copy the
neighbour's value (with the ±u↔v swap at rotated junctions), and only
the corner wedges interpolate bilinearly. Metrics (great-circle edge
lengths, spherical cell areas by L'Huilier's formula) come from the exact
node positions.

The geometry is computed on the host in numpy float64 with the JAX
package's arithmetic, then moved to ``device`` in ``dtype``, so that
metrics, halo maps and node positions are bitwise the JAX grid's. The map
is evaluated once per distinct chart point (every face shares the
square's lattice, and each face's frame only rotates it), in chunks on
the host's cores; a geometry of one (N, halo, map) is kept for the next
grid of the same size.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import os

import numpy as np
import torch

from ..utils.location import C, F
from .conformal_map import _basis_integrals, conformal_coefficients
from .rectilinear import _Axis, _build_axis
from .topology import BOUNDED, FLAT, FULLY_CONNECTED

# face frames: (centre, e1 (ξ/x direction), e2 (η/y direction)); every
# cube edge is the NEGATIVE (x=-1 or y=-1) side of exactly one face, and
# every frame is right-handed (e1 × e2 = outward normal), as in the JAX
# package
_FACES = [
    ((+1, 0, 0), (0, +1, 0), (0, 0, +1)),
    ((0, +1, 0), (-1, 0, 0), (0, 0, +1)),
    ((-1, 0, 0), (0, 0, -1), (0, -1, 0)),
    ((0, -1, 0), (0, 0, -1), (+1, 0, 0)),
    ((0, 0, +1), (-1, 0, 0), (0, -1, 0)),   # north cap
    ((0, 0, -1), (0, +1, 0), (+1, 0, 0)),   # south cap
]

# square corners / side endpoints in chart coordinates (complex x+iy);
# sides: 0: x=+1, 1: x=-1, 2: y=+1, 3: y=-1
_SIDE_ENDS = {0: (1 - 1j, 1 + 1j), 1: (-1 + 1j, -1 - 1j),
              2: (1 + 1j, -1 + 1j), 3: (-1 - 1j, 1 - 1j)}

#: chart points a worker evaluates the conformal map on at once
_CHUNK = 8192


def _corner_dir(face, zc):
    """Exact 3D direction of a chart corner (map-independent)."""
    c, e1, e2 = _frame(face)
    p = c + zc.real * e1 + zc.imag * e2
    return p / np.linalg.norm(p)


@dataclasses.dataclass(frozen=True)
class _Motion:
    """Holomorphic rigid chart transition z' = a z + b onto face g."""
    g: int
    a: complex
    b: complex

    def __call__(self, z):
        return self.a * z + self.b


def _side_motions():
    """motions[f][s]: the transition from face f's chart across side s
    into the neighbouring face's chart, from exact corner
    correspondences."""
    corners = {(f, zc): _corner_dir(f, zc) for f in range(6)
               for zc in (1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j)}
    motions = [[None] * 4 for _ in range(6)]
    for f in range(6):
        for s, (zA, zB) in _SIDE_ENDS.items():
            A3, B3 = corners[(f, zA)], corners[(f, zB)]
            for g in range(6):
                if g == f:
                    continue
                zmatch = {}
                for zc in (1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j):
                    if np.allclose(corners[(g, zc)], A3, atol=1e-12):
                        zmatch["A"] = zc
                    if np.allclose(corners[(g, zc)], B3, atol=1e-12):
                        zmatch["B"] = zc
                if len(zmatch) == 2:
                    a = (zmatch["B"] - zmatch["A"]) / (zB - zA)
                    b = zmatch["A"] - a * zA
                    # probe: a first-halo point must land inside g's square
                    mid = 0.5 * (zA + zB)
                    outward = (zB - zA) * (-1j)  # right of A→B
                    probe = a * (mid + 0.05 * outward) + b
                    if max(abs(probe.real), abs(probe.imag)) > 1.0:
                        # wrong orientation: swap endpoint correspondence
                        a = (zmatch["A"] - zmatch["B"]) / (zB - zA)
                        b = zmatch["B"] - a * zA
                    motions[f][s] = _Motion(g, complex(a), complex(b))
                    break
    return motions


def _frame(face):
    return tuple(np.asarray(v, np.float64) for v in _FACES[face])


def _w_series(zs, d):
    """Σ d_k J_k at the points ``zs`` (1D complex), chunk by chunk on the
    host's cores: each point's value is its own row's, whatever rows
    share its call."""
    chunks = [zs[i:i + _CHUNK] for i in range(0, zs.size, _CHUNK)]
    one = lambda z: _basis_integrals(z, d.size) @ d
    if len(chunks) <= 1:
        return one(zs)
    with concurrent.futures.ThreadPoolExecutor(min(len(chunks),
                                                   os.cpu_count() or 1)) as ex:
        return np.concatenate(list(ex.map(one, chunks)))


class _MapMemo:
    """w at the chart points evaluated so far, by bit pattern."""

    def __init__(self):
        self.index, self.w = {}, []

    def __call__(self, zs, d):
        """w at the distinct points ``zs`` (1D complex): remembered ones
        looked up, the others evaluated and remembered."""
        raw = zs.tobytes()
        keys = [raw[16 * i:16 * i + 16] for i in range(zs.size)]
        at = np.array([self.index.get(k, -1) for k in keys], dtype=np.int64)
        miss = at < 0
        if miss.any():
            base = sum(len(w) for w in self.w)
            self.w.append(_w_series(zs[miss], d))
            for j, i in enumerate(np.flatnonzero(miss)):
                self.index[keys[i]] = base + j
            at[miss] = base + np.arange(int(miss.sum()))
        self.w = [np.concatenate(self.w)] if len(self.w) > 1 else self.w
        return self.w[0][at]


def _conformal_w(z, memo=None):
    """w(z) and w'(z) of the conformal square→stereographic map
    (vectorized, complex), the series evaluated once per distinct point
    (bit pattern: +0 and −0 stay apart), and with ``memo`` (a
    ``_MapMemo``) once over every call that shares it."""
    d = np.asarray(conformal_coefficients())
    z = np.asarray(z, complex)
    flat = np.ascontiguousarray(z.ravel())
    if flat.size == 0:
        w = np.zeros(0, complex)
    else:
        bits, inv = np.unique(flat.view(np.uint64).reshape(-1, 2), axis=0,
                              return_inverse=True)
        zs = np.ascontiguousarray(bits).view(complex).ravel()
        w = (memo(zs, d) if memo is not None else _w_series(zs, d))[inv.ravel()]
    w = w.reshape(z.shape)
    z4 = z ** 4 / 4.0
    psi = np.zeros_like(z)
    for k in range(d.size - 1, -1, -1):
        psi = psi * z4 + d[k]
    dw = (1.0 + z4) ** (1.0 / 3.0) * psi
    return w, dw


def _chart_xyz(xs, ys, memo=None):
    """(X, Y, Z) of the conformal map at square coords (xs, ys) in the
    chart's own frame (inverse stereographic image)."""
    w, _ = _conformal_w(np.asarray(xs) + 1j * np.asarray(ys), memo)
    u, v = np.real(w), np.imag(w)
    r2 = u * u + v * v
    den = 1.0 + r2
    return 2 * u / den, 2 * v / den, (1 - r2) / den


def _rotate(face, Xm, Ym, Zm):
    """Chart-frame points onto ``face``'s frame (2D arrays)."""
    c, e1, e2 = _frame(face)
    return (Xm[:, :, None] * e1 + Ym[:, :, None] * e2 + Zm[:, :, None] * c)


def _points(face, xs, ys, map_kind="conformal"):
    """3D unit vectors for square coords (xs, ys) ∈ ~[-1,1] on a face
    (xs, ys broadcastable 2D arrays)."""
    c, e1, e2 = _frame(face)
    if map_kind == "gnomonic":
        t1 = np.tan(np.asarray(xs) * np.pi / 4)
        t2 = np.tan(np.asarray(ys) * np.pi / 4)
        p = (c[None, None, :] + t1[:, :, None] * e1[None, None, :]
             + t2[:, :, None] * e2[None, None, :])
        return p / np.linalg.norm(p, axis=-1, keepdims=True)
    return _rotate(face, *_chart_xyz(xs, ys))


def _points_all(xs, ys, map_kind, memo=None):
    """``_points`` of every face at the same square coords, (6, ...):
    the conformal map evaluated once and rotated into each frame."""
    if map_kind == "gnomonic":
        return np.stack([_points(f, xs, ys, map_kind) for f in range(6)])
    xyz = _chart_xyz(xs, ys, memo)
    return np.stack([_rotate(f, *xyz) for f in range(6)])


def _xy_of(face, pts, map_kind="conformal"):
    """Inverse of _points: square coords (x, y) of unit 3D points on a
    face (Newton on the conformal map; closed form for gnomonic)."""
    c, e1, e2 = _frame(face)
    a = pts @ e1
    b = pts @ e2
    cc = pts @ c
    x_g = np.arctan2(a, cc) / (np.pi / 4)
    y_g = np.arctan2(b, cc) / (np.pi / 4)
    if map_kind == "gnomonic":
        return x_g, y_g
    wt = (a + 1j * b) / (1.0 + cc)          # target stereographic position
    z = x_g + 1j * y_g                       # gnomonic initial guess
    for _ in range(12):
        w, dw = _conformal_w(z)
        step = (w - wt) / dw
        z = z - step
        if np.abs(step).max() < 1e-12:
            break
    return np.real(z), np.imag(z)


def _arc(a, b):
    """Great-circle distance between unit-vector arrays."""
    d = np.clip((a * b).sum(-1), -1.0, 1.0)
    return np.arccos(d)


def _tri_area(a, b, c):
    """Spherical triangle area (L'Huilier)."""
    A, B, Cc = _arc(b, c), _arc(a, c), _arc(a, b)
    s = 0.5 * (A + B + Cc)
    t = np.sqrt(np.clip(np.tan(s / 2) * np.tan((s - A) / 2)
                        * np.tan((s - B) / 2) * np.tan((s - Cc) / 2), 0, None))
    return 4.0 * np.arctan(t)


def _square_lattices(N, H):
    """(d, face coords (len n+1), centre coords (len n)) of the square."""
    d = 2.0 / N
    idx = np.arange(-H, N + H + 1)
    sq_f = -1.0 + idx * d
    sq_c = 0.5 * (sq_f[:-1] + sq_f[1:])
    return d, sq_f, sq_c


class _Geometry:
    """The host geometry of one (N, halo, map): corners and centres of
    every face, and the node positions and tangents the models read,
    each computed at its first use."""

    def __init__(self, N, H, map_kind):
        self.N, self.H, self.map_kind = N, H, map_kind
        self.d, self.sq_f, self.sq_c = _square_lattices(N, H)
        self.motions = _side_motions()
        self._nodes = {}
        self._tangents = {}
        # the corners' and centres' lattices are the interior nodes of
        # (F, F) and (C, C): the map is evaluated there once
        self.memo = _MapMemo()

    @functools.cached_property
    def corners(self):
        XF, YF = np.meshgrid(self.sq_f, self.sq_f, indexing="ij")
        return _points_all(XF, YF, self.map_kind, self.memo)

    @functools.cached_property
    def centers(self):
        XC, YC = np.meshgrid(self.sq_c, self.sq_c, indexing="ij")
        return _points_all(XC, YC, self.map_kind, self.memo)

    def lattice_1d(self, l):
        return self.sq_f[:-1] if l is F else self.sq_c

    def hop(self, z):
        """(face, z_owner, a_rot) of chart coordinates z, (6, P) in face
        f's chart, through the side motions into the owning face's
        chart (the JAX ``_hop``)."""
        motions = self.motions
        face = np.repeat(np.arange(6)[:, None], z.shape[1], 1)
        z = z.copy()
        a = np.ones_like(z)
        tol = 1e-9
        # positive sides hop AT the edge too (x=+1 / y=+1 columns are halo
        # storage — the matching negative-side face computes them); negative
        # edges are the face's own computed columns and stay
        for _ in range(2):
            for ff in range(6):
                for sd, cond in ((0, z.real > 1 - tol), (1, z.real < -1 - tol),
                                 (2, z.imag > 1 - tol), (3, z.imag < -1 - tol)):
                    m = motions[ff][sd]
                    sel = (face == ff) & cond
                    if not sel.any():
                        continue
                    z[sel] = m.a * z[sel] + m.b
                    a[sel] = a[sel] * m.a
                    face[sel] = m.g
        return face, z, a

    def nodes(self, loc2):
        """(6, n, n, 3) node positions incl. halos at ``loc2``: interior
        nodes from the face's own map, halo nodes from the OWNER's chart
        (the JAX ``_node_positions``; the map evaluated once for all
        owners)."""
        if loc2 not in self._nodes:
            xs, ys = self.lattice_1d(loc2[0]), self.lattice_1d(loc2[1])
            X, Y = np.meshgrid(xs, ys, indexing="ij")
            Z = (X + 1j * Y)[None].repeat(6, 0).reshape(6, -1)
            fo, zo, _ = self.hop(Z)
            pts = np.empty((6, Z.shape[1], 3))
            if self.map_kind == "gnomonic":
                for g in range(6):
                    sel = fo == g
                    if sel.any():
                        zz = zo[sel]
                        pts[sel] = _points(g, zz.real[None], zz.imag[None],
                                           self.map_kind)[0]
            else:
                Xm, Ym, Zm = _chart_xyz(zo.real, zo.imag, self.memo)
                for g in range(6):
                    sel = fo == g
                    if sel.any():
                        pts[sel] = _rotate(g, Xm[sel][None], Ym[sel][None],
                                           Zm[sel][None])[0]
            self._nodes[loc2] = pts.reshape((6,) + X.shape + (3,))
        return self._nodes[loc2]

    def tangents(self, loc2, axis):
        """(6, n, n, 3) unit tangents along each face's x (axis 0) or y
        (axis 1) at the interior-clipped lattice of ``loc2`` (the JAX
        ``_tangent`` of every face)."""
        key = (loc2, axis)
        if key not in self._tangents:
            xs, ys = self.lattice_1d(loc2[0]), self.lattice_1d(loc2[1])
            X, Y = np.meshgrid(xs, ys, indexing="ij")
            X, Y = np.clip(X, -1, 1), np.clip(Y, -1, 1)
            self._tangents[key] = _tangents_all(X, Y, axis, self.map_kind)
        return self._tangents[key]


def _tangents_all(xs, ys, axis, map_kind):
    """The JAX ``_tangent`` of every face at the same coords."""
    eps = 1e-6
    dx = (eps, 0.0) if axis == 0 else (0.0, eps)
    xs = np.asarray(xs, float)
    ys = np.asarray(ys, float)
    shape = xs.shape
    p1 = _points_all((xs + dx[0]).reshape(1, -1), (ys + dx[1]).reshape(1, -1),
                     map_kind)[:, 0]
    p0 = _points_all((xs - dx[0]).reshape(1, -1), (ys - dx[1]).reshape(1, -1),
                     map_kind)[:, 0]
    t = (p1 - p0).reshape((6,) + shape + (3,))
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=4)
def _geometry(N, H, map_kind):
    return _Geometry(N, H, map_kind)


@dataclasses.dataclass
class _LocMap:
    """Exchange gather for one staggered location: for every halo node,
    two candidate sources (the neighbour's x-component lattice and
    y-component lattice) with bilinear weights and rotation coefficients.
    Exact node matches have one-hot weights and ±1/0 rotations."""

    hij: tuple           # (i_idx, j_idx) halo positions in storage coords
    f: torch.Tensor      # owner face (6, nh)
    iA: torch.Tensor     # base indices into source lattice A (x-comp)
    jA: torch.Tensor
    wxA: torch.Tensor
    wyA: torch.Tensor
    rA: torch.Tensor     # coefficient multiplying the A-sample
    iB: torch.Tensor     # source lattice B (y-comp)
    jB: torch.Tensor
    wxB: torch.Tensor
    wyB: torch.Tensor
    rB: torch.Tensor


class CubedSphereGrid:
    """6 faces × (Nx, Ny) horizontal cells × Nz vertical levels.

    Field tensors have shape (6, Nx+2H, Ny+2H, Nz+2Hz). ``face_grids()``
    gives the metric protocol per face, so every operator works unchanged
    inside a ``torch.func.vmap`` over faces (``vmap_faces``);
    ``fill_halos`` performs the inter-face exchange.
    """

    curvilinear = True

    def __init__(self, *, size, z=None, radius=6_371_000.0, halo=2,
                 dtype=torch.float32, map_kind="conformal", device="cuda"):
        if isinstance(size, int):
            size = (size, size, 1)
        N, _, nz = size[0], size[1], size[2]
        if size[1] != N:
            raise ValueError("cubed-sphere faces must be square")
        if map_kind not in ("conformal", "gnomonic"):
            raise ValueError(f"unknown map_kind {map_kind!r}")
        self._set_dtype_device(dtype, device)
        self.N = N
        self.H = H = int(halo)
        self.radius = float(radius)
        self.map_kind = map_kind
        z_topo = FLAT if (nz == 1 and z is None) else BOUNDED
        hz = 0 if z_topo is FLAT else max(1, halo)
        if z is None:
            z = (0.0, 1.0)
        interval = (float(z[0]), float(z[1])) if (np.ndim(z) == 1 and len(z) == 2) else None
        spec = None if interval is not None else z
        self._zaxis = _build_axis(nz, hz, z_topo, interval, spec, dtype, self.device)
        self.Nz, self.Hz = nz, hz
        self._set_lattices()

        geo = self._geo
        corners, centers = geo.corners, geo.centers
        R = self.radius
        n = self._sq_c.size
        # x-edges (between corners (i,j)→(i+1,j)): (6, n, n+1) → (C, F)
        edge_x = R * _arc(corners[:, :-1, :, :], corners[:, 1:, :, :])
        # y-edges: (6, n+1, n) → (F, C)
        edge_y = R * _arc(corners[:, :, :-1, :], corners[:, :, 1:, :])
        dx_cf = edge_x[:, :, :n]
        dy_fc = edge_y[:, :n, :]
        # center-to-center distances: (F,C) along x, (C,F) along y
        dx_fc = np.empty((6, n, n))
        dx_fc[:, 1:, :] = R * _arc(centers[:, :-1, :, :], centers[:, 1:, :, :])
        dx_fc[:, 0, :] = dx_fc[:, 1, :]
        dy_cf = np.empty((6, n, n))
        dy_cf[:, :, 1:] = R * _arc(centers[:, :, :-1, :], centers[:, :, 1:, :])
        dy_cf[:, :, 0] = dy_cf[:, :, 1]
        # cell-center widths: average the two bounding edges
        dx_cc = 0.5 * (edge_x[:, :, :-1] + edge_x[:, :, 1:])
        dy_cc = 0.5 * (edge_y[:, :-1, :] + edge_y[:, 1:, :])
        # (F,F) spacings: averages of neighbouring edge lengths
        dx_ff = np.empty((6, n, n))
        dx_ff[:, 1:, :] = 0.5 * (dx_cc[:, :-1, :] + dx_cc[:, 1:, :])
        dx_ff[:, 0, :] = dx_ff[:, 1, :]
        dy_ff = np.empty((6, n, n))
        dy_ff[:, :, 1:] = 0.5 * (dy_cc[:, :, :-1] + dy_cc[:, :, 1:])
        dy_ff[:, :, 0] = dy_ff[:, :, 1]
        # cell areas at (C,C): two spherical triangles per quad
        a_ = corners[:, :-1, :-1]
        b_ = corners[:, 1:, :-1]
        c_ = corners[:, 1:, 1:]
        d_ = corners[:, :-1, 1:]
        az_cc = R * R * (_tri_area(a_, b_, c_) + _tri_area(a_, c_, d_))
        # vorticity-cell areas at (F,F): quad of surrounding centers
        az_ff = np.empty((6, n, n))
        a2 = centers[:, :-1, :-1]
        b2 = centers[:, 1:, :-1]
        c2 = centers[:, 1:, 1:]
        d2 = centers[:, :-1, 1:]
        az_ff[:, 1:, 1:] = R * R * (_tri_area(a2, b2, c2) + _tri_area(a2, c2, d2))
        az_ff[:, 0, :] = az_ff[:, 1, :]
        az_ff[:, :, 0] = az_ff[:, :, 1]

        to = lambda a: self._tensor(a[..., None])  # add z-broadcast dim
        self._dx = {(C, C): to(dx_cc), (C, F): to(dx_cf),
                    (F, C): to(dx_fc), (F, F): to(dx_ff)}
        self._dy = {(C, C): to(dy_cc), (F, C): to(dy_fc),
                    (C, F): to(dy_cf), (F, F): to(dy_ff)}
        self._az = {(C, C): to(az_cc), (F, F): to(az_ff),
                    (F, C): to(0.5 * (az_cc + np.roll(az_cc, 1, axis=1))),
                    (C, F): to(0.5 * (az_cc + np.roll(az_cc, 1, axis=2)))}
        self._centers3d = centers
        self._build_maps()
        self._lonlat(centers)

    def _set_dtype_device(self, dtype, device):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        self.dtype = dtype
        self.device = torch.device(device)
        self._cache = {}

    def _set_lattices(self):
        self._geo = _geometry(self.N, self.H, self.map_kind)
        self._d, self._sq_f, self._sq_c = self._geo.d, self._geo.sq_f, self._geo.sq_c
        self._motions_tbl = self._geo.motions

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    def _build_maps(self):
        self._maps = {k: self._build_loc_map(k) for k in ((C, C), (F, C), (C, F))}

    # -- grid files --------------------------------------------------------------
    _KEYS = ((C, C), (C, F), (F, C), (F, F))

    def to_file(self, path):
        """Persist the grid's metrics + geometry to one .npz, with the JAX
        package's keys (a file of either package loads in the other)."""
        kn = lambda k: "".join("c" if l is C else "f" for l in k)
        host = lambda t: t.detach().cpu().numpy()
        za = self._zaxis
        data = {"N": self.N, "H": self.H, "radius": self.radius,
                "map_kind": self.map_kind,
                "z_meta": np.array([za.n, za.h, int(za.topo is not FLAT),
                                    int(za.regular), za.extent], np.float64),
                "z_cf": host(za.cf), "z_cc": host(za.cc),
                "z_dc": host(za.dc), "z_df": host(za.df),
                "centers3d": self._centers3d}
        for name, d in (("dx", self._dx), ("dy", self._dy), ("az", self._az)):
            for k, v in d.items():
                data[f"{name}_{kn(k)}"] = host(v)
        np.savez(path, **data)

    @classmethod
    def from_file(cls, path, dtype=torch.float64, device="cuda"):
        """Rebuild a grid saved with ``to_file`` (by either package)
        without re-evaluating the conformal map for its metrics (the
        exchange maps and motions are cheap and rebuilt)."""
        z = np.load(path, allow_pickle=True)
        obj = object.__new__(cls)
        obj._set_dtype_device(dtype, device)
        obj.N, obj.H = int(z["N"]), int(z["H"])
        obj.radius = float(z["radius"])
        obj.map_kind = str(z["map_kind"])
        n, h, bounded, regular, extent = z["z_meta"]
        t = lambda key: obj._tensor(z[key])
        obj._zaxis = _Axis(int(n), int(h), BOUNDED if bounded else FLAT,
                           t("z_cf"), t("z_cc"), t("z_dc"), t("z_df"),
                           bool(regular), float(extent))
        obj.Nz, obj.Hz = obj._zaxis.n, obj._zaxis.h
        obj._set_lattices()
        kn = lambda k: "".join("c" if l is C else "f" for l in k)
        obj._dx = {k: t(f"dx_{kn(k)}") for k in cls._KEYS}
        obj._dy = {k: t(f"dy_{kn(k)}") for k in cls._KEYS}
        obj._az = {k: t(f"az_{kn(k)}") for k in cls._KEYS}
        obj._centers3d = z["centers3d"]
        obj._build_maps()
        obj._lonlat(obj._centers3d)
        return obj

    # -- node lattices ----------------------------------------------------------
    def _lattice_1d(self, l):
        # storage length is n for every location: face-located dims use
        # sq_f[:-1] (face i sits between cells i-1 and i)
        return self._geo.lattice_1d(l)

    def _nodes(self, face, loc2):
        """3D node positions incl. halos, (n, n, 3) of ``face`` or (6, n,
        n, 3) of every face: interior nodes from the face's own map, halo
        nodes from the OWNER's chart (the JAX ``_node_positions``)."""
        pts = self._geo.nodes(tuple(loc2))
        return pts[face] if np.isscalar(face) else pts

    def _tangents(self, loc2, axis):
        """``_tangent`` of every face at the interior-clipped lattice of
        ``loc2``, (6, n, n, 3)."""
        return self._geo.tangents(tuple(loc2), axis)

    # -- exchange maps ----------------------------------------------------------
    def _build_loc_map(self, loc2):
        """Per-location exchange map (see _LocMap) from the chart
        transition motions: band halo nodes land exactly on the owner's
        lattice (one-hot gather, rotation = the motion's quarter-turn);
        corner-wedge nodes land off-lattice and use rotated bilinear
        interpolation."""
        N, H, d = self.N, self.H, self._d
        xs = self._lattice_1d(loc2[0])
        ys = self._lattice_1d(loc2[1])
        n0, n1 = xs.size, ys.size
        scalar = loc2 == (C, C)
        locA = loc2
        locB = (C, C) if scalar else (loc2[1], loc2[0])

        halo_mask = np.ones((n0, n1), bool)
        halo_mask[H:H + N, H:H + N] = False
        hij = np.argwhere(halo_mask)
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        zh = (X[halo_mask] + 1j * Y[halo_mask])[None].repeat(6, 0)
        fo, zo, a = self._geo.hop(zh)

        # my component direction in the owner chart: the constant a of the
        # composed motion. Lattice A is this location's own lattice; B the
        # swapped one.
        if scalar:
            rA = np.ones(a.shape)
            rB = np.zeros(a.shape)
        elif loc2[0] is F:       # u-located: my x-direction = a
            rA, rB = a.real, a.imag
        else:                    # v-located: my y-direction = i·a
            dirc = 1j * a
            rA, rB = dirc.imag, dirc.real

        def frac(loc_src):
            sx = self._lattice_1d(loc_src[0])
            sy = self._lattice_1d(loc_src[1])
            fi = (zo.real - sx[0]) / d
            fj = (zo.imag - sy[0]) / d
            return fi, fj

        def entries(loc_src):
            fi, fj = frac(loc_src)
            ri, rj = np.round(fi), np.round(fj)
            exact = (np.abs(fi - ri) < 1e-6) & (np.abs(fj - rj) < 1e-6)
            lo, hi = H, H + N - 1
            i0 = np.clip(np.where(exact, ri, np.floor(fi)), lo, hi - 1).astype(int)
            j0 = np.clip(np.where(exact, rj, np.floor(fj)), lo, hi - 1).astype(int)
            wx = np.clip(np.where(exact, ri, fi) - i0, 0.0, 1.0)
            wy = np.clip(np.where(exact, rj, fj) - j0, 0.0, 1.0)
            return i0, j0, wx, wy

        iA, jA, wxA, wyA = entries(locA)
        if scalar:
            iB, jB, wxB, wyB = iA, jA, wxA, wyA
            rB = np.zeros_like(rA)
        else:
            iB, jB, wxB, wyB = entries(locB)

        I = lambda v: self._tensor(v, torch.int64)
        R = self._tensor
        return _LocMap((I(hij[:, 0]), I(hij[:, 1])), I(fo), I(iA), I(jA),
                       R(wxA), R(wyA), R(rA), I(iB), I(jB), R(wxB), R(wyB), R(rB))

    def _plan(self, loc2, lattice):
        """The bilinear gather of the map at ``loc2`` from its lattice A or
        B (the JAX ``_gather``, (1−wx)(1−wy)·g00 + wx(1−wy)·g10 +
        (1−wx)wy·g01 + wx·wy·g11) as one indexed read: the flat (face, i,
        j) indices of the four corners, (4, 6, nh), and their weights,
        (4, 6, nh, 1), each product formed as JAX forms it; with the halo
        points' flat (i, j) indices."""
        key = (loc2, lattice)
        if key not in self._cache:
            m = self._maps[loc2]
            f, i0, j0, wx, wy = (getattr(m, k + lattice) if k != "f" else m.f
                                 for k in ("f", "i", "j", "wx", "wy"))
            n = self.N + 2 * self.H
            flat = lambda di, dj: (f * n + i0 + di) * n + j0 + dj
            idx = torch.stack([flat(0, 0), flat(1, 0), flat(0, 1), flat(1, 1)])
            wx, wy = wx[:, :, None], wy[:, :, None]
            w = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy])
            self._cache[key] = (idx, w, m.hij[0] * n + m.hij[1])
        return self._cache[key]

    def _gather(self, data, loc2, lattice):
        """The JAX ``_gather`` of ``data`` through ``_plan``: the same terms
        in the same order."""
        idx, w, _ = self._plan(loc2, lattice)
        g = data.reshape(-1, data.shape[-1])[idx]
        return w[0] * g[0] + w[1] * g[1] + w[2] * g[2] + w[3] * g[3]

    def _set_halos(self, data, loc2, values):
        """A copy of ``data`` with the halo points of the map at ``loc2``
        set to ``values`` (6, nh, Z), one indexed write."""
        out = data.clone()
        n = self.N + 2 * self.H
        out.view(6, n * n, data.shape[-1])[:, self._plan(loc2, "A")[2], :] = values
        return out

    def _lonlat(self, centers):
        x, y, z = centers[..., 0], centers[..., 1], centers[..., 2]
        self.longitude = self._tensor(np.degrees(np.arctan2(y, x)))
        self.latitude = self._tensor(np.degrees(np.arcsin(np.clip(z, -1, 1))))

    # -- shapes ---------------------------------------------------------------
    @property
    def total_shape(self):
        n = self.N + 2 * self.H
        return (6, n, n, self.Nz + 2 * self.Hz)

    @property
    def shape(self):
        return (6, self.N, self.N, self.Nz)

    def new_field(self, fill=0.0):
        return torch.full(self.total_shape, fill, dtype=self.dtype, device=self.device)

    def interior(self, data):
        H, Hz = self.H, self.Hz
        return data[:, H:H + self.N, H:H + self.N, Hz:Hz + self.Nz]

    # -- halo filling ----------------------------------------------------------
    def fill_halos(self, data, vector_pair=None):
        """Inter-face halo exchange by precomputed gathers; returns new
        tensors and leaves its arguments untouched.

        Scalars (cell-centred): exact rotated index copies where halo
        nodes coincide with neighbour centres, bilinear in the corner
        wedges. Horizontal velocity pairs (``vector_pair=(u, v)``): both
        of the neighbour's components sampled on their own staggered
        lattices and combined with the (snapped) tangent rotation."""
        data = data.contiguous()
        if vector_pair is None:
            return self._set_halos(data, (C, C), self._gather(data, (C, C), "A"))
        u, v = (x.contiguous() for x in vector_pair)
        mu = self._maps[(F, C)]
        mv = self._maps[(C, F)]
        uh = (mu.rA[:, :, None] * self._gather(u, (F, C), "A")
              + mu.rB[:, :, None] * self._gather(v, (F, C), "B"))
        vh = (mv.rA[:, :, None] * self._gather(v, (C, F), "A")
              + mv.rB[:, :, None] * self._gather(u, (C, F), "B"))
        return self._set_halos(u, (F, C), uh), self._set_halos(v, (C, F), vh)

    # -- per-face grids (for vmap) --------------------------------------------
    def face_grids(self):
        """The per-face metric protocol over the stacked faces: its
        tensors carry the leading face axis; ``vmap_faces`` maps a
        function of one face over them."""
        return _FaceGrid(dict(self._dx), dict(self._dy), dict(self._az),
                         self._zaxis, self.N, self.H, self.Nz, self.Hz, self.dtype)

    def vmap_faces(self, fn, *args):
        """``fn(face_grid, *per-face args)`` over the six faces in one
        ``torch.func.vmap``: every tensor of ``args`` (pytrees of them)
        carries the leading face axis."""
        fg = self.face_grids()
        keys = [("dx", k) for k in fg._dx] + [("dy", k) for k in fg._dy] \
            + [("az", k) for k in fg._az]
        leaves = tuple(getattr(fg, "_" + kind)[k] for kind, k in keys)

        def one(metrics, *a):
            d = {"dx": {}, "dy": {}, "az": {}}
            for (kind, k), t in zip(keys, metrics):
                d[kind][k] = t
            return fn(_FaceGrid(d["dx"], d["dy"], d["az"], fg._zaxis, fg.N,
                                fg.H, fg.Nz, fg.Hz, fg.dtype), *a)

        return torch.func.vmap(one)(leaves, *args)

    def __repr__(self):
        return (f"CubedSphereGrid(6 × {self.N}×{self.N}×{self.Nz}, halo="
                f"{self.H}, radius={self.radius:g}, {self.map_kind}, "
                f"device={self.device})")


class _FaceGrid:
    """Metric protocol over one face: outside ``vmap_faces`` its tensors
    carry the leading face axis; inside, they are per-face (X, Y, 1)."""

    curvilinear = True
    dist = (None, None, None)

    def __init__(self, dx, dy, az, zaxis, N, H, Nz, Hz, dtype):
        self._dx, self._dy, self._az = dx, dy, az
        self._zaxis = zaxis
        self.N, self.H, self.Nz, self.Hz = N, H, Nz, Hz
        self.dtype = dtype
        self.Nx = self.Ny = N
        self.Hx = self.Hy = H
        self.topology = (FULLY_CONNECTED, FULLY_CONNECTED, self._zaxis.topo)

    # metric protocol
    def dx(self, loc):
        return self._dx[(loc[0], loc[1])]

    def dy(self, loc):
        return self._dy[(loc[0], loc[1])]

    def dz(self, loc):
        arr = self._zaxis.dc if loc[2] is C else self._zaxis.df
        return arr.reshape(1, 1, -1)

    def spacing(self, axis, loc):
        return (self.dx, self.dy, self.dz)[axis](loc)

    def Az(self, loc):
        return self._az[(loc[0], loc[1])]

    def Ax(self, loc):
        return self.dy(loc) * self.dz(loc)

    def Ay(self, loc):
        return self.dx(loc) * self.dz(loc)

    def V(self, loc):
        return self.Az(loc) * self.dz(loc)

    @property
    def total_shape(self):
        n = self.N + 2 * self.H
        return (n, n, self.Nz + 2 * self.Hz)

    @property
    def shape(self):
        return (self.N, self.N, self.Nz)

    @property
    def halo(self):
        return (self.H, self.H, self.Hz)

    def interior(self, data):
        H, Hz = self.H, self.Hz
        return data[H:H + self.N, H:H + self.N, Hz:Hz + self.Nz]


def cubed_sphere_tracer_step(grid, c, u, v, dt, scheme):
    """One explicit tracer-advection step on the cubed sphere: exchange
    halos, then the per-face flux divergence in one vmapped call."""
    from ..advection.fluxes import div_Uc

    c = grid.fill_halos(c)
    u, v = grid.fill_halos(u, vector_pair=(u, v))

    def face_div(g, u_f, v_f, c_f):
        w0 = torch.zeros_like(c_f)
        return -div_Uc(g, scheme, u_f, v_f, w0, c_f)

    G = grid.vmap_faces(face_div, u, v, c)
    return c + dt * G
