"""Rectilinear staggered grids, regular or stretched per axis.

Counterpart of ``clima_oceananigans_jl_tpu/grids/rectilinear.py``
(Oceananigans' ``RectilinearGrid``). Every field array carries explicit
halos of width ``(Hx, Hy, Hz)``: array index ``a`` along an axis is
logical cell ``i = a - H``, interior cells are ``i in [0, N)``, and face
``i`` is the lower face of cell ``i``. A bounded axis has one more
interior face, ``i = N``, stored in the first halo cell.

An axis is given by an interval, an array of its ``n + 1`` face
positions, or a callable of the face index; its halo faces continue the
edge spacing (bounded) or wrap (periodic), and a regular axis holds
exactly ``extent / n`` in every spacing entry, as the JAX grid does.
The grid holds its coordinate and spacing arrays as tensors on
``device`` (the card unless the caller asks for ``"cpu"``) in
``dtype``; every array of a model is allocated from them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.location import C
from .topology import BOUNDED, FLAT, PERIODIC, Topology


def _face_positions(interval, n, spec=None):
    """The n+1 interior face positions (float64) from an interval, a face
    array or a callable of the face index."""
    if spec is None:
        lo, hi = interval
        return np.linspace(lo, hi, n + 1, dtype=np.float64)
    if callable(spec):
        return np.asarray([spec(k) for k in range(n + 1)], dtype=np.float64)
    faces = np.asarray(spec, dtype=np.float64)
    if faces.shape != (n + 1,):
        raise ValueError(f"face-position array must have length n+1={n + 1}, "
                         f"got {faces.shape}")
    if np.any(np.diff(faces) <= 0):
        raise ValueError("face positions must be strictly increasing")
    return faces


def _extend_faces(faces, topo, h):
    """Interior faces (length n+1) continued into the halos: length n+2h+1."""
    n = len(faces) - 1
    length = faces[-1] - faces[0]
    left = [faces[n - k] - length if topo is PERIODIC
            else faces[0] - k * (faces[1] - faces[0]) for k in range(1, h + 1)]
    right = [faces[k] + length if topo is PERIODIC
             else faces[-1] + k * (faces[-1] - faces[-2]) for k in range(1, h + 1)]
    return np.concatenate([left[::-1], faces, right])


@dataclasses.dataclass(frozen=True)
class _Axis:
    """One axis: coordinates and spacings with halos, as 1D tensors."""

    n: int
    h: int
    topo: Topology
    cf: torch.Tensor   # face coordinates, len n+2h (face i = lower face of cell i)
    cc: torch.Tensor   # centre coordinates, len n+2h
    dc: torch.Tensor   # spacing at centres (cell widths), len n+2h
    df: torch.Tensor   # spacing at faces (centre-to-centre), len n+2h
    regular: bool
    extent: float


def _build_axis(n, h, topo, interval, spec, dtype, device):
    """The JAX ``_build_axis`` rules: halo extension, ``df[0] = df[1]``,
    and a regular axis canonicalised to exactly extent/n everywhere (so
    every metric is bitwise position-independent)."""
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    if topo is FLAT:
        one, zero = to(np.ones(1)), to(np.zeros(1))
        return _Axis(1, 0, topo, zero, zero, one, one, True, 1.0)
    if h < 1:
        raise ValueError("halo width must be >= 1 on non-flat axes")
    faces = _face_positions(interval, n, spec)
    ext = _extend_faces(faces, topo, h)        # len n+2h+1
    centres = 0.5 * (ext[:-1] + ext[1:])
    dc = np.diff(ext)
    df = np.empty_like(dc)
    df[1:] = centres[1:] - centres[:-1]
    df[0] = df[1] if len(df) > 1 else dc[0]
    regular = bool(np.allclose(dc, dc[0]))
    if regular:
        const = float(faces[-1] - faces[0]) / n
        dc = np.full_like(dc, const)
        df = np.full_like(df, const)
    return _Axis(n, h, topo, to(ext[:-1]), to(centres), to(dc), to(df),
                 regular, float(faces[-1] - faces[0]))


def _host(t):
    """A 1D tensor as a float64 numpy array (the value in the grid's type)."""
    return t.detach().cpu().double().numpy()


def _bx(arr, axis):
    """Reshape a 1D per-axis tensor to broadcast over an (x, y, z) field."""
    shape = [1, 1, 1]
    shape[axis] = arr.shape[0]
    return arr.reshape(shape)


class RectilinearGrid:
    """Staggered rectilinear grid, regular or stretched per axis."""

    curvilinear = False
    #: per axis None, or (mesh_axis, n_shards, global_topology) on an axis
    #: cut over a mesh of shards (``parallel/decomposition.py``)
    dist = (None, None, None)

    def __init__(self, *, size, extent=None, x=None, y=None, z=None,
                 topology=(PERIODIC, PERIODIC, BOUNDED), halo=None,
                 dtype=torch.float32, device="cuda"):
        if len(size) != 3:
            raise ValueError("size must be a 3-tuple (use 1 for flat axes)")
        topology = tuple(Topology(t) for t in topology)
        if halo is None:
            halo = tuple(0 if t is FLAT else 3 for t in topology)
        halo = tuple(0 if t is FLAT else max(1, h) for h, t in zip(halo, topology))
        intervals = [None, None, None]
        specs = [x, y, z]
        if extent is not None:
            ex = iter(extent)
            for a in range(3):
                if topology[a] is not FLAT and specs[a] is None:
                    intervals[a] = (0.0, float(next(ex)))
        for a, s in enumerate(specs):
            # a 2-element spec is an interval (for n=1 it coincides with faces)
            if s is not None and not callable(s) and np.ndim(s) == 1 and len(s) == 2:
                intervals[a] = (float(s[0]), float(s[1]))
                specs[a] = None
        for a in range(3):
            if topology[a] is not FLAT and intervals[a] is None and specs[a] is None:
                raise ValueError("each non-flat axis needs an extent or x/y/z")
        self._set_dtype_device(dtype, device)
        self._axes = tuple(_build_axis(size[a], halo[a], topology[a],
                                       intervals[a], specs[a], dtype, self.device)
                           for a in range(3))
        self._init_static()

    def _set_dtype_device(self, dtype, device):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        self.dtype = dtype
        self.device = torch.device(device)
        #: per-grid cache of constants derived from the grid: stretched-axis
        #: WENO5 tables (``advection/reconstruction_tables.py``), the
        #: kernels' metric rows (``ops/metric_rows.py``), the column depths
        self._cache = {}

    def _init_static(self):
        ax = self._axes
        self.Nx, self.Ny, self.Nz = (a.n for a in ax)
        self.Hx, self.Hy, self.Hz = (a.h for a in ax)
        self.topology = tuple(a.topo for a in ax)
        self.Lx, self.Ly, self.Lz = (a.extent for a in ax)

    # -- shapes ------------------------------------------------------------
    @property
    def shape(self):
        """Interior shape (Nx, Ny, Nz)."""
        return (self.Nx, self.Ny, self.Nz)

    @property
    def total_shape(self):
        """Array shape with halos."""
        return (self.Nx + 2 * self.Hx, self.Ny + 2 * self.Hy,
                self.Nz + 2 * self.Hz)

    @property
    def halo(self):
        return (self.Hx, self.Hy, self.Hz)

    @property
    def interior_slices(self):
        return tuple(slice(h, h + n) for h, n in zip(self.halo, self.shape))

    def interior(self, data):
        """Interior view of a with-halo array. Arrays already of interior
        shape (the halo-free ``G_prev``) pass through unchanged."""
        if data.ndim == 3 and tuple(data.shape) == tuple(self.shape):
            return data
        return data[self.interior_slices]

    def zeros(self, shape=None):
        """A zero tensor on the grid's device in its dtype (with-halo
        shape by default)."""
        return torch.zeros(self.total_shape if shape is None else shape,
                           dtype=self.dtype, device=self.device)

    def pad(self, interior):
        """Place an interior-shaped tensor into a zero with-halo array."""
        out = self.zeros()
        out[self.interior_slices] = interior
        return out

    # -- coordinates ---------------------------------------------------------
    def coord(self, axis, loc, with_halo=False):
        a = self._axes[axis]
        arr = a.cc if loc == C else a.cf
        return arr if with_halo else arr[a.h: a.h + a.n]

    def nodes(self, loc, with_halo=False):
        """Broadcastable (x, y, z) coordinate tensors at a location triple."""
        return tuple(_bx(self.coord(a, loc[a], with_halo), a) for a in range(3))

    # -- metrics (broadcastable over (x, y, z) with-halo arrays) ---------------
    def spacing(self, axis, loc):
        """Grid spacing along `axis` for a field at location-triple `loc`."""
        a = self._axes[axis]
        return _bx(a.dc if loc[axis] == C else a.df, axis)

    def dx(self, loc):
        return self.spacing(0, loc)

    def dy(self, loc):
        return self.spacing(1, loc)

    def dz(self, loc):
        return self.spacing(2, loc)

    def Ax(self, loc):  # area of the yz cell face crossed by u
        return self.dy(loc) * self.dz(loc)

    def Ay(self, loc):
        return self.dx(loc) * self.dz(loc)

    def Az(self, loc):
        return self.dx(loc) * self.dy(loc)

    def V(self, loc):
        return self.dx(loc) * self.dy(loc) * self.dz(loc)

    # -- regularity ------------------------------------------------------------
    @property
    def x_regular(self):
        return self._axes[0].regular

    @property
    def y_regular(self):
        return self._axes[1].regular

    @property
    def z_regular(self):
        return self._axes[2].regular

    @property
    def all_regular(self):
        return self.x_regular and self.y_regular and self.z_regular

    @property
    def hregular(self):
        """Regular in x and y (z may be stretched)."""
        return self.x_regular and self.y_regular

    @property
    def regular(self):
        """Per-axis regularity flags (x, y, z)."""
        return tuple(a.regular for a in self._axes)

    def min_spacing(self):
        """Smallest interior grid spacing (a host number)."""
        vals = [float(a.dc[a.h: a.h + a.n].min()) for a in self._axes
                if a.topo is not FLAT]
        return min(vals) if vals else 1.0

    def with_halo(self, halo):
        """This grid with (at least) the given halo widths."""
        halo = tuple(0 if t is FLAT else max(h, 1)
                     for h, t in zip(halo, self.topology))
        if halo == self.halo:
            return self
        return self._rebuild_with_halo(halo)

    def _rebuild_with_halo(self, halo):
        """The JAX rebuild: a regular axis from its stored first face and
        extent, a stretched one from its stored interior faces."""
        new = object.__new__(type(self))
        new._set_dtype_device(self.dtype, self.device)
        new.dist = self.dist
        axes = []
        for a, h in zip(self._axes, halo):
            if a.topo is FLAT:
                axes.append(a)
                continue
            cf = _host(a.cf)
            if a.regular:
                lo = float(cf[a.h])
                axes.append(_build_axis(a.n, h, a.topo, (lo, lo + a.extent),
                                        None, self.dtype, self.device))
                continue
            dc = _host(a.dc)
            faces = np.empty(a.n + 1)
            faces[:-1] = cf[a.h: a.h + a.n]
            faces[-1] = cf[a.h + a.n - 1] + dc[a.h + a.n - 1]
            axes.append(_build_axis(a.n, h, a.topo, None, faces, self.dtype,
                                    self.device))
        new._axes = tuple(axes)
        new._init_static()
        return new

    def subgrid_along(self, axis, start, n_new):
        """The strip of interior cells [start, start + n_new) of ``axis``,
        with this grid's halo width: the axis' arrays sliced (array index
        offset ``start``), so positions and spacings stay the grid's own.
        The halo-overlap step recomputes a shard's edge strips on these;
        ``dist`` is cleared on the sliced axis (a strip never exchanges)."""
        a = self._axes[axis]
        new = object.__new__(type(self))
        new._set_dtype_device(self.dtype, self.device)
        new.dist = tuple(None if i == axis else d for i, d in enumerate(self.dist))
        sl = slice(start, start + n_new + 2 * a.h)
        sub = _Axis(n_new, a.h, a.topo, a.cf[sl], a.cc[sl], a.dc[sl], a.df[sl],
                    a.regular, a.extent * n_new / a.n)
        new._axes = tuple(sub if i == axis else ax for i, ax in enumerate(self._axes))
        new._init_static()
        return new

    def __repr__(self):
        t = tuple(t.value for t in self.topology)
        return (f"{type(self).__name__}(size={self.shape}, halo={self.halo}, "
                f"topology={t}, dtype={self.dtype}, device={self.device})")
